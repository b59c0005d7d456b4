// The split-K single-query (decode-mode) attention shared by
// flash_decode.cu (a contiguous cache) and flash_decode_paged.cu (a paged
// pool), in fp32, bf16 and fp16, for Hopper (sm_90a).
//
//   o = softmax(q . K^T * scale + key_bias) V, one query row per (slot, head)
//
// Bound on this card: bytes. Every cached K and V row is read once and
// used for two multiply-adds per element; at the serving shape (96
// (slot, head) rows of 1024 keys, D = 64) a layer's step streams 50 MB
// of K/V in fp32 (25 MB in bf16) against ~0.2 us of arithmetic. What held
// the first design (one block per row, loads issued four keys at a time
// and waited for) below that rate was too few bytes in flight: at
// 3.35 TB/s and about a microsecond of latency the card wants some 3 MB
// requested at any time. The design:
//
// - Split-K over a thread-block cluster. Each (slot, head) row's keys
//   can be cut into `splits` ranges (the host's `_decode_splits`, from
//   the shape alone), one block each: ceil(S / splits) keys in the
//   contiguous kernel, ceil(max_blocks / splits) whole pool blocks in the
//   paged one. The blocks of one row form a cluster (at most 8, the
//   portable size): at the end each holds its partial state (m, l,
//   acc[D]) in shared memory, and rank 0 reads the others' through
//   distributed shared memory, in rank order, and writes o. No global
//   scratch, no atomics, no second launch, and the output is the same
//   bits on every run. With one split a block writes o itself.
// - An asynchronous copy ring. A block streams its range as tiles of
//   `tile` key rows (K, V and the key bias) through the stages of a
//   shared-memory ring (`Ring`, each kernel's own), all but one stage in
//   flight while one is scored. The contiguous kernel copies 16-byte
//   pieces with `cp.async`, every thread in turn; the paged kernel copies
//   each pool block (a contiguous [blk, D] run of one head) with one
//   `cp.async.bulk` counted on the stage's `mbarrier`, the lanes of one
//   warp issuing a tile's blocks side by side from the split's table
//   entries (staged in shared memory once), with no division. A tile holds whole
//   pool blocks, or a piece of one when a block is longer than a tile.
//   The key bias comes with 4-byte `cp.async` copies. A tile's size
//   follows from the Ring: 16 KB of K and V for 128 threads and four rows
//   a group (the paged kernel), 32 KB for 256 threads (the contiguous
//   one), twice that for fp32 past D = 128.
// - Reading the ring. A block's threads work in groups of `lanes`
//   threads, one key row a group at a time; a thread holds `kP` 16-byte
//   pieces of the row (piece p of lane j is the row's piece p * lanes + j)
//   and the group sums its dot product with shuffles. Rows are packed in
//   shared memory with no padding: the groups of a warp read consecutive
//   rows, so a quarter warp reads 128 consecutive bytes, and the copies
//   write them the same way: no bank conflict, no swizzle.
// - The softmax. Each group takes the Ring's rows-per-group rows of a
//   tile at once and keeps an online-softmax state (m, l, acc) in
//   registers across the tiles; at the end the groups' states merge in
//   shared memory (group order), then the cluster's (rank order). Scores,
//   p, l and acc are fp32, the loop's exponentials exp2 of x log2(e); in
//   bf16 and fp16 each p rounds to T before it multiplies V, as the
//   reference's p.astype(v.dtype), against the group's running max within
//   its split. A row past the split's range, or a split with no keys,
//   adds weight 0.
// - Head dims. A D whose rows are whole 16-byte pieces with 16-byte
//   aligned operands (every multiple of 8, and of 4 in fp32) goes through
//   the ring, at D = 64 and 16 from instantiations that fix D (measured
//   faster than the run-time form there), at any other D from one that
//   takes it at run time. Any other D (or a misaligned operand) runs the
//   element path: the same split, merge and arithmetic, four elements a
//   piece read straight from device memory, no ring.

#pragma once

#include <cooperative_groups.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace flash {
namespace decode {

namespace cg = cooperative_groups;
using mma::cp_async4;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::smem_addr;

constexpr int kMaxSplits = 8;      // the portable cluster size

// The shape of a kernel's ring: threads a block, key rows a thread group
// takes a tile, stages (tiles) of the ring, and whether the lanes of one
// warp move each contiguous run of rows with one bulk copy (else every
// thread, 16 bytes at a time). Each kernel's source picks its own.
template <int Threads, int RowsPerGroup, int Stages, bool Bulk>
struct Ring {
  static constexpr int kThreads = Threads;
  static constexpr int kRowsPerGroup = RowsPerGroup;
  static constexpr int kStages = Stages;
  static constexpr bool kBulk = Bulk;
};

// Threads of a key row: the smallest power of two >= chunks / pieces.
__host__ __device__ constexpr int row_lanes(int chunks, int pieces) {
  int need = (chunks + pieces - 1) / pieces;
  int n = 1;
  while (n < need) n *= 2;
  return n;
}

// Elements of a piece: 16 bytes of T on the ring, four on the element
// path.
template <typename T, bool kVec>
__host__ __device__ constexpr int piece_elems() {
  return kVec ? 16 / (int)sizeof(T) : 4;
}

// The geometry of one launch, the same on the host (for the shared
// memory it asks for) and in the kernel.
struct Geometry {
  int chunks;     // pieces of a row
  int lanes;      // threads of a row
  int pieces;     // pieces of a row a group holds, padding included:
                  // lanes * kP
  int groups;     // rows a block reads at once: threads / lanes
  int tile;       // key rows of a tile: groups * rows per group
  int row_bytes;  // D * sizeof(T)
};

template <typename T, bool kVec, int kP, class R>
__host__ __device__ constexpr Geometry geometry(int d) {
  Geometry g{};
  g.chunks = (d + piece_elems<T, kVec>() - 1) / piece_elems<T, kVec>();
  g.lanes = row_lanes(g.chunks, kP);
  g.pieces = g.lanes * kP;
  g.groups = R::kThreads / g.lanes;
  g.tile = g.groups * R::kRowsPerGroup;
  g.row_bytes = d * (int)sizeof(T);
  return g;
}

// Byte offsets of the dynamic shared memory: the ring (K, V, bias per
// stage), the stages' mbarriers, the split's table entries, the groups'
// states and the block's merged state, which the cluster reads.
struct SmemLayout {
  int stage, ring, bars, table, gm, gl, gacc, st, total;
};

__host__ __device__ inline SmemLayout smem_layout(const Geometry& g, int pe,
                                                  int stages, bool bulk,
                                                  int table_entries) {
  SmemLayout s{};
  int off = 0;
  s.stage = stages > 0 ? 2 * g.tile * g.row_bytes + 4 * g.tile : 0;
  s.ring = off;
  off += stages * s.stage;
  s.bars = off;
  off += bulk ? 8 * stages : 0;
  s.table = off;
  off = (off + 4 * table_entries + 15) & ~15;
  s.gm = off;
  off += 4 * g.groups;
  s.gl = off;
  off = (off + 4 * g.groups + 15) & ~15;
  s.gacc = off;          // [groups][pieces][pe]
  off += 4 * g.groups * g.pieces * pe;
  s.st = off;            // m, l, 2 unused, acc[pieces][pe]
  off += 16 + 4 * g.pieces * pe;
  s.total = off;
  return s;
}

// --- the pieces of a row ---

// A piece as read: 16 raw bytes on the ring, four widened elements on the
// element path (those past D zero).
template <typename T, bool kVec>
struct Piece {
  uint4 raw;
};

template <typename T>
struct Piece<T, false> {
  float x[4];
};

template <typename T>
__device__ __forceinline__ void widen16(const uint4& u, float* f);

template <>
__device__ __forceinline__ void widen16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(const uint4& u,
                                                       float* f) {
  const float4 a = widen<__nv_bfloat16>(make_uint2(u.x, u.y));
  const float4 b = widen<__nv_bfloat16>(make_uint2(u.z, u.w));
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

template <>
__device__ __forceinline__ void widen16<__half>(const uint4& u, float* f) {
  const float4 a = widen<__half>(make_uint2(u.x, u.y));
  const float4 b = widen<__half>(make_uint2(u.z, u.w));
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// The piece's elements as fp32.
template <typename T, bool kVec>
__device__ __forceinline__ void piece_floats(const Piece<T, kVec>& p,
                                             float (&f)[piece_elems<T, kVec>()]) {
  if constexpr (kVec) {
    widen16<T>(p.raw, f);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = p.x[e];
  }
}

// Elements [x * 4, x * 4 + 4) of a row at `row` in device memory, those
// at or past `d` zero.
template <typename T>
__device__ __forceinline__ Piece<T, false> load_elems(const T* row, int x,
                                                      int d) {
  Piece<T, false> p;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * x + e;
    p.x[e] = i < d ? to_float(__ldg(row + i)) : 0.f;
  }
  return p;
}

// Elements [x * n, x * n + n) of a row at `row` in device memory, as
// fp32 (16-byte aligned on the ring).
template <typename T, bool kVec>
__device__ __forceinline__ void load_row_floats(
    const T* row, int x, int d, float (&f)[piece_elems<T, kVec>()]) {
  if constexpr (kVec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row) + x);
    widen16<T>(u, f);
  } else {
    piece_floats<T, false>(load_elems<T>(row, x, d), f);
  }
}

// fp32 values stored at `row` + piece x in T (rounded to nearest even).
template <typename T, bool kVec>
__device__ __forceinline__ void store_row_floats(
    T* row, int x, int d, const float (&f)[piece_elems<T, kVec>()]) {
  constexpr int kE = piece_elems<T, kVec>();
  if constexpr (kVec && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(row + kE * x) =
        make_float4(f[0], f[1], f[2], f[3]);
  } else if constexpr (kVec) {
    uint4 u;
    u.x = pack2(from_float<T>(f[0]), from_float<T>(f[1]));
    u.y = pack2(from_float<T>(f[2]), from_float<T>(f[3]));
    u.z = pack2(from_float<T>(f[4]), from_float<T>(f[5]));
    u.w = pack2(from_float<T>(f[6]), from_float<T>(f[7]));
    *reinterpret_cast<uint4*>(row + kE * x) = u;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (4 * x + e < d) row[4 * x + e] = from_float<T>(f[e]);
    }
  }
}

// exp(x) in the online softmax's loop, as exp2 of x log2(e) (the
// training kernels' form: one MUFU.EX2 and a multiply)
__device__ __forceinline__ float softmax_exp(float x) {
  return exp2f(x * 1.4426950408889634f);
}

// --- asynchronous copies: 16-byte `cp.async`, and bulk copies on
// mbarriers (the paged kernel's ring) ---

// 16 bytes from device memory into shared memory, bypassing L1.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of copies to complete.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of `parity` to complete. A wait of more than ~2^34
// cycles (seconds) can only be a fault (a copy count that does not add
// up): it traps, which the host sees as a launch error, rather than hang
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// `bytes` (a multiple of 16) from device memory into this block's shared
// memory, both 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// --- the kernel ---

template <typename T>
struct Params {
  const T *q, *k, *v;      // q [bh, d]; k, v the cache or the pools
  const int* tables;       // paged: [bh / heads, max_blocks]
  const float* kb;         // key bias [bh / bias_heads, s_len] or null
  T* o;                    // [bh, d]
  int bh, heads, bias_heads, s_len, d, splits;
  int max_blocks, blk, pool_blocks;  // paged
  unsigned blk_m, blk_s;             // paged: j / blk as (umulhi(j, m) + j) >> s
  float scale;
};

// The multiplier and shift that divide by d (>= 1) any n < 2^31 as
// (umulhi(n, m) + n) >> s, s = ceil(log2(d)) (Granlund and Montgomery).
inline void divider(unsigned d, unsigned& m, unsigned& s) {
  s = 0;
  while ((1u << s) < d) ++s;
  m = (unsigned)(((1ull << 32) * ((1ull << s) - d)) / d + 1);
}

// Where a split's keys live. Contiguous: row bh of k/v, [bh, s_len, d];
// keys [lo, hi). Paged: the slot's pool blocks through its table,
// [pool_blocks, heads, blk, d]; logical blocks [lo / blk, hi / blk),
// whose clamped table entries `table` holds (from block lo / blk on).
template <bool kPaged>
struct Keys {
  int lo, hi;           // keys of the split
  size_t base;          // contiguous: first element of row bh
  const int* table;     // paged: the split's entries (shared memory)
  int b0, nb;           // paged: the split's first logical block, blocks
  int n, heads, blk, d;
  unsigned blk_m, blk_s;  // paged: the divider of blk

  // Paged: element offset of row r of logical block lb in k/v.
  __device__ __forceinline__ size_t block_offset(int lb, int r) const {
    return (((size_t)table[lb - b0] * heads + n) * blk + r) * (size_t)d;
  }

  // Element offset of key j's row in k/v.
  __device__ __forceinline__ size_t row_offset(int j) const {
    if constexpr (kPaged) {
      const int lb = (int)((__umulhi((unsigned)j, blk_m) + (unsigned)j) >> blk_s);
      return block_offset(lb, j - lb * blk);
    } else {
      return base + (size_t)j * d;
    }
  }
};

// The split's tiles: contiguous, `tile` keys each from lo; paged, whole
// pool blocks (as many as fit a tile) or, for a block longer than a tile,
// pieces of `tile` keys of one block, so that no tile crosses a block
// boundary in a way its copies cannot follow.
struct Tiles {
  int lo, hi, tile, blk;  // blk 0: contiguous
  int per;                // paged: blocks a tile (>= 1), or 0: pieces
  int subs;               // paged, pieces: tiles a block

  __device__ __forceinline__ int count() const {
    if (hi <= lo) return 0;
    if (blk == 0) return (hi - lo + tile - 1) / tile;
    const int nb = (hi - lo) / blk;
    return per > 0 ? (nb + per - 1) / per : nb * subs;
  }
  __device__ __forceinline__ int key0(int t) const {
    if (blk == 0) return lo + t * tile;
    if (per > 0) return lo + t * per * blk;
    return lo + (t / subs) * blk + (t % subs) * tile;
  }
  __device__ __forceinline__ int rows(int t) const {
    if (blk == 0) return min(tile, hi - key0(t));
    if (per > 0) return min(per * blk, hi - key0(t));
    return min(tile, blk - (t % subs) * tile);
  }
};

// R: the kernel's Ring (its stages and copies used on the ring only).
template <typename T, bool kPaged, int kD, int kP, bool kVec, class R>
__device__ __forceinline__ void decode_split(const Params<T>& a) {
  constexpr int kE = piece_elems<T, kVec>();
  constexpr int kThreads = R::kThreads;
  constexpr int kR = R::kRowsPerGroup;
  constexpr int kStages = R::kStages;
  constexpr bool kBulk = kVec && R::kBulk;
  extern __shared__ __align__(128) unsigned char smem[];

  const int d = kD > 0 ? kD : a.d;
  const Geometry geo = geometry<T, kVec, kP, R>(d);
  const int lanes = geo.lanes;
  const int groups = geo.groups;
  const int chunks = geo.chunks;
  const int tile = geo.tile;
  const int tid = threadIdx.x;
  const int g = tid / lanes;
  const int ln = tid - g * lanes;
  const int splits = a.splits;
  const int split = blockIdx.x % splits;   // the block's cluster rank
  const int bh = blockIdx.x / splits;

  // the split's keys and their tiles
  Keys<kPaged> keys{};
  Tiles tiles{};
  int table_entries = 0;
  if constexpr (kPaged) {
    const int blk = a.blk;   // pool block size
    const int per = (a.max_blocks + splits - 1) / splits;
    const int b0 = min(split * per, a.max_blocks);
    const int b1 = min(b0 + per, a.max_blocks);
    table_entries = per;
    keys.lo = b0 * blk;
    keys.hi = b1 * blk;
    keys.b0 = b0;
    keys.nb = b1 - b0;
    keys.n = bh % a.heads;
    keys.heads = a.heads;
    keys.blk = blk;
    keys.blk_m = a.blk_m;
    keys.blk_s = a.blk_s;
    tiles.blk = blk;
    tiles.per = blk <= tile ? tile / blk : 0;
    tiles.subs = (blk + tile - 1) / tile;
  } else {
    const int per = (a.s_len + splits - 1) / splits;
    keys.lo = min(split * per, a.s_len);
    keys.hi = min(keys.lo + per, a.s_len);
    keys.base = (size_t)bh * a.s_len * d;
    tiles.blk = 0;
    tiles.per = 0;
    tiles.subs = 1;
  }
  keys.d = d;
  tiles.lo = keys.lo;
  tiles.hi = keys.hi;
  tiles.tile = tile;
  const int ntiles = tiles.count();
  const SmemLayout sm =
      smem_layout(geo, kE, kVec ? kStages : 0, kBulk, table_entries);
  const float* kbp =
      a.kb ? a.kb + (size_t)(bh / a.bias_heads) * a.s_len : nullptr;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + sm.bars);

  if constexpr (kPaged) {
    int* table = reinterpret_cast<int*>(smem + sm.table);
    const int* trow = a.tables + (size_t)(bh / a.heads) * a.max_blocks;
    for (int i = tid; i < keys.nb; i += kThreads) {
      table[i] = min(max(__ldg(trow + keys.b0 + i), 0), a.pool_blocks - 1);
    }
    keys.table = table;
  }
  if constexpr (kBulk) {
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < kStages; ++s) mbar_init(bars + s, 1);
      mbar_fence_init();
    }
  }
  if constexpr (kPaged || kBulk) __syncthreads();

  // Tile t into its stage (ring only): the bias by 4-byte copies, K and V
  // by 16-byte copies from every thread or, kBulk, one bulk copy per
  // contiguous run from warp 0.
  auto issue = [&](int t) {
    if (t >= ntiles) return;
    const int s = t % kStages;
    unsigned char* ks = smem + sm.ring + s * sm.stage;
    unsigned char* vs = ks + tile * geo.row_bytes;
    float* bs = reinterpret_cast<float*>(vs + tile * geo.row_bytes);
    const int j0 = tiles.key0(t);
    const int rows = tiles.rows(t);
    if (kbp) {
      for (int r = tid; r < rows; r += kThreads) cp_async4(bs + r, kbp + j0 + r, true);
    }
    if constexpr (kBulk) {
      // warp 0 moves the tile's runs, one a lane: the whole tile
      // (contiguous), one pool block each (paged, `per` blocks a tile), or
      // a piece of one (paged, blocks longer than a tile); lane 0 first
      // tells the stage's barrier how many bytes to expect
      if (tid < 32) {
        if (tid == 0) mbar_expect_tx(bars + s, 2u * rows * geo.row_bytes);
        __syncwarp();
        int runs = 1, run = rows, lb = 0, r0 = 0;
        if constexpr (kPaged) {
          if (tiles.per > 0) {
            runs = min(tiles.per, keys.nb - t * tiles.per);
            run = keys.blk;
            lb = keys.b0 + t * tiles.per;
          } else {
            lb = keys.b0 + t / tiles.subs;
            r0 = (t % tiles.subs) * tile;
          }
        }
        for (int i = tid; i < runs; i += 32) {
          size_t off;
          if constexpr (kPaged) {
            off = keys.block_offset(lb + i, r0);
          } else {
            off = keys.row_offset(j0);
          }
          const unsigned bytes = (unsigned)(run * geo.row_bytes);
          const int r = i * run;
          bulk_copy(ks + r * geo.row_bytes, a.k + off, bytes, bars + s);
          bulk_copy(vs + r * geo.row_bytes, a.v + off, bytes, bars + s);
        }
      }
    } else {
      for (int c = tid; c < rows * chunks; c += kThreads) {
        const int r = c / chunks;
        const int x = c - r * chunks;
        const size_t off = keys.row_offset(j0 + r) + (size_t)x * kE;
        copy16(ks + r * geo.row_bytes + 16 * x, a.k + off);
        copy16(vs + r * geo.row_bytes + 16 * x, a.v + off);
      }
    }
  };

  if constexpr (kVec) {
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      issue(t);
      cp_async_commit();
    }
  }

  float qv[kP][kE];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int x = p * lanes + ln;
#pragma unroll
    for (int e = 0; e < kE; ++e) qv[p][e] = 0.f;
    if (x < chunks) load_row_floats<T, kVec>(a.q + (size_t)bh * d, x, d, qv[p]);
  }

  float m = kNeg;
  float l = 0.f;
  float acc[kP][kE];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[p][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    const unsigned char* ks = smem + sm.ring + s * sm.stage;
    const unsigned char* vs = ks + tile * geo.row_bytes;
    const float* bs = reinterpret_cast<const float*>(vs + tile * geo.row_bytes);
    if constexpr (kVec) {
      cp_async_wait<kStages - 2>();          // this thread's copies of tile t
      if constexpr (kBulk) mbar_wait(bars + s, (unsigned)(t / kStages) & 1u);
      __syncthreads();                       // everyone's; tile t - 1 read
      issue(t + kStages - 1);                // into tile t - 1's stage
      cp_async_commit();
    }
    const int j0 = tiles.key0(t);
    const int rows = tiles.rows(t);

    // the group's kR rows: i * groups + g
    Piece<T, kVec> kk[kR][kP];
    bool ok[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = i * groups + g;
      ok[i] = r < rows;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int x = p * lanes + ln;
        kk[i][p] = Piece<T, kVec>{};
        if constexpr (kVec) {
          if (x < chunks) {
            kk[i][p].raw = *reinterpret_cast<const uint4*>(
                ks + r * geo.row_bytes + 16 * x);
          }
        } else {
          if (ok[i] && x < chunks) {
            kk[i][p] = load_elems<T>(a.k + keys.row_offset(j0 + r), x, d);
          }
        }
      }
    }
    float sc[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float part = 0.f;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        float kf[kE];
        piece_floats<T, kVec>(kk[i][p], kf);
#pragma unroll
        for (int e = 0; e < kE; ++e) part += qv[p][e] * kf[e];
      }
      sc[i] = part;
    }
    // each group's sums over its lanes (all 32 lanes take part)
    for (int off = lanes / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        sc[i] += __shfl_xor_sync(0xffffffffu, sc[i], off);
      }
    }
    float mx = m;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = i * groups + g;
      float b = 0.f;
      if (kbp && ok[i]) b = kVec ? bs[r] : __ldg(kbp + j0 + r);
      sc[i] = ok[i] ? sc[i] * a.scale + b : kNeg;
      mx = fmaxf(mx, sc[i]);
    }
    const float alpha = softmax_exp(m - mx);
    float ps[kR];
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      ps[i] = ok[i] ? softmax_exp(sc[i] - mx) : 0.f;
      psum += ps[i];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[p][e] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      if (!ok[i]) continue;
      const int r = i * groups + g;
      // p rounds to the value type for the P.V product (the identity in
      // fp32)
      const float pr = round_to<T>(ps[i]);
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int x = p * lanes + ln;
        if (x >= chunks) continue;
        float vf[kE];
        if constexpr (kVec) {
          widen16<T>(*reinterpret_cast<const uint4*>(vs + r * geo.row_bytes +
                                                      16 * x),
                     vf);
        } else {
          load_row_floats<T, false>(a.v + keys.row_offset(j0 + r), x, d, vf);
        }
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[p][e] += pr * vf[e];
      }
    }
    m = mx;
  }

  // the groups' states, merged in group order by one thread a piece
  float* gm = reinterpret_cast<float*>(smem + sm.gm);
  float* gl = reinterpret_cast<float*>(smem + sm.gl);
  float* gacc = reinterpret_cast<float*>(smem + sm.gacc);
  float* st = reinterpret_cast<float*>(smem + sm.st);
  const int pieces = geo.pieces;
  if (ln == 0) {
    gm[g] = m;
    gl[g] = l;
  }
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int x = p * lanes + ln;
#pragma unroll
    for (int e = 0; e < kE; ++e) gacc[(g * pieces + x) * kE + e] = acc[p][e];
  }
  __syncthreads();
  const int x = tid;                   // the merging thread's piece
  float out[kE];
  float m_all = kNeg;
  float l_all = 0.f;
  if (x < pieces) {
    for (int i = 0; i < groups; ++i) m_all = fmaxf(m_all, gm[i]);
#pragma unroll
    for (int e = 0; e < kE; ++e) out[e] = 0.f;
    for (int i = 0; i < groups; ++i) {
      const float w = expf(gm[i] - m_all);
      l_all += gl[i] * w;
#pragma unroll
      for (int e = 0; e < kE; ++e) out[e] += gacc[(i * pieces + x) * kE + e] * w;
    }
  }
  T* orow = a.o + (size_t)bh * d;
  if (splits == 1) {
    if (x < chunks) {
      const float inv = 1.f / fmaxf(l_all, 1e-30f);
      float f[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) f[e] = out[e] * inv;
      store_row_floats<T, kVec>(orow, x, d, f);
    }
    return;
  }

  // the cluster's states, merged in rank order by rank 0
  if (x < pieces) {
#pragma unroll
    for (int e = 0; e < kE; ++e) st[4 + x * kE + e] = out[e];
    if (x == 0) {
      st[0] = m_all;
      st[1] = l_all;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0 && x < chunks) {
    // unrolled to the largest cluster, so that the arrays stay in
    // registers
    const float* rs[kMaxSplits];
    float mr[kMaxSplits];
    float mc = kNeg;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) {
        rs[r] = cluster.map_shared_rank(st, r);
        mr[r] = rs[r][0];
        mc = fmaxf(mc, mr[r]);
      }
    }
    float lc = 0.f;
    float f[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) f[e] = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) {
        const float w = expf(mr[r] - mc);
        lc += rs[r][1] * w;
#pragma unroll
        for (int e = 0; e < kE; ++e) f[e] += rs[r][4 + x * kE + e] * w;
      }
    }
    const float inv = 1.f / fmaxf(lc, 1e-30f);
#pragma unroll
    for (int e = 0; e < kE; ++e) f[e] *= inv;
    store_row_floats<T, kVec>(orow, x, d, f);
  }
  cluster.sync();  // the other ranks' shared memory stays until read
}

// --- the host side ---

// A kernel whose dynamic shared memory may pass 48 KB says so on each
// device, for the most it has asked there (`set`, the kernel's own).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int (&set)[32]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && set[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 32) set[dev] = bytes;
  return err;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Launch `kernel` (one instantiation of a decode kernel) over bh * splits
// blocks, the splits of a row one cluster.
template <typename T, bool kPaged, int kP, bool kVec, class R,
          typename Kernel>
cudaError_t launch(Kernel kernel, const Params<T>& a, int (&set)[32],
                   cudaStream_t stream) {
  const Geometry geo = geometry<T, kVec, kP, R>(a.d);
  const int table = kPaged ? (a.max_blocks + a.splits - 1) / a.splits : 0;
  const SmemLayout sm =
      smem_layout(geo, piece_elems<T, kVec>(), kVec ? R::kStages : 0,
                  kVec && R::kBulk, table);
  cudaError_t err = allow_smem(kernel, sm.total, set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.bh * a.splits));
  cfg.blockDim = dim3(R::kThreads);
  cfg.dynamicSmemBytes = (size_t)sm.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The ring takes rows of whole 16-byte pieces from 16-byte aligned
// operands; anything else runs the element path.
template <typename T>
bool ring_form(const Params<T>& a) {
  return (a.d * (int)sizeof(T)) % 16 == 0 && aligned16(a.q) &&
         aligned16(a.k) && aligned16(a.v) && aligned16(a.o);
}

}  // namespace decode
}  // namespace flash
