// Tensor-core pieces shared by the flash training kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu) in all their forms: their block of
// 4 warps, warp-level `mma.sync` with fp32 accumulators (m16n8k16 on
// bf16/fp16 operands, m16n8k8 on TF32 ones), `ldmatrix` fragment loads
// from shared memory, `cp.async` copies from device memory, the swizzled
// tile layouts they read, and the opt-in to more than 48 KB of shared
// memory.
//
// Fragments of one m16n8k16 product (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), for lane l of the warp, g = l / 4 and t = l % 4:
//   A (16 x 16, row-major), 4 registers of two 16-bit elements each:
//     a0 = A[g][2t, 2t+1]       a1 = A[g+8][2t, 2t+1]
//     a2 = A[g][2t+8, 2t+9]     a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, "col": B[k][n] with k contiguous for a fixed n):
//     b0 = B[2t, 2t+1][g]       b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8, fp32): c0, c1 = C[g][2t, 2t+1]; c2, c3 = C[g+8][2t, 2t+1]
// The lower-indexed element of a pair sits in the low half of its
// register. An accumulator pair (c0, c1) of two neighbouring n-tiles is
// therefore an A fragment of the next product as it is (after rounding to
// 16 bits): P or dS never leaves the registers.
//
// Fragments of one m16n8k8 TF32 product ("Matrix fragments for
// mma.m16n8k8", .tf32), one 32-bit element a register:
//   A (16 x 8, row-major): a0 = A[g][t], a1 = A[g+8][t],
//                          a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8, "col"):      b0 = B[t][g], b1 = B[t+4][g]
//   C, D (16 x 8, fp32):   as m16n8k16.
// Here an accumulator pair (c0, c1) holds columns 2t and 2t+1, where A
// wants t and t+4: the fp32 forward reads P.V's k index t as key 2t and
// t+4 as key 2t+1, and loads V's rows in that order, so P still never
// leaves the registers. The tensor cores read only the 19 high bits of a
// TF32 element. An fp32 value x is held as big = tf32(x) and small =
// tf32(x - big), each rounded to nearest (ties away); a product of two
// such pairs as a_small b_big + a_big b_small + a_big b_big ("3xTF32",
// small terms first) drops a_small b_small, ~2^-22 of the product, and
// keeps fp32's accuracy at the tensor cores' TF32 rate, as long as each
// k-step's three products are summed apart from the running sum
// (`mma_3xtf32`).
//
// Tiles of 16-bit elements in shared memory are [rows][D], rows of D/8
// 16-byte chunks. `ldmatrix` reads eight rows at one chunk column at a
// time; a plain layout puts those eight 16-byte pieces in the same four
// banks whenever a row is a multiple of 128 bytes. `swz` XORs the chunk
// index with the row (row & 7 for D >= 64; (row >> 1) & 3 for D = 32,
// whose 64-byte rows pair up in a 128-byte line), so the eight rows of
// one read, and the 16-byte `cp.async` writes of one row, fall in eight
// different bank groups.
//
// fp32 tiles are [rows][D] of 4-byte elements, D a multiple of 32 (every
// row starts at bank 0), read one element a lane with plain loads.
// `swz_rows` XORs column bits 2-4 with row & 7: an A fragment or a "col"
// B fragment (8 rows g by 4 columns t) then touches 32 different banks.
// `swz_pairs` XORs column bits 3-4 with (row >> 1) & 3 for P.V's V: rows
// 2t or 2t+1 by 8 columns g, 32 banks again. Both keep each 4-element
// (16-byte) `cp.async` piece contiguous.
//
// The fp32 backward kernels read every streamed tile in two roles: as the
// B operand of a product over D (Q.K^T: k = column, n = row) and of one
// over the tile's rows (dS.K: k = row, n = column). Both read 8-byte
// pairs. Over D, the k-step at columns c0 .. c0 + 7 takes column c0 + 2t
// at k index t and c0 + 2t + 1 at t + 4 in both operands (the order of a
// sum's terms is free), so a lane's (t, t + 4) is one 8-byte load; over
// the rows, k index t is row 2t and t + 4 row 2t + 1 (the accumulators'
// own order, as in the forward's P.V), and two neighbouring n-tiles take
// the even and odd columns c0 + 2g, c0 + 2g + 1, so one 8-byte load feeds
// both. `swz_tf32` XORs column bits 3-4 with f(row & 7) = (r1, r0 ^ r2),
// which is one to one on rows 0-3 and 4-7 (the first read: 4 rows by 4
// pairs in each half-warp's phase) and on rows 0, 2, 4, 6 and 1, 3, 5, 7
// (the second: rows 2t + h by 4 pairs): both reads, and the 16-byte
// `cp.async` writes, meet no bank conflict, and one layout serves both
// roles. Each tile is split once into TF32 big parts, kept in place, and
// small parts at the same offsets of a second buffer.

#pragma once

#include "flash_common.cuh"

namespace flash {
namespace mma {

// A block of the tensor-core kernels: 4 warps, each owning 16 rows of
// `mma` tiles.
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2(e))

// Element offset of (row, col) in a swizzled [rows][D] tile; `col` may
// be any column: its chunk is permuted, its place in the chunk kept.
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  static_assert(D == 32 || D % 64 == 0, "tile width: 32 or a multiple of 64");
  int chunk = col >> 3;
  if constexpr (D >= 64) {
    chunk ^= row & 7;
  } else {
    chunk ^= (row >> 1) & 3;
  }
  return row * D + (chunk << 3) + (col & 7);
}

// Element offsets of (row, col) in the fp32 tiles (see above).
template <int D>
__device__ __forceinline__ int swz_rows(int row, int col) {
  static_assert(D % 32 == 0, "fp32 tile width: a multiple of 32");
  return row * D + (col ^ ((row & 7) << 2));
}

template <int D>
__device__ __forceinline__ int swz_pairs(int row, int col) {
  static_assert(D % 32 == 0, "fp32 tile width: a multiple of 32");
  return row * D + (col ^ (((row >> 1) & 3) << 3));
}

template <int D>
__device__ __forceinline__ int swz_tf32(int row, int col) {
  static_assert(D % 32 == 0, "fp32 tile width: a multiple of 32");
  const int f = (row & 2) | ((row ^ (row >> 2)) & 1);
  return row * D + (col ^ (f << 3));
}

// The fp32 tile layouts, for `load_tile_f32`.
enum class F32Layout { kRows, kPairs, kTf32 };

template <int D, F32Layout L>
__device__ __forceinline__ int swz_f32(int row, int col) {
  if constexpr (L == F32Layout::kRows) {
    return swz_rows<D>(row, col);
  } else if constexpr (L == F32Layout::kPairs) {
    return swz_pairs<D>(row, col);
  } else {
    return swz_tf32<D>(row, col);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, bypassing L1; when
// `valid` is false nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, zeroed when `valid` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 matrices of 16-bit elements: lane l gives the address of row
// l % 8 of matrix l / 8 (16 bytes); register i receives row l / 4,
// elements 2 (l % 4) and 2 (l % 4) + 1, of matrix i.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, transposed: register i receives rows 2 (l % 4) and
// 2 (l % 4) + 1, element l / 4, of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b on the tensor cores, fp32 accumulation.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4],
                                                 const unsigned (&a)[4],
                                                 unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to nearest even in T, `lo` in the low half:
// the `round_to<T>` of flash_common.cuh, packed for a fragment.
template <typename T>
__device__ __forceinline__ unsigned pack_round(float lo, float hi);

template <>
__device__ __forceinline__ unsigned pack_round<__nv_bfloat16>(float lo,
                                                              float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

template <>
__device__ __forceinline__ unsigned pack_round<__half>(float lo, float hi) {
  return pack2(__float2half_rn(lo), __float2half_rn(hi));
}

// x rounded to TF32 (to nearest, ties away), as the tensor cores read it.
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as big + small, both TF32 (see above).
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a * b on the tensor cores, TF32 operands, fp32 accumulation.
__device__ __forceinline__ void mma1688_tf32(float (&d)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in split TF32: a = (ab, as), b = ((b0b, b1b), (b0s, b1s)).
// The tensor cores add a product's terms aligned to the largest of them
// and cut, not rounded, to 24 bits, so adding small products straight
// into a large running sum biases it toward zero, step after step. The
// three products are summed from zero here, where no addend is much
// larger than the others, and that sum is added to d on the CUDA cores,
// rounded to nearest.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const unsigned (&ab)[4],
                                           const unsigned (&as)[4],
                                           unsigned b0b, unsigned b1b,
                                           unsigned b0s, unsigned b1s) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma1688_tf32(t, as, b0b, b1b);
  mma1688_tf32(t, ab, b0s, b1s);
  mma1688_tf32(t, ab, b0b, b1b);
  d[0] += t[0];
  d[1] += t[1];
  d[2] += t[2];
  d[3] += t[3];
}

// Four fp32 values at `big` split into TF32 big parts, stored back in
// place, and small parts, stored at `small`.
__device__ __forceinline__ void split4_tf32(float* big, float* small) {
  const float4 x = *reinterpret_cast<const float4*>(big);
  uint4 b;
  uint4 sm;
  split_tf32(x.x, b.x, sm.x);
  split_tf32(x.y, b.y, sm.y);
  split_tf32(x.z, b.z, sm.z);
  split_tf32(x.w, b.w, sm.w);
  *reinterpret_cast<uint4*>(big) = b;
  *reinterpret_cast<uint4*>(small) = sm;
}

// A [ROWS][D] fp32 tile split by the block's THREADS threads, big parts in
// place and small parts at the same offsets of `small`.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void split_tile_tf32(float* big, float* small,
                                                int tid) {
#pragma unroll
  for (int i = 4 * tid; i < ROWS * D; i += 4 * THREADS) {
    split4_tf32(big + i, small + i);
  }
}

// Fragments of split-TF32 products from `swz_tf32` tiles split into big
// parts (`tb`) and small parts (`ts`); g = lane / 4, t = lane % 4.
__device__ __forceinline__ uint2 lds2(const float* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// The A fragment of rows row0 .. row0 + 15 at the k-step over columns
// c0 .. c0 + 7 (k index t: column c0 + 2t, t + 4: c0 + 2t + 1).
template <int D>
__device__ __forceinline__ void frag_a_tf32(unsigned (&big)[4],
                                            unsigned (&small)[4],
                                            const float* tb, const float* ts,
                                            int row0, int c0, int g, int t4) {
  const int o0 = swz_tf32<D>(row0 + g, c0 + 2 * t4);
  const int o1 = swz_tf32<D>(row0 + g + 8, c0 + 2 * t4);
  const uint2 b0 = lds2(tb + o0);
  const uint2 b1 = lds2(tb + o1);
  const uint2 s0 = lds2(ts + o0);
  const uint2 s1 = lds2(ts + o1);
  big[0] = b0.x;
  big[1] = b1.x;
  big[2] = b0.y;
  big[3] = b1.y;
  small[0] = s0.x;
  small[1] = s1.x;
  small[2] = s0.y;
  small[3] = s1.y;
}

// The "col" B fragment whose n index is the tile's rows n0 .. n0 + 7, at
// the k-step over columns c0 .. c0 + 7 (as `frag_a_tf32`): (b0, b1) in
// (.x, .y) of `big` and `small`.
template <int D>
__device__ __forceinline__ void frag_b_tf32(uint2& big, uint2& small,
                                            const float* tb, const float* ts,
                                            int n0, int c0, int g, int t4) {
  const int o = swz_tf32<D>(n0 + g, c0 + 2 * t4);
  big = lds2(tb + o);
  small = lds2(ts + o);
}

// The B fragments of two n-tiles whose k index is the tile's rows
// k0 .. k0 + 7 (t: row k0 + 2t, t + 4: row k0 + 2t + 1) and whose n
// indices are the columns c0 + 2n (first n-tile) and c0 + 2n + 1
// (second): (b0, b1) of n-tile i in (.x, .y) of big[i] and small[i].
template <int D>
__device__ __forceinline__ void frag_b2_tf32(uint2* big, uint2* small,
                                             const float* tb, const float* ts,
                                             int k0, int c0, int g, int t4) {
  const int o0 = swz_tf32<D>(k0 + 2 * t4, c0 + 2 * g);
  const int o1 = swz_tf32<D>(k0 + 2 * t4 + 1, c0 + 2 * g);
  const uint2 lb = lds2(tb + o0);
  const uint2 ls = lds2(ts + o0);
  const uint2 hb = lds2(tb + o1);
  const uint2 hs = lds2(ts + o1);
  big[0] = make_uint2(lb.x, hb.x);
  big[1] = make_uint2(lb.y, hb.y);
  small[0] = make_uint2(ls.x, hs.x);
  small[1] = make_uint2(ls.y, hs.y);
}

// An n-tile's fp32 accumulators (rows g, g + 8; columns 2t, 2t + 1) as
// the split A fragment of the product over those columns: k index t is
// column 2t and t + 4 column 2t + 1, so a0 .. a3 = c0, c2, c1, c3.
__device__ __forceinline__ void acc_a_tf32(unsigned (&big)[4],
                                           unsigned (&small)[4],
                                           const float (&c)[4]) {
  split_tf32(c[0], big[0], small[0]);
  split_tf32(c[2], big[1], small[1]);
  split_tf32(c[1], big[2], small[2]);
  split_tf32(c[3], big[3], small[3]);
}

// `mma_3xtf32` for N n-tiles that share the A fragment: d[i] += a * b[i],
// b[i] = ((bb[i].x, bb[i].y), (bs[i].x, bs[i].y)), each n-tile's three
// products summed from zero and added on the CUDA cores, and run stage
// by stage across the n-tiles so that no product waits on the one before
// it.
template <int N>
__device__ __forceinline__ void mma_3xtf32_n(float (*d)[4],
                                             const unsigned (&ab)[4],
                                             const unsigned (&as)[4],
                                             const uint2* bb,
                                             const uint2* bs) {
  float t[N][4];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i][0] = t[i][1] = t[i][2] = t[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) mma1688_tf32(t[i], as, bb[i].x, bb[i].y);
#pragma unroll
  for (int i = 0; i < N; ++i) mma1688_tf32(t[i], ab, bs[i].x, bs[i].y);
#pragma unroll
  for (int i = 0; i < N; ++i) mma1688_tf32(t[i], ab, bb[i].x, bb[i].y);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] += t[i][e];
  }
}

// Rows [row0, row0 + ROWS) of a [n_rows, D] matrix in device memory into
// a swizzled [ROWS][D] tile, 16 bytes per copy spread over `threads`
// threads; rows at or past `n_rows` are zero-filled (and read nothing).
template <int D, int ROWS, int THREADS, typename T>
__device__ __forceinline__ void load_tile(T* tile, const T* src, int row0,
                                          int n_rows, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    const bool valid = row0 + r < n_rows;
    const T* p = src + (size_t)(valid ? row0 + r : 0) * D + c;
    cp_async16(tile + swz<D>(r, c), p, valid);
  }
}

// The fp32 form of `load_tile`: rows [row0, row0 + ROWS) of a [n_rows, D]
// fp32 matrix into a [ROWS][D] tile in layout L, 4 elements per copy;
// rows at or past `n_rows` zero-fill.
template <int D, int ROWS, int THREADS, F32Layout L>
__device__ __forceinline__ void load_tile_f32(float* tile, const float* src,
                                              int row0, int n_rows, int tid) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 4;
    const bool valid = row0 + r < n_rows;
    const float* p = src + (size_t)(valid ? row0 + r : 0) * D + c;
    cp_async16(tile + swz_f32<D, L>(r, c), p, valid);
  }
}

// A kernel whose dynamic shared memory may pass 48 KB must say so on each
// device it runs on, once: `done` (the kernel's own, bit i for device i)
// records where it has.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev) & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

}  // namespace mma
}  // namespace flash
