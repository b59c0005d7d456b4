// Flash-attention backward, dQ, fp32, bf16 and fp16, written by hand for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_dq_kernel`
// (paddle_tpu/kernels/flash_attention.py:207, launched by
// `_flash_bwd_core` at :771 behind `flash_attention_bwd_from_residuals`)
// for a key-only additive bias, the general additive bias [G, Sq, Sk],
// the causal flag and the hash dropout: the GPT train step's backward and
// that of `fluid.layers.flash_attention(bias=...)`.
//
//   p   = exp(s - lse)              s: the forward's masked scores
//   dp  = keep o (dO V^T) / (1 - rate)
//   ds  = p o (dp - delta)
//   dq  = scale * sum_kv ds K
//
// delta = rowsum(dO o O) (minus an lse cotangent) comes in from the
// wrapper, as the reference leaves it to XLA. Nothing here is stored
// between blocks: one block owns a (head, query tile) and sweeps the key
// tiles in a loop, which takes the place of the TPU's sequential kv loop;
// under `causal` it stops at the diagonal tile, as the forward does, and
// the key tiles past it are never loaded.
//
// Layout: q/dout/dq [BH, Sq, D], k/v [BH, Sk, D] in the element type T
// (fp32, bf16 or fp16; flash_common.cuh), lse/delta [BH, Sq], key_bias
// [BH / bias_heads, Sk] (null = none), bias [G, Sq, Sk] with head bh
// reading row (bh / bias_div) % bias_rows (null = none; see flash_fwd.cu),
// those four fp32; all contiguous. In bf16 and fp16, ds rounds to T
// before the ds.K product, as the reference's ds.astype(k.dtype), and dq
// is stored in T. The scores add the bias as the forward does, so
// p = exp(s - lse) is the forward's probability.
//
// Two kernels on the tensor cores, one per element type (flash_mma.cuh);
// dispatching by type is the design, not a fallback:
//
// fp32 (the fp32 train step): `flash_bwd_dq_tf32_kernel`, split TF32. Bound
// at the fp32 train shape [8, 12, 1024, 64], causal (50 M (query, key)
// pairs): two products over D (scores, dO V^T) and one over the keys (dq),
// 6D flops a pair, 19.4 GFLOP; at the 67 TFLOP/s of fp32 on the CUDA cores
// that is 0.29 ms, as three TF32 products at 495 TFLOP/s 0.12 ms, against
// ~126 MB of q, k, v, dO, dq, lse and delta at 3.35 TB/s (0.04 ms). Each
// fp32 operand is split into a TF32 big and small part and each product
// taken as three `mma.sync.m16n8k8` TF32 products (small*small dropped), as
// the fp32 forward does, for all three products: S = Q.K^T, dP = dO.V^T and
// dq += dS.K with ds in fp32, which the fp32 reference does not round. Each
// k-step's three products are summed from zero and added to the running sums
// on the CUDA cores: the tensor cores cut their sums, and dq sums over up to
// 1024 keys. They are run stage by stage across four n-tiles
// (`mma_3xtf32_n`), so that no product waits on the one before it. The rest
// is the bf16 kernel's design below, with fp32 tiles in one layout
// (`swz_tf32`): Q and dO come in once and are split once into big parts (in
// place) and small parts in shared memory; K/V tiles of 32 keys (16 at
// D = 128, 8 at D = 256, where two warps share 16 rows) stream in a
// two-stage `cp.async` ring and each is split once for the block. K is read
// in two roles, as the B operand of Q.K^T (k = column) and of dS.K (k = key
// row), each lane reading 8-byte pairs; the k index order of both products
// (flash_mma.cuh) makes one conflict-free layout serve both, and dS.K reads
// ds's accumulators as its A fragment as they are. dq is scaled and stored
// as 16-byte rows of four columns.
//
// bf16 and fp16 (the AMP train step): `flash_bwd_dq_mma_kernel`, on the
// tensor cores (flash_mma.cuh). Bound at the AMP train shape: the same
// 19.3 GFLOP at 989 TFLOP/s, 0.020 ms, against 63 MB at 3.35 TB/s; the
// exp and the dropout hash of every pair on the CUDA cores come next.
// FlashAttention-2's dq pass, beside flash_bwd_dkv.cu's tensor-core
// kernel:
//   - a block of 4 warps owns 64 query rows, 16 a warp (at D = 256 two
//     warps share 16 rows, each accumulating half of dq's columns, and
//     the block owns 32); Q and dO come in once by `cp.async` and stay as
//     `mma` A fragments (in shared memory past D = 64), with lse and
//     delta of the warp's rows in registers;
//   - K and V tiles of 64 keys (32 from D = 128 on) in a two-stage
//     `cp.async` ring, swizzled for `ldmatrix`; the next tile's copy runs
//     under the current tile's products; keys past Sk and rows past Sq
//     zero-fill, so a padded row runs on zeros and is not stored;
//   - S = Q.K^T and dP = dO.V^T by `mma.sync.m16n8k16`, K and V as "col"
//     B operands through `ldmatrix` as they are stored;
//   - in the accumulator layout (2 rows x 16 keys a thread): scale, key
//     bias, general bias and masks as the forward applies them; p as exp2
//     of the log2(e)-scaled difference against lse; the dropout hash on
//     the fragment's own absolute (row, col, bh); ds = p o (dp - delta) in
//     fp32;
//   - round_T(ds) repacked from the accumulators straight into A
//     fragments; dq += round_T(ds) K with K by `ldmatrix.trans`;
//   - under `causal` only tiles that cross the diagonal or a ragged end
//     are masked, and a warp whose rows all end before a tile skips it;
//   - dq scaled and stored in T at the end.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace flash;

using flash::mma::kLog2e;
using flash::mma::kMmaThreads;
using flash::mma::kMmaWarps;

// The split-TF32 kernel (fp32): 4 warps; kSplit warps share 16 query
// rows, each accumulating D / kSplit columns of dq.
template <int D>
__host__ __device__ constexpr int tf32_split() {
  return D > 128 ? 2 : 1;
}

template <int D>
__host__ __device__ constexpr int tf32_rows() {  // query rows a block owns
  return 16 * kMmaWarps / tf32_split<D>();
}

template <int D>
__host__ __device__ constexpr int tf32_bk() {  // key rows per K/V tile
  return D <= 64 ? 32 : D == 128 ? 16 : 8;
}

// Q and dO in big and small parts, two stages of K and V, and the small
// parts of one K and V tile, fp32
template <int D>
__host__ __device__ constexpr int tf32_smem_bytes() {
  return (4 * tf32_rows<D>() * D + 6 * tf32_bk<D>() * D) * 4;
}

template <int D, bool kDropout, bool kBias>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ kb,
                         const float* __restrict__ bias,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int bias_heads, int bias_div,
                         int bias_rows, int sq, int sk, float scale,
                         int causal, unsigned seed, unsigned thresh,
                         float inv_keep) {
  using namespace flash::mma;
  constexpr int kSplit = tf32_split<D>();
  constexpr int kRows = tf32_rows<D>();
  constexpr int BK = tf32_bk<D>();
  constexpr int kDS = D / kSplit;  // dq columns a warp accumulates
  constexpr int kKSteps = D / 8;   // k-steps of Q.K^T and dO.V^T
  constexpr int kNT = BK / 8;      // n-tiles of S and dP, k-steps of dS.K
  constexpr int kDP = kDS / 16;    // pairs of n-tiles of the warp's dq
  constexpr int kNC = 4;           // n-tiles of dq taken together
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kRows][D], swz_tf32
  float* qss = qs + kRows * D;                 // Q's small parts
  float* dos = qss + kRows * D;                // [kRows][D]
  float* doss = dos + kRows * D;               // dO's small parts
  float* ks = doss + kRows * D;                // [2][BK][D]
  float* vs = ks + 2 * BK * D;                 // [2][BK][D]
  float* kss = vs + 2 * BK * D;                // [BK][D], K's small parts
  float* vss = kss + BK * D;                   // [BK][D], V's small parts

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wrow = (warp / kSplit) * 16;   // the warp's first row
  const int dcol = (warp % kSplit) * kDS;  // its first dq column
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // the thread's two rows: accumulator elements 0, 1 and 2, 3
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  const unsigned head_s = head_seed(seed, (unsigned)bh);
  const unsigned row_h[2] = {row_hash((unsigned)rows[0]),
                             row_hash((unsigned)rows[1])};
  // rows past Sq run on zeroed Q and dO with lse = delta = 0 (their ds
  // is 0) and are not stored
  float lse_r[2];
  float dlt_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < sq;
    lse_r[r] = ok ? __ldg(lse + (size_t)bh * sq + rows[r]) : 0.f;
    dlt_r[r] = ok ? __ldg(delta + (size_t)bh * sq + rows[r]) : 0.f;
  }

  const float* kp = k + (size_t)bh * sk * D;
  const float* vp = v + (size_t)bh * sk * D;
  const float* kbp = kb ? kb + (size_t)(bh / bias_heads) * sk : nullptr;
  const float* brow[2] = {nullptr, nullptr};
  if (kBias) {
    const size_t base = (size_t)((bh / bias_div) % bias_rows) * sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      brow[r] = bias + (base + min(rows[r], sq - 1)) * sk;
    }
  }
  // key tiles starting past the block's last row are masked for every
  // row of the block: never loaded
  const int kend = causal ? min(sk, q0 + kRows) : sk;
  const int ntiles = (kend + BK - 1) / BK;

  constexpr F32Layout kL = F32Layout::kTf32;
  load_tile_f32<D, kRows, kMmaThreads, kL>(qs, q + (size_t)bh * sq * D, q0,
                                           sq, tid);
  load_tile_f32<D, kRows, kMmaThreads, kL>(dos, dout + (size_t)bh * sq * D,
                                           q0, sq, tid);
  load_tile_f32<D, BK, kMmaThreads, kL>(ks, kp, 0, sk, tid);
  load_tile_f32<D, BK, kMmaThreads, kL>(vs, vp, 0, sk, tid);
  cp_async_commit();

  float acc[2 * kDP][4];
#pragma unroll
  for (int j = 0; j < 2 * kDP; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    const float* kst = ks + (t & 1) * BK * D;
    const float* vst = vs + (t & 1) * BK * D;
    if (t + 1 < ntiles) {
      // the stage it fills was last read in iteration t - 1, which ended
      // in a barrier
      load_tile_f32<D, BK, kMmaThreads, kL>(ks + ((t + 1) & 1) * BK * D, kp,
                                            k0 + BK, sk, tid);
      load_tile_f32<D, BK, kMmaThreads, kL>(vs + ((t + 1) & 1) * BK * D, vp,
                                            k0 + BK, sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // every tile split once for the block: Q and dO on the first, K and V
    // on each (their small parts were last read before the last barrier)
    if (t == 0) {
      split_tile_tf32<D, kRows, kMmaThreads>(qs, qss, tid);
      split_tile_tf32<D, kRows, kMmaThreads>(dos, doss, tid);
    }
    split_tile_tf32<D, BK, kMmaThreads>(ks + (t & 1) * BK * D, kss, tid);
    split_tile_tf32<D, BK, kMmaThreads>(vs + (t & 1) * BK * D, vss, tid);
    __syncthreads();
    // a warp whose rows all end before the tile's first key (causal) has
    // p = 0 on the whole tile
    if (!causal || k0 <= q0 + wrow + 15) {
      // the key bias of the thread's keys, loaded ahead of the products
      // that hide its latency
      float kbv[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = k0 + 8 * j + 2 * t4 + h;
          kbv[j][h] = kbp && col < sk ? __ldg(kbp + col) : 0.f;
        }
      }

      // S = Q K^T and dP = dO V^T in split TF32
      float s[kNT][4];
      float dp[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        unsigned qb[4], qsm[4], gb[4], gsm[4];
        frag_a_tf32<D>(qb, qsm, qs, qss, wrow, 8 * kk, g, t4);
        frag_a_tf32<D>(gb, gsm, dos, doss, wrow, 8 * kk, g, t4);
        uint2 kb2[kNT], ks2[kNT], vb2[kNT], vs2[kNT];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          frag_b_tf32<D>(kb2[j], ks2[j], kst, kss, 8 * j, 8 * kk, g, t4);
          frag_b_tf32<D>(vb2[j], vs2[j], vst, vss, 8 * j, 8 * kk, g, t4);
        }
        mma_3xtf32_n<kNT>(s, qb, qsm, kb2, ks2);
        mma_3xtf32_n<kNT>(dp, gb, gsm, vb2, vs2);
      }

      // p, ds in the accumulator layout: s[j][e] is row rows[e / 2], key
      // k0 + 8j + 2 t4 + e % 2; s takes ds
      const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > q0 + wrow);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = k0 + 8 * j + 2 * t4 + (e & 1);
          float x = s[j][e] * scale + kbv[j][e & 1];
          if (kBias && (!edge || col < sk)) x += __ldg(brow[r] + col);
          if (edge && (col >= sk || (causal && col > rows[r]))) x = kNeg;
          // exp as exp2 of the log2(e)-scaled difference, as the forward
          const float p = exp2f((x - lse_r[r]) * kLog2e);
          float d = dp[j][e];
          if (kDropout) {
            d = hash_keep(row_h[r], (unsigned)col, head_s, thresh)
                    ? d * inv_keep
                    : 0.f;
          }
          s[j][e] = p * (d - dlt_r[r]);
        }
      }

      // dq += dS K in split TF32, ds in fp32 as the fp32 reference keeps
      // it: the k-step over keys k0 + 8j .. + 7 takes ds's accumulators
      // as its A fragment, K's rows as its k index and K's even and odd
      // columns as the n-tiles 2m and 2m + 1
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        unsigned ab[4], as[4];
        acc_a_tf32(ab, as, s[j]);
#pragma unroll
        for (int c = 0; c < 2 * kDP; c += kNC) {
          uint2 bb[kNC], bs[kNC];
#pragma unroll
          for (int m = 0; m < kNC / 2; ++m) {
            frag_b2_tf32<D>(bb + 2 * m, bs + 2 * m, kst, kss, 8 * j,
                            dcol + 8 * c + 16 * m, g, t4);
          }
          mma_3xtf32_n<kNC>(acc + c, ab, as, bb, bs);
        }
      }
    }
    __syncthreads();  // this stage is consumed
  }

  // n-tile 2m + e holds columns dcol + 16m + 2n + e: the thread's four
  // columns from dcol + 16m + 4 t4 on are (2m, c0), (2m + 1, c0),
  // (2m, c1), (2m + 1, c1) of a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    float* op = dq + ((size_t)bh * sq + rows[r]) * D + dcol + 4 * t4;
#pragma unroll
    for (int m = 0; m < kDP; ++m) {
      *reinterpret_cast<float4*>(op + 16 * m) = make_float4(
          acc[2 * m][2 * r] * scale, acc[2 * m + 1][2 * r] * scale,
          acc[2 * m][2 * r + 1] * scale, acc[2 * m + 1][2 * r + 1] * scale);
    }
  }
}

// The tensor-core kernel (bf16, fp16): 4 warps; kSplit warps share 16
// query rows, each accumulating D / kSplit columns of dq.

template <int D>
__host__ __device__ constexpr int mma_split() {
  return D > 128 ? 2 : 1;
}

template <int D>
__host__ __device__ constexpr int mma_rows() {  // query rows a block owns
  return 16 * kMmaWarps / mma_split<D>();
}

template <int D>
__host__ __device__ constexpr int mma_bk() {  // key rows per K/V tile
  return D <= 64 ? 64 : 32;
}

// Q and dO, two stages of K and V
template <int D>
__host__ __device__ constexpr int mma_smem_bytes() {
  return (2 * mma_rows<D>() * D + 4 * mma_bk<D>() * D) * 2;
}

template <typename T, int D, bool kDropout, bool kBias>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ kb,
                        const float* __restrict__ bias,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int bias_heads, int bias_div, int bias_rows, int sq,
                        int sk, float scale, int causal, unsigned seed,
                        unsigned thresh, float inv_keep) {
  using namespace flash::mma;
  constexpr int kSplit = mma_split<D>();
  constexpr int kRows = mma_rows<D>();
  constexpr int BK = mma_bk<D>();
  constexpr int kDS = D / kSplit;  // dq columns a warp accumulates
  constexpr int kKSteps = D / 16;  // k-steps of Q.K^T and dO.V^T
  constexpr int kNT = BK / 8;      // n-tiles of S and dP (8 keys each)
  constexpr int kDT = kDS / 8;     // n-tiles of the warp's dq
  constexpr bool kQRegs = D <= 64;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [kRows][D]
  T* dos = qs + kRows * D;             // [kRows][D]
  T* ks = dos + kRows * D;             // [2][BK][D]
  T* vs = ks + 2 * BK * D;             // [2][BK][D]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wrow = (warp / kSplit) * 16;  // the warp's first row
  const int dcol = (warp % kSplit) * kDS;  // its first dq column
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // the thread's two rows: accumulator elements 0, 1 and 2, 3
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  const unsigned head_s = head_seed(seed, (unsigned)bh);
  const unsigned row_h[2] = {row_hash((unsigned)rows[0]),
                             row_hash((unsigned)rows[1])};
  // rows past Sq run on zeroed Q and dO with lse = delta = 0 (their ds
  // is 0) and are not stored
  float lse_r[2];
  float dlt_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < sq;
    lse_r[r] = ok ? __ldg(lse + (size_t)bh * sq + rows[r]) : 0.f;
    dlt_r[r] = ok ? __ldg(delta + (size_t)bh * sq + rows[r]) : 0.f;
  }

  const T* kp = k + (size_t)bh * sk * D;
  const T* vp = v + (size_t)bh * sk * D;
  const float* kbp = kb ? kb + (size_t)(bh / bias_heads) * sk : nullptr;
  const float* brow[2] = {nullptr, nullptr};
  if (kBias) {
    const size_t base = (size_t)((bh / bias_div) % bias_rows) * sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      brow[r] = bias + (base + min(rows[r], sq - 1)) * sk;
    }
  }
  // key tiles starting past the block's last row are masked for every
  // row of the block: never loaded
  const int kend = causal ? min(sk, q0 + kRows) : sk;
  const int ntiles = (kend + BK - 1) / BK;

  load_tile<D, kRows, kMmaThreads>(qs, q + (size_t)bh * sq * D, q0, sq, tid);
  load_tile<D, kRows, kMmaThreads>(dos, dout + (size_t)bh * sq * D, q0, sq,
                                   tid);
  load_tile<D, BK, kMmaThreads>(ks, kp, 0, sk, tid);
  load_tile<D, BK, kMmaThreads>(vs, vp, 0, sk, tid);
  cp_async_commit();

  unsigned qf[kQRegs ? kKSteps : 1][4];
  unsigned gf[kQRegs ? kKSteps : 1][4];
  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    const T* kst = ks + (t & 1) * BK * D;
    const T* vst = vs + (t & 1) * BK * D;
    if (t + 1 < ntiles) {
      // the stage it fills was last read in iteration t - 1, which ended
      // in a barrier
      load_tile<D, BK, kMmaThreads>(ks + ((t + 1) & 1) * BK * D, kp, k0 + BK,
                                    sk, tid);
      load_tile<D, BK, kMmaThreads>(vs + ((t + 1) & 1) * BK * D, vp, k0 + BK,
                                    sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kQRegs && t == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQRegs ? kKSteps : 0); ++kk) {
        const int off = swz<D>(wrow + (lane & 15), kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(qf[kk], qs + off);
        ldmatrix_x4(gf[kk], dos + off);
      }
    }
    // a warp whose rows all end before the tile's first key (causal) has
    // p = 0 on the whole tile
    if (!causal || k0 <= q0 + wrow + 15) {
      // the key bias of the thread's 16 keys, loaded ahead of the
      // products that hide its latency
      float kbv[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = k0 + 8 * j + 2 * t4 + h;
          kbv[j][h] = kbp && col < sk ? __ldg(kbp + col) : 0.f;
        }
      }

      // S = Q K^T and dP = dO V^T
      float s[kNT][4];
      float dp[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        unsigned aq[4];
        unsigned ag[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            aq[i] = qf[kk][i];
            ag[i] = gf[kk][i];
          }
        } else {
          const int off =
              swz<D>(wrow + (lane & 15), kk * 16 + (lane >> 4) * 8);
          ldmatrix_x4(aq, qs + off);
          ldmatrix_x4(ag, dos + off);
        }
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp) {
          const int off = swz<D>(jp * 16 + (lane & 7) + (lane >> 4) * 8,
                                 kk * 16 + ((lane >> 3) & 1) * 8);
          unsigned b[4];
          ldmatrix_x4(b, kst + off);
          mma16816<T>(s[2 * jp], aq, b[0], b[1]);
          mma16816<T>(s[2 * jp + 1], aq, b[2], b[3]);
          ldmatrix_x4(b, vst + off);
          mma16816<T>(dp[2 * jp], ag, b[0], b[1]);
          mma16816<T>(dp[2 * jp + 1], ag, b[2], b[3]);
        }
      }

      // p, ds in the accumulator layout: s[j][e] is row rows[e / 2], key
      // k0 + 8j + 2 t4 + e % 2; s takes ds
      const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > q0 + wrow);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int col = k0 + 8 * j + 2 * t4 + (e & 1);
          float x = s[j][e] * scale + kbv[j][e & 1];
          if (kBias && (!edge || col < sk)) x += __ldg(brow[r] + col);
          if (edge && (col >= sk || (causal && col > rows[r]))) x = kNeg;
          // exp as exp2 of the log2(e)-scaled difference, as the forward
          const float p = exp2f((x - lse_r[r]) * kLog2e);
          float d = dp[j][e];
          if (kDropout) {
            d = hash_keep(row_h[r], (unsigned)col, head_s, thresh)
                    ? d * inv_keep
                    : 0.f;
          }
          s[j][e] = p * (d - dlt_r[r]);
        }
      }

      // dq += round_T(ds) K, ds rounded as the reference's
      // ds.astype(k.dtype)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const unsigned a[4] = {
            pack_round<T>(s[2 * kk][0], s[2 * kk][1]),
            pack_round<T>(s[2 * kk][2], s[2 * kk][3]),
            pack_round<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_round<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int jp = 0; jp < kDT / 2; ++jp) {
          unsigned b[4];
          ldmatrix_x4_trans(
              b, kst + swz<D>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                              dcol + jp * 16 + (lane >> 4) * 8));
          mma16816<T>(acc[2 * jp], a, b[0], b[1]);
          mma16816<T>(acc[2 * jp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= sq) continue;
    T* op = dq + ((size_t)bh * sq + rows[r]) * D + dcol + 2 * t4;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      *reinterpret_cast<unsigned*>(op + 8 * j) =
          pack_round<T>(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
    }
  }
}

template <typename T>
struct Args {
  const T *q, *k, *v;
  const float *kb, *bias;
  const T* dout;
  const float *lse, *delta;
  T* dq;
  int bias_heads, bias_div, bias_rows, sq, sk;
  float scale;
  int causal;
  unsigned seed, thresh;
  float inv_keep;
};

template <int D, bool kDropout, bool kBias>
cudaError_t launch_tf32_one(dim3 grid, const Args<float>& a,
                            cudaStream_t stream) {
  constexpr int smem = tf32_smem_bytes<D>();
  auto kernel = flash_bwd_dq_tf32_kernel<D, kDropout, kBias>;
  static unsigned done = 0;
  const cudaError_t err = flash::mma::allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      a.q, a.k, a.v, a.kb, a.bias, a.dout, a.lse, a.delta, a.dq,
      a.bias_heads, a.bias_div, a.bias_rows, a.sq, a.sk, a.scale, a.causal,
      a.seed, a.thresh, a.inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32(const Args<float>& a, int bh, int dropout,
                        cudaStream_t stream) {
  dim3 grid((a.sq + tf32_rows<D>() - 1) / tf32_rows<D>(), bh);
  if (dropout) {
    return a.bias ? launch_tf32_one<D, true, true>(grid, a, stream)
                  : launch_tf32_one<D, true, false>(grid, a, stream);
  }
  return a.bias ? launch_tf32_one<D, false, true>(grid, a, stream)
                : launch_tf32_one<D, false, false>(grid, a, stream);
}

template <typename T, int D, bool kDropout, bool kBias>
cudaError_t launch_mma_one(dim3 grid, const Args<T>& a, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  auto kernel = flash_bwd_dq_mma_kernel<T, D, kDropout, kBias>;
  // the opt-in is kept per signature: each instantiation says so itself
  static unsigned done = 0;
  const cudaError_t err = flash::mma::allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      a.q, a.k, a.v, a.kb, a.bias, a.dout, a.lse, a.delta, a.dq,
      a.bias_heads, a.bias_div, a.bias_rows, a.sq, a.sk, a.scale, a.causal,
      a.seed, a.thresh, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const Args<T>& a, int bh, int dropout,
                       cudaStream_t stream) {
  dim3 grid((a.sq + mma_rows<D>() - 1) / mma_rows<D>(), bh);
  if (dropout) {
    return a.bias ? launch_mma_one<T, D, true, true>(grid, a, stream)
                  : launch_mma_one<T, D, true, false>(grid, a, stream);
  }
  return a.bias ? launch_mma_one<T, D, false, true>(grid, a, stream)
                : launch_mma_one<T, D, false, false>(grid, a, stream);
}

// Returns a cudaError_t: 0 on a successful launch (asynchronous on
// `stream`; nothing allocated or synchronised). `dropout` 0 ignores seed,
// thresh and inv_keep; otherwise `inv_keep` is 1 / (1 - rate) as fp32.
// `bias` null means no general bias (see flash_fwd.cu). q/k/v/dout/dq are
// T; key_bias, bias, lse and delta fp32. `d` is 32, 64, 128 or 256. fp32
// runs the split-TF32 kernel, bf16 and fp16 the bf16/fp16 tensor-core
// one.
template <typename T>
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* key_bias, const void* bias, const void* dout,
                 const void* lse, const void* delta, void* dq, int bh,
                 int bias_heads, int bias_div, int bias_rows, int sq, int sk,
                 int d, float scale, int causal, int dropout, unsigned seed,
                 unsigned thresh, float inv_keep, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || bias_heads <= 0 ||
      bh % bias_heads != 0 || bias_div <= 0 || bias_rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.kb = static_cast<const float*>(key_bias);
  a.bias = static_cast<const float*>(bias);
  a.dout = static_cast<const T*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<T*>(dq);
  a.bias_heads = bias_heads;
  a.bias_div = bias_div;
  a.bias_rows = bias_rows;
  a.sq = sq;
  a.sk = sk;
  a.scale = scale;
  a.causal = causal;
  a.seed = seed;
  a.thresh = thresh;
  a.inv_keep = inv_keep;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, float>::value) {
    switch (d) {
      case 32:
        return (int)launch_tf32<32>(a, bh, dropout, s);
      case 64:
        return (int)launch_tf32<64>(a, bh, dropout, s);
      case 128:
        return (int)launch_tf32<128>(a, bh, dropout, s);
      case 256:
        return (int)launch_tf32<256>(a, bh, dropout, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (d) {
      case 32:
        return (int)launch_mma<T, 32>(a, bh, dropout, s);
      case 64:
        return (int)launch_mma<T, 64>(a, bh, dropout, s);
      case 128:
        return (int)launch_mma<T, 128>(a, bh, dropout, s);
      case 256:
        return (int)launch_mma<T, 256>(a, bh, dropout, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
}

}  // namespace

FLASH_ENTRY_POINTS(
    paddle_flash_bwd_dq, flash_bwd_dq,
    (const void* q, const void* k, const void* v, const void* key_bias,
     const void* bias, const void* dout, const void* lse, const void* delta,
     void* dq, int bh, int bias_heads, int bias_div, int bias_rows, int sq,
     int sk, int d, float scale, int causal, int dropout, unsigned seed,
     unsigned thresh, float inv_keep, void* stream),
    (q, k, v, key_bias, bias, dout, lse, delta, dq, bh, bias_heads, bias_div,
     bias_rows, sq, sk, d, scale, causal, dropout, seed, thresh, inv_keep,
     stream))

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
