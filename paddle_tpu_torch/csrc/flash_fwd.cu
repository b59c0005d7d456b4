// Forward flash attention, fp32, bf16 and fp16, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (paddle_tpu/kernels/flash_attention.py:149, launched by
// `_flash_fwd_impl` at :701 behind `flash_attention_lse` /
// `flash_attention`): a key-only additive bias, the general additive bias
// [G, Sq, Sk], the causal flag and the in-kernel hash dropout. GPT
// prefill (rate 0), the GPT train step (rate 0.1) and
// `fluid.layers.flash_attention(bias=...)` (a learnable per-head bias).
//
//   P   = softmax(Q K^T * scale + key_bias + bias, causal)
//   O   = (keep o P) V / (1 - rate)   (keep: the reference's hash mask)
//   lse = m + log(l)            (per query row, unmasked; for the backward)
//
// Dropout masks P after `l` has accumulated, so `l` and `lse` describe
// the undropped distribution and the backward's rowsum(dO o O) trick
// still gives delta. At rate 0 the dropout-free instantiation runs, the
// same arithmetic as before dropout was added (serving prefill relies on
// it).
//
// Layout: q/o [BH, Sq, D], k/v [BH, Sk, D] in the element type T (fp32,
// bf16 or fp16; flash_common.cuh), lse [BH, Sq] fp32, all contiguous.
// key_bias is [BH / bias_heads, Sk]: head bh reads row bh / bias_heads,
// so the model's [batch, Sk] padding bias (bias_heads = heads) is read as
// it is, with no per-head copy; a null key_bias means no bias.
// Conventions of the reference: masked scores are -1e30, `l` is clamped
// at 1e-30, accumulation is fp32.
//
// The general bias is [G, Sq, Sk] fp32 (null = none): head bh = b*N + n
// reads row (bh / bias_div) % bias_rows, which maps every broadcast form
// of the reference straight onto the caller's heads ([Sq, Sk] -> row 0,
// [B, 1, ..] -> bh / N, [B, N, ..] -> bh, [1, N, ..] -> bh % N). The TPU
// kernel swaps B and N for the per-head form so that heads sharing a row
// are consecutive on its sequential grid; CUDA blocks run in no order, so
// no swap is needed, and the dropout hash keeps the caller's head index.
// bias = false is the instantiation without it.
//
// Two kernels on the tensor cores, one per element type (flash_mma.cuh);
// dispatching by type is the design, not a fallback:
//
// fp32 (serving prefill, the fp32 train step): `flash_fwd_tf32_kernel`,
// split TF32 ("3xTF32"). Bound at the fp32 train shape [8, 12, 1024,
// 64], causal: 12.9 GFLOP of Q.K^T and P.V; at the 67 TFLOP/s of fp32 on
// the CUDA cores that is 0.19 ms, but as three TF32 products at 495
// TFLOP/s it is 0.078 ms, against 50 MB of q/k/v/o/lse at 3.35 TB/s
// (0.015 ms). A single TF32 product rounds the operands to 11 bits and
// misses the fp32 reference by ~1e-3; each operand is split into a TF32
// big part and a TF32 small part, and every product is taken as three
// `mma.sync.m16n8k8` TF32 products with the small*small term dropped
// (~2^-22 relative), which keeps fp32's accuracy (CUTLASS's
// OpMultiplyAddFastF32). Both products are split: S = Q.K^T, and O += P.V
// with P in fp32, which the fp32 reference does not round. Each k-step's
// three products are summed from zero and added to the running sums on
// the CUDA cores: the tensor cores cut their sums to 24 bits, and adding
// into the large running O that way biased out toward zero, enough to
// move the train step's exactly-zero k-bias gradient past its check
// (chip_smoke.py, train phase).
// The rest is the bf16 kernel's design below, with fp32 tiles
// (`swz_rows` for Q and K, `swz_pairs` for V; Q split once and kept in
// registers up to D = 64, split as it is read from shared memory past it;
// K/V tiles of 64 keys, 16 from D = 128 on, each split once for the
// block into big and small parts in shared memory) and P.V reading key 2t
// at k index t and key 2t+1 at t+4, so that P's accumulators are its A
// fragment as they are.
//
// bf16 and fp16 (the AMP train step): `flash_fwd_mma_kernel`, on the
// tensor cores (flash_mma.cuh). Bound at the AMP train shape [8, 12,
// 1024, 64], causal: 12.9 GFLOP of Q.K^T and P.V at 989 TFLOP/s, 0.013
// ms, against 25 MB of q/k/v/o/lse at 3.35 TB/s, 0.0075 ms; the exp and
// the dropout hash of every (query, key) pair (~50 M) on the CUDA cores
// come close behind. The design is FlashAttention-2's:
//   - a block of 4 warps owns 64 query rows, 16 a warp; the Q tile comes
//     in once by `cp.async` and stays as `mma` A fragments (in shared
//     memory at D = 256, where registers run out);
//   - K and V tiles of 64 keys (32 at D = 256) in a two-stage `cp.async`
//     ring, swizzled for `ldmatrix`; the next tile's copy runs under the
//     current tile's products; keys past Sk and rows past Sq zero-fill;
//   - S = Q.K^T by `mma.sync.m16n8k16` (fp32 accumulators); scale, key
//     bias, general bias and masks are applied in the accumulator layout,
//     where each thread holds 2 rows x 16 keys (the tile's key bias is
//     loaded before the products, which hide its latency); the row max and
//     sum need two shuffles within a quad of lanes; the exponentials run
//     as exp2 of log2(e)-scaled differences;
//   - the reference's softmax conventions, not FlashAttention's: masked
//     scores -1e30, m starting at -1e30, `l` summing the undropped p,
//     clamped at 1e-30, lse = m + log(l);
//   - dropout after `l`, one hash per (row, key) element on the absolute
//     (row, col, bh), as the backward kernels compute it;
//   - P.V with p rounded to T (the reference's p.astype(v.dtype)) and
//     repacked from the accumulators straight into A fragments; V by
//     `ldmatrix.trans`;
//   - under `causal` the tiles above the diagonal are skipped and only
//     tiles that cross the diagonal or the ragged end are masked;
//   - o = acc / (l * (1 - rate)) stored in T.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace flash;

// The tensor-core kernel (bf16, fp16). 4 warps, 16 query rows each.
using flash::mma::kLog2e;
using flash::mma::kMmaThreads;
using flash::mma::kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;

// key rows per K/V tile, and the dynamic shared memory of a block: the Q
// tile and two stages of K and V
template <int D>
__host__ __device__ constexpr int mma_bk() {
  return D <= 128 ? 64 : 32;
}

template <int D>
__host__ __device__ constexpr int mma_smem_bytes() {
  return (kMmaRows * D + 4 * mma_bk<D>() * D) * 2;
}

template <typename T, int D, bool kDropout, bool kBias>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ kb,
                     const float* __restrict__ bias, T* __restrict__ o,
                     float* __restrict__ lse, int bias_heads, int bias_div,
                     int bias_rows, int sq, int sk, float scale, int causal,
                     unsigned seed, unsigned thresh, float keep_prob) {
  using namespace flash::mma;
  constexpr int BK = mma_bk<D>();
  constexpr int kKSteps = D / 16;  // k-steps of Q.K^T
  constexpr int kNT = BK / 8;      // n-tiles of S (8 keys each)
  constexpr int kDT = D / 8;       // n-tiles of O (8 columns each)
  constexpr bool kQRegs = D <= 128;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);  // [kMmaRows][D]
  T* ks = qs + kMmaRows * D;           // [2][BK][D]
  T* vs = ks + 2 * BK * D;             // [2][BK][D]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kMmaRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wrow = (tid >> 5) * 16;  // the warp's first row in the tile
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // the thread's two rows: accumulator elements 0, 1 and 2, 3
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  const unsigned head_s = head_seed(seed, (unsigned)bh);
  const unsigned row_h[2] = {row_hash((unsigned)rows[0]),
                             row_hash((unsigned)rows[1])};

  const T* qp = q + (size_t)bh * sq * D;
  const T* kp = k + (size_t)bh * sk * D;
  const T* vp = v + (size_t)bh * sk * D;
  const float* kbp = kb ? kb + (size_t)(bh / bias_heads) * sk : nullptr;
  const float* brow[2] = {nullptr, nullptr};
  if (kBias) {
    const size_t base = (size_t)((bh / bias_div) % bias_rows) * sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // rows past Sq read row Sq - 1 and store nothing
      brow[r] = bias + (base + min(rows[r], sq - 1)) * sk;
    }
  }
  // key tiles starting past the block's last row are masked for every
  // row of the block: skip them
  const int kend = causal ? min(sk, q0 + kMmaRows) : sk;
  const int ntiles = (kend + BK - 1) / BK;

  load_tile<D, kMmaRows, kMmaThreads>(qs, qp, q0, sq, tid);
  load_tile<D, BK, kMmaThreads>(ks, kp, 0, sk, tid);
  load_tile<D, BK, kMmaThreads>(vs, vp, 0, sk, tid);
  cp_async_commit();

  unsigned qf[kQRegs ? kKSteps : 1][4];
  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums

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
        ldmatrix_x4(qf[kk],
                    qs + swz<D>(wrow + (lane & 15), kk * 16 + (lane >> 4) * 8));
      }
    }

    // the key bias of the thread's 16 keys, loaded ahead of the products
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

    // S = Q K^T
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      unsigned a[4];
      if constexpr (kQRegs) {
        a[0] = qf[kk][0];
        a[1] = qf[kk][1];
        a[2] = qf[kk][2];
        a[3] = qf[kk][3];
      } else {
        ldmatrix_x4(a, qs + swz<D>(wrow + (lane & 15),
                                   kk * 16 + (lane >> 4) * 8));
      }
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        unsigned b[4];
        ldmatrix_x4(b, kst + swz<D>(jp * 16 + (lane & 7) + (lane >> 4) * 8,
                                    kk * 16 + ((lane >> 3) & 1) * 8));
        mma16816<T>(s[2 * jp], a, b[0], b[1]);
        mma16816<T>(s[2 * jp + 1], a, b[2], b[3]);
      }
    }

    // scores, masks and the online softmax, in the accumulator layout:
    // s[j][e] is row rows[e / 2], key k0 + 8j + 2 t4 + e % 2
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > q0 + wrow);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + 8 * j + 2 * t4 + (e & 1);
        float x = s[j][e] * scale + kbv[j][e & 1];
        if (kBias && (!edge || col < sk)) x += __ldg(brow[r] + col);
        if (edge && (col >= sk || (causal && col > rows[r]))) x = kNeg;
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    // exponentials as exp2 of log2(e)-scaled differences: the hardware
    // exp2; the product's rounding moves p = exp(x) by at most |x| fp32
    // ulps (20 at p = 2e-9), far below T's; a difference of two masked
    // scores is 0, as in expf
    float alpha[2];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[j][e] - m[e >> 1]) * kLog2e);
        psum[e >> 1] += p;
        s[j][e] = p;
      }
    }
    l[0] = l[0] * alpha[0] + psum[0];
    l[1] = l[1] * alpha[1] + psum[1];
    if (kDropout) {
      // after `l`: dropout leaves the normalizer undropped
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned col = (unsigned)(k0 + 8 * j + 2 * t4 + (e & 1));
          if (!hash_keep(row_h[e >> 1], col, head_s, thresh)) s[j][e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V, p rounded to T as the reference's p.astype(v.dtype)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned a[4] = {pack_round<T>(s[2 * kk][0], s[2 * kk][1]),
                             pack_round<T>(s[2 * kk][2], s[2 * kk][3]),
                             pack_round<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_round<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < kDT / 2; ++jp) {
        unsigned b[4];
        ldmatrix_x4_trans(
            b, vst + swz<D>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                            jp * 16 + (lane >> 4) * 8));
        mma16816<T>(acc[2 * jp], a, b[0], b[1]);
        mma16816<T>(acc[2 * jp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] >= sq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    // the reference scales the normalizer, not the output: l * (1 - rate)
    const float l_out = kDropout ? l_safe * keep_prob : l_safe;
    T* op = o + ((size_t)bh * sq + rows[r]) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      *reinterpret_cast<unsigned*>(op + 8 * j) = pack_round<T>(
          acc[j][2 * r] / l_out, acc[j][2 * r + 1] / l_out);
    }
    if (t4 == 0) lse[(size_t)bh * sq + rows[r]] = m[r] + logf(l_safe);
  }
}

// The split-TF32 kernel (fp32): the same block of 4 warps, 16 query rows
// each.
template <int D>
__host__ __device__ constexpr int tf32_bk() {  // key rows per K/V tile
  return D <= 64 ? 64 : 16;
}

// the Q tile, two stages of K and V, and the small parts of one K and V
// tile, fp32
template <int D>
__host__ __device__ constexpr int tf32_smem_bytes() {
  return (kMmaRows * D + 6 * tf32_bk<D>() * D) * 4;
}

// The A fragment of rows [row0, row0 + 16), columns [c0, c0 + 8) of a
// `swz_rows` tile, split into TF32 big and small parts.
template <int D>
__device__ __forceinline__ void load_a_tf32(unsigned (&big)[4],
                                            unsigned (&small)[4],
                                            const float* tile, int row0,
                                            int c0, int g, int t4) {
  using flash::mma::split_tf32;
  using flash::mma::swz_rows;
  split_tf32(tile[swz_rows<D>(row0 + g, c0 + t4)], big[0], small[0]);
  split_tf32(tile[swz_rows<D>(row0 + g + 8, c0 + t4)], big[1], small[1]);
  split_tf32(tile[swz_rows<D>(row0 + g, c0 + t4 + 4)], big[2], small[2]);
  split_tf32(tile[swz_rows<D>(row0 + g + 8, c0 + t4 + 4)], big[3], small[3]);
}

template <int D, bool kDropout, bool kBias>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ kb,
                      const float* __restrict__ bias, float* __restrict__ o,
                      float* __restrict__ lse, int bias_heads, int bias_div,
                      int bias_rows, int sq, int sk, float scale, int causal,
                      unsigned seed, unsigned thresh, float keep_prob) {
  using namespace flash::mma;
  constexpr int BK = tf32_bk<D>();
  constexpr int kKSteps = D / 8;  // k-steps of Q.K^T (8 columns each)
  constexpr int kNT = BK / 8;     // n-tiles of S (8 keys each)
  constexpr int kDT = D / 8;      // n-tiles of O (8 columns each)
  constexpr bool kQRegs = D <= 64;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kMmaRows][D], swz_rows
  float* ks = qs + kMmaRows * D;               // [2][BK][D], swz_rows
  float* vs = ks + 2 * BK * D;                 // [2][BK][D], swz_pairs
  float* kss = vs + 2 * BK * D;                // [BK][D], K's small parts
  float* vss = kss + BK * D;                   // [BK][D], V's small parts

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kMmaRows;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wrow = (tid >> 5) * 16;  // the warp's first row in the tile
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // the thread's two rows: accumulator elements 0, 1 and 2, 3
  const int rows[2] = {q0 + wrow + g, q0 + wrow + g + 8};
  const unsigned head_s = head_seed(seed, (unsigned)bh);
  const unsigned row_h[2] = {row_hash((unsigned)rows[0]),
                             row_hash((unsigned)rows[1])};

  const float* kp = k + (size_t)bh * sk * D;
  const float* vp = v + (size_t)bh * sk * D;
  const float* kbp = kb ? kb + (size_t)(bh / bias_heads) * sk : nullptr;
  const float* brow[2] = {nullptr, nullptr};
  if (kBias) {
    const size_t base = (size_t)((bh / bias_div) % bias_rows) * sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // rows past Sq read row Sq - 1 and store nothing
      brow[r] = bias + (base + min(rows[r], sq - 1)) * sk;
    }
  }
  // key tiles starting past the block's last row are masked for every
  // row of the block: skip them
  const int kend = causal ? min(sk, q0 + kMmaRows) : sk;
  const int ntiles = (kend + BK - 1) / BK;

  load_tile_f32<D, kMmaRows, kMmaThreads, F32Layout::kRows>(
      qs, q + (size_t)bh * sq * D, q0, sq, tid);
  load_tile_f32<D, BK, kMmaThreads, F32Layout::kRows>(ks, kp, 0, sk, tid);
  load_tile_f32<D, BK, kMmaThreads, F32Layout::kPairs>(vs, vp, 0, sk, tid);
  cp_async_commit();

  unsigned qb[kQRegs ? kKSteps : 1][4];
  unsigned qsm[kQRegs ? kKSteps : 1][4];
  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    float* kst = ks + (t & 1) * BK * D;
    float* vst = vs + (t & 1) * BK * D;
    if (t + 1 < ntiles) {
      // the stage it fills was last read in iteration t - 1, which ended
      // in a barrier
      load_tile_f32<D, BK, kMmaThreads, F32Layout::kRows>(
          ks + ((t + 1) & 1) * BK * D, kp, k0 + BK, sk, tid);
      load_tile_f32<D, BK, kMmaThreads, F32Layout::kPairs>(
          vs + ((t + 1) & 1) * BK * D, vp, k0 + BK, sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // K and V split once for the block, not once a warp: TF32 big parts
    // in place, small parts beside them at the same (swizzled) offsets
    split_tile_tf32<D, BK, kMmaThreads>(kst, kss, tid);
    split_tile_tf32<D, BK, kMmaThreads>(vst, vss, tid);
    __syncthreads();
    if (kQRegs && t == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQRegs ? kKSteps : 0); ++kk) {
        load_a_tf32<D>(qb[kk], qsm[kk], qs, wrow, kk * 8, g, t4);
      }
    }

    // the key bias of the thread's 16 keys, loaded ahead of the products
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

    // S = Q K^T in split TF32; K's "col" B fragment is row g, columns t
    // and t + 4 of the tile
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      unsigned ab[4];
      unsigned as[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ab[i] = qb[kk][i];
          as[i] = qsm[kk][i];
        }
      } else {
        load_a_tf32<D>(ab, as, qs, wrow, kk * 8, g, t4);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int o0 = swz_rows<D>(8 * j + g, kk * 8 + t4);
        const int o1 = swz_rows<D>(8 * j + g, kk * 8 + t4 + 4);
        mma_3xtf32(s[j], ab, as, __float_as_uint(kst[o0]),
                   __float_as_uint(kst[o1]), __float_as_uint(kss[o0]),
                   __float_as_uint(kss[o1]));
      }
    }

    // scores, masks and the online softmax, in the accumulator layout:
    // s[j][e] is row rows[e / 2], key k0 + 8j + 2 t4 + e % 2
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > q0 + wrow);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = k0 + 8 * j + 2 * t4 + (e & 1);
        float x = s[j][e] * scale + kbv[j][e & 1];
        if (kBias && (!edge || col < sk)) x += __ldg(brow[r] + col);
        if (edge && (col >= sk || (causal && col > rows[r]))) x = kNeg;
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    // exponentials as in the bf16 kernel: exp2 of log2(e)-scaled
    // differences; the product's rounding moves p = exp(x) by at most |x|
    // fp32 ulps, within the forward's 2e-5 / 1e-4 of the reference
    float alpha[2];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[j][e] - m[e >> 1]) * kLog2e);
        psum[e >> 1] += p;
        s[j][e] = p;
      }
    }
    l[0] = l[0] * alpha[0] + psum[0];
    l[1] = l[1] * alpha[1] + psum[1];
    if (kDropout) {
      // after `l`: dropout leaves the normalizer undropped
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned col = (unsigned)(k0 + 8 * j + 2 * t4 + (e & 1));
          if (!hash_keep(row_h[e >> 1], col, head_s, thresh)) s[j][e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V in split TF32, p in fp32 as the fp32 reference keeps it.
    // The k-step over keys k0 + 8j .. + 7 reads key 2t at k index t and
    // key 2t + 1 at t + 4: the accumulators (rows g, g + 8; keys 2t,
    // 2t + 1) are then a0..a3 = s0, s2, s1, s3, and V's "col" B fragment
    // is rows 2t, 2t + 1 of the tile at column g.
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      unsigned pb[4];
      unsigned ps[4];
      acc_a_tf32(pb, ps, s[j]);
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        const int o0 = swz_pairs<D>(8 * j + 2 * t4, 8 * n + g);
        const int o1 = swz_pairs<D>(8 * j + 2 * t4 + 1, 8 * n + g);
        mma_3xtf32(acc[n], pb, ps, __float_as_uint(vst[o0]),
                   __float_as_uint(vst[o1]), __float_as_uint(vss[o0]),
                   __float_as_uint(vss[o1]));
      }
    }
    __syncthreads();  // this stage is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (rows[r] >= sq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    // the reference scales the normalizer, not the output: l * (1 - rate)
    const float l_out = kDropout ? l_safe * keep_prob : l_safe;
    float* op = o + ((size_t)bh * sq + rows[r]) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      *reinterpret_cast<float2*>(op + 8 * j) =
          make_float2(acc[j][2 * r] / l_out, acc[j][2 * r + 1] / l_out);
    }
    if (t4 == 0) lse[(size_t)bh * sq + rows[r]] = m[r] + logf(l_safe);
  }
}

template <typename T>
struct Args {
  const T *q, *k, *v;
  const float *kb, *bias;
  T* o;
  float* lse;
  int bias_heads, bias_div, bias_rows, sq, sk;
  float scale;
  int causal;
  unsigned seed, thresh;
  float keep_prob;
};

template <int D, bool kDropout, bool kBias>
cudaError_t launch_tf32_one(dim3 grid, const Args<float>& a,
                            cudaStream_t stream) {
  constexpr int smem = tf32_smem_bytes<D>();
  auto kernel = flash_fwd_tf32_kernel<D, kDropout, kBias>;
  static unsigned done = 0;
  const cudaError_t err = flash::mma::allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      a.q, a.k, a.v, a.kb, a.bias, a.o, a.lse, a.bias_heads, a.bias_div,
      a.bias_rows, a.sq, a.sk, a.scale, a.causal, a.seed, a.thresh,
      a.keep_prob);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32(const Args<float>& a, int bh, int dropout,
                        cudaStream_t stream) {
  dim3 grid((a.sq + kMmaRows - 1) / kMmaRows, bh);
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
  auto kernel = flash_fwd_mma_kernel<T, D, kDropout, kBias>;
  static unsigned done = 0;
  const cudaError_t err = flash::mma::allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      a.q, a.k, a.v, a.kb, a.bias, a.o, a.lse, a.bias_heads, a.bias_div,
      a.bias_rows, a.sq, a.sk, a.scale, a.causal, a.seed, a.thresh,
      a.keep_prob);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const Args<T>& a, int bh, int dropout,
                       cudaStream_t stream) {
  dim3 grid((a.sq + kMmaRows - 1) / kMmaRows, bh);
  if (dropout) {
    return a.bias ? launch_mma_one<T, D, true, true>(grid, a, stream)
                  : launch_mma_one<T, D, true, false>(grid, a, stream);
  }
  return a.bias ? launch_mma_one<T, D, false, true>(grid, a, stream)
                : launch_mma_one<T, D, false, false>(grid, a, stream);
}

// Returns a cudaError_t: 0 on a successful launch. The launch is
// asynchronous on `stream`; nothing is allocated or synchronised here.
// `dropout` 0 ignores seed, thresh and keep_prob; otherwise `seed` is the
// 23-bit normalized seed, `thresh` the keep threshold and `keep_prob`
// 1 - rate (as fp32). `bias` null means no general bias; otherwise head
// bh reads its row (bh / bias_div) % bias_rows. q/k/v/o are T; key_bias,
// bias and lse fp32. `d` is 32, 64, 128 or 256: the wrapper zero-pads
// any other head dim up to one of these. fp32 runs the split-TF32 kernel,
// bf16 and fp16 the bf16/fp16 tensor-core one.
template <typename T>
int flash_fwd(const void* q, const void* k, const void* v,
              const void* key_bias, const void* bias, void* o, void* lse,
              int bh, int bias_heads, int bias_div, int bias_rows, int sq,
              int sk, int d, float scale, int causal, int dropout,
              unsigned seed, unsigned thresh, float keep_prob, void* stream) {
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
  a.o = static_cast<T*>(o);
  a.lse = static_cast<float*>(lse);
  a.bias_heads = bias_heads;
  a.bias_div = bias_div;
  a.bias_rows = bias_rows;
  a.sq = sq;
  a.sk = sk;
  a.scale = scale;
  a.causal = causal;
  a.seed = seed;
  a.thresh = thresh;
  a.keep_prob = keep_prob;
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
    paddle_flash_fwd, flash_fwd,
    (const void* q, const void* k, const void* v, const void* key_bias,
     const void* bias, void* o, void* lse, int bh, int bias_heads,
     int bias_div, int bias_rows, int sq, int sk, int d, float scale,
     int causal, int dropout, unsigned seed, unsigned thresh,
     float keep_prob, void* stream),
    (q, k, v, key_bias, bias, o, lse, bh, bias_heads, bias_div, bias_rows,
     sq, sk, d, scale, causal, dropout, seed, thresh, keep_prob, stream))

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
