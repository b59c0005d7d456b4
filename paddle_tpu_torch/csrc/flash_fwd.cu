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
// Two kernels, one per element type:
//
// fp32: `flash_fwd_kernel`, on the CUDA cores. Bound: operations. At the
// prefill shape (12 heads, T = 1024, D = 64, causal) it moves ~13 MB but
// does 4 * D * T(T+1)/2 * 12 = 1.6 GFLOP of fp32 multiply-adds: ~24 us
// at the 67 TFLOP/s of non-tensor fp32 against ~4 us for the bytes at
// 3.35 TB/s (data-sheet peaks of the NVIDIA H100 80GB HBM3 at 700.00 W).
// fp32 operands cannot use the tensor cores' full rate (TF32 would round
// the inputs), so it attacks the other costs: the [S, S] scores never
// reach device memory (one block owns a 64-row query tile and sweeps key
// tiles with an online softmax); each K/V tile is staged once into
// shared memory for all 64 rows; under `causal` the key tiles above the
// diagonal are skipped; four threads share a query row
// (flash_common.cuh), each computing the dropout hash of its row.
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
//     (row, col, bh), as the fp32 kernel computes it;
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

// The fp32 kernel. T is kept as a parameter so that the launch code is
// shared with the tensor-core form, but only fp32 instantiates it (the
// static_assert below); its round_to<T> points are then the identity.
// T: element type of q/k/v/o. D: head dim (multiple of 16). BK: key rows
// per shared-memory tile.
template <typename T, int D, int BK, bool kDropout, bool kBias>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ kb,
                 const float* __restrict__ bias, T* __restrict__ o,
                 float* __restrict__ lse, int bias_heads, int bias_div,
                 int bias_rows, int sq, int sk, float scale, int causal,
                 unsigned seed, unsigned thresh, float keep_prob) {
  static_assert(std::is_same<T, float>::value,
                "bf16/fp16 run the tensor-core kernel");
  constexpr int kVec = D / 16;   // float4s per thread: d = 16c + 4*lane
  constexpr int kRow4 = D / 4;   // float4s per K/V row
  __shared__ float4 ks[BK][kRow4];
  __shared__ float4 vs[BK][kRow4];
  __shared__ float kbs[BK];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTileRows;
  const int tid = threadIdx.x;
  const int lane = tid & (kRowThreads - 1);
  const int qi = q0 + tid / kRowThreads;
  const bool row_ok = qi < sq;
  const unsigned head_s = head_seed(seed, (unsigned)bh);
  const unsigned row_h = row_hash((unsigned)qi);

  // rows past Sq still run (they take part in the shuffles and the
  // barriers) on row 0's data and store nothing
  const T* qp = q + ((size_t)bh * sq + (row_ok ? qi : 0)) * D;
  float4 qr[kVec];
  float4 acc[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    qr[c] = load4(qp + 16 * c + 4 * lane);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNeg;
  float l = 0.f;

  const T* kp = k + (size_t)bh * sk * D;
  const T* vp = v + (size_t)bh * sk * D;
  const float* kbp = kb ? kb + (size_t)(bh / bias_heads) * sk : nullptr;
  const float* brow =
      kBias ? bias + ((size_t)((bh / bias_div) % bias_rows) * sq +
                      (row_ok ? qi : 0)) * sk
            : nullptr;
  // key tiles starting past the block's last row are masked for every
  // row of the block: skip them
  const int kend = causal ? min(sk, q0 + kTileRows) : sk;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = tid; i < BK * kRow4; i += kThreads) {
      const int j = i / kRow4;
      const int c = i - j * kRow4;
      const int kj = k0 + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (kj < sk) {
        kk = load4(kp + (size_t)kj * D + 4 * c);
        vv = load4(vp + (size_t)kj * D + 4 * c);
      }
      ks[j][c] = kk;
      vs[j][c] = vv;
    }
    for (int j = tid; j < BK; j += kThreads) {
      const int kj = k0 + j;
      kbs[j] = kj >= sk ? kNeg : (kbp ? __ldg(kbp + kj) : 0.f);
    }
    __syncthreads();

    float s[BK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kVec; ++c) part += dot4(qr[c], ks[j][4 * c + lane]);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + j;
      float sj = part * scale + kbs[j];
      if (kBias && kj < sk) sj += __ldg(brow + kj);
      if (kj >= sk || (causal && kj > qi)) sj = kNeg;
      s[j] = sj;
      m_new = fmaxf(m_new, sj);
    }
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
    if (kDropout) {
      // after `l`: dropout leaves the normalizer undropped
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        if (!hash_keep(row_h, (unsigned)(k0 + j), head_s, thresh)) s[j] = 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      // p rounds to the value type for the P.V product, as the
      // reference's p.astype(v.dtype); the identity in fp32
      const float p = round_to<T>(s[j]);
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const float4 vv = vs[j][4 * c + lane];
        acc[c].x += p * vv.x;
        acc[c].y += p * vv.y;
        acc[c].z += p * vv.z;
        acc[c].w += p * vv.w;
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float l_safe = fmaxf(l, 1e-30f);
    T* op = o + ((size_t)bh * sq + qi) * D;
    if (kDropout) {
      // the reference scales the normalizer, not the output: l * (1 - rate)
      const float l_out = l_safe * keep_prob;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        store4(op + 16 * c + 4 * lane,
               make_float4(acc[c].x / l_out, acc[c].y / l_out,
                           acc[c].z / l_out, acc[c].w / l_out));
      }
    } else {
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        store4(op + 16 * c + 4 * lane,
               make_float4(acc[c].x / l_safe, acc[c].y / l_safe,
                           acc[c].z / l_safe, acc[c].w / l_safe));
      }
    }
    if (lane == 0) lse[(size_t)bh * sq + qi] = m + logf(l_safe);
  }
}

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

template <typename T, int D, int BK, bool kDropout, bool kBias>
void launch_one(dim3 grid, const Args<T>& a, cudaStream_t stream) {
  flash_fwd_kernel<T, D, BK, kDropout, kBias><<<grid, kThreads, 0, stream>>>(
      a.q, a.k, a.v, a.kb, a.bias, a.o, a.lse, a.bias_heads, a.bias_div,
      a.bias_rows, a.sq, a.sk, a.scale, a.causal, a.seed, a.thresh,
      a.keep_prob);
}

template <typename T, int D, int BK>
cudaError_t launch(const Args<T>& a, int bh, int dropout,
                   cudaStream_t stream) {
  dim3 grid((a.sq + kTileRows - 1) / kTileRows, bh);
  if (dropout) {
    if (a.bias) {
      launch_one<T, D, BK, true, true>(grid, a, stream);
    } else {
      launch_one<T, D, BK, true, false>(grid, a, stream);
    }
  } else {
    if (a.bias) {
      launch_one<T, D, BK, false, true>(grid, a, stream);
    } else {
      launch_one<T, D, BK, false, false>(grid, a, stream);
    }
  }
  return cudaGetLastError();
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
// any other head dim up to one of these. fp32 runs the CUDA-core kernel,
// bf16 and fp16 the tensor-core one.
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
        return (int)launch<T, 32, 64>(a, bh, dropout, s);
      case 64:
        return (int)launch<T, 64, 64>(a, bh, dropout, s);
      case 128:
        return (int)launch<T, 128, 32>(a, bh, dropout, s);
      case 256:
        return (int)launch<T, 256, 16>(a, bh, dropout, s);
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
