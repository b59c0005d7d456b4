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
//   dq  = scale * sum_kv (p o (dp - delta)) K
//
// delta = rowsum(dO o O) (minus an lse cotangent) comes in from the
// wrapper, as the reference leaves it to XLA. Nothing here is stored
// between blocks: one block owns a (head, 64-row query tile) and sweeps
// the key tiles in a loop, which takes the place of the TPU's sequential
// kv loop; under `causal` it stops at the diagonal tile, as the forward
// does.
//
// Layout: q/dout/dq [BH, Sq, D], k/v [BH, Sk, D] in the element type T
// (fp32, bf16 or fp16; flash_common.cuh), lse/delta [BH, Sq], key_bias
// [BH / bias_heads, Sk] (null = none), bias [G, Sq, Sk] with head bh
// reading row (bh / bias_div) % bias_rows (null = none; see flash_fwd.cu),
// those four fp32; all contiguous. In bf16 and fp16, ds rounds to T
// before the ds.K product, as the reference's ds.astype(k.dtype), and dq
// is stored in T. The scores add the bias as the
// forward does, so p = exp(s - lse) is the forward's probability.
//
// Bound on this card: operations. Per (query, key) pair the kernel does
// two dot products over D (scores, dO V^T) and one D-wide axpy (dq): 6D
// flops, 0.29 ms at the training shape [8, 12, 1024, 64] causal (50 M
// pairs) against 67 TFLOP/s of non-tensor fp32, while it moves ~126 MB
// (q, k, v, dO in, dq out: 0.04 ms at 3.35 TB/s). Design, as flash_fwd.cu: the K/V tile is
// staged once in shared memory for the block's 64 rows; four threads
// share a query row and hold its q, dO and dq parts in registers
// (flash_common.cuh); fully masked key tiles are never loaded.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int D, int BK, bool kDropout, bool kBias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ kb,
                    const float* __restrict__ bias,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int bias_heads, int bias_div, int bias_rows, int sq,
                    int sk, float scale, int causal, unsigned seed,
                    unsigned thresh, float inv_keep) {
  constexpr int kVec = D / 16;
  constexpr int kRow4 = D / 4;
  __shared__ float4 ks[BK][kRow4];
  __shared__ float4 vs[BK][kRow4];
  __shared__ float kbs[BK];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTileRows;
  const int tid = threadIdx.x;
  const int lane = tid & (kRowThreads - 1);
  const int qi = q0 + tid / kRowThreads;
  const bool row_ok = qi < sq;
  const int row = row_ok ? qi : 0;   // rows past Sq run on row 0's data
  const unsigned head_s = head_seed(seed, (unsigned)bh);
  const unsigned row_h = row_hash((unsigned)qi);

  const T* qp = q + ((size_t)bh * sq + row) * D;
  const T* dop = dout + ((size_t)bh * sq + row) * D;
  float4 qr[kVec];
  float4 dor[kVec];
  float4 acc[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    qr[c] = load4(qp + 16 * c + 4 * lane);
    dor[c] = load4(dop + 16 * c + 4 * lane);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float lse_i = lse[(size_t)bh * sq + row];
  const float delta_i = delta[(size_t)bh * sq + row];

  const T* kp = k + (size_t)bh * sk * D;
  const T* vp = v + (size_t)bh * sk * D;
  const float* kbp = kb ? kb + (size_t)(bh / bias_heads) * sk : nullptr;
  const float* brow =
      kBias ? bias + ((size_t)((bh / bias_div) % bias_rows) * sq + row) * sk
            : nullptr;
  const int kend = causal ? min(sk, q0 + kTileRows) : sk;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
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

#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      float part_s = 0.f;
      float part_dp = 0.f;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        part_s += dot4(qr[c], ks[j][4 * c + lane]);
        part_dp += dot4(dor[c], vs[j][4 * c + lane]);
      }
      part_s = group_sum(part_s);
      float dp = group_sum(part_dp);
      const int kj = k0 + j;
      float s = part_s * scale + kbs[j];
      if (kBias && kj < sk) s += __ldg(brow + kj);
      if (kj >= sk || (causal && kj > qi)) s = kNeg;
      const float p = expf(s - lse_i);
      if (kDropout) {
        dp = hash_keep(row_h, (unsigned)kj, head_s, thresh) ? dp * inv_keep
                                                             : 0.f;
      }
      const float ds = round_to<T>(p * (dp - delta_i));
#pragma unroll
      for (int c = 0; c < kVec; ++c) axpy4(acc[c], ds, ks[j][4 * c + lane]);
    }
  }

  if (row_ok) {
    T* out = dq + ((size_t)bh * sq + qi) * D;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      store4(out + 16 * c + 4 * lane,
             make_float4(acc[c].x * scale, acc[c].y * scale,
                         acc[c].z * scale, acc[c].w * scale));
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

template <typename T, int D, int BK, bool kDropout, bool kBias>
void launch_one(dim3 grid, const Args<T>& a, cudaStream_t stream) {
  flash_bwd_dq_kernel<T, D, BK, kDropout, kBias>
      <<<grid, kThreads, 0, stream>>>(
          a.q, a.k, a.v, a.kb, a.bias, a.dout, a.lse, a.delta, a.dq,
          a.bias_heads, a.bias_div, a.bias_rows, a.sq, a.sk, a.scale,
          a.causal, a.seed, a.thresh, a.inv_keep);
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

// Returns a cudaError_t: 0 on a successful launch (asynchronous on
// `stream`; nothing allocated or synchronised). `dropout` 0 ignores seed,
// thresh and inv_keep; otherwise `inv_keep` is 1 / (1 - rate) as fp32.
// `bias` null means no general bias (see flash_fwd.cu). q/k/v/dout/dq are
// T; key_bias, bias, lse and delta fp32. `d` is 32, 64, 128 or 256.
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
