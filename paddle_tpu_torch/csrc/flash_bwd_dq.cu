// Flash-attention backward, dQ, fp32, written by hand for Hopper (sm_90a).
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
// Layout: q/dout/dq [BH, Sq, D], k/v [BH, Sk, D], lse/delta [BH, Sq],
// key_bias [BH / bias_heads, Sk] (null = none), bias [G, Sq, Sk] with head
// bh reading row (bh / bias_div) % bias_rows (null = none; see
// flash_fwd.cu), all fp32, contiguous. The scores add the bias as the
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

template <int D, int BK, bool kDropout, bool kBias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ kb,
                    const float* __restrict__ bias,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
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

  const float4* qp = reinterpret_cast<const float4*>(
      q + ((size_t)bh * sq + row) * D);
  const float4* dop = reinterpret_cast<const float4*>(
      dout + ((size_t)bh * sq + row) * D);
  float4 qr[kVec];
  float4 dor[kVec];
  float4 acc[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    qr[c] = qp[4 * c + lane];
    dor[c] = dop[4 * c + lane];
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float lse_i = lse[(size_t)bh * sq + row];
  const float delta_i = delta[(size_t)bh * sq + row];

  const float4* kp = reinterpret_cast<const float4*>(k + (size_t)bh * sk * D);
  const float4* vp = reinterpret_cast<const float4*>(v + (size_t)bh * sk * D);
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
        kk = __ldg(kp + (size_t)kj * kRow4 + c);
        vv = __ldg(vp + (size_t)kj * kRow4 + c);
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
      const float ds = p * (dp - delta_i);
#pragma unroll
      for (int c = 0; c < kVec; ++c) axpy4(acc[c], ds, ks[j][4 * c + lane]);
    }
  }

  if (row_ok) {
    float4* out = reinterpret_cast<float4*>(dq + ((size_t)bh * sq + qi) * D);
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      out[4 * c + lane] = make_float4(acc[c].x * scale, acc[c].y * scale,
                                      acc[c].z * scale, acc[c].w * scale);
    }
  }
}

template <int D, int BK, bool kDropout>
void launch_bias(dim3 grid, const float* q, const float* k, const float* v,
                 const float* kb, const float* bias, const float* dout,
                 const float* lse, const float* delta, float* dq,
                 int bias_heads, int bias_div, int bias_rows, int sq, int sk,
                 float scale, int causal, unsigned seed, unsigned thresh,
                 float inv_keep, cudaStream_t stream) {
  if (bias) {
    flash_bwd_dq_kernel<D, BK, kDropout, true><<<grid, kThreads, 0, stream>>>(
        q, k, v, kb, bias, dout, lse, delta, dq, bias_heads, bias_div,
        bias_rows, sq, sk, scale, causal, seed, thresh, inv_keep);
  } else {
    flash_bwd_dq_kernel<D, BK, kDropout, false>
        <<<grid, kThreads, 0, stream>>>(
            q, k, v, kb, bias, dout, lse, delta, dq, bias_heads, bias_div,
            bias_rows, sq, sk, scale, causal, seed, thresh, inv_keep);
  }
}

template <int D, int BK>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* kb, const float* bias, const float* dout,
                   const float* lse, const float* delta, float* dq, int bh,
                   int bias_heads, int bias_div, int bias_rows, int sq,
                   int sk, float scale, int causal, int dropout,
                   unsigned seed, unsigned thresh, float inv_keep,
                   cudaStream_t stream) {
  dim3 grid((sq + kTileRows - 1) / kTileRows, bh);
  if (dropout) {
    launch_bias<D, BK, true>(grid, q, k, v, kb, bias, dout, lse, delta, dq,
                             bias_heads, bias_div, bias_rows, sq, sk, scale,
                             causal, seed, thresh, inv_keep, stream);
  } else {
    launch_bias<D, BK, false>(grid, q, k, v, kb, bias, dout, lse, delta, dq,
                              bias_heads, bias_div, bias_rows, sq, sk, scale,
                              causal, seed, thresh, inv_keep, stream);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch (asynchronous on
// `stream`; nothing allocated or synchronised). `dropout` 0 ignores seed,
// thresh and inv_keep; otherwise `inv_keep` is 1 / (1 - rate) as fp32.
// `bias` null means no general bias (see paddle_flash_fwd_f32).
int paddle_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                            const void* key_bias, const void* bias,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh,
                            int bias_heads, int bias_div, int bias_rows,
                            int sq, int sk, int d, float scale, int causal,
                            int dropout, unsigned seed, unsigned thresh,
                            float inv_keep, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || bias_heads <= 0 ||
      bh % bias_heads != 0 || bias_div <= 0 || bias_rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bf = static_cast<const float*>(key_bias);
  const float* gb = static_cast<const float*>(bias);
  const float* gf = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  float* out = static_cast<float*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return (int)launch<32, 64>(qf, kf, vf, bf, gb, gf, lf, df, out, bh,
                                 bias_heads, bias_div, bias_rows, sq, sk,
                                 scale, causal, dropout, seed, thresh,
                                 inv_keep, s);
    case 64:
      return (int)launch<64, 64>(qf, kf, vf, bf, gb, gf, lf, df, out, bh,
                                 bias_heads, bias_div, bias_rows, sq, sk,
                                 scale, causal, dropout, seed, thresh,
                                 inv_keep, s);
    case 128:
      return (int)launch<128, 32>(qf, kf, vf, bf, gb, gf, lf, df, out, bh,
                                 bias_heads, bias_div, bias_rows, sq, sk,
                                 scale, causal, dropout, seed, thresh,
                                 inv_keep, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
