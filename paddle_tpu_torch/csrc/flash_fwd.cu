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
// bf16 or fp16; flash_common.cuh), lse [BH, Sq] fp32, all contiguous. key_bias is [BH / bias_heads, Sk]: head bh reads row
// bh / bias_heads, so the model's [batch, Sk] padding bias (bias_heads =
// heads) is read as it is, with no per-head copy; a null key_bias means
// no bias. Conventions of the reference: masked scores are -1e30, `l` is
// clamped at 1e-30, accumulation is fp32.
//
// The general bias is [G, Sq, Sk] fp32 (null = none): head bh = b*N + n
// reads row (bh / bias_div) % bias_rows, which maps every broadcast form
// of the reference straight onto the caller's heads ([Sq, Sk] -> row 0,
// [B, 1, ..] -> bh / N, [B, N, ..] -> bh, [1, N, ..] -> bh % N). The TPU
// kernel swaps B and N for the per-head form so that heads sharing a row
// are consecutive on its sequential grid; CUDA blocks run in no order, so
// no swap is needed, and the dropout hash keeps the caller's head index.
// Each thread reads its own row's bias entries from global memory (the
// four threads of a row read the same address; a warp's eight rows are
// eight sectors); bias = false is the instantiation without it, the same
// arithmetic as before the bias was added.
//
// Bound on this card: operations. At the prefill shape (12 heads,
// T = 1024, D = 64, causal) the kernel moves ~13 MB but does
// 4 * D * T(T+1)/2 * 12 = 1.6 GFLOP of fp32 multiply-adds: ~24 us at the
// 67 TFLOP/s of non-tensor fp32 against ~4 us for the bytes at 3.35 TB/s
// (data-sheet peaks of the NVIDIA H100 80GB HBM3 at 700.00 W). fp32
// operands cannot use the tensor cores' full rate (TF32 would round the
// inputs), so this first version stays on the CUDA cores and attacks the
// other costs instead:
//   - the [S, S] scores never reach device memory: one block owns a
//     64-row query tile and sweeps key tiles with an online softmax;
//   - each K/V tile is staged once into shared memory (64 x D fp32 each,
//     16 KB at D = 64) and read by all 64 rows of the block;
//   - under `causal` the whole key tiles above the diagonal are skipped,
//     which halves the work at T = 1024;
//   - four threads share a query row (flash_common.cuh).
// The dropout hash costs ~10 integer operations per (row, key) and
// thread; each of a row's four threads computes it, which is simpler
// than sharing the bits and cheaper than storing a mask.
// The bf16 and fp16 forms (the AMP train step) widen q/k/v to fp32 on
// load into the same fp32 tiles, round p to T before the P.V product as
// the reference does, and store o in T: the same scalar arithmetic, half
// the bytes. A tensor-core (wgmma or mma.sync) version of the bf16 form
// with TMA-fed pipelined tiles is the later fast design.

#include "flash_common.cuh"

namespace {

using namespace flash;

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

// Returns a cudaError_t: 0 on a successful launch. The launch is
// asynchronous on `stream`; nothing is allocated or synchronised here.
// `dropout` 0 ignores seed, thresh and keep_prob; otherwise `seed` is the
// 23-bit normalized seed, `thresh` the keep threshold and `keep_prob`
// 1 - rate (as fp32). `bias` null means no general bias; otherwise head
// bh reads its row (bh / bias_div) % bias_rows. q/k/v/o are T; key_bias,
// bias and lse fp32. `d` is 32, 64 or 128: the wrapper zero-pads any
// other head dim up to one of these.
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
  switch (d) {
    case 32:
      return (int)launch<T, 32, 64>(a, bh, dropout, s);
    case 64:
      return (int)launch<T, 64, 64>(a, bh, dropout, s);
    case 128:
      return (int)launch<T, 128, 32>(a, bh, dropout, s);
    default:
      return (int)cudaErrorInvalidValue;
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
