// Single-query (decode-mode) attention, fp32, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (paddle_tpu/kernels/flash_attention.py:363, launched by
// `flash_decode_attention` at :438): one new token per (slot, head)
// attends over that slot's contiguous K/V cache row.
//
//   o = softmax(q . K^T * scale + key_bias) V
//
// Layout: q/o [BH, D], k/v [BH, S, D], fp32, contiguous, D any multiple
// of 8 up to 128 (one instantiation each). key_bias is
// [BH / bias_heads, S]: head bh reads row bh / bias_heads, so the
// engine's [slots, S] bias (bias_heads = heads) is read as it is, with no
// per-head copy; a null key_bias means no bias. There is no causal flag:
// the key bias carries all masking
// (-1e4 past each slot's live length), so one launch serves every mix of
// slot lengths. No lse, forward only.
//
// Bound on this card: bytes. Every cached K and V row is read once and
// used for two multiply-adds per element. At the serving shape (8 slots,
// 12 heads, S = 1024, D = 64) one layer's step streams
// 2 * 8 * 12 * 1024 * 64 * 4 B = 50 MB of K/V: ~15 us at 3.35 TB/s
// against ~0.2 us of arithmetic at 67 TFLOP/s (data-sheet peaks of the
// NVIDIA H100 80GB HBM3 at 700.00 W). The design therefore aims at
// keeping enough loads in flight:
//   - one block per (slot, head); its 256 threads split the S cache
//     positions, D/4 threads per key row with one float4 each, so a warp
//     reads whole 256-byte rows (coalesced, 16 bytes per thread); where
//     D/4 is not a power of two (D = 24, 40, 48, ...) the row's group is
//     padded to the next one with idle lanes that read nothing;
//   - each thread issues the K and V loads of four keys before it uses
//     any of them, so every block keeps 32 KB of reads in flight;
//   - each thread group keeps a partial online-softmax state
//     (m, l, acc[D/4]) in registers, and one block-level merge through
//     shared memory combines the groups at the end.
// With 96 (slot, head) blocks the grid covers fewer than the 132 SMs; a
// split-K (flash-decoding) grid, which spreads each row over several
// blocks and merges partial states in a second pass, is the later fast
// design.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // keys per thread group per iteration

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// The smallest power of two >= n: the shuffle reduction over a key row's
// threads needs a power-of-two group.
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ kb, float* __restrict__ o,
                    int bias_heads, int s_len, float scale) {
  constexpr int kVecs = D / 4;                // float4s per key row
  // threads per key row: D/4, padded to a power of two (D = 24, 40, 48,
  // ...); the padding lanes hold zeros and store nothing
  constexpr int kLanes = pow2_at_least(kVecs);
  constexpr int kGroups = kThreads / kLanes;  // key rows in flight per pass
  __shared__ float m_s[kGroups];
  __shared__ float l_s[kGroups];
  __shared__ float4 acc_s[kGroups][kLanes];

  const int bh = blockIdx.x;
  const int g = threadIdx.x / kLanes;
  const int lane = threadIdx.x - g * kLanes;
  const bool lane_ok = kVecs == kLanes || lane < kVecs;

  const float4 qv =
      lane_ok ? __ldg(reinterpret_cast<const float4*>(q + (size_t)bh * D) + lane)
              : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* kp = reinterpret_cast<const float4*>(k + (size_t)bh * s_len * D);
  const float4* vp = reinterpret_cast<const float4*>(v + (size_t)bh * s_len * D);
  const float* kbp = kb ? kb + (size_t)(bh / bias_heads) * s_len : nullptr;

  float m = kNeg;
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);

  // every thread runs the same number of passes (the shuffles below
  // need the whole warp); out-of-range keys are skipped per group
  for (int base = 0; base < s_len; base += kGroups * kUnroll) {
    float4 kk[kUnroll];
    float4 vv[kUnroll];
    float bb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kGroups + g;
      if (j < s_len) {
        kk[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        vv[u] = kk[u];
        if (lane_ok) {
          kk[u] = __ldg(kp + (size_t)j * kVecs + lane);
          vv[u] = __ldg(vp + (size_t)j * kVecs + lane);
        }
        bb[u] = kbp ? __ldg(kbp + j) : 0.f;
      } else {
        kk[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        vv[u] = kk[u];
        bb[u] = kNeg;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = dot4(qv, kk[u]);
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      if (base + u * kGroups + g < s_len) {
        const float sj = part * scale + bb[u];
        const float m_new = fmaxf(m, sj);
        const float alpha = expf(m - m_new);
        const float p = expf(sj - m_new);
        l = l * alpha + p;
        acc.x = acc.x * alpha + p * vv[u].x;
        acc.y = acc.y * alpha + p * vv[u].y;
        acc.z = acc.z * alpha + p * vv[u].z;
        acc.w = acc.w * alpha + p * vv[u].w;
        m = m_new;
      }
    }
  }

  acc_s[g][lane] = acc;
  if (lane == 0) {
    m_s[g] = m;
    l_s[g] = l;
  }
  __syncthreads();

  // merge the group states: rescale each to the block-wide max
  if (threadIdx.x < kVecs) {
    float m_all = kNeg;
#pragma unroll 4
    for (int i = 0; i < kGroups; ++i) m_all = fmaxf(m_all, m_s[i]);
    float l_all = 0.f;
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = 0; i < kGroups; ++i) {
      const float w = expf(m_s[i] - m_all);
      l_all += l_s[i] * w;
      const float4 a = acc_s[i][threadIdx.x];
      out.x += a.x * w;
      out.y += a.y * w;
      out.z += a.z * w;
      out.w += a.w * w;
    }
    const float l_safe = fmaxf(l_all, 1e-30f);
    reinterpret_cast<float4*>(o + (size_t)bh * D)[threadIdx.x] =
        make_float4(out.x / l_safe, out.y / l_safe, out.z / l_safe,
                    out.w / l_safe);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* kb, float* o, int bh, int bias_heads,
                   int s_len, float scale, cudaStream_t stream) {
  flash_decode_kernel<D><<<bh, kThreads, 0, stream>>>(q, k, v, kb, o,
                                                      bias_heads, s_len, scale);
  return cudaGetLastError();
}

// The instantiation for head dim d: every multiple of 8 from 8 to 128
// (one per width, as padding would copy the whole cache every step).
template <int D>
cudaError_t launch_d(int d, const float* q, const float* k, const float* v,
                     const float* kb, float* o, int bh, int bias_heads,
                     int s_len, float scale, cudaStream_t stream) {
  if (d == D) {
    return launch<D>(q, k, v, kb, o, bh, bias_heads, s_len, scale, stream);
  }
  if constexpr (D < 128) {
    return launch_d<D + 8>(d, q, k, v, kb, o, bh, bias_heads, s_len, scale,
                           stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. The launch is
// asynchronous on `stream`; nothing is allocated or synchronised here.
int paddle_flash_decode_f32(const void* q, const void* k, const void* v,
                            const void* key_bias, void* o, int bh,
                            int bias_heads, int s_len, int d, float scale,
                            void* stream) {
  if (bh <= 0 || s_len <= 0 || bias_heads <= 0 || bh % bias_heads != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bf = static_cast<const float*>(key_bias);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_d<8>(d, qf, kf, vf, bf, of, bh, bias_heads, s_len,
                          scale, s);
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
