// Single-query (decode-mode) attention, fp32, bf16 and fp16, written by
// hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (paddle_tpu/kernels/flash_attention.py:363, launched by
// `flash_decode_attention` at :438): one new token per (slot, head)
// attends over that slot's contiguous K/V cache row.
//
//   o = softmax(q . K^T * scale + key_bias) V
//
// Layout: q/o [BH, D], k/v [BH, S, D] in the element type T (fp32, bf16
// or fp16: one for all three and o), contiguous; any D from 1 to 256:
// every multiple of 8 has its own instantiation, any other D runs one
// instantiation that takes D at run time. key_bias (fp32) is
// [BH / bias_heads, S]: head bh reads row bh / bias_heads, so the
// engine's [slots, S] bias (bias_heads = heads) is read as it is, with no
// per-head copy; a null key_bias means no bias. There is no causal flag:
// the key bias carries all masking
// (-1e4 past each slot's live length), so one launch serves every mix of
// slot lengths. No lse, forward only. Scores, p, l and the P.V sums are
// fp32; in bf16 and fp16 the running (unnormalised) p rounds to T before
// it multiplies V, as the reference's p.astype(v.dtype) (:389), and o is
// stored in T. The fp32 instantiations are the arithmetic the kernel had
// before the other types were added, statement for statement.
//
// Bound on this card: bytes. Every cached K and V row is read once and
// used for two multiply-adds per element. At the serving shape (8 slots,
// 12 heads, S = 1024, D = 64) one layer's step streams
// 2 * 8 * 12 * 1024 * 64 * 4 B = 50 MB of K/V: ~15 us at 3.35 TB/s
// against ~0.2 us of arithmetic at 67 TFLOP/s (data-sheet peaks of the
// NVIDIA H100 80GB HBM3 at 700.00 W). The design therefore aims at
// keeping enough loads in flight:
//   - one block per (slot, head); its 256 threads split the S cache
//     positions, D/4 threads per key row with four elements each (D/8
//     threads with two pieces past D = 128, so that a row stays within a
//     warp; flash_common.cuh), so a warp reads whole rows (coalesced, 16
//     bytes per thread in fp32, 8 in bf16 and fp16); where the thread
//     count is not a power of two (D = 24, 40, 48,
//     ...) the row's group is padded to the next one with idle lanes that
//     read nothing; a D off the multiples of 8 reads element by element;
//   - each thread issues the K and V loads of four keys before it uses
//     any of them, so every block keeps 32 KB of reads in flight (16 KB
//     in bf16 and fp16, whose pieces stay raw 16-bit vectors until the
//     products use them: widened between the loads, they would make
//     each load wait for the one before: 1.85x the time at the serving
//     shape on an NVIDIA H100 80GB HBM3);
//   - each thread group keeps a partial online-softmax state
//     (m, l, acc[D/4]) in registers, and one block-level merge through
//     shared memory combines the groups at the end.
// With 96 (slot, head) blocks the grid covers fewer than the 132 SMs; a
// split-K (flash-decoding) grid, which spreads each row over several
// blocks and merges partial states in a second pass, is the later fast
// design.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kUnroll = 4;   // keys per thread group per iteration

// D > 0: the head dim, a multiple of 8. D = 0: any head dim, `d_rt` at
// run time, with the threads per key row (`lanes_rt`, a power of two >=
// d_rt / 4) from the host.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const float* __restrict__ kb, T* __restrict__ o,
                    int bias_heads, int s_len, float scale, int d_rt,
                    int lanes_rt) {
  constexpr int kP = decode_pieces(D);        // pieces a lane holds
  // threads per key row: D/4 (D/8 past 128), padded to a power of two (D
  // = 24, 40, 48, ...); the padding lanes hold zeros and store nothing
  constexpr int kLanes = D > 0 ? decode_lanes(D) : 1;
  const int d = D > 0 ? D : d_rt;
  const int lanes = D > 0 ? kLanes : lanes_rt;
  const int groups = kThreads / lanes;        // key rows in flight per pass
  __shared__ float m_s[kThreads];
  __shared__ float l_s[kThreads];
  __shared__ float4 acc_s[kP][kThreads];      // [piece][groups][lanes]

  const int bh = blockIdx.x;
  const int g = threadIdx.x / lanes;
  const int lane = threadIdx.x - g * lanes;
  // elements of the row in each of the lane's pieces (<= 0: none)
  int rem[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) rem[p] = d - 4 * (p * lanes + lane);

  float4 qv[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    qv[p] = rem[p] > 0 ? load_piece<T, D>(q + (size_t)bh * d + d - rem[p], rem[p])
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const T* kp = k + (size_t)bh * s_len * d;
  const T* vp = v + (size_t)bh * s_len * d;
  const float* kbp = kb ? kb + (size_t)(bh / bias_heads) * s_len : nullptr;

  float m = kNeg;
  float l = 0.f;
  float4 acc[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) acc[p] = make_float4(0.f, 0.f, 0.f, 0.f);

  // every thread runs the same number of passes (the shuffles below
  // need the whole warp); out-of-range keys are skipped per group
  for (int base = 0; base < s_len; base += groups * kUnroll) {
    RawPiece<T, D> kk[kUnroll][kP];
    RawPiece<T, D> vv[kUnroll][kP];
    float bb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * groups + g;
      if (j < s_len) {
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          kk[u][p] = RawPiece<T, D>{};
          vv[u][p] = kk[u][p];
          if (rem[p] > 0) {
            kk[u][p] = load_raw<T, D>(kp + (size_t)j * d + d - rem[p], rem[p]);
            vv[u][p] = load_raw<T, D>(vp + (size_t)j * d + d - rem[p], rem[p]);
          }
        }
        bb[u] = kbp ? __ldg(kbp + j) : 0.f;
      } else {
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          kk[u][p] = RawPiece<T, D>{};
          vv[u][p] = kk[u][p];
        }
        bb[u] = kNeg;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = dot4(qv[0], widen_piece<T, D>(kk[u][0]));
#pragma unroll
      for (int p = 1; p < kP; ++p) {
        part += dot4(qv[p], widen_piece<T, D>(kk[u][p]));
      }
      if constexpr (D > 0) {
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1) {
          part += __shfl_xor_sync(0xffffffffu, part, off);
        }
      } else {
        for (int off = lanes / 2; off > 0; off >>= 1) {
          part += __shfl_xor_sync(0xffffffffu, part, off);
        }
      }
      if (base + u * groups + g < s_len) {
        const float sj = part * scale + bb[u];
        const float m_new = fmaxf(m, sj);
        const float alpha = expf(m - m_new);
        const float p = expf(sj - m_new);
        l = l * alpha + p;
        // p rounds to the value type for the P.V product (the identity
        // in fp32)
        const float pr = round_to<T>(p);
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const float4 vw = widen_piece<T, D>(vv[u][p]);
          acc[p].x = acc[p].x * alpha + pr * vw.x;
          acc[p].y = acc[p].y * alpha + pr * vw.y;
          acc[p].z = acc[p].z * alpha + pr * vw.z;
          acc[p].w = acc[p].w * alpha + pr * vw.w;
        }
        m = m_new;
      }
    }
  }

#pragma unroll
  for (int p = 0; p < kP; ++p) acc_s[p][threadIdx.x] = acc[p];
  if (lane == 0) {
    m_s[g] = m;
    l_s[g] = l;
  }
  __syncthreads();

  // merge the group states, one thread per (piece, lane) that holds part
  // of the row: rescale each group's state to the block-wide max
  const int idx = threadIdx.x;  // element 4 idx of the row
  if (4 * idx < d && idx < kP * lanes) {
    const int p = idx / lanes;
    const int ln = idx - p * lanes;
    float m_all = kNeg;
#pragma unroll 4
    for (int i = 0; i < groups; ++i) m_all = fmaxf(m_all, m_s[i]);
    float l_all = 0.f;
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = 0; i < groups; ++i) {
      const float w = expf(m_s[i] - m_all);
      l_all += l_s[i] * w;
      const float4 a = acc_s[p][i * lanes + ln];
      out.x += a.x * w;
      out.y += a.y * w;
      out.z += a.z * w;
      out.w += a.w * w;
    }
    const float l_safe = fmaxf(l_all, 1e-30f);
    store_piece<T, D>(o + (size_t)bh * d + 4 * idx,
                      make_float4(out.x / l_safe, out.y / l_safe,
                                  out.z / l_safe, out.w / l_safe),
                      d - 4 * idx);
  }
}

template <typename T>
struct Args {
  const T *q, *k, *v;
  const float* kb;
  T* o;
  int bh, bias_heads, s_len, d;
  float scale;
};

template <typename T, int D>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  const int lanes = D > 0 ? 0 : decode_lanes(a.d);
  flash_decode_kernel<T, D><<<a.bh, kThreads, 0, stream>>>(
      a.q, a.k, a.v, a.kb, a.o, a.bias_heads, a.s_len, a.scale, a.d, lanes);
  return cudaGetLastError();
}

// The instantiation for head dim d: every multiple of 8 from 8 to 256
// (one per width, as padding would copy the whole cache every step); any
// other d from 1 to 256 runs the run-time-D kernel.
template <typename T, int D>
cudaError_t launch_d(const Args<T>& a, cudaStream_t stream) {
  if (a.d == D) return launch<T, D>(a, stream);
  if constexpr (D < 256) return launch_d<T, D + 8>(a, stream);
  return launch<T, 0>(a, stream);
}

// Returns a cudaError_t: 0 on a successful launch. The launch is
// asynchronous on `stream`; nothing is allocated or synchronised here.
// q/k/v/o are T, key_bias fp32.
template <typename T>
int flash_decode(const void* q, const void* k, const void* v,
                 const void* key_bias, void* o, int bh, int bias_heads,
                 int s_len, int d, float scale, void* stream) {
  if (bh <= 0 || s_len <= 0 || bias_heads <= 0 || bh % bias_heads != 0 ||
      d <= 0 || d > 256) {
    return (int)cudaErrorInvalidValue;
  }
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.kb = static_cast<const float*>(key_bias);
  a.o = static_cast<T*>(o);
  a.bh = bh;
  a.bias_heads = bias_heads;
  a.s_len = s_len;
  a.d = d;
  a.scale = scale;
  return (int)launch_d<T, 8>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

FLASH_ENTRY_POINTS(
    paddle_flash_decode, flash_decode,
    (const void* q, const void* k, const void* v, const void* key_bias,
     void* o, int bh, int bias_heads, int s_len, int d, float scale,
     void* stream),
    (q, k, v, key_bias, o, bh, bias_heads, s_len, d, scale, stream))

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
