// Single-query (decode-mode) attention over a PAGED KV pool, fp32, written
// by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_paged_kernel`
// (paddle_tpu/kernels/flash_attention.py:459, launched by
// `flash_decode_paged_attention` at :590): one new token per (slot, head)
// attends over that slot's logical K/V row, which lives in the shared
// pool as the blocks its block table names.
//
//   o = softmax(q . K^T * scale + key_bias) V,
//   K row j of slot b = k_pool[tables[b, j / blk], head, j % blk, :]
//
// Layout: q/o [BH, D] with BH = B * heads; k_pool/v_pool [blocks, heads,
// blk, D]; tables [B, max_blocks] int32; key_bias [BH / bias_heads, S]
// with S = max_blocks * blk (head bh reads row bh / bias_heads, so the
// engine's [slots, S] bias is read as it is); a null key_bias means no
// bias. All fp32 (tables int32), contiguous; D any multiple of 8 up to
// 128 (one instantiation each; D/4 threads per key row, padded to a power
// of two with idle lanes). There is no causal flag: the
// key bias carries all masking, including the garbage that sink blocks
// and not-yet-written positions hold (-1e4 there). A fully masked slot
// still gets a finite softmax over garbage, which the caller ignores.
//
// On the TPU the indirection lives in the BlockSpec index maps (the table
// rides scalar prefetch and each DMA pulls one physical block), with a
// sequential grid over logical blocks and the softmax state in VMEM. Here
// a block loads its own indices: the slot's table row is staged in shared
// memory once, and every key row address is computed from it with 64-bit
// arithmetic, so a pool past 2^31 floats (a few thousand GPT-2 blocks of
// 64 positions) stays addressable. Table entries are clamped to the
// pool, as the reference's gather clamps.
//
// Bound on this card: bytes, as for `flash_decode`. At the serving shape
// (8 slots, 12 heads, 64 blocks of 16 positions, D = 64) one layer's step
// reads 50 MB of K/V against ~0.2 us of arithmetic. The design keeps the
// contiguous kernel's load pattern: one block per (slot, head), D/4
// threads per key row with one float4 each (a block of `blk` consecutive
// rows is contiguous in the pool, so a warp still reads whole 256-byte
// rows), four keys in flight per thread group, partial online-softmax
// states (m, l, acc) per group merged through shared memory at the end.
// Split-K and TMA are later work.

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
flash_decode_paged_kernel(const float* __restrict__ q,
                          const float* __restrict__ k_pool,
                          const float* __restrict__ v_pool,
                          const int* __restrict__ tables,
                          const float* __restrict__ kb, float* __restrict__ o,
                          int heads, int bias_heads, int max_blocks, int blk,
                          int pool_blocks, float scale) {
  constexpr int kVecs = D / 4;                // float4s per key row
  // threads per key row: D/4, padded to a power of two (D = 24, 40, 48,
  // ...); the padding lanes hold zeros and store nothing
  constexpr int kLanes = pow2_at_least(kVecs);
  constexpr int kGroups = kThreads / kLanes;  // key rows in flight per pass
  extern __shared__ int table_s[];            // [max_blocks]
  __shared__ float m_s[kGroups];
  __shared__ float l_s[kGroups];
  __shared__ float4 acc_s[kGroups][kLanes];

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int n = bh - b * heads;
  const int g = threadIdx.x / kLanes;
  const int lane = threadIdx.x - g * kLanes;
  const bool lane_ok = kVecs == kLanes || lane < kVecs;
  const int s_len = max_blocks * blk;

  const int* trow = tables + (size_t)b * max_blocks;
  for (int i = threadIdx.x; i < max_blocks; i += kThreads) {
    table_s[i] = min(max(__ldg(trow + i), 0), pool_blocks - 1);
  }
  __syncthreads();

  const float4 qv =
      lane_ok ? __ldg(reinterpret_cast<const float4*>(q + (size_t)bh * D) + lane)
              : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* kp = reinterpret_cast<const float4*>(k_pool);
  const float4* vp = reinterpret_cast<const float4*>(v_pool);
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
        const int lb = j / blk;
        // float4 index of (pool block, head n, in-block row, lane)
        const size_t row = ((size_t)table_s[lb] * heads + n) * blk + (j - lb * blk);
        kk[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        vv[u] = kk[u];
        if (lane_ok) {
          kk[u] = __ldg(kp + row * kVecs + lane);
          vv[u] = __ldg(vp + row * kVecs + lane);
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
cudaError_t launch(const float* q, const float* k_pool, const float* v_pool,
                   const int* tables, const float* kb, float* o, int bh,
                   int heads, int bias_heads, int max_blocks, int blk,
                   int pool_blocks, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)max_blocks * sizeof(int);
  flash_decode_paged_kernel<D><<<bh, kThreads, smem, stream>>>(
      q, k_pool, v_pool, tables, kb, o, heads, bias_heads, max_blocks, blk,
      pool_blocks, scale);
  return cudaGetLastError();
}

// The instantiation for head dim d: every multiple of 8 from 8 to 128
// (one per width, as padding would copy the whole cache every step).
template <int D>
cudaError_t launch_d(int d, const float* q, const float* k_pool,
                     const float* v_pool, const int* tables,
                     const float* kb, float* o, int bh, int heads,
                     int bias_heads, int max_blocks, int blk,
                     int pool_blocks, float scale, cudaStream_t stream) {
  if (d == D) {
    return launch<D>(q, k_pool, v_pool, tables, kb, o, bh, heads,
                     bias_heads, max_blocks, blk, pool_blocks, scale, stream);
  }
  if constexpr (D < 128) {
    return launch_d<D + 8>(d, q, k_pool, v_pool, tables, kb, o, bh, heads,
                           bias_heads, max_blocks, blk, pool_blocks, scale,
                           stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns a cudaError_t: 0 on a successful launch. The launch is
// asynchronous on `stream`; nothing is allocated or synchronised here.
int paddle_flash_decode_paged_f32(const void* q, const void* k_pool,
                                  const void* v_pool, const void* tables,
                                  const void* key_bias, void* o, int bh,
                                  int heads, int bias_heads, int max_blocks,
                                  int blk, int pool_blocks, int d, float scale,
                                  void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads != 0 || bias_heads <= 0 ||
      bh % bias_heads != 0 || max_blocks <= 0 || blk <= 0 ||
      pool_blocks <= 0 || (long long)max_blocks * blk > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_pool);
  const float* vf = static_cast<const float*>(v_pool);
  const int* tf = static_cast<const int*>(tables);
  const float* bf = static_cast<const float*>(key_bias);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)launch_d<8>(d, qf, kf, vf, tf, bf, of, bh, heads, bias_heads,
                          max_blocks, blk, pool_blocks, scale, s);
}

const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
