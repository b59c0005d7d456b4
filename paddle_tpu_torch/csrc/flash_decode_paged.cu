// Single-query (decode-mode) attention over a PAGED KV pool, fp32, bf16
// and fp16, written by hand for Hopper (sm_90a).
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
// bias. q, the pools and o in the element type T (fp32, bf16 or fp16),
// key_bias fp32, tables int32, all contiguous; any D from 1 to 256 (every
// multiple of 8 its own instantiation with D/4 threads per key row,
// padded to a power of two with idle lanes; any other D one instantiation
// that takes D at run time and reads element by element). As in
// flash_decode.cu, scores and sums are fp32 and in bf16 and fp16 the
// running p rounds to T before P.V (the reference's :492); the fp32
// instantiations keep their arithmetic. There is no causal flag: the
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
// threads per key row with four elements each (D/8 threads with two
// pieces past D = 128; flash_common.cuh) (a block of `blk` consecutive
// rows is contiguous in the pool, so a warp still reads whole 256-byte
// rows), four keys in flight per thread group (16-bit pieces loaded raw
// and widened where they are used, as there), partial online-softmax
// states (m, l, acc) per group merged through shared memory at the end.
// Split-K and TMA are later work.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kUnroll = 4;   // keys per thread group per iteration

// D > 0: the head dim, a multiple of 8. D = 0: any head dim, `d_rt` at
// run time, with the threads per key row (`lanes_rt`, a power of two >=
// d_rt / 4) from the host.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_paged_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool,
                          const int* __restrict__ tables,
                          const float* __restrict__ kb, T* __restrict__ o,
                          int heads, int bias_heads, int max_blocks, int blk,
                          int pool_blocks, float scale, int d_rt,
                          int lanes_rt) {
  constexpr int kP = decode_pieces(D);        // pieces a lane holds
  // threads per key row: D/4 (D/8 past 128), padded to a power of two (D
  // = 24, 40, 48, ...); the padding lanes hold zeros and store nothing
  constexpr int kLanes = D > 0 ? decode_lanes(D) : 1;
  const int d = D > 0 ? D : d_rt;
  const int lanes = D > 0 ? kLanes : lanes_rt;
  const int groups = kThreads / lanes;        // key rows in flight per pass
  extern __shared__ int table_s[];            // [max_blocks]
  __shared__ float m_s[kThreads];
  __shared__ float l_s[kThreads];
  __shared__ float4 acc_s[kP][kThreads];      // [piece][groups][lanes]

  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int n = bh - b * heads;
  const int g = threadIdx.x / lanes;
  const int lane = threadIdx.x - g * lanes;
  // elements of the row in each of the lane's pieces (<= 0: none)
  int rem[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) rem[p] = d - 4 * (p * lanes + lane);
  const int s_len = max_blocks * blk;

  const int* trow = tables + (size_t)b * max_blocks;
  for (int i = threadIdx.x; i < max_blocks; i += kThreads) {
    table_s[i] = min(max(__ldg(trow + i), 0), pool_blocks - 1);
  }
  __syncthreads();

  float4 qv[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    qv[p] = rem[p] > 0 ? load_piece<T, D>(q + (size_t)bh * d + d - rem[p], rem[p])
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
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
        const int lb = j / blk;
        // row index of (pool block, head n, in-block row)
        const size_t row = ((size_t)table_s[lb] * heads + n) * blk + (j - lb * blk);
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          kk[u][p] = RawPiece<T, D>{};
          vv[u][p] = kk[u][p];
          if (rem[p] > 0) {
            kk[u][p] = load_raw<T, D>(k_pool + row * d + d - rem[p], rem[p]);
            vv[u][p] = load_raw<T, D>(v_pool + row * d + d - rem[p], rem[p]);
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
  const T *q, *k_pool, *v_pool;
  const int* tables;
  const float* kb;
  T* o;
  int bh, heads, bias_heads, max_blocks, blk, pool_blocks, d;
  float scale;
};

template <typename T, int D>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.max_blocks * sizeof(int);
  const int lanes = D > 0 ? 0 : decode_lanes(a.d);
  flash_decode_paged_kernel<T, D><<<a.bh, kThreads, smem, stream>>>(
      a.q, a.k_pool, a.v_pool, a.tables, a.kb, a.o, a.heads, a.bias_heads,
      a.max_blocks, a.blk, a.pool_blocks, a.scale, a.d, lanes);
  return cudaGetLastError();
}

// The instantiation for head dim d: every multiple of 8 from 8 to 256
// (one per width, as padding would copy the whole pool every step); any
// other d from 1 to 256 runs the run-time-D kernel.
template <typename T, int D>
cudaError_t launch_d(const Args<T>& a, cudaStream_t stream) {
  if (a.d == D) return launch<T, D>(a, stream);
  if constexpr (D < 256) return launch_d<T, D + 8>(a, stream);
  return launch<T, 0>(a, stream);
}

// Returns a cudaError_t: 0 on a successful launch. The launch is
// asynchronous on `stream`; nothing is allocated or synchronised here.
// q, the pools and o are T; key_bias fp32; tables int32.
template <typename T>
int flash_decode_paged(const void* q, const void* k_pool, const void* v_pool,
                       const void* tables, const void* key_bias, void* o,
                       int bh, int heads, int bias_heads, int max_blocks,
                       int blk, int pool_blocks, int d, float scale,
                       void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads != 0 || bias_heads <= 0 ||
      bh % bias_heads != 0 || max_blocks <= 0 || blk <= 0 ||
      pool_blocks <= 0 || (long long)max_blocks * blk > 0x7fffffffLL ||
      d <= 0 || d > 256) {
    return (int)cudaErrorInvalidValue;
  }
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k_pool = static_cast<const T*>(k_pool);
  a.v_pool = static_cast<const T*>(v_pool);
  a.tables = static_cast<const int*>(tables);
  a.kb = static_cast<const float*>(key_bias);
  a.o = static_cast<T*>(o);
  a.bh = bh;
  a.heads = heads;
  a.bias_heads = bias_heads;
  a.max_blocks = max_blocks;
  a.blk = blk;
  a.pool_blocks = pool_blocks;
  a.d = d;
  a.scale = scale;
  return (int)launch_d<T, 8>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

FLASH_ENTRY_POINTS(
    paddle_flash_decode_paged, flash_decode_paged,
    (const void* q, const void* k_pool, const void* v_pool,
     const void* tables, const void* key_bias, void* o, int bh, int heads,
     int bias_heads, int max_blocks, int blk, int pool_blocks, int d,
     float scale, void* stream),
    (q, k_pool, v_pool, tables, key_bias, o, bh, heads, bias_heads,
     max_blocks, blk, pool_blocks, d, scale, stream))

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
