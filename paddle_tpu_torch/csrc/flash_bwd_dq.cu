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
// Two kernels, one per element type:
//
// fp32: `flash_bwd_dq_kernel`, on the CUDA cores. Bound: operations. Per
// (query, key) pair it does two dot products over D (scores, dO V^T) and
// one D-wide axpy (dq): 6D flops, 0.29 ms at the training shape [8, 12,
// 1024, 64] causal (50 M pairs) against 67 TFLOP/s of non-tensor fp32,
// while it moves ~126 MB (q, k, v, dO in, dq out: 0.04 ms at 3.35 TB/s).
// The K/V tile is staged once in shared memory for the block's 64 rows;
// four threads share a query row and hold its q, dO and dq parts in
// registers (flash_common.cuh).
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

// The fp32 kernel. T is kept as a parameter so that the launch code is
// shared with the tensor-core form, but only fp32 instantiates it (the
// static_assert below); its round_to<T> points are then the identity.
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
  static_assert(std::is_same<T, float>::value,
                "bf16/fp16 run the tensor-core kernel");
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

// The tensor-core kernel (bf16, fp16): 4 warps; kSplit warps share 16
// query rows, each accumulating D / kSplit columns of dq.
using flash::mma::kLog2e;
using flash::mma::kMmaThreads;
using flash::mma::kMmaWarps;

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
// runs the CUDA-core kernel, bf16 and fp16 the tensor-core one.
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
