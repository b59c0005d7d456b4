// Flash-attention backward, dK / dV / d(key bias), fp32, bf16 and fp16,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_dkv_kernel`
// (paddle_tpu/kernels/flash_attention.py:262, launched by
// `_flash_bwd_core` at :856 behind `flash_attention_bwd_from_residuals`)
// with the causal flag, the hash dropout, the key bias and the general
// bias [G, Sq, Sk] with its gradient dbias, summed over the heads that
// share a bias row: the GPT train step's backward and that of
// `fluid.layers.flash_attention(bias=...)`.
//
//   p    = exp(s - lse)                  s: the forward's masked scores
//   dp   = keep o (dO V^T) / (1 - rate)
//   ds   = p o (dp - delta)
//   dk   = scale * sum_q ds^T Q
//   dv   = sum_q (keep o p / (1 - rate))^T dO
//   dkb  = sum_q ds                      (per head and key: [BH, Sk])
//   dbias[row(bh)] += ds                  (per bias row: [G, Sq, Sk])
//
// One block owns a (head, 64-row key tile) and sweeps the query tiles in
// a loop; under `causal` it starts at the tile holding its first key row.
// On the TPU the grid runs in order; here blocks run in parallel in no
// order, and nothing carries over between them: every block writes only
// its own dk/dv/dkb rows, so those need no atomics. Four threads share a
// key row and hold its k, v, dk and dv parts in registers
// (flash_common.cuh); the query tile (Q and dO rows, lse, delta) is
// staged once in shared memory for the block's 64 key rows.
//
// Layout: q/dout [BH, Sq, D], k/v/dk/dv [BH, Sk, D] in the element type T
// (fp32, bf16 or fp16; flash_common.cuh), lse/delta [BH, Sq], key_bias
// [BH / bias_heads, Sk] (null = none), dkb [BH, Sk], bias and dbias
// [G, Sq, Sk] with head bh on row (bh / bias_div) % bias_rows (null =
// none; see flash_fwd.cu), those fp32; all contiguous. In bf16 and fp16,
// keep*p/keep rounds to T before the P^T.dO product and ds before the
// ds^T.Q product, as the reference's kernel rounds them; dk and dv are
// stored in T, while dkey_bias and dbias sum the unrounded fp32 ds.
//
// dbias. The TPU kernel runs its grid transposed (heads innermost) so
// that the heads sharing a bias row revisit its gradient block in order;
// here the blocks of those heads run at the same time. When every head
// owns its row (G = BH), each (row, query, key) entry belongs to one
// thread of one block and is stored plainly. When heads share a row, the
// thread adds its ds with a float atomicAdd into dbias, which the wrapper
// zeroes first (causal tiles the kernel skips must read 0, as the
// reference's ds = 0 there gives); masked causal entries add nothing.
// The summation order over the sharing heads is then not fixed: results
// agree with the plain version to rounding, not bit for bit. The
// deterministic alternatives (one block per (row, key tile) looping over
// the heads, or a per-head scratch reduced afterwards) cost parallelism
// or memory and are later work.
//
// Bound on this card: operations. Per (query, key) pair: two dot
// products over D (scores, dO V^T) and two D-wide axpys (dk, dv): 8D
// flops, 0.39 ms at the training shape [8, 12, 1024, 64] causal (50 M
// pairs) against 67 TFLOP/s of non-tensor fp32, while it moves ~151 MB
// (q, k, v, dO in; dk, dv out: 0.05 ms at 3.35 TB/s).

#include "flash_common.cuh"

namespace {

using namespace flash;

// T: element type of q/k/v/dO/dk/dv. D: head dim (multiple of 16). BQ:
// query rows per shared-memory tile.
template <typename T, int D, int BQ, bool kDropout, bool kBias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ kb,
                     const float* __restrict__ bias,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, float* __restrict__ dkb,
                     float* __restrict__ dbias, int bias_heads, int bias_div,
                     int bias_rows, int dbias_atomic, int sq, int sk,
                     float scale, int causal, unsigned seed, unsigned thresh,
                     float inv_keep) {
  constexpr int kVec = D / 16;
  constexpr int kRow4 = D / 4;
  __shared__ float4 qs[BQ][kRow4];
  __shared__ float4 dos[BQ][kRow4];
  __shared__ float lses[BQ];
  __shared__ float deltas[BQ];

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTileRows;
  const int tid = threadIdx.x;
  const int lane = tid & (kRowThreads - 1);
  const int kj = k0 + tid / kRowThreads;
  const bool col_ok = kj < sk;
  const int col = col_ok ? kj : 0;   // key rows past Sk run on row 0's data
  const unsigned head_s = head_seed(seed, (unsigned)bh);

  const T* kp = k + ((size_t)bh * sk + col) * D;
  const T* vp = v + ((size_t)bh * sk + col) * D;
  float4 kr[kVec];
  float4 vr[kVec];
  float4 dk_acc[kVec];
  float4 dv_acc[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    kr[c] = load4(kp + 16 * c + 4 * lane);
    vr[c] = load4(vp + 16 * c + 4 * lane);
    dk_acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[c] = dk_acc[c];
  }
  float dkb_acc = 0.f;
  const float kb_j =
      kb ? __ldg(kb + (size_t)(bh / bias_heads) * sk + col) : 0.f;

  const T* qp = q + (size_t)bh * sq * D;
  const T* gp = dout + (size_t)bh * sq * D;
  const float* lp = lse + (size_t)bh * sq;
  const float* dlp = delta + (size_t)bh * sq;
  // this head's bias and dbias rows at key column `col`, stepped by sk
  const size_t bcol =
      kBias ? (size_t)((bh / bias_div) % bias_rows) * sq * sk + col : 0;
  // query tiles that end before the block's first key row are masked for
  // every key of the block: start at the tile holding row k0
  const int qstart = causal ? (k0 / BQ) * BQ : 0;

  for (int q0 = qstart; q0 < sq; q0 += BQ) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = tid; i < BQ * kRow4; i += kThreads) {
      const int r = i / kRow4;
      const int c = i - r * kRow4;
      const int qi = q0 + r;
      float4 qq = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 gg = qq;
      if (qi < sq) {
        qq = load4(qp + (size_t)qi * D + 4 * c);
        gg = load4(gp + (size_t)qi * D + 4 * c);
      }
      qs[r][c] = qq;
      dos[r][c] = gg;
    }
    for (int r = tid; r < BQ; r += kThreads) {
      const int qi = q0 + r;
      lses[r] = qi < sq ? __ldg(lp + qi) : 0.f;
      deltas[r] = qi < sq ? __ldg(dlp + qi) : 0.f;
    }
    __syncthreads();

#pragma unroll 8
    for (int r = 0; r < BQ; ++r) {
      float part_s = 0.f;
      float part_dp = 0.f;
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        part_s += dot4(kr[c], qs[r][4 * c + lane]);
        part_dp += dot4(vr[c], dos[r][4 * c + lane]);
      }
      part_s = group_sum(part_s);
      float dp = group_sum(part_dp);
      const int qi = q0 + r;
      float s = part_s * scale + kb_j;
      if (kBias && qi < sq) s += __ldg(bias + bcol + (size_t)qi * sk);
      const bool masked = !col_ok || (causal && kj > qi);
      if (masked) s = kNeg;
      // padded query rows (past Sq) contribute nothing, as the
      // reference's zero-padded rows do
      const float p = qi < sq ? expf(s - lses[r]) : 0.f;
      float pv = p;
      if (kDropout) {
        const bool keep =
            hash_keep(row_hash((unsigned)qi), (unsigned)kj, head_s, thresh);
        pv = keep ? p * inv_keep : 0.f;
        dp = keep ? dp * inv_keep : 0.f;
      }
      const float ds = p * (dp - deltas[r]);
      dkb_acc += ds;
      if (kBias && lane == 0 && qi < sq && col_ok) {
        float* dst = dbias + bcol + (size_t)qi * sk;
        if (!dbias_atomic) {
          *dst = ds;
        } else if (!masked) {
          atomicAdd(dst, ds);
        }
      }
      // the products' operands round to T, as the reference's kernel
      // rounds them for the MXU; the identity in fp32
      const float pv_t = round_to<T>(pv);
      const float ds_t = round_to<T>(ds);
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        axpy4(dv_acc[c], pv_t, dos[r][4 * c + lane]);
        axpy4(dk_acc[c], ds_t, qs[r][4 * c + lane]);
      }
    }
  }

  if (col_ok) {
    const size_t off = ((size_t)bh * sk + kj) * D;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      store4(dk + off + 16 * c + 4 * lane,
             make_float4(dk_acc[c].x * scale, dk_acc[c].y * scale,
                         dk_acc[c].z * scale, dk_acc[c].w * scale));
      store4(dv + off + 16 * c + 4 * lane, dv_acc[c]);
    }
    if (lane == 0) dkb[(size_t)bh * sk + kj] = dkb_acc;
  }
}

template <typename T>
struct Args {
  const T *q, *k, *v;
  const float *kb, *bias;
  const T* dout;
  const float *lse, *delta;
  T *dk, *dv;
  float *dkb, *dbias;
  int bias_heads, bias_div, bias_rows, dbias_atomic, sq, sk;
  float scale;
  int causal;
  unsigned seed, thresh;
  float inv_keep;
};

template <typename T, int D, int BQ, bool kDropout, bool kBias>
void launch_one(dim3 grid, const Args<T>& a, cudaStream_t stream) {
  flash_bwd_dkv_kernel<T, D, BQ, kDropout, kBias>
      <<<grid, kThreads, 0, stream>>>(
          a.q, a.k, a.v, a.kb, a.bias, a.dout, a.lse, a.delta, a.dk, a.dv,
          a.dkb, a.dbias, a.bias_heads, a.bias_div, a.bias_rows,
          a.dbias_atomic, a.sq, a.sk, a.scale, a.causal, a.seed, a.thresh,
          a.inv_keep);
}

template <typename T, int D, int BQ>
cudaError_t launch(const Args<T>& a, int bh, int dropout,
                   cudaStream_t stream) {
  dim3 grid((a.sk + kTileRows - 1) / kTileRows, bh);
  if (dropout) {
    if (a.bias) {
      launch_one<T, D, BQ, true, true>(grid, a, stream);
    } else {
      launch_one<T, D, BQ, true, false>(grid, a, stream);
    }
  } else {
    if (a.bias) {
      launch_one<T, D, BQ, false, true>(grid, a, stream);
    } else {
      launch_one<T, D, BQ, false, false>(grid, a, stream);
    }
  }
  return cudaGetLastError();
}

// Returns a cudaError_t: 0 on a successful launch (asynchronous on
// `stream`; nothing allocated or synchronised). `dropout` 0 ignores seed,
// thresh and inv_keep; otherwise `inv_keep` is 1 / (1 - rate) as fp32.
// `bias` null means no general bias and `dbias` is not touched; otherwise
// `dbias` [G, Sq, Sk] receives the bias gradient: stored when every head
// owns its row (bias_rows == bh, bias_div == 1), else added atomically,
// in which case the caller zeroes it first. q/k/v/dout/dk/dv are T; the
// rest fp32. `d` is 32, 64 or 128.
template <typename T>
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* key_bias, const void* bias, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv,
                  void* dkb, void* dbias, int bh, int bias_heads,
                  int bias_div, int bias_rows, int sq, int sk, int d,
                  float scale, int causal, int dropout, unsigned seed,
                  unsigned thresh, float inv_keep, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || bias_heads <= 0 ||
      bh % bias_heads != 0 || bias_div <= 0 || bias_rows <= 0 ||
      (bias != nullptr) != (dbias != nullptr)) {
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
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.dkb = static_cast<float*>(dkb);
  a.dbias = static_cast<float*>(dbias);
  a.bias_heads = bias_heads;
  a.bias_div = bias_div;
  a.bias_rows = bias_rows;
  a.dbias_atomic = !(bias_rows == bh && bias_div == 1);
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
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

FLASH_ENTRY_POINTS(
    paddle_flash_bwd_dkv, flash_bwd_dkv,
    (const void* q, const void* k, const void* v, const void* key_bias,
     const void* bias, const void* dout, const void* lse, const void* delta,
     void* dk, void* dv, void* dkb, void* dbias, int bh, int bias_heads,
     int bias_div, int bias_rows, int sq, int sk, int d, float scale,
     int causal, int dropout, unsigned seed, unsigned thresh,
     float inv_keep, void* stream),
    (q, k, v, key_bias, bias, dout, lse, delta, dk, dv, dkb, dbias, bh,
     bias_heads, bias_div, bias_rows, sq, sk, d, scale, causal, dropout,
     seed, thresh, inv_keep, stream))

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
