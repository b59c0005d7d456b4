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
// One block owns a (head, key tile) and sweeps the query tiles in a loop;
// under `causal` it starts at the tile holding its first key row. On the
// TPU the grid runs in order; here blocks run in parallel in no order,
// and nothing carries over between them: every block writes only its own
// dk/dv/dkb rows, so those need no atomics.
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
// Two kernels on the tensor cores, one per element type (flash_mma.cuh);
// dispatching by type is the design, not a fallback:
//
// fp32 (the fp32 train step): `flash_bwd_dkv_tf32_kernel`, split TF32. Bound
// at the fp32 train shape [8, 12, 1024, 64], causal (50 M pairs): two
// products over D (scores, dO V^T) and two over the queries (dk, dv), 8D
// flops a pair, 25.8 GFLOP; at the 67 TFLOP/s of fp32 on the CUDA cores that
// is 0.39 ms, as three TF32 products at 495 TFLOP/s 0.16 ms, against ~151 MB
// of q, k, v, dO, dk, dv, dkey_bias, lse and delta at 3.35 TB/s (0.05 ms).
// All four products are split TF32 as in the fp32 forward: S^T = K.Q^T,
// dP^T = V.dO^T, dV += (keep o p / (1 - rate))^T.dO and dK += ds^T.Q, with p
// and ds in fp32 (the fp32 reference rounds neither); each k-step's three
// products are summed from zero and added to the running sums on the CUDA
// cores, since dk and dv sum over up to 1024 queries and the train step's
// k-bias gradient is exactly sum_keys dk = 0: a biased sum shows there
// first. They run stage by stage across four n-tiles (`mma_3xtf32_n`), so
// that no product waits on the one before it. dkey_bias and dbias take the
// fp32 ds before any split. The rest is the bf16 kernel's design below, with
// fp32 tiles in one layout (`swz_tf32`): K and V come in once and are split
// once into big parts (in place) and small parts in shared memory; the block
// sweeps query tiles of 32 (16 from D = 128 on) in a two-stage `cp.async`
// ring with lse and delta beside them, each Q and dO tile split once for the
// block. Q and dO are each read in two roles (B operand over D of K.Q^T and
// V.dO^T, over the queries of ds^T.Q and p^T.dO); the k index order of
// flash_mma.cuh makes one conflict-free layout serve both, and the
// accumulators are the A fragments of the second pair as they are. A warp
// accumulates 64 of dk and dv's columns: at D = 128 two warps share 16 keys,
// at D = 256 four, so the block owns 64, 32 or 16 keys.
//
// bf16 and fp16 (the AMP train step): `flash_bwd_dkv_mma_kernel`, on the
// tensor cores (flash_mma.cuh). Bound at the AMP train shape: the same
// 25.8 GFLOP on the tensor cores at 989 TFLOP/s, 0.026 ms, against 75 MB
// at 3.35 TB/s (0.022 ms); the exp and the hash of every pair come next.
// A block of 4 warps owns 64 key rows (16 a warp; at D = 256 two warps
// share 16 keys, each accumulating half of dk and dv's columns, and the
// block owns 32). K and V come in once by `cp.async` and stay as A
// fragments (in shared memory past D = 64). The block sweeps query tiles
// of 64 (32 from D = 128 on), with Q and dO in a two-stage `cp.async`
// ring (swizzled for `ldmatrix`) and lse and delta staged beside them;
// per tile and warp:
//   S^T  = K Q^T and dP^T = V dO^T by `mma.sync.m16n8k16`, each thread
//          holding 2 keys x 16 queries of each;
//   p^T  = exp(s^T - lse[q]), the scores biased and masked as the forward
//          does; ds^T = p^T o (keep o dP^T / (1 - rate) - delta[q]), the
//          dropout hash on (query row, key col, bh): the transpose of the
//          fragment's own (row, col);
//   dV  += round_T(keep o p^T / (1 - rate)) dO and dK += round_T(ds^T) Q,
//          P and dS repacked from the accumulators as A fragments, dO and
//          Q by `ldmatrix.trans`;
//   dkey_bias sums the unrounded fp32 ds^T in registers across tiles (a
//          quad shuffle at the end); dbias is stored or added as above,
//          transposed from the ds^T layout.
// Under `causal` the sweep starts at the query tile holding the block's
// first key, and only tiles that cross the diagonal or a ragged end are
// masked. dk is scaled, and dk, dv stored in T, at the end.

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace flash;

using flash::mma::kLog2e;
using flash::mma::kMmaThreads;
using flash::mma::kMmaWarps;

// The split-TF32 kernel (fp32): 4 warps; kSplit warps share 16 keys, each
// accumulating 64 columns of dk and dv (D / kSplit; D = 32 all of them).
template <int D>
__host__ __device__ constexpr int tf32_split() {
  return D > 64 ? D / 64 : 1;
}

template <int D>
__host__ __device__ constexpr int tf32_keys() {  // key rows a block owns
  return 16 * kMmaWarps / tf32_split<D>();
}

template <int D>
__host__ __device__ constexpr int tf32_bq() {  // query rows per tile
  return D <= 64 ? 32 : 16;
}

// K and V in big and small parts, two stages of Q and dO, the small parts
// of one Q and dO tile, two stages of lse and delta
template <int D>
__host__ __device__ constexpr int tf32_smem_bytes() {
  return (4 * tf32_keys<D>() * D + 6 * tf32_bq<D>() * D) * 4 +
         4 * tf32_bq<D>() * 4;
}

template <int D, bool kDropout, bool kBias>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ kb,
    const float* __restrict__ bias, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dkb,
    float* __restrict__ dbias, int bias_heads, int bias_div, int bias_rows,
    int dbias_atomic, int sq, int sk, float scale, int causal, unsigned seed,
    unsigned thresh, float inv_keep) {
  using namespace flash::mma;
  constexpr int kSplit = tf32_split<D>();
  constexpr int kKeys = tf32_keys<D>();
  constexpr int BQ = tf32_bq<D>();
  constexpr int kDS = D / kSplit;  // dk/dv columns a warp accumulates
  constexpr int kKSteps = D / 8;   // k-steps of K.Q^T and V.dO^T
  constexpr int kNQ = BQ / 8;      // n-tiles of S^T and dP^T
  constexpr int kDP = kDS / 16;    // pairs of n-tiles of a warp's dk, dv
  constexpr int kNC = 4;  // n-tiles of dk or dv taken together
  extern __shared__ __align__(128) unsigned char smem[];
  float* kst = reinterpret_cast<float*>(smem);  // [kKeys][D], swz_tf32
  float* kss = kst + kKeys * D;                 // K's small parts
  float* vst = kss + kKeys * D;                 // [kKeys][D]
  float* vss = vst + kKeys * D;                 // V's small parts
  float* qs = vss + kKeys * D;                  // [2][BQ][D]
  float* dos = qs + 2 * BQ * D;                 // [2][BQ][D]
  float* qss = dos + 2 * BQ * D;                // [BQ][D], Q's small parts
  float* doss = qss + BQ * D;                   // [BQ][D], dO's small parts
  float* lses = doss + BQ * D;                  // [2][BQ]
  float* dels = lses + 2 * BQ;                  // [2][BQ]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kKeys;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int krow = (warp / kSplit) * 16;   // the warp's first key row
  const int dcol = (warp % kSplit) * kDS;  // its first dk/dv column
  const bool lead = warp % kSplit == 0;    // writes dkey_bias and dbias
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // the thread's two keys: accumulator elements 0, 1 and 2, 3
  const int keys[2] = {k0 + krow + g, k0 + krow + g + 8};
  const unsigned head_s = head_seed(seed, (unsigned)bh);
  float kbv[2];
  size_t bcol[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = min(keys[r], sk - 1);  // keys past Sk store nothing
    kbv[r] = kb ? __ldg(kb + (size_t)(bh / bias_heads) * sk + key) : 0.f;
    // this head's bias and dbias rows at column `key`, stepped by sk
    bcol[r] = kBias ? (size_t)((bh / bias_div) % bias_rows) * sq * sk + key
                    : 0;
  }

  const float* qp = q + (size_t)bh * sq * D;
  const float* gp = dout + (size_t)bh * sq * D;
  const float* lp = lse + (size_t)bh * sq;
  const float* dlp = delta + (size_t)bh * sq;
  // query tiles that end before the block's first key row are masked for
  // every key of the block: start at the tile holding row k0
  const int qstart = causal ? (k0 / BQ) * BQ : 0;
  const int ntiles = (sq - qstart + BQ - 1) / BQ;

  constexpr F32Layout kL = F32Layout::kTf32;
  auto load_queries = [&](int stage, int q0) {
    load_tile_f32<D, BQ, kMmaThreads, kL>(qs + stage * BQ * D, qp, q0, sq,
                                          tid);
    load_tile_f32<D, BQ, kMmaThreads, kL>(dos + stage * BQ * D, gp, q0, sq,
                                          tid);
    for (int i = tid; i < 2 * BQ; i += kMmaThreads) {
      const int r = i % BQ;
      const bool valid = q0 + r < sq;
      const float* src = (i < BQ ? lp : dlp) + (valid ? q0 + r : 0);
      cp_async4((i < BQ ? lses : dels) + stage * BQ + r, src, valid);
    }
  };
  load_tile_f32<D, kKeys, kMmaThreads, kL>(kst, k + (size_t)bh * sk * D, k0,
                                           sk, tid);
  load_tile_f32<D, kKeys, kMmaThreads, kL>(vst, v + (size_t)bh * sk * D, k0,
                                           sk, tid);
  load_queries(0, qstart);
  cp_async_commit();

  float dka[2 * kDP][4];
  float dva[2 * kDP][4];
#pragma unroll
  for (int j = 0; j < 2 * kDP; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
  }
  float dkb_acc[2] = {0.f, 0.f};  // this thread's part of dkey_bias

  for (int t = 0; t < ntiles; ++t) {
    const int q0 = qstart + t * BQ;
    const int stage = t & 1;
    if (t + 1 < ntiles) {
      // the stage it fills was last read in iteration t - 1, which ended
      // in a barrier
      load_queries(stage ^ 1, q0 + BQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qst = qs + stage * BQ * D;
    const float* dost = dos + stage * BQ * D;
    const float* ls = lses + stage * BQ;
    const float* dl = dels + stage * BQ;
    // every tile split once for the block: K and V on the first, Q and dO
    // on each (their small parts were last read before the last barrier)
    if (t == 0) {
      split_tile_tf32<D, kKeys, kMmaThreads>(kst, kss, tid);
      split_tile_tf32<D, kKeys, kMmaThreads>(vst, vss, tid);
    }
    split_tile_tf32<D, BQ, kMmaThreads>(qs + stage * BQ * D, qss, tid);
    split_tile_tf32<D, BQ, kMmaThreads>(dos + stage * BQ * D, doss, tid);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T in split TF32
    float st[kNQ][4];
    float dpt[kNQ][4];
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      unsigned akb[4], aks[4], avb[4], avs[4];
      frag_a_tf32<D>(akb, aks, kst, kss, krow, 8 * kk, g, t4);
      frag_a_tf32<D>(avb, avs, vst, vss, krow, 8 * kk, g, t4);
      uint2 qb2[kNQ], qs2[kNQ], gb2[kNQ], gs2[kNQ];
#pragma unroll
      for (int j = 0; j < kNQ; ++j) {
        frag_b_tf32<D>(qb2[j], qs2[j], qst, qss, 8 * j, 8 * kk, g, t4);
        frag_b_tf32<D>(gb2[j], gs2[j], dost, doss, 8 * j, 8 * kk, g, t4);
      }
      mma_3xtf32_n<kNQ>(st, akb, aks, qb2, qs2);
      mma_3xtf32_n<kNQ>(dpt, avb, avs, gb2, gs2);
    }

    // p, ds in the accumulator layout: st[j][e] is key keys[e / 2] and
    // query q0 + 8j + 2 t4 + e % 2; st takes keep * p / (1 - rate), dpt ds
    const bool edge = q0 + BQ > sq || k0 + krow + 16 > sk ||
                      (causal && q0 < k0 + krow + 15);
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qr = 8 * j + 2 * t4 + (e & 1);  // query row in the tile
        const int qi = q0 + qr;
        float x = st[j][e] * scale + kbv[r];
        if (kBias && (!edge || qi < sq)) {
          x += __ldg(bias + bcol[r] + (size_t)qi * sk);
        }
        const bool masked =
            edge && (keys[r] >= sk || (causal && keys[r] > qi));
        if (masked) x = kNeg;
        // padded query rows (past Sq) contribute nothing, as the
        // reference's zero-padded rows do; exp as exp2 of the
        // log2(e)-scaled difference, as the forward
        const float p =
            (!edge || qi < sq) ? exp2f((x - ls[qr]) * kLog2e) : 0.f;
        float dp = dpt[j][e];
        float pv = p;
        if (kDropout) {
          const bool keep = hash_keep(row_hash((unsigned)qi),
                                      (unsigned)keys[r], head_s, thresh);
          pv = keep ? p * inv_keep : 0.f;
          dp = keep ? dp * inv_keep : 0.f;
        }
        // dkey_bias and dbias take this fp32 ds before any split
        const float ds = p * (dp - dl[qr]);
        dkb_acc[r] += ds;
        if (kBias && lead && (!edge || (qi < sq && keys[r] < sk))) {
          float* dst = dbias + bcol[r] + (size_t)qi * sk;
          if (!dbias_atomic) {
            *dst = ds;
          } else if (!masked) {
            atomicAdd(dst, ds);
          }
        }
        st[j][e] = pv;
        dpt[j][e] = ds;
      }
    }

    // dV += pv^T dO and dK += ds^T Q in split TF32, pv and ds in fp32 as
    // the fp32 reference keeps them: the k-step over queries q0 + 8j .. + 7
    // takes the accumulators as its A fragment, dO's and Q's rows as its k
    // index and their even and odd columns as the n-tiles 2m and 2m + 1
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
      unsigned apb[4], aps[4], asb[4], ass[4];
      acc_a_tf32(apb, aps, st[j]);
      acc_a_tf32(asb, ass, dpt[j]);
#pragma unroll
      for (int c = 0; c < 2 * kDP; c += kNC) {
        uint2 bb[kNC], bs[kNC];
#pragma unroll
        for (int m = 0; m < kNC / 2; ++m) {
          frag_b2_tf32<D>(bb + 2 * m, bs + 2 * m, dost, doss, 8 * j,
                          dcol + 8 * c + 16 * m, g, t4);
        }
        mma_3xtf32_n<kNC>(dva + c, apb, aps, bb, bs);
#pragma unroll
        for (int m = 0; m < kNC / 2; ++m) {
          frag_b2_tf32<D>(bb + 2 * m, bs + 2 * m, qst, qss, 8 * j,
                          dcol + 8 * c + 16 * m, g, t4);
        }
        mma_3xtf32_n<kNC>(dka + c, asb, ass, bb, bs);
      }
    }
    __syncthreads();  // this stage is consumed
  }

  // n-tile 2m + e holds columns dcol + 16m + 2n + e (see flash_bwd_dq.cu)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dkb_acc[r] += __shfl_xor_sync(0xffffffffu, dkb_acc[r], 1);
    dkb_acc[r] += __shfl_xor_sync(0xffffffffu, dkb_acc[r], 2);
    if (keys[r] >= sk) continue;
    const size_t off = ((size_t)bh * sk + keys[r]) * D + dcol + 4 * t4;
#pragma unroll
    for (int m = 0; m < kDP; ++m) {
      *reinterpret_cast<float4*>(dk + off + 16 * m) = make_float4(
          dka[2 * m][2 * r] * scale, dka[2 * m + 1][2 * r] * scale,
          dka[2 * m][2 * r + 1] * scale, dka[2 * m + 1][2 * r + 1] * scale);
      *reinterpret_cast<float4*>(dv + off + 16 * m) =
          make_float4(dva[2 * m][2 * r], dva[2 * m + 1][2 * r],
                      dva[2 * m][2 * r + 1], dva[2 * m + 1][2 * r + 1]);
    }
    if (lead && t4 == 0) dkb[(size_t)bh * sk + keys[r]] = dkb_acc[r];
  }
}

// The tensor-core kernel (bf16, fp16): 4 warps; kSplit warps share 16
// keys, each accumulating D / kSplit columns of dk and dv.

template <int D>
__host__ __device__ constexpr int mma_split() {
  return D > 128 ? 2 : 1;
}

template <int D>
__host__ __device__ constexpr int mma_keys() {  // key rows a block owns
  return 16 * kMmaWarps / mma_split<D>();
}

template <int D>
__host__ __device__ constexpr int mma_bq() {  // query rows per tile
  return D >= 128 ? 32 : 64;
}

// K and V, two stages of Q and dO, two of lse and delta
template <int D>
__host__ __device__ constexpr int mma_smem_bytes() {
  return (2 * mma_keys<D>() * D + 4 * mma_bq<D>() * D) * 2 +
         4 * mma_bq<D>() * 4;
}

template <typename T, int D, bool kDropout, bool kBias>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ kb,
    const float* __restrict__ bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dkb,
    float* __restrict__ dbias, int bias_heads, int bias_div, int bias_rows,
    int dbias_atomic, int sq, int sk, float scale, int causal, unsigned seed,
    unsigned thresh, float inv_keep) {
  using namespace flash::mma;
  constexpr int kSplit = mma_split<D>();
  constexpr int kKeys = mma_keys<D>();
  constexpr int BQ = mma_bq<D>();
  constexpr int kDS = D / kSplit;    // dk/dv columns a warp accumulates
  constexpr int kKSteps = D / 16;    // k-steps of K.Q^T and V.dO^T
  constexpr int kNQ = BQ / 8;        // n-tiles of S^T and dP^T
  constexpr int kDT = kDS / 8;       // n-tiles of a warp's dk and dv
  constexpr bool kKVRegs = D <= 64;
  extern __shared__ __align__(128) unsigned char smem[];
  T* kst = reinterpret_cast<T*>(smem);  // [kKeys][D]
  T* vst = kst + kKeys * D;             // [kKeys][D]
  T* qs = vst + kKeys * D;              // [2][BQ][D]
  T* dos = qs + 2 * BQ * D;             // [2][BQ][D]
  float* lses = reinterpret_cast<float*>(dos + 2 * BQ * D);  // [2][BQ]
  float* dels = lses + 2 * BQ;                               // [2][BQ]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kKeys;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int krow = (warp / kSplit) * 16;  // the warp's first key row
  const int dcol = (warp % kSplit) * kDS;  // its first dk/dv column
  const bool lead = warp % kSplit == 0;    // writes dkey_bias and dbias
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // the thread's two keys: accumulator elements 0, 1 and 2, 3
  const int keys[2] = {k0 + krow + g, k0 + krow + g + 8};
  const unsigned head_s = head_seed(seed, (unsigned)bh);
  float kbv[2];
  size_t bcol[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = min(keys[r], sk - 1);  // keys past Sk store nothing
    kbv[r] = kb ? __ldg(kb + (size_t)(bh / bias_heads) * sk + key) : 0.f;
    // this head's bias and dbias rows at column `key`, stepped by sk
    bcol[r] = kBias ? (size_t)((bh / bias_div) % bias_rows) * sq * sk + key
                    : 0;
  }

  const T* qp = q + (size_t)bh * sq * D;
  const T* gp = dout + (size_t)bh * sq * D;
  const float* lp = lse + (size_t)bh * sq;
  const float* dlp = delta + (size_t)bh * sq;
  // query tiles that end before the block's first key row are masked for
  // every key of the block: start at the tile holding row k0
  const int qstart = causal ? (k0 / BQ) * BQ : 0;
  const int ntiles = (sq - qstart + BQ - 1) / BQ;

  auto load_queries = [&](int stage, int q0) {
    load_tile<D, BQ, kMmaThreads>(qs + stage * BQ * D, qp, q0, sq, tid);
    load_tile<D, BQ, kMmaThreads>(dos + stage * BQ * D, gp, q0, sq, tid);
    for (int i = tid; i < 2 * BQ; i += kMmaThreads) {
      const int r = i % BQ;
      const bool valid = q0 + r < sq;
      const float* src = (i < BQ ? lp : dlp) + (valid ? q0 + r : 0);
      cp_async4((i < BQ ? lses : dels) + stage * BQ + r, src, valid);
    }
  };
  load_tile<D, kKeys, kMmaThreads>(kst, k + (size_t)bh * sk * D, k0, sk, tid);
  load_tile<D, kKeys, kMmaThreads>(vst, v + (size_t)bh * sk * D, k0, sk, tid);
  load_queries(0, qstart);
  cp_async_commit();

  unsigned kf[kKVRegs ? kKSteps : 1][4];
  unsigned vf[kKVRegs ? kKSteps : 1][4];
  float dka[kDT][4];
  float dva[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
  }
  float dkb_acc[2] = {0.f, 0.f};  // this thread's part of dkey_bias

  for (int t = 0; t < ntiles; ++t) {
    const int q0 = qstart + t * BQ;
    const int stage = t & 1;
    if (t + 1 < ntiles) {
      load_queries(stage ^ 1, q0 + BQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* qst = qs + stage * BQ * D;
    const T* dost = dos + stage * BQ * D;
    const float* ls = lses + stage * BQ;
    const float* dl = dels + stage * BQ;
    if (kKVRegs && t == 0) {
#pragma unroll
      for (int kk = 0; kk < (kKVRegs ? kKSteps : 0); ++kk) {
        const int off = swz<D>(krow + (lane & 15), kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(kf[kk], kst + off);
        ldmatrix_x4(vf[kk], vst + off);
      }
    }

    // S^T = K Q^T and dP^T = V dO^T
    float st[kNQ][4];
    float dpt[kNQ][4];
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      unsigned ak[4];
      unsigned av[4];
      if constexpr (kKVRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ak[i] = kf[kk][i];
          av[i] = vf[kk][i];
        }
      } else {
        const int off = swz<D>(krow + (lane & 15), kk * 16 + (lane >> 4) * 8);
        ldmatrix_x4(ak, kst + off);
        ldmatrix_x4(av, vst + off);
      }
#pragma unroll
      for (int jp = 0; jp < kNQ / 2; ++jp) {
        const int off = swz<D>(jp * 16 + (lane & 7) + (lane >> 4) * 8,
                               kk * 16 + ((lane >> 3) & 1) * 8);
        unsigned b[4];
        ldmatrix_x4(b, qst + off);
        mma16816<T>(st[2 * jp], ak, b[0], b[1]);
        mma16816<T>(st[2 * jp + 1], ak, b[2], b[3]);
        ldmatrix_x4(b, dost + off);
        mma16816<T>(dpt[2 * jp], av, b[0], b[1]);
        mma16816<T>(dpt[2 * jp + 1], av, b[2], b[3]);
      }
    }

    // p, ds in the accumulator layout: st[j][e] is key keys[e / 2] and
    // query q0 + 8j + 2 t4 + e % 2; st takes keep * p / (1 - rate), dpt ds
    const bool edge = q0 + BQ > sq || k0 + krow + 16 > sk ||
                      (causal && q0 < k0 + krow + 15);
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qr = 8 * j + 2 * t4 + (e & 1);  // query row in the tile
        const int qi = q0 + qr;
        float x = st[j][e] * scale + kbv[r];
        if (kBias && (!edge || qi < sq)) x += __ldg(bias + bcol[r] + (size_t)qi * sk);
        const bool masked =
            edge && (keys[r] >= sk || (causal && keys[r] > qi));
        if (masked) x = kNeg;
        // padded query rows (past Sq) contribute nothing, as the
        // reference's zero-padded rows do
        // exp as exp2 of the log2(e)-scaled difference, as the forward
        const float p =
            (!edge || qi < sq) ? exp2f((x - ls[qr]) * kLog2e) : 0.f;
        float dp = dpt[j][e];
        float pv = p;
        if (kDropout) {
          const bool keep = hash_keep(row_hash((unsigned)qi),
                                      (unsigned)keys[r], head_s, thresh);
          pv = keep ? p * inv_keep : 0.f;
          dp = keep ? dp * inv_keep : 0.f;
        }
        const float ds = p * (dp - dl[qr]);
        dkb_acc[r] += ds;
        if (kBias && lead && (!edge || (qi < sq && keys[r] < sk))) {
          float* dst = dbias + bcol[r] + (size_t)qi * sk;
          if (!dbias_atomic) {
            *dst = ds;
          } else if (!masked) {
            atomicAdd(dst, ds);
          }
        }
        st[j][e] = pv;
        dpt[j][e] = ds;
      }
    }

    // dV += round_T(pv^T) dO, dK += round_T(ds^T) Q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const unsigned ap[4] = {
          pack_round<T>(st[2 * kk][0], st[2 * kk][1]),
          pack_round<T>(st[2 * kk][2], st[2 * kk][3]),
          pack_round<T>(st[2 * kk + 1][0], st[2 * kk + 1][1]),
          pack_round<T>(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const unsigned as[4] = {
          pack_round<T>(dpt[2 * kk][0], dpt[2 * kk][1]),
          pack_round<T>(dpt[2 * kk][2], dpt[2 * kk][3]),
          pack_round<T>(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
          pack_round<T>(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < kDT / 2; ++jp) {
        const int off = swz<D>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                               dcol + jp * 16 + (lane >> 4) * 8);
        unsigned b[4];
        ldmatrix_x4_trans(b, dost + off);
        mma16816<T>(dva[2 * jp], ap, b[0], b[1]);
        mma16816<T>(dva[2 * jp + 1], ap, b[2], b[3]);
        ldmatrix_x4_trans(b, qst + off);
        mma16816<T>(dka[2 * jp], as, b[0], b[1]);
        mma16816<T>(dka[2 * jp + 1], as, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dkb_acc[r] += __shfl_xor_sync(0xffffffffu, dkb_acc[r], 1);
    dkb_acc[r] += __shfl_xor_sync(0xffffffffu, dkb_acc[r], 2);
    if (keys[r] >= sk) continue;
    const size_t off = ((size_t)bh * sk + keys[r]) * D + dcol + 2 * t4;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      *reinterpret_cast<unsigned*>(dk + off + 8 * j) = pack_round<T>(
          dka[j][2 * r] * scale, dka[j][2 * r + 1] * scale);
      *reinterpret_cast<unsigned*>(dv + off + 8 * j) =
          pack_round<T>(dva[j][2 * r], dva[j][2 * r + 1]);
    }
    if (lead && t4 == 0) dkb[(size_t)bh * sk + keys[r]] = dkb_acc[r];
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

template <int D, bool kDropout, bool kBias>
cudaError_t launch_tf32_one(dim3 grid, const Args<float>& a,
                            cudaStream_t stream) {
  constexpr int smem = tf32_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_tf32_kernel<D, kDropout, kBias>;
  static unsigned done = 0;
  const cudaError_t err = flash::mma::allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      a.q, a.k, a.v, a.kb, a.bias, a.dout, a.lse, a.delta, a.dk, a.dv, a.dkb,
      a.dbias, a.bias_heads, a.bias_div, a.bias_rows, a.dbias_atomic, a.sq,
      a.sk, a.scale, a.causal, a.seed, a.thresh, a.inv_keep);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tf32(const Args<float>& a, int bh, int dropout,
                        cudaStream_t stream) {
  dim3 grid((a.sk + tf32_keys<D>() - 1) / tf32_keys<D>(), bh);
  if (dropout) {
    return a.bias ? launch_tf32_one<D, true, true>(grid, a, stream)
                  : launch_tf32_one<D, true, false>(grid, a, stream);
  }
  return a.bias ? launch_tf32_one<D, false, true>(grid, a, stream)
                : launch_tf32_one<D, false, false>(grid, a, stream);
}

template <typename T, int D, bool kDropout, bool kBias>
cudaError_t launch_mma_one(dim3 grid, const Args<T>& a, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_mma_kernel<T, D, kDropout, kBias>;
  static unsigned done = 0;
  const cudaError_t err = flash::mma::allow_smem(kernel, smem, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      a.q, a.k, a.v, a.kb, a.bias, a.dout, a.lse, a.delta, a.dk, a.dv, a.dkb,
      a.dbias, a.bias_heads, a.bias_div, a.bias_rows, a.dbias_atomic, a.sq,
      a.sk, a.scale, a.causal, a.seed, a.thresh, a.inv_keep);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const Args<T>& a, int bh, int dropout,
                       cudaStream_t stream) {
  dim3 grid((a.sk + mma_keys<D>() - 1) / mma_keys<D>(), bh);
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
// `bias` null means no general bias and `dbias` is not touched; otherwise
// `dbias` [G, Sq, Sk] receives the bias gradient: stored when every head
// owns its row (bias_rows == bh, bias_div == 1), else added atomically,
// in which case the caller zeroes it first. q/k/v/dout/dk/dv are T; the
// rest fp32. `d` is 32, 64, 128 or 256. fp32 runs the split-TF32 kernel,
// bf16 and fp16 the bf16/fp16 tensor-core one.
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
  if constexpr (std::is_same<T, float>::value) {
    switch (d) {
      case 32:
        return (int)launch_tf32<32>(a, bh, dropout, s);
      case 64:
        return (int)launch_tf32<64>(a, bh, dropout, s);
      case 128:
        return (int)launch_tf32<128>(a, bh, dropout, s);
      case 256:
        return (int)launch_tf32<256>(a, bh, dropout, s);
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
