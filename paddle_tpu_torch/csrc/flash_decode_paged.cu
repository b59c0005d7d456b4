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
// key_bias fp32, tables int32, all contiguous; any D from 1 to 256. There
// is no causal flag: the key bias carries all masking, including the
// garbage that sink blocks and not-yet-written positions hold (-1e4
// there). A fully masked slot still gets a finite softmax over garbage,
// which the caller ignores. Table entries are clamped to the pool, as the
// reference's gather clamps.
//
// On the TPU the indirection lives in the BlockSpec index maps (the table
// rides scalar prefetch and each DMA pulls one physical block). Here the
// Hopper counterpart of that DMA does the same: each (slot, head) row is
// split into `splits` ranges of whole pool blocks (ceil(max_blocks /
// splits) each, the wrapper's `_decode_splits`), one block of a
// thread-block cluster each; a block stages its range's table entries in
// shared memory once, and the lanes of one warp move a tile's pool blocks
// of its head (each a contiguous [blk, D] run) into a shared-memory ring,
// one `cp.async.bulk` a block, counted on the stage's `mbarrier`. So a key costs no address arithmetic and no table read; the old
// design did both per key before its loads could issue, and its run-time
// division by the block size cost it 17-19% of its time (PERF.md). The cluster
// merges the ranges' softmax states through distributed shared memory
// (flash_decode.cuh). Row addresses are 64-bit, so a pool past 2^31
// elements stays addressable.
//
// Bound on this card: bytes, as for `flash_decode`: at the serving shape
// (8 slots, 12 heads, 64 blocks of 16 positions, D = 64) one layer's
// step reads 50 MB of K/V in fp32 (25 MB in bf16), each mapped block
// once, against ~0.2 us of arithmetic.

#include "flash_decode.cuh"

namespace {

using namespace flash;
using decode::Params;

// The paged kernel's ring (decode::Ring): threads a block, key rows a
// thread group takes a tile, stages, and its copies: one `cp.async.bulk`
// a pool block from the lanes of warp 0 (true), or 16-byte `cp.async`
// from every thread (false). The fastest the card measured at the serving shape
// (`tools/decode_variants.py`), with about three blocks an SM
// (`_decode_splits`: two waves).
constexpr int kThreads = 128;
constexpr int kRowsPerGroup = 4;
constexpr int kStages = 3;
constexpr bool kBulk = true;
using Ring = decode::Ring<kThreads, kRowsPerGroup, kStages, kBulk>;

// kD > 0: the head dim, fixed; kD = 0: D at run time. kP: pieces a lane
// holds. kVec: the ring (whole 16-byte pieces), else the element path.
template <typename T, int kD, int kP, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_decode_paged_kernel(const Params<T> a) {
  decode::decode_split<T, true, kD, kP, kVec, Ring>(a);
}

template <typename T, int kD, int kP, bool kVec>
cudaError_t launch(const Params<T>& a, cudaStream_t stream) {
  static int set[32] = {};
  return decode::launch<T, true, kP, kVec, Ring>(
      flash_decode_paged_kernel<T, kD, kP, kVec>, a, set, stream);
}

// The instantiation for head dim d, as in flash_decode.cu.
template <typename T>
cudaError_t dispatch(const Params<T>& a, cudaStream_t stream) {
  if (!decode::ring_form(a)) return launch<T, 0, 2, false>(a, stream);
  if (a.d == 64) return launch<T, 64, 1, true>(a, stream);
  if (a.d == 16) return launch<T, 16, 1, true>(a, stream);
  if constexpr (sizeof(T) == 4) {
    if (a.d > 128) return launch<T, 0, 2, true>(a, stream);
  }
  return launch<T, 0, 1, true>(a, stream);
}

// Returns a cudaError_t: 0 on a successful launch. The launch is
// asynchronous on `stream`; nothing is allocated or synchronised here.
// q, the pools and o are T; key_bias fp32; tables int32;
// 1 <= splits <= 8.
template <typename T>
int flash_decode_paged(const void* q, const void* k_pool, const void* v_pool,
                       const void* tables, const void* key_bias, void* o,
                       int bh, int heads, int bias_heads, int max_blocks,
                       int blk, int pool_blocks, int d, float scale,
                       int splits, void* stream) {
  if (bh <= 0 || heads <= 0 || bh % heads != 0 || bias_heads <= 0 ||
      bh % bias_heads != 0 || max_blocks <= 0 || blk <= 0 ||
      pool_blocks <= 0 || (long long)max_blocks * blk > 0x7fffffffLL ||
      d <= 0 || d > 256 || splits < 1 || splits > decode::kMaxSplits ||
      (long long)bh * splits > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  Params<T> a = {};
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k_pool);
  a.v = static_cast<const T*>(v_pool);
  a.tables = static_cast<const int*>(tables);
  a.kb = static_cast<const float*>(key_bias);
  a.o = static_cast<T*>(o);
  a.bh = bh;
  a.heads = heads;
  a.bias_heads = bias_heads;
  a.s_len = max_blocks * blk;
  a.d = d;
  a.splits = splits;
  a.max_blocks = max_blocks;
  a.blk = blk;
  decode::divider((unsigned)blk, a.blk_m, a.blk_s);
  a.pool_blocks = pool_blocks;
  a.scale = scale;
  return (int)dispatch<T>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

FLASH_ENTRY_POINTS(
    paddle_flash_decode_paged, flash_decode_paged,
    (const void* q, const void* k_pool, const void* v_pool,
     const void* tables, const void* key_bias, void* o, int bh, int heads,
     int bias_heads, int max_blocks, int blk, int pool_blocks, int d,
     float scale, int splits, void* stream),
    (q, k_pool, v_pool, tables, key_bias, o, bh, heads, bias_heads,
     max_blocks, blk, pool_blocks, d, scale, splits, stream))

// The design's constants, for the reports (as flash_decode.cu's).
extern "C" void paddle_flash_decode_design(int* out) {
  out[0] = kThreads;
  out[1] = kRowsPerGroup;
  out[2] = kStages;
  out[3] = decode::kMaxSplits;
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
