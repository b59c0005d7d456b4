// Single-query (decode-mode) attention over a contiguous KV cache, fp32,
// bf16 and fp16, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (paddle_tpu/kernels/flash_attention.py:363, launched by
// `flash_decode_attention` at :438): one new token per (slot, head)
// attends over that slot's contiguous K/V cache row.
//
//   o = softmax(q . K^T * scale + key_bias) V
//
// Layout: q/o [BH, D], k/v [BH, S, D] in the element type T (fp32, bf16
// or fp16: one for all three and o), contiguous; any D from 1 to 256.
// key_bias (fp32) is [BH / bias_heads, S]: head bh reads row
// bh / bias_heads, so the engine's [slots, S] bias (bias_heads = heads)
// is read as it is, with no per-head copy; a null key_bias means no bias.
// There is no causal flag: the key bias carries all masking (-1e4 past
// each slot's live length), so one launch serves every mix of slot
// lengths, and a fully masked slot gets the finite softmax over its
// garbage that the reference gives. No lse, forward only.
//
// Bound on this card: bytes (flash_decode.cuh: at the serving shape, 8
// slots x 12 heads x 1024 keys x D = 64, a layer's step streams 50 MB of
// K/V in fp32, 25 MB in bf16). The design, shared with the paged kernel
// in flash_decode.cuh: each (slot, head) row can be split into `splits`
// key ranges of ceil(S / splits) keys (the wrapper's `_decode_splits`),
// one block each, the row's blocks one thread-block cluster that merges
// their partial softmax states through distributed shared memory; inside
// a block a ring of shared-memory stages, filled by 16-byte `cp.async`
// copies from every thread, keeps two tiles of K/V in flight while one is
// scored. This kernel's blocks are 256 threads, four key rows a thread
// group a tile (a tile of 32 KB at D = 64), which at the serving shape
// keep enough in flight at one block a row: `_decode_splits` gives it no
// more blocks than the card has SMs (PERF.md, `tools/decode_variants.py`).
// The bytes the kernel moves are the bound's: every K/V row once, q, the
// bias row and o.

#include "flash_decode.cuh"

namespace {

using namespace flash;
using decode::Params;

// The contiguous kernel's ring (decode::Ring): threads a block, key rows
// a thread group takes a tile, stages, and its copies: 16-byte
// `cp.async` from every thread (false), or one `cp.async.bulk` a tile
// from warp 0 (true). The fastest the card measured at the serving
// shape (`tools/decode_variants.py`).
constexpr int kThreads = 256;
constexpr int kRowsPerGroup = 4;
constexpr int kStages = 3;
constexpr bool kBulk = false;
using Ring = decode::Ring<kThreads, kRowsPerGroup, kStages, kBulk>;

// kD > 0: the head dim, fixed; kD = 0: D at run time. kP: pieces a lane
// holds. kVec: the ring (whole 16-byte pieces), else the element path.
template <typename T, int kD, int kP, bool kVec>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const Params<T> a) {
  decode::decode_split<T, false, kD, kP, kVec, Ring>(a);
}

template <typename T, int kD, int kP, bool kVec>
cudaError_t launch(const Params<T>& a, cudaStream_t stream) {
  static int set[32] = {};
  return decode::launch<T, false, kP, kVec, Ring>(
      flash_decode_kernel<T, kD, kP, kVec>, a, set, stream);
}

// The instantiation for head dim d: the ring at D = 64 (GPT-2, BERT) and
// 16 (the tiny test GPT) fixed, at any other D of whole 16-byte pieces
// taking D at run time (two pieces a lane for fp32 past D = 128); the
// element path for the rest.
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
// q/k/v/o are T, key_bias fp32; 1 <= splits <= 8.
template <typename T>
int flash_decode(const void* q, const void* k, const void* v,
                 const void* key_bias, void* o, int bh, int bias_heads,
                 int s_len, int d, float scale, int splits, void* stream) {
  if (bh <= 0 || s_len <= 0 || bias_heads <= 0 || bh % bias_heads != 0 ||
      d <= 0 || d > 256 || splits < 1 || splits > decode::kMaxSplits ||
      (long long)bh * splits > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  Params<T> a = {};
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.kb = static_cast<const float*>(key_bias);
  a.o = static_cast<T*>(o);
  a.bh = bh;
  a.heads = 1;
  a.bias_heads = bias_heads;
  a.s_len = s_len;
  a.d = d;
  a.splits = splits;
  a.scale = scale;
  return (int)dispatch<T>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

FLASH_ENTRY_POINTS(
    paddle_flash_decode, flash_decode,
    (const void* q, const void* k, const void* v, const void* key_bias,
     void* o, int bh, int bias_heads, int s_len, int d, float scale,
     int splits, void* stream),
    (q, k, v, key_bias, o, bh, bias_heads, s_len, d, scale, splits, stream))

// The design's constants, for the reports: threads a block, key rows a
// thread group takes a tile, stages of the ring, the largest cluster.
extern "C" void paddle_flash_decode_design(int* out) {
  out[0] = kThreads;
  out[1] = kRowsPerGroup;
  out[2] = kStages;
  out[3] = decode::kMaxSplits;
}

extern "C" const char* paddle_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
