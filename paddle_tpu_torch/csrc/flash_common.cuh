// Pieces shared by the flash-attention training kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu), so that the forward and both
// backward kernels can never disagree on masking or on the dropout mask.
//
// Layout of all three: one block of 256 threads owns a 64-row tile (query
// rows in the forward and dq kernels, key rows in the dk/dv kernel); four
// threads share a row, each holding D/4 of its dimensions as float4s
// (d = 16c + 4*lane), so shared-memory rows are read as 16-byte vectors
// without bank conflicts and a dot product over D needs two warp
// shuffles. Conventions of the reference
// (paddle_tpu/kernels/flash_attention.py): masked scores are -1e30,
// accumulation is fp32.

#pragma once

#include <cuda_runtime.h>

namespace flash {

constexpr float kNeg = -1e30f;
constexpr int kTileRows = 64;     // rows a block owns
constexpr int kRowThreads = 4;    // threads sharing one row
constexpr int kThreads = kTileRows * kRowThreads;

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Sum over the four threads of a row group (lanes 4r .. 4r+3 of a warp).
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ void axpy4(float4& acc, float a, const float4& x) {
  acc.x += a * x.x;
  acc.y += a * x.y;
  acc.z += a * x.z;
  acc.w += a * x.w;
}

// The stateless dropout mask of the reference (`_hash_keep`): a
// splitmix32-style scramble of the ABSOLUTE (row, col), the flat head
// index bh = b*N + n and the 23-bit seed, in uint32 arithmetic that wraps
// as the reference's jnp.uint32 does. `head_seed` is seed + bh * H3 and
// `row_h` is row * H1, both computed once per thread. Keep iff the hash
// is below `thresh` = min(int((1 - rate) * 2^32), 2^32 - 1), which the
// host computes in double precision as the reference does.
__device__ __forceinline__ unsigned head_seed(unsigned seed, unsigned bh) {
  return seed + bh * 0xC2B2AE3Du;
}

__device__ __forceinline__ unsigned row_hash(unsigned row) {
  return row * 0x9E3779B1u;
}

__device__ __forceinline__ bool hash_keep(unsigned row_h, unsigned col,
                                          unsigned head_s, unsigned thresh) {
  unsigned n = row_h + col * 0x85EBCA77u + head_s;
  n ^= n >> 15;
  n *= 0x2C1B3C6Du;
  n ^= n >> 12;
  n *= 0x297A2D39u;
  n ^= n >> 15;
  return n < thresh;
}

}  // namespace flash
