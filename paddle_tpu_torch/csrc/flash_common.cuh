// Pieces shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu, and the decode kernels'
// flash_decode.cu and flash_decode_paged.cu), so that the forward and both
// backward kernels can never disagree on masking, on the dropout mask or
// on where a low-precision form rounds. The training kernels add
// flash_mma.cuh. Conventions of the reference
// (paddle_tpu/kernels/flash_attention.py): masked scores are -1e30,
// accumulation is fp32.
//
// Element types. q/k/v/o and dO/dq/dk/dv are fp32, bf16 or fp16 (all of
// one call in one type); lse, delta, the key bias, the general bias and
// their gradients stay fp32. All three training kernels run on the
// tensor cores (flash_mma.cuh): bf16 and fp16 operands as they are, with
// fp32 accumulators, and fp32 operands in split TF32. The decode kernels
// (flash_decode.cuh) take all three types on the CUDA cores: a
// low-precision operand is widened to fp32 as it is read from shared
// memory (eight elements, one 16-byte access) and every product and sum
// runs in fp32. A bf16 or fp16 product is exact in
// fp32, so either way this is the reference's bf16 x bf16 -> fp32 dot up
// to the order of the sum.
// Where the reference rounds an fp32 intermediate to the operand type
// before a dot (p before P.V, ds before ds.K and ds^T.Q, keep*p/keep
// before P^T.dO), the decode kernels round with `round_to<T>`, the
// identity for fp32, and the tensor-core kernels round the same values
// as they repack them into fragments. Outputs are rounded to T once, at
// the store. Conversions go through the CUDA intrinsics only.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>


namespace flash {

constexpr float kNeg = -1e30f;

// Four 16-bit values packed in 8 bytes (the lower index in the low half),
// widened to fp32 exactly.
template <typename T>
__device__ __forceinline__ float4 widen(const uint2& u);

template <>
__device__ __forceinline__ float4 widen<__nv_bfloat16>(const uint2& u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

template <>
__device__ __forceinline__ float4 widen<__half>(const uint2& u) {
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Two 16-bit values in one 32-bit word, `lo` in the low half.
__device__ __forceinline__ unsigned pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) |
         ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ unsigned pack2(__half lo, __half hi) {
  return (unsigned)__half_as_ushort(lo) | ((unsigned)__half_as_ushort(hi) << 16);
}

// One element as fp32, and one fp32 value rounded to nearest even in T.
__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// An fp32 intermediate rounded to the operand type T and widened back:
// what the reference's `.astype(T)` before a dot gives.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return x;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <>
__device__ __forceinline__ float round_to<__half>(float x) {
  return __half2float(__float2half_rn(x));
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

// The C entry points of one kernel in its three element types: `NAME_f32`,
// `NAME_bf16` and `NAME_f16` each call `FN<T>` with the same arguments
// (pointers as void*), so the host binds one argument list per kernel.
#define FLASH_ENTRY_POINTS(NAME, FN, PARAMS, ARGS)              \
  extern "C" int NAME##_f32 PARAMS { return FN<float> ARGS; }   \
  extern "C" int NAME##_bf16 PARAMS {                           \
    return FN<__nv_bfloat16> ARGS;                              \
  }                                                             \
  extern "C" int NAME##_f16 PARAMS { return FN<__half> ARGS; }
