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
// take all three types on the CUDA cores: a low-precision operand is
// widened to fp32 as it is loaded (four elements, one 8-byte access) and
// every product and sum runs in fp32. A bf16 or fp16 product is exact in
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

#include <type_traits>

namespace flash {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;  // a block of the decode kernels

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Four consecutive elements at `p` (16-byte aligned for fp32, 8-byte for
// the 16-bit types) as fp32, from the read-only path.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

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

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  return widen<__nv_bfloat16>(__ldg(reinterpret_cast<const uint2*>(p)));
}

__device__ __forceinline__ float4 load4(const __half* p) {
  return widen<__half>(__ldg(reinterpret_cast<const uint2*>(p)));
}

// Four fp32 values stored at `p` in the element type, rounded to nearest
// even.
__device__ __forceinline__ void store4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ unsigned pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) |
         ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ unsigned pack2(__half lo, __half hi) {
  return (unsigned)__half_as_ushort(lo) | ((unsigned)__half_as_ushort(hi) << 16);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4& v) {
  uint2 u;
  u.x = pack2(__float2bfloat16_rn(v.x), __float2bfloat16_rn(v.y));
  u.y = pack2(__float2bfloat16_rn(v.z), __float2bfloat16_rn(v.w));
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store4(__half* p, const float4& v) {
  uint2 u;
  u.x = pack2(__float2half_rn(v.x), __float2half_rn(v.y));
  u.y = pack2(__float2half_rn(v.z), __float2half_rn(v.w));
  *reinterpret_cast<uint2*>(p) = u;
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

// --- the decode kernels (flash_decode.cu, flash_decode_paged.cu) ---
//
// Threads of a key row: each holds kP four-element pieces of the row, piece
// p at elements 4 (p lanes + lane) .. + 3, so a warp reads consecutive
// 16-byte (fp32) or 8-byte (bf16, fp16) pieces. One piece a lane up to D =
// 128 (D/4 lanes), two past it (D/8 lanes): a row's lanes, padded to a
// power of two, stay within one warp, whose shuffles sum its dot product.
// The kernel that takes D at run time (D = 0) holds two.

// The smallest power of two >= n: the shuffle reduction over a key row's
// threads needs a power-of-two group.
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

__host__ __device__ constexpr int decode_pieces(int D) {
  return D > 0 && D <= 128 ? 1 : 2;
}

__host__ __device__ constexpr int decode_lanes(int d) {
  return pow2_at_least(d <= 128 ? (d + 3) / 4 : (d + 7) / 8);
}

// A piece at `p` holding `n` (>= 1) of the row's elements, as fp32: one
// vector load when D is a compile-time multiple of 8 (n >= 4 then), else
// element by element with those past n read as zero.
template <typename T, int D>
__device__ __forceinline__ float4 load_piece(const T* p, int n) {
  if constexpr (D > 0) {
    return load4(p);
  } else {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = i < n ? to_float(__ldg(p + i)) : 0.f;
    return make_float4(x[0], x[1], x[2], x[3]);
  }
}

// The loop's K and V pieces as loaded, widened to fp32 only where they
// are used, so that nothing between a pass's loads waits on one of them:
// 8 raw bytes for the 16-bit types at a compile-time D, else the fp32
// piece itself.
template <typename T, int D>
using RawPiece = typename std::conditional<(D > 0 && sizeof(T) == 2), uint2,
                                           float4>::type;

template <typename T, int D>
__device__ __forceinline__ RawPiece<T, D> load_raw(const T* p, int n) {
  if constexpr (D > 0 && sizeof(T) == 2) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  } else {
    return load_piece<T, D>(p, n);
  }
}

template <typename T, int D>
__device__ __forceinline__ float4 widen_piece(const RawPiece<T, D>& x) {
  if constexpr (D > 0 && sizeof(T) == 2) {
    return widen<T>(x);
  } else {
    return x;
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_piece(T* p, const float4& v, int n) {
  if constexpr (D > 0) {
    store4(p, v);
  } else {
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < n) p[i] = from_float<T>(x[i]);
    }
  }
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
