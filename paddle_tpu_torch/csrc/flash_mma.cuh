// Tensor-core pieces shared by the bf16 and fp16 forms of the flash
// training kernels (flash_fwd.cu, flash_bwd_dkv.cu): their block of 4
// warps, warp-level `mma.sync.m16n8k16` with fp32 accumulators,
// `ldmatrix` fragment loads from shared memory, `cp.async` copies from
// device memory, the swizzled tile layout they read, and the opt-in to
// more than 48 KB of shared memory.
//
// Fragments of one m16n8k16 product (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), for lane l of the warp, g = l / 4 and t = l % 4:
//   A (16 x 16, row-major), 4 registers of two 16-bit elements each:
//     a0 = A[g][2t, 2t+1]       a1 = A[g+8][2t, 2t+1]
//     a2 = A[g][2t+8, 2t+9]     a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, "col": B[k][n] with k contiguous for a fixed n):
//     b0 = B[2t, 2t+1][g]       b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8, fp32): c0, c1 = C[g][2t, 2t+1]; c2, c3 = C[g+8][2t, 2t+1]
// The lower-indexed element of a pair sits in the low half of its
// register. An accumulator pair (c0, c1) of two neighbouring n-tiles is
// therefore an A fragment of the next product as it is (after rounding to
// 16 bits): P or dS never leaves the registers.
//
// Tiles in shared memory are [rows][D] of 16-bit elements, rows of D/8
// 16-byte chunks. `ldmatrix` reads eight rows at one chunk column at a
// time; a plain layout puts those eight 16-byte pieces in the same four
// banks whenever a row is a multiple of 128 bytes. `swz` XORs the chunk
// index with the row (row & 7 for D >= 64; (row >> 1) & 3 for D = 32,
// whose 64-byte rows pair up in a 128-byte line), so the eight rows of
// one read, and the 16-byte `cp.async` writes of one row, fall in eight
// different bank groups.

#pragma once

#include "flash_common.cuh"

namespace flash {
namespace mma {

// A block of the tensor-core kernels: 4 warps, each owning 16 rows of
// `mma` tiles.
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2(e))

// Element offset of (row, col) in a swizzled [rows][D] tile; `col` may
// be any column: its chunk is permuted, its place in the chunk kept.
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  static_assert(D == 32 || D % 64 == 0, "tile width: 32 or a multiple of 64");
  int chunk = col >> 3;
  if constexpr (D >= 64) {
    chunk ^= row & 7;
  } else {
    chunk ^= (row >> 1) & 3;
  }
  return row * D + (chunk << 3) + (col & 7);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, bypassing L1; when
// `valid` is false nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, zeroed when `valid` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 matrices of 16-bit elements: lane l gives the address of row
// l % 8 of matrix l / 8 (16 bytes); register i receives row l / 4,
// elements 2 (l % 4) and 2 (l % 4) + 1, of matrix i.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The same, transposed: register i receives rows 2 (l % 4) and
// 2 (l % 4) + 1, element l / 4, of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b on the tensor cores, fp32 accumulation.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4],
                                                 const unsigned (&a)[4],
                                                 unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to nearest even in T, `lo` in the low half:
// the `round_to<T>` of flash_common.cuh, packed for a fragment.
template <typename T>
__device__ __forceinline__ unsigned pack_round(float lo, float hi);

template <>
__device__ __forceinline__ unsigned pack_round<__nv_bfloat16>(float lo,
                                                              float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

template <>
__device__ __forceinline__ unsigned pack_round<__half>(float lo, float hi) {
  return pack2(__float2half_rn(lo), __float2half_rn(hi));
}

// Rows [row0, row0 + ROWS) of a [n_rows, D] matrix in device memory into
// a swizzled [ROWS][D] tile, 16 bytes per copy spread over `threads`
// threads; rows at or past `n_rows` are zero-filled (and read nothing).
template <int D, int ROWS, int THREADS, typename T>
__device__ __forceinline__ void load_tile(T* tile, const T* src, int row0,
                                          int n_rows, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    const bool valid = row0 + r < n_rows;
    const T* p = src + (size_t)(valid ? row0 + r : 0) * D + c;
    cp_async16(tile + swz<D>(r, c), p, valid);
  }
}

// A kernel whose dynamic shared memory may pass 48 KB must say so on each
// device it runs on, once: `done` (the kernel's own, bit i for device i)
// records where it has.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev) & 1u) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

}  // namespace mma
}  // namespace flash
