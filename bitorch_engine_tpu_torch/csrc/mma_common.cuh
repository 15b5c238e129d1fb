// PTX wrappers shared by the tensor-core kernels (binary_gemm.cu,
// flash_attention.cu, mbwq_matmul.cu, paged_attention.cu, quad_matmul.cu):
// asynchronous copies into shared memory, ldmatrix and its lane addresses,
// the bf16 mma.sync.m16n8k16, the int8 m16n8k32 and the 1-bit m16n8k256
// products, and the bf16 packing of two floats.  Each source
// compiles its own copy into its library (an anonymous namespace); an edit
// here rebuilds all of them (the build hashes every csrc/*.cuh).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An asynchronous copy of B (4, 8 or 16) bytes from device to shared memory.
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src), "n"(B)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest N committed groups of this thread's copies have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Unit u (16 bytes) of lane l's slot in a ring stage lies at index u * 32 +
// l: a warp's reads of one unit are consecutive, with no bank conflict.
// Byte b of a lane's field starting at unit u0 lies in unit u0 + b / 16.
__device__ __forceinline__ char* unit_ptr(uint4* stage, int u, int lane) {
  return reinterpret_cast<char*>(stage + u * 32 + lane);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, s32) += a (16 x 32, u8, row) * b (32 x 8, s8, col): exact
__device__ __forceinline__ void mma_u8s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, s32) += popc(a (16 x 256 bits, row) AND b (256 x 8 bits, col))
// per output, exact.  Lane (g, t) holds row g's bits (a[0], a[2]) and row
// g + 8's (a[1], a[3]) at k 32 t .. 32 t + 31 (a[0], a[1]) and 128 + 32 t ..
// (a[2], a[3]), column g's at the k of a[0] (b0) and a[2] (b1), and D as
// the 8-bit m16n8k32 does.
__device__ __forceinline__ void mma_b1_and(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ldmatrix addresses, for lane `lane` of a warp, into a tile with row
// stride LD.  A operand: the 16 x 16 block at (r0, c0) of a row-major
// [m][k] tile.  B operands of two 8-wide n-tiles: the 16 (n) x 16 (k) block
// at (n0, k0) of an [n][k] tile (non-transposed load), or the 16 (k) x 16
// (n) block at (k0, n0) of a [k][n] tile (transposed load).  Either way
// r[0], r[1] feed n-tile n0 and r[2], r[3] n-tile n0 + 8.
template <int LD>
__device__ __forceinline__ const bf16* a_addr(const bf16* base, int r0, int c0, int lane) {
  return base + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ const bf16* bn_addr(const bf16* base, int n0, int k0, int lane) {
  return base + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8;
}
template <int LD>
__device__ __forceinline__ const bf16* bt_addr(const bf16* base, int k0, int n0, int lane) {
  return base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8;
}

}  // namespace
