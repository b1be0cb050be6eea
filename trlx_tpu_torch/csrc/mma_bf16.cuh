// Warp-level tensor-core and async-copy helpers for sm_90a kernels (inline
// PTX): mma.sync m16n8k16 with bf16 inputs and f32 accumulators, ldmatrix
// (plain and transposed) from shared memory, and 16-byte cp.async copies
// with zero fill.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col (PTX ISA), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), four b32 registers of two bf16 each:
//     a0 = (row g,     cols 2t, 2t+1)    a1 = (row g + 8, cols 2t, 2t+1)
//     a2 = (row g,     cols 2t+8, 2t+9)  a3 = (row g + 8, cols 2t+8, 2t+9)
//   B (16 x 8, column-major), two registers:
//     b0 = (rows 2t, 2t+1, col g)        b1 = (rows 2t+8, 2t+9, col g)
//   C/D (16 x 8, f32), four floats:
//     c0, c1 = (row g, cols 2t, 2t+1)    c2, c3 = (row g + 8, cols 2t, 2t+1)
// Two adjacent C tiles (cols 0-7 and 8-15) are therefore exactly the A
// fragment of a 16 x 16 operand once packed to bf16 pairs, which is how a
// score tile feeds the next product without a trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices; lanes 8j..8j+7 give the row addresses of matrix j,
// and register j of lane l holds (row l / 4, cols 2(l % 4), +1) of matrix j
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// the same, transposed: register j of lane l holds (rows 2(l % 4), +1;
// col l / 4) of matrix j as stored
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// 16 bytes global -> shared, bypassing L1; when !valid nothing is read and
// the destination is zero-filled
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared (through L1, for unaligned rows), zero-filled
// when !valid
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

}  // namespace mma_bf16
