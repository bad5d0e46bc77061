// PTX wrappers of the warp-level tensor-core kernels of the port (the
// integer row stores' pass 1 in topk_mma.cuh):
// cp.async staging, ldmatrix fragment loads, mma.sync m16n8k16 in bf16 with
// f32 sums and m16n8k32 in int8 with int32 sums.
//
// Fragments (PTX ISA), with g = lane / 4 and c = 2 (lane % 4): A (16 x 16,
// row major) at rows g and g + 8, columns c, c + 1 and c + 8, c + 9; B
// (16 x 8) at k = c, c + 1 and c + 8, c + 9 of column g; C (16 x 8, f32) at
// rows g and g + 8, columns c, c + 1. A C fragment of two neighbouring
// 8-column tiles is thus the A fragment of those 16 columns.
//
// ldmatrix.x4 takes four 8 x 8 matrices, the addresses of their rows from
// lanes 0-7, 8-15, 16-23 and 24-31 in turn, and hands lane l row l / 4,
// elements 2 (l % 4) and 2 (l % 4) + 1 of each (.trans: column l / 4, rows
// 2 (l % 4) and 2 (l % 4) + 1), so a row-major A tile, a B operand stored
// [n][k] and, with .trans, a B operand stored [k][n] load as fragments.
//
// m16n8k32 in int8 has the same fragments in bytes: A (16 x 32) at rows g
// and g + 8, bytes 4 (lane % 4) .. + 3 and 16 + 4 (lane % 4) .. + 3; B
// (32 x 8) at those k of column g; C (int32) as above.
//
// Everything here has internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes = 0 writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// two matrices, into r[0] and r[1]; the addresses from lanes 0-15
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b: A 16 x 16 bf16, B 16 x 8 bf16 (b0, b1), D 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b: A 16 x 32 s8, B 32 x 8 s8 (b0, b1), D 16 x 8 s32; wraps, not
// .satfinite (the row stores' sums stay under 127 * 127 * 2048 < 2^31)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same with A unsigned: A 16 x 32 u8
__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
