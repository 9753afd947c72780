// The warp-level PTX instructions of the tensor-core kernels (flash_fwd.cu,
// flash_dq.cu and flash_dkv.cu), one __device__ function each, and nothing
// else: every other line of the kernels is plain CUDA C++.
// tests/cuda_emu/flash_mma.cuh is a host stand-in with the same names and
// fragment layouts; flash_common.cuh includes this header with angle
// brackets, so a host build that puts that directory first on the include
// path picks the stand-in.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// "ldmatrix"), with lane = threadIdx.x % 32, g = lane / 4, t = lane % 4:
//   A (16x16 bf16, row): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..2t+1),
//                        a[2] = (g, 2t+8..2t+9), a[3] = (g+8, 2t+8..2t+9);
//   B (16x8 bf16, col):  b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8..2t+9, n g);
//   C, D (16x8 fp32):    c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1).
// Two bf16 values share a 32-bit register, the lower column in the low half.
// ldmatrix.x4 reads four 8x8 b16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i of lane l receives row l/4, columns
// 2(l%4)..2(l%4)+1 of matrix i (.trans: column l/4, rows 2(l%4)..+1).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tepdist {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; row_addr is this lane's row.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4],
                                            const void* row_addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row_addr))
      : "memory");
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* row_addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row_addr))
      : "memory");
}

// d += a * b for one 16x8 tile: bf16 products, fp32 sums.
__device__ __forceinline__ void mma_bf16_16816(float d[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory without passing through registers;
// zeros instead when fill is false (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

// Closes the group of this thread's cp.async copies issued since the last.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tepdist
