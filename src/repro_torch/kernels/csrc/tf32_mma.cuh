// Tensor-core products at float32 accuracy (3xTF32) and asynchronous
// global-to-shared copies, for sm_90a. Used by rwkv6_scan_bwd.cu.
//
// 3xTF32: a float32 x is split once into hi = tf32(x) and lo = tf32(x - hi),
// both rounded to nearest (cvt.rna); a product a b is taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi on the tensor cores with a float32
// accumulator. x - hi - lo is below 2^-22 |x| and the dropped a_lo b_lo
// below 2^-22 |a b|, so the sum is as close to the float32 product as a
// float32 FMA chain (tests/test_torch_ssm_train.py replays the split). A
// value that is already a TF32 number (a bf16 input) has lo = 0, and its
// products take two of the three.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x rounded to TF32 (10 mantissa bits, ties away from zero), as float bits.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a b for one m16n8k8 tile: a row-major 16 x 8, b column-major 8 x 8,
// TF32 operands, float32 accumulator (mma.sync; SASS HMMA).
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async; SASS LDGSTS); zeros instead when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

}  // namespace tf32x3
