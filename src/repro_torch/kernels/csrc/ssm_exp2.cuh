// 2^x on the special-function unit, for the selective scan's decays
// (ssm_scan.cu and ssm_scan_bwd.cu). Both kernels form exp(dt * A) as
// 2^(dt * a) with a = A * log2(e), so the backward's recomputed h has the
// forward's bits.
#pragma once

#include <cuda_runtime.h>

// x <= 0 here (dt >= 0, A < 0); relative error about 2^-22; subnormal
// results flush to zero. One MUFU.EX2 in SASS.
__device__ __forceinline__ float ssm_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
