// The special-function unit's rate of ex2.approx.ftz.f32 on one card, built
// and run by tools/ssm_scan_variants.py: every thread runs kChains
// independent chains of x <- 2^-x (one MUFU.EX2 each; the negation is an
// operand modifier), with as many threads an SM as the caller launches.
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__global__ void sfu_kernel(float* out, int iters) {
  float x[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) x[c] = 0.001f * (threadIdx.x + c);
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < kChains; ++c) x[c] = ex2(-x[c]);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += x[c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" {

// blocks x threads threads, each iters x sfu_rate_chains() ex2; out
// [blocks * threads] float32.
int sfu_rate_launch(void* out, int blocks, int threads, int iters, void* stream) {
  sfu_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

int sfu_rate_chains() { return kChains; }

}  // extern "C"
