// A CPU stand-in for the parts of the CUDA runtime and device language that
// src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu, moe_dispatch.cu,
// ssm_scan.cu and ssm_scan_bwd.cu use, so that g++ can build and run those
// sources on the host (tools/scan_bwd_emulate.py, tools/ssm_emulate.py,
// tests/test_torch_moe_emulated.py). A launch
// runs its blocks one after another; a block runs one std::thread per CUDA
// thread on a fresh heap allocation of exactly its dynamic shared memory,
// filled with 0xff bytes (NaN as float32) so a read before a write shows.
// __syncthreads is a std::barrier of the block, __syncwarp one of the warp;
// a shuffle goes through a per-warp array between two warp barriers. The
// device has emu::kSms SMs (2) and one block of any kernel fits on each, so
// a persistent grid of the moe kernels has at most 2 blocks and its
// grid-stride loops run several times on small inputs.
#pragma once

#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, gridDim, blockDim;

struct float4 {
  float x, y, z, w;
};
struct float2 {
  float x, y;
};
struct uint2 {
  uint32_t x, y;
};
struct uint4 {
  uint32_t x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
template <typename T>
inline T __ldg(const T* p) {
  return *p;
}
template <typename T>
inline void __stcs(T* p, T v) {
  *p = v;
}
inline float __expf(float x) { return std::exp(x); }
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9
};
enum { cudaSharedmemCarveoutMaxShared = 100 };
template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, int, int) {
  return cudaSuccess;
}
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace emu {
constexpr int kSms = 2;
inline std::barrier<>* block_bar;
inline std::barrier<>* warp_bar[32];
inline float shfl[32][32];
inline uint64_t shfl_bits[32][32];
inline uint32_t frag_a[32][32][4], frag_b[32][32][2];
inline int warp_of() { return threadIdx.x / 32; }
}  // namespace emu

inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline void __syncwarp() { emu::warp_bar[emu::warp_of()]->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  const int w = emu::warp_of(), l = threadIdx.x & 31;
  emu::shfl[w][l] = v;
  __syncwarp();
  const float r = emu::shfl[w][l ^ m];
  __syncwarp();
  return r;
}

template <typename T>
inline T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) <= sizeof(uint64_t));
  const int w = emu::warp_of(), l = threadIdx.x & 31;
  std::memcpy(&emu::shfl_bits[w][l], &v, sizeof(T));
  __syncwarp();
  T r;
  std::memcpy(&r, &emu::shfl_bits[w][src & 31], sizeof(T));
  __syncwarp();
  return r;
}

inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr attr, int) {
  if (attr != cudaDevAttrMultiProcessorCount) return cudaErrorInvalidValue;
  *v = emu::kSms;
  return cudaSuccess;
}

inline unsigned char* emu_smem;

// kernel<<<grid, block, smem, stream>>>(args...), as the build script
// rewrites it.
template <typename K, typename... A>
void emu_launch(K kernel, unsigned grid, int block, size_t smem, cudaStream_t, A... args) {
  gridDim.x = grid;
  blockDim.x = block;
  for (unsigned bx = 0; bx < grid; ++bx) {
    blockIdx.x = bx;
    emu_smem = static_cast<unsigned char*>(std::aligned_alloc(16, (smem + 15) / 16 * 16 + 16));
    std::memset(emu_smem, 0xff, smem);
    std::barrier<> bar(block);
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (int w = 0; w < (block + 31) / 32; ++w) {
      warps.emplace_back(new std::barrier<>(32));
      emu::warp_bar[w] = warps.back().get();
    }
    emu::block_bar = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        kernel(args...);
      });
    for (auto& th : threads) th.join();
    std::free(emu_smem);
  }
}
