// One call of the scan backward's launch (src/repro_torch/kernels/csrc/
// rwkv6_scan_bwd.cu, all four passes) at [B, T, H, Dh] = [1, 130, 2, 64],
// C = 64, on random operands, with no PyTorch in the process, so that
// compute-sanitizer can watch it:
//
//   scan_bwd_sanitize <library.so> <bf16: 0 or 1>
//
// The library is loaded with dlopen. Outputs and scratch are left as
// cudaMalloc gives them (initcheck then reports any read before a write).
// Prints the count of non-finite entries of dr, dk, dv and dlogw and
// exits 0 when the launch and the synchronisation after it succeed.
// tools/scan_bwd_ptxas_check.py builds and runs it.
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <cmath>
#include <random>
#include <vector>

typedef int (*LaunchFn)(const void*, const void*, const void*, const void*, const void*,
                        const void*, const void*, const void*, const void*, void*, void*, void*,
                        void*, void*, void*, void*, void*, void*, int, int, int, int, int,
                        int64_t, int64_t, int64_t, int, void*);

static int check(cudaError_t err, const char* what) {
  if (err != cudaSuccess) {
    fprintf(stderr, "%s: %s\n", what, cudaGetErrorString(err));
    exit(1);
  }
  return 0;
}

// float32 to bfloat16 bits, rounded to nearest even.
static uint16_t bf16_bits(float x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

static float bf16_value(uint16_t b) {
  const uint32_t u = (uint32_t)b << 16;
  float x;
  memcpy(&x, &u, 4);
  return x;
}

static void* device_copy(const void* host, size_t bytes) {
  void* p = nullptr;
  check(cudaMalloc(&p, bytes), "cudaMalloc");
  check(cudaMemcpy(p, host, bytes, cudaMemcpyHostToDevice), "cudaMemcpy");
  return p;
}

static void* device_empty(size_t bytes) {
  void* p = nullptr;
  check(cudaMalloc(&p, bytes), "cudaMalloc");
  return p;
}

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: %s <librwkv6_scan_bwd.so> <bf16: 0 or 1>\n", argv[0]);
    return 2;
  }
  void* lib = dlopen(argv[1], RTLD_NOW);
  if (!lib) {
    fprintf(stderr, "dlopen: %s\n", dlerror());
    return 2;
  }
  const LaunchFn launch = (LaunchFn)dlsym(lib, "rwkv6_scan_bwd_launch");
  if (!launch) {
    fprintf(stderr, "dlsym: %s\n", dlerror());
    return 2;
  }
  const int bf16 = atoi(argv[2]) != 0;
  const int B = 1, T = 130, H = 2, Dh = 64, C = 64, nc = (T + C - 1) / C, BH = B * H;
  const size_t n = (size_t)B * T * H * Dh, state = (size_t)BH * Dh * Dh;
  std::mt19937 gen(0);
  std::normal_distribution<float> normal(0.f, 1.f);

  // r, k, v in the inputs' type; the float32 values the library sees.
  void* rkv[3];
  for (auto& p : rkv) {
    std::vector<float> x(n);
    for (auto& e : x) e = normal(gen);
    if (bf16) {
      std::vector<uint16_t> b(n);
      for (size_t i = 0; i < n; ++i) b[i] = bf16_bits(x[i]);
      p = device_copy(b.data(), n * 2);
    } else {
      p = device_copy(x.data(), n * 4);
    }
  }
  std::vector<float> logw(n), dout(n), u((size_t)H * Dh), states(nc * state), s_final(state);
  for (auto& e : logw) e = -std::exp(-1.f + std::tanh(normal(gen)));
  for (auto& e : dout) e = normal(gen);
  for (auto& e : u) e = 0.5f * normal(gen);
  for (auto& e : states) e = normal(gen);
  for (auto& e : s_final) e = normal(gen);
  void* d_logw = device_copy(logw.data(), n * 4);
  void* d_do = device_copy(dout.data(), n * 4);
  void* d_u = device_copy(u.data(), u.size() * 4);
  void* d_states = device_copy(states.data(), states.size() * 4);
  void* d_sfin = device_copy(s_final.data(), state * 4);
  const size_t elt = bf16 ? 2 : 4;
  void* dr = device_empty(n * elt);
  void* dk = device_empty(n * elt);
  void* dv = device_empty(n * elt);
  void* dlogw = device_empty(n * 4);
  void* du = device_empty((size_t)H * Dh * 4);
  void* dstate = device_empty(state * 4);
  void* grads = device_empty(nc * state * 4);
  void* log_decay = device_empty((size_t)nc * BH * Dh * 4);
  void* du_part = device_empty((size_t)nc * BH * Dh * 4);

  const int err = launch(rkv[0], rkv[1], rkv[2], d_logw, d_u, d_do, nullptr, d_states, d_sfin,
                         dr, dk, dv, dlogw, du, dstate, grads, log_decay, du_part, B, H, T, Dh,
                         C, (int64_t)T * H * Dh, (int64_t)H * Dh, Dh, bf16, nullptr);
  if (err != 0) {
    fprintf(stderr, "rwkv6_scan_bwd_launch returned %d\n", err);
    return 1;
  }
  check(cudaDeviceSynchronize(), "cudaDeviceSynchronize");

  size_t bad = 0;
  void* outs[3] = {dr, dk, dv};
  for (void* p : outs) {
    if (bf16) {
      std::vector<uint16_t> b(n);
      check(cudaMemcpy(b.data(), p, n * 2, cudaMemcpyDeviceToHost), "cudaMemcpy");
      for (uint16_t e : b) bad += !std::isfinite(bf16_value(e));
    } else {
      std::vector<float> x(n);
      check(cudaMemcpy(x.data(), p, n * 4, cudaMemcpyDeviceToHost), "cudaMemcpy");
      for (float e : x) bad += !std::isfinite(e);
    }
  }
  std::vector<float> x(n);
  check(cudaMemcpy(x.data(), dlogw, n * 4, cudaMemcpyDeviceToHost), "cudaMemcpy");
  for (float e : x) bad += !std::isfinite(e);
  printf("non-finite entries of dr, dk, dv, dlogw: %zu of %zu\n", bad, 4 * n);
  return 0;
}
