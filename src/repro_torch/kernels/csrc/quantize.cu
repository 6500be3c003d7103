// Upload compression kernels for Hopper, one pass each over [R, N] rows.
//
// Replaces the Pallas kernels of src/repro/kernels/quantize.py:
//   * int8_roundtrip (stochastic int8 quantize + dequantize)
//     -> int8_roundtrip_launch:
//        out = clip(floor(u / scale[r] + noise), -127, 127) * scale[r];
//   * topk_mask (magnitude sparsification against a per-row threshold)
//     -> topk_mask_launch:
//        out = |u| >= thresh[r] ? u : 0.
// A row is one upload: one client's (or one group's) whole-model delta in
// the flat layout, or one model leaf of it in the tree layout.
//
// Bound: HBM bytes. Each element costs a handful of flops against 8 to 12
// bytes of traffic, so the design goal is to touch every byte once:
//   * The int8 payload never reaches device memory: quantize and
//     dequantize happen in registers (bytes on the wire are modeled in
//     core/compression.py, as in the reference).
//   * The noise U[0, 1) stays an operand, drawn outside the kernel, so the
//     kernel, its plain PyTorch version and the JAX package see the same
//     numbers.
//   * The per-row scalar (scale or threshold) is read once per row.
//   * No padded copy: the grid is (tiles of a row, rows), as flat_kernel in
//     mtgc_update.cu, and each block masks its own ragged tail. N need not
//     be a multiple of 4 (the CIFAR-10 CNN has N = 2,156,490), so rows are
//     not 16-byte aligned; loads are coalesced scalar loads, several per
//     thread in flight.
//   * Offsets are 64-bit: R * N exceeds 2^31 at the client link's size.
//
// Arithmetic matches the plain PyTorch version (kernels/quantize.py) bit for
// bit: u / scale is an IEEE-rounded division (__fdiv_rn), + noise is rounded
// on its own (__fadd_rn, never contracted), then floorf, the clip and
// __fmul_rn(q, scale), then the cast to u's dtype. The clip is written with
// comparisons that leave NaN alone, as torch.clamp and jnp.clip do
// (fminf/fmaxf would return the non-NaN operand).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // elements per thread per block-tile
constexpr int kTile = kThreads * kItems;
constexpr int64_t kMaxGridY = 65535;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// clip(q, -127, 127) that keeps NaN (a comparison with NaN is false).
__device__ __forceinline__ float clip127(float q) {
  q = q < -127.0f ? -127.0f : q;
  return q > 127.0f ? 127.0f : q;
}

// u, noise, out: [rows, n]; scale: [rows] float32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_kernel(const T* __restrict__ u, const float* __restrict__ noise,
            const float* __restrict__ scale, T* __restrict__ out, int64_t rows,
            int64_t n) {
  const int64_t col0 = (int64_t)blockIdx.x * kTile + threadIdx.x;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int64_t base = row * n;
    const float s = scale[row];
    T uv[kItems];
    float nv[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t c = col0 + (int64_t)i * kThreads;
      if (c < n) {
        uv[i] = u[base + c];
        nv[i] = noise[base + c];
      }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t c = col0 + (int64_t)i * kThreads;
      if (c < n) {
        const float q = clip127(floorf(__fadd_rn(__fdiv_rn(to_f32(uv[i]), s), nv[i])));
        out[base + c] = from_f32<T>(__fmul_rn(q, s));
      }
    }
  }
}

// u, out: [rows, n]; thresh: [rows] in u's dtype. Every tie is kept.
template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_kernel(const T* __restrict__ u, const T* __restrict__ thresh, T* __restrict__ out,
            int64_t rows, int64_t n) {
  const int64_t col0 = (int64_t)blockIdx.x * kTile + threadIdx.x;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int64_t base = row * n;
    const float t = to_f32(thresh[row]);
    T uv[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t c = col0 + (int64_t)i * kThreads;
      if (c < n) uv[i] = u[base + c];
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t c = col0 + (int64_t)i * kThreads;
      // bfloat16 -> float32 is exact, so the comparison is the reference's.
      if (c < n) out[base + c] = fabsf(to_f32(uv[i])) >= t ? uv[i] : from_f32<T>(0.0f);
    }
  }
}

dim3 row_grid(int64_t rows, int64_t n) {
  return dim3((unsigned)((n + kTile - 1) / kTile),
              (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
}

}  // namespace

extern "C" {

// u_bf16: u and out are bfloat16 (else float32). noise and scale are
// float32. Returns cudaGetLastError() after the launch (0 on success).
int int8_roundtrip_launch(const void* u, const void* noise, const void* scale, void* out,
                          int64_t rows, int64_t n, int u_bf16, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* nz = static_cast<const float*>(noise);
  const float* sc = static_cast<const float*>(scale);
  if (u_bf16)
    int8_kernel<__nv_bfloat16><<<row_grid(rows, n), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(u), nz, sc, static_cast<__nv_bfloat16*>(out),
        rows, n);
  else
    int8_kernel<float><<<row_grid(rows, n), kThreads, 0, s>>>(
        static_cast<const float*>(u), nz, sc, static_cast<float*>(out), rows, n);
  return (int)cudaGetLastError();
}

// u_bf16: u, thresh and out are bfloat16 (else float32).
int topk_mask_launch(const void* u, const void* thresh, void* out, int64_t rows, int64_t n,
                     int u_bf16, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u_bf16)
    topk_kernel<__nv_bfloat16><<<row_grid(rows, n), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(thresh),
        static_cast<__nv_bfloat16*>(out), rows, n);
  else
    topk_kernel<float><<<row_grid(rows, n), kThreads, 0, s>>>(
        static_cast<const float*>(u), static_cast<const float*>(thresh),
        static_cast<float*>(out), rows, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
