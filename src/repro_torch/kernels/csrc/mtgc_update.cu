// Fused MTGC local update for Hopper: x <- x - lr * (g * g_scale + z + y).
//
// Replaces the Pallas kernels of src/repro/kernels/mtgc_update.py:
//   * mtgc_update_flat (whole model, x/g/z [G, K, N], y [G, N], optional
//     [G, K] participation mask) -> mtgc_update_flat_launch;
//   * mtgc_update (one leaf, x/g/z/y of one shape, no mask)
//     -> mtgc_update_leaf_launch.
//
// Bound: HBM bytes. Each element costs 3 flops against 16 to 20 bytes of
// traffic (about 0.2 flop per byte), far below the H100's balance point, so
// the only design goal is to touch every byte exactly once: one pass reads
// x, g, z and y and writes the new x. Consequences for the design:
//   * No lane padding and no padded copy of the operands (the TPU kernel
//     pads to (rows, 128) tiles); each block masks its own ragged tail.
//   * y is read as row `row / K` of the [G, N] buffer: it is never
//     materialized per client, so its traffic is 1/K of x's.
//   * The mask is read once per row. A frozen row (mask == 0) copies x's
//     exact bits and never loads g, z or y, so NaN/Inf there cannot leak.
//   * Neighbouring threads touch neighbouring elements (coalesced scalar
//     loads). N need not be a multiple of 4 (the CIFAR-10 CNN has
//     N = 2,156,490), so rows are not 16-byte aligned and vector loads are
//     avoided; several independent loads per thread keep bytes in flight.
//   * Offsets are 64-bit: G*K*N exceeds 2^31 at realistic sizes.
//   * The flat kernel may run in place (out == x): each thread loads its
//     elements of x before it stores the same elements of out, and no
//     thread touches another's, so x and out are not declared __restrict__.
//     In place, a frozen row is left as it is (no copy at all).
//
// Arithmetic matches the plain PyTorch version (kernels/mtgc_update.py) bit
// for bit in float32: every operation is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn never contract into an FMA), in the reference order
// ((g * g_scale + z) + y), then x - lr * d. bfloat16 operands are widened
// with __bfloat162float and the result rounded with __float2bfloat16_rn.
//
// The tree layout's y is already broadcast to the leaf's [G, K, ...] shape
// by the caller (`.expand(...).contiguous()`, as the reference engine's
// broadcast_to does), so the leaf kernel takes four equal-shape operands.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // elements per thread per block-tile
constexpr int kTile = kThreads * kItems;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One element: ((g * g_scale + z) + y), then x - lr * d, each op rounded.
template <typename TX, typename TC>
__device__ __forceinline__ TX update(TX x, TX g, TC z, TC y, float lr, float g_scale) {
  float d = __fadd_rn(__fadd_rn(__fmul_rn(to_f32(g), g_scale), to_f32(z)), to_f32(y));
  return from_f32<TX>(__fsub_rn(to_f32(x), __fmul_rn(lr, d)));
}

// x, g, z, out: [rows, n]; y: [rows / K, n]; mask: [rows] float32 or null.
// out may be x itself. grid.x tiles the row (kTile elements per block),
// grid.y strides over rows.
template <typename TX, typename TC>
__global__ void __launch_bounds__(kThreads)
flat_kernel(const TX* x, const TX* __restrict__ g,
            const TC* __restrict__ z, const TC* __restrict__ y,
            const float* __restrict__ mask, TX* out,
            int64_t rows, int64_t K, int64_t n, float lr, float g_scale) {
  const int64_t col0 = (int64_t)blockIdx.x * kTile + threadIdx.x;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int64_t base = row * n;
    const int64_t ybase = (row / K) * n;
    const bool active = mask == nullptr || mask[row] != 0.0f;
    if (!active) {
      if (out == x) continue;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int64_t c = col0 + (int64_t)i * kThreads;
        if (c < n) out[base + c] = x[base + c];
      }
      continue;
    }
    TX xv[kItems], gv[kItems];
    TC zv[kItems], yv[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t c = col0 + (int64_t)i * kThreads;
      if (c < n) {
        xv[i] = x[base + c];
        gv[i] = g[base + c];
        zv[i] = z[base + c];
        yv[i] = y[ybase + c];
      }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t c = col0 + (int64_t)i * kThreads;
      if (c < n) out[base + c] = update<TX, TC>(xv[i], gv[i], zv[i], yv[i], lr, g_scale);
    }
  }
}

// x, g, z, y, out: [n]; grid-stride over kTile-element tiles.
template <typename TX, typename TC>
__global__ void __launch_bounds__(kThreads)
leaf_kernel(const TX* __restrict__ x, const TX* __restrict__ g,
            const TC* __restrict__ z, const TC* __restrict__ y,
            TX* __restrict__ out, int64_t n, float lr, float g_scale) {
  for (int64_t t0 = (int64_t)blockIdx.x * kTile; t0 < n; t0 += (int64_t)gridDim.x * kTile) {
    TX xv[kItems], gv[kItems];
    TC zv[kItems], yv[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t c = t0 + threadIdx.x + (int64_t)i * kThreads;
      if (c < n) {
        xv[i] = x[c];
        gv[i] = g[c];
        zv[i] = z[c];
        yv[i] = y[c];
      }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int64_t c = t0 + threadIdx.x + (int64_t)i * kThreads;
      if (c < n) out[c] = update<TX, TC>(xv[i], gv[i], zv[i], yv[i], lr, g_scale);
    }
  }
}

constexpr int64_t kMaxGridY = 65535;
constexpr int64_t kMaxLeafBlocks = 132 * 32;  // 32 resident-block waves of 132 SMs

template <typename TX, typename TC>
void launch_flat(const void* x, const void* g, const void* z, const void* y,
                 const float* mask, void* out, int64_t rows, int64_t K, int64_t n,
                 float lr, float g_scale, cudaStream_t stream) {
  const dim3 grid((unsigned)((n + kTile - 1) / kTile),
                  (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  flat_kernel<TX, TC><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(g), static_cast<const TC*>(z),
      static_cast<const TC*>(y), mask, static_cast<TX*>(out), rows, K, n, lr, g_scale);
}

template <typename TX, typename TC>
void launch_leaf(const void* x, const void* g, const void* z, const void* y, void* out,
                 int64_t n, float lr, float g_scale, cudaStream_t stream) {
  int64_t blocks = (n + kTile - 1) / kTile;
  if (blocks > kMaxLeafBlocks) blocks = kMaxLeafBlocks;
  leaf_kernel<TX, TC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(g), static_cast<const TC*>(z),
      static_cast<const TC*>(y), static_cast<TX*>(out), n, lr, g_scale);
}

}  // namespace

extern "C" {

// x_bf16: x/g/out are bfloat16 (else float32); c_bf16: z/y are bfloat16.
// out is x (in place) or a buffer that overlaps none of the operands.
// Returns cudaGetLastError() after the launch (0 on success).
int mtgc_update_flat_launch(const void* x, const void* g, const void* z, const void* y,
                            const void* mask, void* out, int64_t rows, int64_t K,
                            int64_t n, float lr, float g_scale, int x_bf16, int c_bf16,
                            void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaGetLastError();
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16 && !c_bf16)
    launch_flat<float, float>(x, g, z, y, m, out, rows, K, n, lr, g_scale, s);
  else if (!x_bf16 && c_bf16)
    launch_flat<float, __nv_bfloat16>(x, g, z, y, m, out, rows, K, n, lr, g_scale, s);
  else if (x_bf16 && !c_bf16)
    launch_flat<__nv_bfloat16, float>(x, g, z, y, m, out, rows, K, n, lr, g_scale, s);
  else
    launch_flat<__nv_bfloat16, __nv_bfloat16>(x, g, z, y, m, out, rows, K, n, lr, g_scale, s);
  return (int)cudaGetLastError();
}

int mtgc_update_leaf_launch(const void* x, const void* g, const void* z, const void* y,
                            void* out, int64_t n, float lr, float g_scale, int x_bf16,
                            int c_bf16, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_bf16 && !c_bf16)
    launch_leaf<float, float>(x, g, z, y, out, n, lr, g_scale, s);
  else if (!x_bf16 && c_bf16)
    launch_leaf<float, __nv_bfloat16>(x, g, z, y, out, n, lr, g_scale, s);
  else if (x_bf16 && !c_bf16)
    launch_leaf<__nv_bfloat16, float>(x, g, z, y, out, n, lr, g_scale, s);
  else
    launch_leaf<__nv_bfloat16, __nv_bfloat16>(x, g, z, y, out, n, lr, g_scale, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
