// Top-k token dispatch and combine of the moe family (granite-moe), for Hopper.
//
// Replaces no Pallas kernel. The reference dispatches with dense one-hot
// einsums (src/repro/models/moe.py:86-99): it builds disp [S, k, E, C], the
// product of a token's expert one-hot and its capacity-position one-hot, and
// contracts it with the tokens (sec,sd->ecd) and with the experts' outputs
// (sec,ecd->sd). That is quadratic in the tokens: at granite's prefill (8192
// tokens, k 8, E 32, C 2560) disp is 10.7 GB a layer in bf16 and each
// contraction 1.37 TFLOP. The function itself is a permutation: a token's k
// experts are distinct, so each (expert, slot) holds at most one (token,
// choice). Three kernels compute it directly:
//
//   moe_gather:    out[e, c, :] = scale[v] * src[v / k, :] for the choice
//                  v = s * k + j that holds slot (e, c) (slot[e * C + c] = v),
//                  0 for an empty slot (slot -1). No scale is 1: the dispatch,
//                  a copy of the token's row, bit for bit. With the gates as
//                  the scale it is the combine's backward for the experts'
//                  outputs. Each output row has exactly one writer.
//   moe_combine:   out[s, :] = sum_{j < k, row[s, j] >= 0} w[s, j] *
//                  y[row[s, j], :], with row = e * C + pos of a kept choice,
//                  -1 for a dropped one. The sum runs in float32 in the order
//                  j = 0 .. k - 1 and is rounded once to the output's type.
//                  No w is 1: the dispatch's backward for the tokens.
//   moe_gate_grad: dg[s, j] = <dout[s, :], y[row[s, j], :]> for a kept
//                  choice, 0 for a dropped one: the combine's backward for its
//                  weights, reduced over D in float32 in a fixed order (each
//                  lane's elements in turn, then an xor butterfly), rounded
//                  once.
//
// Bound: HBM bytes. The work is a copy (gather) or a k-term weighted sum
// (combine) of rows, one multiply-add an element at most: granite's dispatch
// moves 185 MB at prefill (0.055 ms at 3.35 TB/s), its combine reads the
// 8 kept rows of each token and writes one, 151 MB (0.045 ms). The design is
// the simple one: one warp a row, each lane moving 16-byte vectors (8 bf16
// or 4 float) of neighbouring columns so that a warp's loads and stores are
// coalesced 512-byte segments; a row's routing entries are read once a warp
// (combine and gate_grad stage them in shared memory). A scalar path takes
// rows whose width or base address does not allow 16-byte vectors.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // rows a block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 32;              // choices a token (one lane each when staged)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Elements of T in one 16-byte vector.
template <typename T>
__host__ __device__ constexpr int vec_n() { return 16 / static_cast<int>(sizeof(T)); }

// One 16-byte vector of T at p (16-byte aligned) as float32.
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// float32 values rounded to T, stored as one 16-byte vector at p.
__device__ __forceinline__ void store_vec(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// One warp a slot row (E * C rows of width D).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
moe_gather_kernel(const T* __restrict__ src, const int* __restrict__ slot,
                  const T* __restrict__ scale, T* __restrict__ out, int64_t rows, int D, int k) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const int v = __ldg(slot + r);
  T* o = out + r * D;
  constexpr int N = vec_n<T>();
  if (v < 0) {
    if (kVec) {
      for (int i = lane; i < D / N; i += 32)
        reinterpret_cast<uint4*>(o)[i] = make_uint4(0, 0, 0, 0);
    } else {
      for (int d = lane; d < D; d += 32) o[d] = from_f32<T>(0.f);
    }
    return;
  }
  const T* s = src + static_cast<int64_t>(v / k) * D;
  if (scale == nullptr) {  // the dispatch: a copy of the row's bits
    if (kVec) {
      for (int i = lane; i < D / N; i += 32)
        reinterpret_cast<uint4*>(o)[i] = __ldg(reinterpret_cast<const uint4*>(s) + i);
    } else {
      for (int d = lane; d < D; d += 32) o[d] = s[d];
    }
    return;
  }
  const float sc = to_f32(__ldg(scale + v));
  if (kVec) {
    for (int i = lane; i < D / N; i += 32) {
      float f[N];
      load_vec(s + i * N, f);
#pragma unroll
      for (int n = 0; n < N; ++n) f[n] = sc * f[n];
      store_vec(o + i * N, f);
    }
  } else {
    for (int d = lane; d < D; d += 32) o[d] = from_f32<T>(sc * to_f32(s[d]));
  }
}

// A token's k routing entries, one lane each, staged in the warp's shared
// memory: the slot row of each choice and, where ws is given, its weight
// (1 where w is null).
template <typename T>
__device__ __forceinline__ void stage_choices(const int* __restrict__ row,
                                              const T* __restrict__ w, int64_t s, int k,
                                              int lane, int* rs, float* ws) {
  if (lane < k) {
    rs[lane] = __ldg(row + s * k + lane);
    if (ws != nullptr) ws[lane] = w == nullptr ? 1.f : to_f32(w[s * k + lane]);
  }
  __syncwarp();
}

// One warp a token (S rows of width D).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
moe_combine_kernel(const T* __restrict__ y, const int* __restrict__ row,
                   const T* __restrict__ w, T* __restrict__ out, int64_t S, int D, int k) {
  __shared__ int rs_all[kWarps][kMaxK];
  __shared__ float ws_all[kWarps][kMaxK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (s >= S) return;
  int* rs = rs_all[warp];
  float* ws = ws_all[warp];
  stage_choices(row, w, s, k, lane, rs, ws);
  T* o = out + s * D;
  constexpr int N = vec_n<T>();
  if (kVec) {
    for (int i = lane; i < D / N; i += 32) {
      float acc[N];
#pragma unroll
      for (int n = 0; n < N; ++n) acc[n] = 0.f;
      for (int j = 0; j < k; ++j) {
        const int r = rs[j];
        if (r < 0) continue;
        float f[N];
        load_vec(y + static_cast<int64_t>(r) * D + i * N, f);
#pragma unroll
        for (int n = 0; n < N; ++n) acc[n] = fmaf(ws[j], f[n], acc[n]);
      }
      store_vec(o + i * N, acc);
    }
  } else {
    for (int d = lane; d < D; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < k; ++j) {
        const int r = rs[j];
        if (r >= 0) acc = fmaf(ws[j], to_f32(y[static_cast<int64_t>(r) * D + d]), acc);
      }
      o[d] = from_f32<T>(acc);
    }
  }
}

// One warp a token: its k dot products in turn.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
moe_gate_grad_kernel(const T* __restrict__ dout, const T* __restrict__ y,
                     const int* __restrict__ row, T* __restrict__ dg, int64_t S, int D, int k) {
  __shared__ int rs_all[kWarps][kMaxK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (s >= S) return;
  int* rs = rs_all[warp];
  stage_choices<T>(row, nullptr, s, k, lane, rs, nullptr);
  const T* a = dout + s * D;
  constexpr int N = vec_n<T>();
  for (int j = 0; j < k; ++j) {
    const int r = rs[j];  // the same for the whole warp
    float part = 0.f;
    if (r >= 0) {
      const T* b = y + static_cast<int64_t>(r) * D;
      if (kVec) {
        for (int i = lane; i < D / N; i += 32) {
          float fa[N], fb[N];
          load_vec(a + i * N, fa);
          load_vec(b + i * N, fb);
#pragma unroll
          for (int n = 0; n < N; ++n) part = fmaf(fa[n], fb[n], part);
        }
      } else {
        for (int d = lane; d < D; d += 32) part = fmaf(to_f32(a[d]), to_f32(b[d]), part);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) dg[s * k + j] = from_f32<T>(part);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

unsigned grid_for(int64_t rows) { return static_cast<unsigned>((rows + kWarps - 1) / kWarps); }

template <typename T>
int gather(const void* src, const int* slot, const void* scale, void* out, int64_t rows, int D,
           int k, cudaStream_t st) {
  const bool vec = D % vec_n<T>() == 0 && aligned16(src) && aligned16(out);
  const T* sp = static_cast<const T*>(src);
  const T* sc = static_cast<const T*>(scale);
  T* op = static_cast<T*>(out);
  if (vec) {
    moe_gather_kernel<T, true><<<grid_for(rows), kThreads, 0, st>>>(sp, slot, sc, op, rows, D, k);
  } else {
    moe_gather_kernel<T, false><<<grid_for(rows), kThreads, 0, st>>>(sp, slot, sc, op, rows, D, k);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int combine(const void* y, const int* row, const void* w, void* out, int64_t S, int D, int k,
            cudaStream_t st) {
  const bool vec = D % vec_n<T>() == 0 && aligned16(y) && aligned16(out);
  const T* yp = static_cast<const T*>(y);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (vec) {
    moe_combine_kernel<T, true><<<grid_for(S), kThreads, 0, st>>>(yp, row, wp, op, S, D, k);
  } else {
    moe_combine_kernel<T, false><<<grid_for(S), kThreads, 0, st>>>(yp, row, wp, op, S, D, k);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gate_grad(const void* dout, const void* y, const int* row, void* dg, int64_t S, int D, int k,
              cudaStream_t st) {
  const bool vec = D % vec_n<T>() == 0 && aligned16(dout) && aligned16(y);
  const T* ap = static_cast<const T*>(dout);
  const T* yp = static_cast<const T*>(y);
  T* gp = static_cast<T*>(dg);
  if (vec) {
    moe_gate_grad_kernel<T, true><<<grid_for(S), kThreads, 0, st>>>(ap, yp, row, gp, S, D, k);
  } else {
    moe_gate_grad_kernel<T, false><<<grid_for(S), kThreads, 0, st>>>(ap, yp, row, gp, S, D, k);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_sizes(int64_t rows, int D, int k) {
  return D <= 0 || k < 1 || k > kMaxK || (rows + kWarps - 1) / kWarps > 0x7fffffff;
}

}  // namespace

extern "C" {

// src [S, D], out [rows = E * C, D], scale [S, k] or null (1): all one type
// (bf16 != 0: bfloat16, else float32); slot [rows] int32 (s * k + j, or -1).
// All contiguous. One launch on `stream`. Returns cudaGetLastError() after it
// (0 on success), or -1 for a width, k or grid the kernel does not take.
int moe_gather_launch(const void* src, const void* slot, const void* scale, void* out,
                      int64_t rows, int D, int k, int bf16, void* stream) {
  if (bad_sizes(rows, D, k)) return -1;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slot);
  return bf16 ? gather<__nv_bfloat16>(src, sl, scale, out, rows, D, k, st)
              : gather<float>(src, sl, scale, out, rows, D, k, st);
}

// y [E * C, D], out [S, D], w [S, k] or null (1): one type; row [S, k] int32
// (e * C + pos, or -1). Launch and return as moe_gather_launch.
int moe_combine_launch(const void* y, const void* row, const void* w, void* out, int64_t S,
                       int D, int k, int bf16, void* stream) {
  if (bad_sizes(S, D, k)) return -1;
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* rw = static_cast<const int*>(row);
  return bf16 ? combine<__nv_bfloat16>(y, rw, w, out, S, D, k, st)
              : combine<float>(y, rw, w, out, S, D, k, st);
}

// dout [S, D], y [E * C, D], dg [S, k]: one type; row as moe_combine_launch.
int moe_gate_grad_launch(const void* dout, const void* y, const void* row, void* dg, int64_t S,
                         int D, int k, int bf16, void* stream) {
  if (bad_sizes(S, D, k)) return -1;
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* rw = static_cast<const int*>(row);
  return bf16 ? gate_grad<__nv_bfloat16>(dout, y, rw, dg, S, D, k, st)
              : gate_grad<float>(dout, y, rw, dg, S, D, k, st);
}

}  // extern "C"
