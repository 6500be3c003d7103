// Tiles and sub-chunk sums shared by the RWKV-6 scan's forward
// (rwkv6_scan.cu) and backward (rwkv6_scan_bwd.cu): one block of kThreads
// threads works on one chunk of <= kMaxC tokens of one (batch, head), with
// each [kMaxC, kMaxDh] operand in shared memory as float32 rows kLd apart.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rwkv6 {

constexpr int kThreads = 256;
constexpr int kMaxDh = 64;
constexpr int kMaxC = 64;
constexpr int kSub = 16;
constexpr int kMaxSub = kMaxC / kSub;
constexpr int kLd = kMaxDh + 4;       // tile row stride: float4-aligned, rows 4 banks apart
constexpr int kTile = kMaxC * kLd;     // one [64, 64] float tile
constexpr int kLdAtt = kMaxC + 4;      // float4-aligned rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One [kMaxC, kMaxDh] tile of a (b, t, h, d) tensor: rows t < C of chunk c
// of (b, h), zero where t >= C, d >= Dh or the token lies past T, stored
// as float32 at t * kLd + d. With a.vec (Dh and the strides multiples of 8
// elements, the tensors 16-byte aligned: the model's layout) fetch() issues
// the thread's 16-byte loads into registers and store() writes them out,
// so a block fetches all its tiles before it waits on any; without a.vec,
// store() loads one element at a time. A is the kernel's argument struct
// (fields C, Dh, T, sT, vec).
template <typename T, typename A>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);           // elements a load
  static constexpr int kRowVecs = kMaxDh / kVec;
  static constexpr int kPer = kMaxC * kRowVecs / kThreads;
  uint4 w[kPer];

  __device__ __forceinline__ void fetch(const T* src, const A& a, int64_t base, int c0) {
    if (!a.vec) return;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int t = idx / kRowVecs, d = (idx % kRowVecs) * kVec;
      w[j] = make_uint4(0u, 0u, 0u, 0u);
      if (t < a.C && d < a.Dh && c0 + t < a.T)
        w[j] = __ldg(reinterpret_cast<const uint4*>(src + base + (int64_t)(c0 + t) * a.sT + d));
    }
  }

  __device__ __forceinline__ void store(float* dst, const T* src, const A& a, int64_t base,
                                        int c0) const {
    if (a.vec) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int idx = threadIdx.x + j * kThreads;
        float* out = dst + (idx / kRowVecs) * kLd + (idx % kRowVecs) * kVec;
        const T* e = reinterpret_cast<const T*>(&w[j]);
#pragma unroll
        for (int x = 0; x < kVec; ++x) out[x] = to_f32(e[x]);
      }
      return;
    }
    for (int idx = threadIdx.x; idx < kMaxC * kMaxDh; idx += kThreads) {
      const int t = idx / kMaxDh, d = idx % kMaxDh;
      float x = 0.f;
      if (t < a.C && d < a.Dh && c0 + t < a.T) x = to_f32(src[base + (int64_t)(c0 + t) * a.sT + d]);
      dst[t * kLd + d] = x;
    }
  }
};

// Per channel and sub-chunk, in token order: lc (inclusive, from the
// sub-chunk's start) over lw in place, lx (exclusive: lc of the previous
// token, 0 at the start) into lx if given, and the sub-chunk total. One
// thread per (sub-chunk, channel).
static_assert(kMaxSub * kMaxDh == kThreads, "local_cumsums takes one thread a (q, d)");
__device__ __forceinline__ void local_cumsums(float* lw_lc, float* lx, float* tot) {
  const int q = threadIdx.x / kMaxDh, d = threadIdx.x % kMaxDh;
  float acc = 0.f;
  for (int t = q * kSub; t < (q + 1) * kSub; ++t) {
    if (lx) lx[t * kLd + d] = acc;
    acc += lw_lc[t * kLd + d];
    lw_lc[t * kLd + d] = acc;
  }
  tot[q * kMaxDh + d] = acc;
}

// tot[lo] + ... + tot[hi - 1] for channel d, in that order.
__device__ __forceinline__ float run_sum(const float* tot, int lo, int hi, int d) {
  float acc = 0.f;
  for (int j = lo; j < hi; ++j) acc += tot[j * kMaxDh + d];
  return acc;
}

// The diagonal blocks of att: att[t, i] = sum_d r[t, d] k[i, d]
// exp(lx[t, d] - lc[i, d]) for the pairs i < t of one sub-chunk, decays
// pairwise, one thread a pair. R and K hold r and k as they are.
__device__ __forceinline__ void att_diagonal(const float* R, const float* K, const float* LX,
                                             const float* LC, float* ATT, int nsub) {
  constexpr int kPairs = kSub * (kSub - 1) / 2;
  for (int idx = threadIdx.x; idx < nsub * kPairs; idx += kThreads) {
    const int q = idx / kPairs;
    int pr = idx % kPairs, tl = 1;
    while (pr >= tl) pr -= tl++;
    const int t = q * kSub + tl, i = q * kSub + pr;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);  // four chains, summed at the end
#pragma unroll 4
    for (int d = 0; d < kMaxDh; d += 4) {
      const float4 rt = *reinterpret_cast<const float4*>(R + t * kLd + d);
      const float4 xt = *reinterpret_cast<const float4*>(LX + t * kLd + d);
      const float4 ki = *reinterpret_cast<const float4*>(K + i * kLd + d);
      const float4 ci = *reinterpret_cast<const float4*>(LC + i * kLd + d);
      acc.x = fmaf(rt.x * ki.x, __expf(xt.x - ci.x), acc.x);
      acc.y = fmaf(rt.y * ki.y, __expf(xt.y - ci.y), acc.y);
      acc.z = fmaf(rt.z * ki.z, __expf(xt.z - ci.z), acc.z);
      acc.w = fmaf(rt.w * ki.w, __expf(xt.w - ci.w), acc.w);
    }
    ATT[t * kLdAtt + i] = (acc.x + acc.y) + (acc.z + acc.w);
  }
}

}  // namespace rwkv6
