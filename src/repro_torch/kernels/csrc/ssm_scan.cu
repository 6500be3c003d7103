// Selective (Mamba-style) diagonal state-space scan for Hopper: the hybrid
// family's SSM heads (hymba).
//
// Replaces no Pallas kernel. The reference evaluates this recurrence with
// jax.lax.associative_scan over (decay, drive) pairs in ssm_parallel
// (src/repro/models/ssm.py:80), which materialises decay = exp(dt * A) and
// drive = (dt * u) * B as [B, T, Di, S] float32 arrays. At hymba's prefill
// (4 x 2048 tokens, Di = 3200, S = 16) each is 1.68 GB a layer, and PyTorch
// would then make log-depth passes over them, or thousands of small launches
// a layer in a loop over T. This kernel forms both on the fly, one token at a
// time, and never writes them out. Per (b, di) and state s, with
// A = -exp(log_a[di, s]):
//
//   h_t[s] = exp(dt_t * A[s]) * h_{t-1}[s] + (dt_t * u_t) * B_t[s]
//   y_t    = sum_s C_t[s] * h_t[s] + d_skip * u_t
//
// from h_{-1} = state0; it returns y [B, T, Di] and h_{T-1} [B, Di, S] in
// float32. T is any length: the reference's chunks of 2048 tokens, padded
// with decay 1 and drive 0, give this same recurrence.
//
// Bound: HBM bytes. The call must read u, dt (per (b, t, di)) and B, C (per
// (b, t)) and write y: at hymba's prefill 263 MB, 0.079 ms at 3.35 TB/s,
// against 16 exponentials and about 7 flops per (b, t, di, s) (2.9 GFLOP,
// 0.044 ms at the float32 peak). The recurrence is sequential in t, so the
// parallelism is B * Di chains (12,800 at that shape); what limits this
// design is latency and instruction issue, not bytes. The design:
//   * kLanes = 4 threads share one (b, di): each holds 4 of its 16 states in
//     registers, and y's sum over s closes with two xor shuffles inside the
//     group. That gives 4 * B * Di threads (12 warps an SM at hymba's
//     shape) where one thread per (b, di) would give 3.
//   * Each thread loads the next kAhead tokens' u, dt, B and C into
//     registers while it computes the current ones, so a load's latency
//     overlaps kAhead tokens of arithmetic.
//   * Neighbouring groups hold neighbouring di: u and dt loads and y stores
//     are coalesced; B and C of one (b, t) are read by every group of a
//     block from L1 (one 16-byte vector a thread when S == 16).
//   * The decays come from the approximate unit, ex2.approx on dt * A2 with
//     A2 = A * log2(e) formed once a thread: two instructions where expf
//     takes about ten. Its relative error (about 2^-22) and the rounding of
//     A2 keep the kernel within float32 rounding of the plain loop's exp.
// tools/ssm_scan_variants.py builds and times this source with two threads
// a chain, with 2 or 8 tokens loaded ahead and with expf decays (PERF.md).
// A simple first design: a chunked two-pass scan (chunk states, a scan over
// chunks, outputs) would give T / chunk times the parallelism.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxS = 16;              // the largest state the kernel takes
constexpr int kLanes = 4;              // threads per (b, di)
constexpr int kPer = kMaxS / kLanes;   // states per thread
constexpr int kThreads = 128;          // 32 (b, di) chains a block
constexpr int kAhead = 4;              // tokens loaded ahead
static_assert(kMaxS % kLanes == 0 && kPer % 4 == 0, "whole 16-byte vectors a thread");

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (x <= 0 here: dt >= 0, A < 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// B or C of token t for this thread's states (q * kPer .. q * kPer + kPer - 1).
template <bool kVec>
__device__ __forceinline__ void load_states(const float* __restrict__ p, int64_t t, int S,
                                            int q, float out[kPer]) {
  if (kVec) {
#pragma unroll
    for (int j = 0; j < kPer; j += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + t * kMaxS + q * kPer + j));
      out[j] = v.x;
      out[j + 1] = v.y;
      out[j + 2] = v.z;
      out[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int s = q * kPer + j;
      out[j] = s < S ? __ldg(p + t * S + s) : 0.f;
    }
  }
}

template <typename TU, bool kVec>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const TU* __restrict__ u, const float* __restrict__ dt, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ log_a,
    const float* __restrict__ d_skip, const float* __restrict__ s0, float* __restrict__ y,
    float* __restrict__ s_out, int B, int T, int Di, int S) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int q = threadIdx.x % kLanes;
  const int64_t chain = g / kLanes;
  // A group past the last chain runs on chain 0's operands and stores
  // nothing: every lane of the warp takes part in the shuffles.
  const bool live = chain < static_cast<int64_t>(B) * Di;
  const int64_t c = live ? chain : 0;
  const int64_t b = c / Di;
  const int di = static_cast<int>(c % Di);

  // a = A * log2(e): exp(dt * A) = 2^(dt * a).
  float a[kPer], h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = q * kPer + j;
    a[j] = s < S ? -expf(log_a[static_cast<int64_t>(di) * S + s]) * kLog2e : 0.f;
    h[j] = s < S ? s0[c * S + s] : 0.f;
  }
  const float dsk = d_skip[di];
  const TU* up = u + b * T * Di + di;
  const float* dp = dt + b * T * Di + di;
  const float* bp = bm + b * T * S;
  const float* cp = cm + b * T * S;
  float* yp = y + b * T * Di + di;

  float cu[kAhead], cd[kAhead], cb[kAhead][kPer], cc[kAhead][kPer];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const int64_t t = i < T ? i : T - 1;
    cu[i] = to_f32(up[t * Di]);
    cd[i] = __ldg(dp + t * Di);
    load_states<kVec>(bp, t, S, q, cb[i]);
    load_states<kVec>(cp, t, S, q, cc[i]);
  }
  for (int t0 = 0; t0 < T; t0 += kAhead) {
    // The next tile's operands (clamped to the last token past the end).
    float nu[kAhead], nd[kAhead], nb[kAhead][kPer], nc[kAhead][kPer];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int64_t t = t0 + kAhead + i < T ? t0 + kAhead + i : T - 1;
      nu[i] = to_f32(up[t * Di]);
      nd[i] = __ldg(dp + t * Di);
      load_states<kVec>(bp, t, S, q, nb[i]);
      load_states<kVec>(cp, t, S, q, nc[i]);
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (t0 + i < T) {  // uniform: every chain has the same T
        const float dtu = cd[i] * cu[i];
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float decay = exp2_approx(cd[i] * a[j]);
          h[j] = fmaf(decay, h[j], dtu * cb[i][j]);
          acc = fmaf(h[j], cc[i][j], acc);
        }
#pragma unroll
        for (int o = 1; o < kLanes; o *= 2) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (live && q == 0) yp[static_cast<int64_t>(t0 + i) * Di] = acc + dsk * cu[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      cu[i] = nu[i];
      cd[i] = nd[i];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        cb[i][j] = nb[i][j];
        cc[i][j] = nc[i][j];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int s = q * kPer + j;
      if (s < S) s_out[c * S + s] = h[j];
    }
  }
}

template <typename TU>
int launch(const void* u, const float* dt, const float* bm, const float* cm, const float* log_a,
           const float* d_skip, const float* s0, float* y, float* s_out, int B, int T, int Di,
           int S, cudaStream_t st) {
  const int64_t threads = static_cast<int64_t>(B) * Di * kLanes;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return -1;
  const bool vec = S == kMaxS && reinterpret_cast<uintptr_t>(bm) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cm) % 16 == 0;
  const TU* up = static_cast<const TU*>(u);
  if (vec) {
    selective_scan_kernel<TU, true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        up, dt, bm, cm, log_a, d_skip, s0, y, s_out, B, T, Di, S);
  } else {
    selective_scan_kernel<TU, false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        up, dt, bm, cm, log_a, d_skip, s0, y, s_out, B, T, Di, S);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// u [B, T, Di] (bf16 != 0: bfloat16, else float32); dt [B, T, Di], bm and cm
// [B, T, S], log_a [Di, S], d_skip [Di], s0 [B, Di, S]: float32. Outputs y
// [B, T, Di] and s_out [B, Di, S], float32. All contiguous. 1 <= S <= 16,
// T >= 1. One launch on `stream`. Returns cudaGetLastError() after it (0 on
// success), or -1 for an unsupported S or a grid too large.
int selective_scan_launch(const void* u, const void* dt, const void* bm, const void* cm,
                          const void* log_a, const void* d_skip, const void* s0, void* y,
                          void* s_out, int B, int T, int Di, int S, int bf16, void* stream) {
  if (S < 1 || S > kMaxS) return -1;
  if (B <= 0 || T <= 0 || Di <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(dt), static_cast<const float*>(bm),
                      static_cast<const float*>(cm), static_cast<const float*>(log_a),
                      static_cast<const float*>(d_skip), static_cast<const float*>(s0)};
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(s_out);
  return bf16 ? launch<__nv_bfloat16>(u, f[0], f[1], f[2], f[3], f[4], f[5], yo, so, B, T, Di,
                                      S, st)
              : launch<float>(u, f[0], f[1], f[2], f[3], f[4], f[5], yo, so, B, T, Di, S, st);
}

}  // extern "C"
