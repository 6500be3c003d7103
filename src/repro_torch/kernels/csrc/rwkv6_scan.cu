// Chunked RWKV-6 (Finch) recurrence for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6_scan.py::rwkv6_scan.
// Per (batch, head), with state S in R^{Dh x Dh} (float32):
//   o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
// computed in the chunked parallel form of the model's
// src/repro/models/rwkv6.py::_rwkv6_chunked.chunk_fn: per chunk of C tokens,
// with cum the inclusive cumulative sum of logw over the chunk and
// cum_ex = cum - logw,
//   o = (r * exp(cum_ex)) S  +  att v  +  (r . (u * k)) v,
//       att[t, i] = sum_d r[t,d] k[i,d] exp(cum_ex[t,d] - cum[i,d])  (i < t)
//   S' = exp(cum[C-1]) * S  +  (k * exp(cum[C-1] - cum))^T v.
// Returns o in float32 and the final state.
//
// Layout: the kernel reads r/k/v (float32 or bfloat16) and logw (float32)
// through (b, t, h) strides, so the model hands it its [B, T, H, Dh]
// projections directly (no transposed float32 copies) and the Pallas
// signature's [BH, T, Dh] is the case H = 1. o has the inputs' strides. A T
// that is not a multiple of C is padded inside the kernel with r = k = v = 0,
// logw = 0 -- the padding the model applies -- so the carried state is exact
// and no padded copy is made.
//
// Bound: at the serving shape (B = 4, T = 2048, H = 32, Dh = 64, C = 64) a
// launch moves about 239 MB (r/k/v bf16, logw f32, o f32 out, state in and
// out): 0.071 ms at 3.35 TB/s on an H100 SXM. The matrix work is 9.7 GFLOP
// (0.010 ms at the bf16 tensor-core peak). The pairwise decays as this
// kernel evaluates them are C (C - 1) / 2 live pairs (i < t) x Dh per chunk:
// 2016 x 64 x 32 chunks x 128 heads = 5.3e8 __expf. At 16 per clock per SM
// on the SFUs, 132 SMs at 1.98 GHz, that is 0.126 ms, 1.8x the byte bound.
// The kernel is still held to the byte bound, because those exponentials are
// not work the function needs: exp(cum_ex[t] - cum[i]) factors into
// exp(cum_ex[t]) * exp(-cum[i]), 2 C Dh exponentials per chunk instead of
// C^2 Dh / 2, kept in float32 range by taking the cumulative sums relative
// to the start of sub-chunks; its exponentials then take well under the
// byte bound. This kernel does not factor, and its gap to the bound
// includes that choice.
// What the design does about it:
//   * One block per (b, h) walks its chunks in order (the TPU's sequential
//     last grid axis becomes a loop inside the block) and keeps the Dh x Dh
//     float32 state in shared memory for the whole sequence: the state
//     touches device memory only on the way in and out. At the serving
//     shape that is B * H = 128 blocks for 132 SMs, one wave, each SM busy
//     with one block: the launch's time is one block's time. So a block is
//     1024 threads (32 warps, at most 64 registers each), to hide the
//     latency of its shared-memory loads and exponentials (256 threads
//     with expf took about twice as long on the H100; PERF.md).
//   * The [C, C, Dh] pairwise decay tensor (1 MB at C = Dh = 64) is never
//     stored: each att[t, i] evaluates its Dh exponentials on the fly (the
//     SFU's __expf: its exponent is <= 0, where the fast form is accurate
//     to a few float32 ulps), and only the C x C att tile stays in shared
//     memory.
//   * Every operand of a chunk is read once into shared memory (rows padded
//     to Dh + 1 words, so the column walks are conflict-free), converted to
//     float32 there; the products run as float32 FMAs on the CUDA cores.
// Sums run in another order than PyTorch's, so the result agrees with the
// plain version (kernels/rwkv6_scan.py) to float32 rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxDh = 64;
constexpr int kMaxC = 64;
constexpr int kStateRegs = kMaxDh * kMaxDh / kThreads;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

size_t smem_bytes(int dh, int c) {
  const int ld = dh + 1;
  // r (then r * exp(cum_ex)), k (then the decayed k), v, logw (then
  // cum_ex), cum: [C, Dh + 1] each; S [Dh, Dh + 1]; att [C, C + 1];
  // bonus [C]; u [Dh].
  return sizeof(float) * (5 * c * ld + dh * ld + c * (c + 1) + c + dh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ logw, const float* __restrict__ u,
             const float* __restrict__ s0, float* __restrict__ o, float* __restrict__ s_out,
             int H, int T_len, int Dh, int C, int64_t sB, int64_t sT, int64_t sH, int64_t uB) {
  const int ld = Dh + 1;
  extern __shared__ float smem[];
  float* R = smem;             // [C, ld]
  float* K = R + C * ld;
  float* V = K + C * ld;
  float* LW = V + C * ld;      // logw, then cum_ex
  float* CUM = LW + C * ld;
  float* S = CUM + C * ld;     // [Dh, ld]
  float* ATT = S + Dh * ld;    // [C, C + 1]
  float* BONUS = ATT + C * (C + 1);
  float* U = BONUS + C;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int64_t base = (int64_t)b * sB + (int64_t)h * sH;
  const int64_t sbase = (int64_t)bh * Dh * Dh;

  for (int idx = tid; idx < Dh * Dh; idx += kThreads)
    S[(idx / Dh) * ld + idx % Dh] = s0[sbase + idx];
  for (int d = tid; d < Dh; d += kThreads) U[d] = u[(int64_t)b * uB + (int64_t)h * Dh + d];

  for (int c0 = 0; c0 < T_len; c0 += C) {
    __syncthreads();  // S, U written; the previous chunk is consumed
    for (int idx = tid; idx < C * Dh; idx += kThreads) {
      const int t = idx / Dh, d = idx % Dh;
      float rv = 0.f, kv = 0.f, vv = 0.f, lw = 0.f;
      if (c0 + t < T_len) {
        const int64_t off = base + (int64_t)(c0 + t) * sT + d;
        rv = to_f32(r[off]);
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
        lw = logw[off];
      }
      R[t * ld + d] = rv;
      K[t * ld + d] = kv;
      V[t * ld + d] = vv;
      LW[t * ld + d] = lw;
    }
    __syncthreads();
    // Inclusive cumulative sum per channel, in token order; cum_ex = cum - logw.
    for (int d = tid; d < Dh; d += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < C; ++t) {
        const float lw = LW[t * ld + d];
        acc += lw;
        CUM[t * ld + d] = acc;
        LW[t * ld + d] = acc - lw;
      }
    }
    // The diagonal bonus r_t . (u * k_t).
    for (int t = tid; t < C; t += kThreads) {
      float acc = 0.f;
      for (int d = 0; d < Dh; ++d) acc = fmaf(R[t * ld + d] * U[d], K[t * ld + d], acc);
      BONUS[t] = acc;
    }
    __syncthreads();
    // att[t, i] for i < t, the pairwise decays evaluated on the fly.
    for (int idx = tid; idx < C * C; idx += kThreads) {
      const int t = idx / C, i = idx % C;
      float acc = 0.f;
      if (i < t) {
        const float* rt = R + t * ld;
        const float* ce = LW + t * ld;
        const float* ki = K + i * ld;
        const float* ci = CUM + i * ld;
        for (int d = 0; d < Dh; ++d) acc = fmaf(rt[d] * ki[d], __expf(ce[d] - ci[d]), acc);
      }
      ATT[t * (C + 1) + i] = acc;
    }
    __syncthreads();
    // r * exp(cum_ex) in place of r; k * exp(cum[C-1] - cum) in place of k.
    for (int idx = tid; idx < C * Dh; idx += kThreads) {
      const int t = idx / Dh, d = idx % Dh;
      R[t * ld + d] *= expf(LW[t * ld + d]);
      K[t * ld + d] *= expf(CUM[(C - 1) * ld + d] - CUM[t * ld + d]);
    }
    __syncthreads();
    // Outputs of the chunk: state part + intra-chunk part + diagonal part.
    for (int idx = tid; idx < C * Dh; idx += kThreads) {
      const int t = idx / Dh, e = idx % Dh;
      if (c0 + t >= T_len) continue;
      float o_state = 0.f;
      for (int d = 0; d < Dh; ++d) o_state = fmaf(R[t * ld + d], S[d * ld + e], o_state);
      float o_intra = 0.f;
      for (int i = 0; i < t; ++i) o_intra = fmaf(ATT[t * (C + 1) + i], V[i * ld + e], o_intra);
      o[base + (int64_t)(c0 + t) * sT + e] = (o_state + o_intra) + BONUS[t] * V[t * ld + e];
    }
    // The carried state, into registers first: S is still being read.
    float s_new[kStateRegs];
#pragma unroll
    for (int n = 0; n < kStateRegs; ++n) {
      const int idx = tid + n * kThreads;
      if (idx < Dh * Dh) {
        const int d = idx / Dh, e = idx % Dh;
        float acc = 0.f;
        for (int i = 0; i < C; ++i) acc = fmaf(K[i * ld + d], V[i * ld + e], acc);
        s_new[n] = expf(CUM[(C - 1) * ld + d]) * S[d * ld + e] + acc;
      }
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < kStateRegs; ++n) {
      const int idx = tid + n * kThreads;
      if (idx < Dh * Dh) S[(idx / Dh) * ld + idx % Dh] = s_new[n];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < Dh * Dh; idx += kThreads)
    s_out[sbase + idx] = S[(idx / Dh) * ld + idx % Dh];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw, const void* u,
           const void* s0, void* o, void* s_out, int B, int H, int T_len, int Dh, int C,
           int64_t sB, int64_t sT, int64_t sH, int64_t uB, cudaStream_t st) {
  const size_t smem = smem_bytes(Dh, C);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_kernel<T><<<(unsigned)(B * H), kThreads, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(logw), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(o), static_cast<float*>(s_out), H,
      T_len, Dh, C, sB, sT, sH, uB);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v (bf16 != 0: bfloat16, else float32) and logw, o (float32): element
// (b, t, h, d) at b * sB + t * sT + h * sH + d. u: float32, element (b, h, d)
// at b * uB + h * Dh + d. s0, s_out: [B * H, Dh, Dh] float32, contiguous.
// 1 <= Dh <= 64, 1 <= C <= 64. Returns cudaGetLastError() after the launch
// (0 on success), or -1 for an unsupported Dh or C.
int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* logw,
                      const void* u, const void* s0, void* o, void* s_out, int B, int H,
                      int T_len, int Dh, int C, int64_t sB, int64_t sT, int64_t sH, int64_t uB,
                      int bf16, void* stream) {
  if (Dh < 1 || Dh > kMaxDh || C < 1 || C > kMaxC) return -1;
  if (B <= 0 || H <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, logw, u, s0, o, s_out, B, H, T_len, Dh, C, sB, sT,
                                 sH, uB, st);
  return launch<float>(r, k, v, logw, u, s0, o, s_out, B, H, T_len, Dh, C, sB, sT, sH, uB,
                       st);
}

}  // extern "C"
