// Backward of flash attention (flash recompute) for Hopper.
//
// Replaces the hand-scheduled custom VJP of the model's attention,
// src/repro/models/flash_jnp.py::_vjp_bwd (jnp in the reference; it is the
// recompute schedule of the Pallas kernel src/repro/kernels/flash_attention.py).
// Given q [B, T, H, Dh], k/v [B, S, Kv, Dh] (GQA: kv head = h / (H / Kv)),
// the forward's o [B, T, H, Dh], the output gradient do [B, T, H, Dh] and the
// forward's row statistics m, l (float32 [B, H, T]):
//   D     = rowsum(do * o)                       (per query row)
//   p     = exp(q k^T * scale - m) / max(l, 1e-30)    where the key is live, else 0
//   dv    = p^T do
//   ds    = p * (do v^T - D)
//   dq    = ds k * scale
//   dk    = ds^T q * scale
// summed over the H / Kv q heads of each kv head for dk and dv, all in
// float32, outputs in the inputs' dtype. The mask is the forward's: s < S,
// (causal) s <= qpos, s > qpos - w with w = window > 0 ? window : S + T,
// qpos = q_offset + t.
//
// Bound: at the training shape (q [1, 2048, 32, 128] against k/v
// [1, 2048, 2, 128], causal) the function does 10 Dh FLOP for each of
// 67,141,632 live (query, key, head) pairs (the five products), 8.59e10
// FLOP: 0.087 ms at the bf16 tensor-core peak of an H100 SXM (700 W),
// against about 72 MB of HBM traffic (0.021 ms), so it is bound by
// operations.
//
// Three launches on the caller's stream, no atomics, so the result is
// deterministic:
//   1. dq: one block per (query tile, q head). D = rowsum(do * o) for its
//      rows (kept for launch 2), then a loop over the kv tiles with a live
//      key that rebuilds p and ds and accumulates dq.
//   2. dk/dv: one block per (key tile, q head). A loop over the q tiles
//      with a live query that rebuilds p^T and ds^T and accumulates this q
//      head's share of dk and dv, written to float32 scratch [B, S, H, Dh].
//   3. flash_bwd_reduce_kernel: dk, dv = the sum of the H / Kv shares of
//      each kv head, in head order, cast to the output dtype.
// Both passes rebuild S and dP, so q k^T and do v^T run twice: 7 products
// where the function needs 5 (one pass would have to sum dq across blocks,
// with atomics, and lose the fixed order).
//
// bfloat16 (the model's dtype): flash_bwd_dq_wgmma_kernel and
// flash_bwd_dkdv_wgmma_kernel, on the tensor cores, built from the
// forward's parts (hopper.cuh) and shaped like its kernel. They replace a
// first version on the CUDA cores (4.43 ms at the training shape on an H100
// SXM at 700 W, 2% of the bound, against 0.31-0.45 ms for the backward of
// PyTorch's SDPA).
//   * A block is a producer warpgroup (one thread issues every load with
//     TMA; setmaxnreg.dec 24) and two consumer warpgroups (setmaxnreg.inc
//     240), each owning 64 rows of a 128-row resident tile: Q and dO in
//     pass 1, K and V in pass 2. The other operands stream through a ring
//     of kStages 64-row tiles with full/empty mbarriers: K and V in pass 1;
//     Q, dO and their rows' statistics in pass 2. 4-D tensor maps over the
//     model's own tensors read the GQA heads unexpanded and zero-fill rows
//     past T and S (no padded copies); tiles are 128-byte swizzled (64-byte
//     at Dh = 32).
//   * Pass 1, per kv tile: S = Q K^T and dP = dO V^T (wgmma, both operands
//     K-major in shared memory); P = 2^(S scale log2(e) - lse) with
//     lse = m log2(e) + log2(l), exactly 0 where the key is masked, and
//     dS = P (dP - D), in registers in the accumulator layout (which is the
//     A fragment's); dQ += dS K (wgmma, dS from registers, K as the
//     MN-major operand, as V in the forward's P V).
//   * Pass 2, per q tile: S^T = K Q^T and dP^T = V dO^T (shared memory);
//     P^T and dS^T in registers, with each query's lse and D read from the
//     float2 that pass 1 wrote for it and a bulk copy brought in with the
//     tile; dV += P^T dO and dK += dS^T Q (registers x MN-major shared
//     memory). Q tiles of 64 keep the two m64 x Dh float32 accumulators
//     (128 registers a thread at Dh = 128) beside S^T, dP^T and the operand
//     packs within 240 registers.
//   * Each pass issues its products at about half the peak. A likely cause
//     (not measured: no profiler of the SM's pipes on the card's host): S
//     and dP are m64n64 products with both operands in shared memory, which
//     read about as many bytes as the tensor cores can take; a wider tile
//     needs registers that pass 2's two accumulators leave no room for.
//   * Accuracy: q k^T and do v^T need nothing (a product of two bf16 is
//     exact in float32). P and dS are float32: each is split into a bf16
//     high part and the bf16 rest, and both go into the same accumulator,
//     so they keep about 16 bits where one bf16 would keep 8 (about 200
//     times the gate of 1e-5 of each gradient's largest entry). So the
//     tensor cores issue 10 products' worth of 2 Dh FLOP a pair: 1.72e11
//     FLOP at the training shape, 0.174 ms at the peak.
//   * ptxas serialises wgmma on a branch it cannot prove warp-uniform, so
//     the warpgroup index comes through a shuffle and both consumers run
//     every tile of the block's range (a tile with no live pair adds 0).
//   * Order: the q heads that share a kv head run next to each other (their
//     K/V tiles meet in L2), and the tiles with the most causal work first.
// float32 (the tests' and the reduced models' dtype): flash_bwd_dq_kernel
// and flash_bwd_dkdv_kernel on the CUDA cores (67 TFLOP/s: 1.28 ms for the
// training shape's FLOP). A block is 256 threads; each owns 4 rows x 4
// columns of the 64 x 64 score tile (rows through warp shuffles, as the
// float32 forward) and 4 rows x Dh / 16 columns of its accumulators.
// Operand tiles are staged in shared memory with a padded row stride (Dh +
// 4 words: conflict-free float4 reads). The grid puts the tile index in y,
// ordered so that the tiles with the most causal work start first.
// Both paths sum in another order than the plain version's, so they agree
// with it to float32 rounding (bf16: plus the outputs' own rounding), not
// bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

using namespace hopper;

constexpr int kB = 64;         // queries (or keys) a tile
constexpr int kThreads = 256;
constexpr int kLDP = kB + 4;   // row stride of the p / ds tiles (words)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float t) {
  t = fmaf(a.x, b.x, t);
  t = fmaf(a.y, b.y, t);
  t = fmaf(a.z, b.z, t);
  return fmaf(a.w, b.w, t);
}

// rows [r0, r0 + kB) of a [*, rows, heads, DH] tensor's head (row stride
// `stride` elements from `base`) into shared memory as float32 with row
// stride DH + 4; rows at or past `n` are zero.
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, const T* base, int64_t stride, int r0, int n) {
  constexpr int LD = DH + 4;
  for (int idx = threadIdx.x; idx < kB * DH / 4; idx += kThreads) {
    const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
    const float4 val = (r0 + r < n) ? load4(base + (int64_t)(r0 + r) * stride + c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

template <int DH>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V padded; ds; m, 1/l, D.
  return sizeof(float) * (4 * kB * (DH + 4) + kB * kLDP + 3 * kB);
}

template <int DH>
constexpr size_t dkdv_smem_bytes() {
  // K, V, Q, dO padded; p^T and ds^T; m, 1/l, D.
  return sizeof(float) * (4 * kB * (DH + 4) + 2 * kB * kLDP + 3 * kB);
}

__device__ __forceinline__ bool is_live(int kpos, int qpos, int S, int w_eff, int causal) {
  bool live = kpos < S && kpos > qpos - w_eff;
  if (causal) live = live && kpos <= qpos;
  return live;
}

// ---------------------------------------------------------------- dq (+ D)

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ m_in, const float* __restrict__ l_in,
                    float* __restrict__ d_out, T* __restrict__ dq, int T_len, int S, int H,
                    int KV, int q_offset, int w_eff, int causal, float scale) {
  constexpr int LD = DH + 4;
  constexpr int DJ = DH / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kB * LD;
  float* Ks = dOs + kB * LD;
  float* Vs = Ks + kB * LD;
  float* Ps = Vs + kB * LD;   // ds [query][key]
  float* Ms = Ps + kB * kLDP;
  float* Li = Ms + kB;
  float* Dv = Li + kB;

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cs = tid & 15;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kB;  // the last q tile first
  const int kvh = h / (H / KV);
  const int64_t q_stride = (int64_t)H * DH, kv_stride = (int64_t)KV * DH;
  const T* qb = q + ((int64_t)b * T_len * H + h) * DH;
  const T* ob = o + ((int64_t)b * T_len * H + h) * DH;
  const T* dob = dout + ((int64_t)b * T_len * H + h) * DH;
  const T* kb = k + ((int64_t)b * S * KV + kvh) * DH;
  const T* vb = v + ((int64_t)b * S * KV + kvh) * DH;
  const int64_t srow = (int64_t)bh * T_len;

  stage<T, DH>(Qs, qb, q_stride, q0, T_len);
  stage<T, DH>(dOs, dob, q_stride, q0, T_len);
  // D = rowsum(do * o): four threads a row, each a quarter of the row.
  {
    const int r = tid >> 2, part = tid & 3;
    float acc = 0.f;
    if (q0 + r < T_len) {
      const T* orow = ob + (int64_t)(q0 + r) * q_stride;
      const T* drow = dob + (int64_t)(q0 + r) * q_stride;
      for (int c = part * (DH / 4); c < (part + 1) * (DH / 4); c += 4)
        acc = dot4(load4(drow + c), load4(orow + c), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      const bool in = q0 + r < T_len;
      Dv[r] = acc;
      Ms[r] = in ? m_in[srow + q0 + r] : 0.f;
      Li[r] = in ? 1.f / fmaxf(l_in[srow + q0 + r], 1e-30f) : 0.f;
      if (in) d_out[srow + q0 + r] = acc;
    }
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // The kv tiles that hold a live key for some row of this query tile.
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kB, T_len) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  const int lo = q_first - w_eff + 1;
  const int k_begin = lo > 0 ? (lo / kB) * kB : 0;

  for (int kt = k_begin; kt < k_end; kt += kB) {
    __syncthreads();  // the previous tile's K, V and ds are consumed (and D, m, 1/l written)
    stage<T, DH>(Ks, kb, kv_stride, kt, S);
    stage<T, DH>(Vs, vb, kv_stride, kt, S);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], c4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(Qs + (rg * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c4[j] = load4(Ks + (cs + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], c4[j], s[i][j]);
    }
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], c4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(dOs + (rg * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c4[j] = load4(Vs + (cs + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = dot4(a[i], c4[j], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const int qpos = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kt + cs + 16 * j;
        const float p = is_live(kpos, qpos, S, w_eff, causal)
                            ? expf(s[i][j] * scale - Ms[r]) * Li[r] : 0.f;
        Ps[r * kLDP + cs + 16 * j] = p * (dp[i][j] - Dv[r]);
      }
    }
    __syncthreads();

    // dq += ds K (the scale at the end).
#pragma unroll 2
    for (int c = 0; c < kB; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = load4(Ps + (rg * 4 + i) * kLDP + c);
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float k0 = Ks[(c + 0) * LD + cs + 16 * j];
        const float k1 = Ks[(c + 1) * LD + cs + 16 * j];
        const float k2 = Ks[(c + 2) * LD + cs + 16 * j];
        const float k3 = Ks[(c + 3) * LD + cs + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = acc[i][j];
          t = fmaf(pv[i].x, k0, t);
          t = fmaf(pv[i].y, k1, t);
          t = fmaf(pv[i].z, k2, t);
          t = fmaf(pv[i].w, k3, t);
          acc[i][j] = t;
        }
      }
    }
  }

  T* dqb = dq + ((int64_t)b * T_len * H + h) * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + rg * 4 + i;
    if (t >= T_len) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dqb[(int64_t)t * q_stride + cs + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

// ---------------------------------------------------------------- dk, dv

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ m_in,
                      const float* __restrict__ l_in, const float* __restrict__ d_in,
                      float* __restrict__ dk_part, float* __restrict__ dv_part, int T_len,
                      int S, int H, int KV, int q_offset, int w_eff, int causal, float scale) {
  constexpr int LD = DH + 4;
  constexpr int DJ = DH / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kB * LD;
  float* Qs = Vs + kB * LD;
  float* dOs = Qs + kB * LD;
  float* Pt = dOs + kB * LD;   // p^T [key][query]
  float* DSt = Pt + kB * kLDP;  // ds^T [key][query]
  float* Ms = DSt + kB * kLDP;
  float* Li = Ms + kB;
  float* Dv = Li + kB;

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cs = tid & 15;   // keys rg*4 .. rg*4+3; queries cs + 16 j
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int k0 = (int)blockIdx.y * kB;      // the first kv tile (the most causal work) first
  const int kvh = h / (H / KV);
  const int64_t q_stride = (int64_t)H * DH, kv_stride = (int64_t)KV * DH;
  const T* qb = q + ((int64_t)b * T_len * H + h) * DH;
  const T* dob = dout + ((int64_t)b * T_len * H + h) * DH;
  const int64_t srow = (int64_t)bh * T_len;

  stage<T, DH>(Ks, k + ((int64_t)b * S * KV + kvh) * DH, kv_stride, k0, S);
  stage<T, DH>(Vs, v + ((int64_t)b * S * KV + kvh) * DH, kv_stride, k0, S);

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // The q tiles that hold a live query for some key of this tile: causal
  // needs qpos >= kpos, the window qpos < kpos + w.
  const int k_last = min(k0 + kB, S) - 1;
  const int t_lo = causal ? max(0, k0 - q_offset) : 0;
  const int t_hi = min(T_len, (int)min((int64_t)k_last + w_eff - q_offset, (int64_t)T_len));
  const int t_begin = (t_lo / kB) * kB;

  for (int qt = t_begin; qt < t_hi; qt += kB) {
    __syncthreads();  // the previous tile's Q, dO, p^T and ds^T are consumed
    stage<T, DH>(Qs, qb, q_stride, qt, T_len);
    stage<T, DH>(dOs, dob, q_stride, qt, T_len);
    if (tid < kB) {
      const bool in = qt + tid < T_len;
      Ms[tid] = in ? m_in[srow + qt + tid] : 0.f;
      Li[tid] = in ? 1.f / fmaxf(l_in[srow + qt + tid], 1e-30f) : 0.f;
      Dv[tid] = in ? d_in[srow + qt + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], c4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(Ks + (rg * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c4[j] = load4(Qs + (cs + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(c4[j], a[i], s[i][j]);
    }
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], c4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(Vs + (rg * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) c4[j] = load4(dOs + (cs + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = dot4(c4[j], a[i], dp[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = rg * 4 + i;
      const int kpos = k0 + key;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = cs + 16 * j;
        const int qpos = q_offset + qt + r;
        const bool live = qt + r < T_len && is_live(kpos, qpos, S, w_eff, causal);
        const float p = live ? expf(s[i][j] * scale - Ms[r]) * Li[r] : 0.f;
        Pt[key * kLDP + r] = p;
        DSt[key * kLDP + r] = p * (dp[i][j] - Dv[r]);
      }
    }
    __syncthreads();

    // dv += p^T dO, dk += ds^T Q (the scale at the end).
#pragma unroll 2
    for (int c = 0; c < kB; c += 4) {
      float4 pv[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = load4(Pt + (rg * 4 + i) * kLDP + c);
        sv[i] = load4(DSt + (rg * 4 + i) * kLDP + c);
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int col = cs + 16 * j;
        const float o0 = dOs[(c + 0) * LD + col], o1 = dOs[(c + 1) * LD + col];
        const float o2 = dOs[(c + 2) * LD + col], o3 = dOs[(c + 3) * LD + col];
        const float x0 = Qs[(c + 0) * LD + col], x1 = Qs[(c + 1) * LD + col];
        const float x2 = Qs[(c + 2) * LD + col], x3 = Qs[(c + 3) * LD + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = dv[i][j];
          t = fmaf(pv[i].x, o0, t);
          t = fmaf(pv[i].y, o1, t);
          t = fmaf(pv[i].z, o2, t);
          t = fmaf(pv[i].w, o3, t);
          dv[i][j] = t;
          float u = dk[i][j];
          u = fmaf(sv[i].x, x0, u);
          u = fmaf(sv[i].y, x1, u);
          u = fmaf(sv[i].z, x2, u);
          u = fmaf(sv[i].w, x3, u);
          dk[i][j] = u;
        }
      }
    }
  }

  // This q head's share, [B, S, H, Dh] float32.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s_idx = k0 + rg * 4 + i;
    if (s_idx >= S) continue;
    const int64_t row = (((int64_t)b * S + s_idx) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk_part[row + cs + 16 * j] = dk[i][j] * scale;
      dv_part[row + cs + 16 * j] = dv[i][j];
    }
  }
}

// dk[b, s, kv, :] = sum over the group's q heads g of part[b, s, kv * grp + g, :].
template <typename T>
__global__ void flash_bwd_reduce_kernel(const float* __restrict__ dk_part,
                                        const float* __restrict__ dv_part, T* __restrict__ dk,
                                        T* __restrict__ dv, int64_t rows, int grp, int DH) {
  const int64_t n = rows * DH;  // rows = B * S * KV
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = i / DH, d = i % DH;
    const int64_t base = row * grp * DH + d;
    float a = 0.f, c = 0.f;
    for (int g = 0; g < grp; ++g) {
      a += dk_part[base + (int64_t)g * DH];
      c += dv_part[base + (int64_t)g * DH];
    }
    dk[i] = from_f32<T>(a);
    dv[i] = from_f32<T>(c);
  }
}


// dk, dv from the float32 shares: the third launch of both paths.
template <typename T>
int launch_reduce(const float* dk_part, const float* dv_part, void* dk, void* dv, int B, int S,
                  int H, int KV, int DH, cudaStream_t st) {
  const int64_t rows = (int64_t)B * S * KV;
  const int64_t n = rows * DH;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
  flash_bwd_reduce_kernel<T><<<blocks, 256, 0, st>>>(dk_part, dv_part, static_cast<T*>(dk),
                                                     static_cast<T*>(dv), rows, H / KV, DH);
  return (int)cudaGetLastError();
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* m, const float* l, float* dvec, float* dk_part, float* dv_part, void* dq,
           void* dk, void* dv, int B, int T_len, int S, int H, int KV, int q_offset, int w_eff,
           int causal, float scale, cudaStream_t st) {
  const size_t s1 = dq_smem_bytes<DH>(), s2 = dkdv_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<float, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<float, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return (int)err;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  flash_bwd_dq_kernel<float, DH><<<dim3((unsigned)(B * H), (unsigned)((T_len + kB - 1) / kB)),
                                   kThreads, s1, st>>>(
      qp, kp, vp, static_cast<const float*>(o), dop, m, l, dvec, static_cast<float*>(dq), T_len,
      S, H, KV, q_offset, w_eff, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<float, DH><<<dim3((unsigned)(B * H), (unsigned)((S + kB - 1) / kB)),
                                     kThreads, s2, st>>>(
      qp, kp, vp, dop, m, l, dvec, dk_part, dv_part, T_len, S, H, KV, q_offset, w_eff, causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce<float>(dk_part, dv_part, dk, dv, B, S, H, KV, DH, st);
}

// ------------------------------------------------------------------
// bfloat16: the warp-specialised wgmma + TMA kernels.

constexpr int kWgRes = 128;       // resident rows a block: queries (pass 1) or keys (pass 2)
constexpr int kWgStr = 64;        // streamed rows a tile: keys (pass 1) or queries (pass 2)
constexpr int kWgThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNoRow = 1e30f;   // the lse of a row past T: 2^(S - lse) = 0

template <int DH>
struct BwdCfg {
  static constexpr int kPanel = DH >= 64 ? 64 : 32;   // bf16 columns a box row holds
  static constexpr int kPanels = DH / kPanel;
  static constexpr int kRowBytes = kPanel * 2;        // = the swizzle width
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 2;
  static constexpr uint32_t kSbo = 8 * kRowBytes;     // 8-row core-matrix groups
  static constexpr int kStages = 3;
  static constexpr int kResBytes = kWgRes * DH * 2;   // one resident tile
  static constexpr int kStrBytes = kWgStr * DH * 2;   // one streamed tile
  static constexpr int kPanelRes = kWgRes * kRowBytes;
  static constexpr int kPanelStr = kWgStr * kRowBytes;
  static constexpr int kStatBytes = kWgStr * 8;       // a float2 a query (pass 2)
  static constexpr int kTileBytes = 2 * kResBytes + kStages * (2 * kStrBytes + kStatBytes);
  // + barriers, alignment
  static constexpr size_t kSmem = kTileBytes + 8 * (2 * kStages + 1) + 1024;
};

// Shared memory of both passes, from a 1024-byte aligned base (swizzled
// tiles need it): two resident tiles, kStages pairs of streamed tiles and
// their statistics, then the full[kStages], empty[kStages] and resident
// mbarriers.
template <int DH>
struct BwdSmem {
  using Cfg = BwdCfg<DH>;
  uint32_t res_a, res_b, str_a, str_b, stat, bar0;
  __device__ explicit BwdSmem(uint32_t base)
      : res_a(base), res_b(base + Cfg::kResBytes), str_a(base + 2 * Cfg::kResBytes),
        str_b(str_a + Cfg::kStages * Cfg::kStrBytes), stat(str_b + Cfg::kStages * Cfg::kStrBytes),
        bar0(base + Cfg::kTileBytes) {}
  __device__ uint32_t full(int s) const { return bar0 + 8 * s; }
  __device__ uint32_t empty(int s) const { return bar0 + 8 * (Cfg::kStages + s); }
  __device__ uint32_t res() const { return bar0 + 16 * Cfg::kStages; }
};

template <int DH>
__device__ __forceinline__ void init_barriers(const BwdSmem<DH>& sm) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < BwdCfg<DH>::kStages; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 2 * 128);
    }
    mbar_init(sm.res(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer thread: the resident tiles (maps ra, rb; head rh, rows from
// r0), then n_tiles streamed pairs (maps sa, sb; head sh, rows from t0, 64
// a tile) through the ring; with `stats`, each streamed tile also brings
// the statistics of its rows (stats[t0 ...]).
template <int DH>
__device__ __forceinline__ void produce(const BwdSmem<DH>& sm, const CUtensorMap* ra,
                                        const CUtensorMap* rb, int rh, int r0,
                                        const CUtensorMap* sa, const CUtensorMap* sb, int sh,
                                        int t0, int n_tiles, int b, const float2* stats) {
  using Cfg = BwdCfg<DH>;
  mbar_expect_tx(sm.res(), 2 * Cfg::kResBytes);
  for (int p = 0; p < Cfg::kPanels; ++p) {
    tma_load_4d(sm.res_a + p * Cfg::kPanelRes, ra, sm.res(), p * Cfg::kPanel, rh, r0, b);
    tma_load_4d(sm.res_b + p * Cfg::kPanelRes, rb, sm.res(), p * Cfg::kPanel, rh, r0, b);
  }
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % Cfg::kStages;
    if (n >= Cfg::kStages) mbar_wait(sm.empty(s), ((n / Cfg::kStages) & 1) ^ 1);
    const int t = t0 + n * kWgStr;
    mbar_expect_tx(sm.full(s), 2 * Cfg::kStrBytes + (stats ? Cfg::kStatBytes : 0));
    for (int p = 0; p < Cfg::kPanels; ++p) {
      const int off = s * Cfg::kStrBytes + p * Cfg::kPanelStr;
      tma_load_4d(sm.str_a + off, sa, sm.full(s), p * Cfg::kPanel, sh, t, b);
      tma_load_4d(sm.str_b + off, sb, sm.full(s), p * Cfg::kPanel, sh, t, b);
    }
    if (stats) bulk_load(sm.stat + s * Cfg::kStatBytes, stats + t, Cfg::kStatBytes, sm.full(s));
  }
}

// d = A B^T over Dh (m64n64): A the warpgroup's 64 rows of a resident tile,
// B a streamed tile, both K-major in shared memory.
template <int DH>
__device__ __forceinline__ void issue_abt(float (&d)[kWgStr / 2], uint32_t a_rows,
                                          uint32_t b_tile) {
  using Cfg = BwdCfg<DH>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int p = kk / (Cfg::kPanel / 16), off = (kk % (Cfg::kPanel / 16)) * 32;
    wgmma_ss<kWgStr>(d, gmma_desc(a_rows + p * Cfg::kPanelRes + off, 16, Cfg::kSbo, Cfg::kSwizzle),
                     gmma_desc(b_tile + p * Cfg::kPanelStr + off, 16, Cfg::kSbo, Cfg::kSwizzle),
                     kk > 0);
  }
}

// acc += A B over a streamed tile's 64 rows (m64nDh): A as its bf16 high
// and low packs (registers, the accumulator's layout), B the tile as the
// MN-major operand.
template <int DH>
__device__ __forceinline__ void issue_ab(float (&acc)[DH / 2], const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4], uint32_t b_tile) {
  using Cfg = BwdCfg<DH>;
#pragma unroll
  for (int j = 0; j < kWgStr / 16; ++j) {
    const uint64_t db = gmma_desc(b_tile + 16 * j * Cfg::kRowBytes, Cfg::kPanelStr, Cfg::kSbo,
                                  Cfg::kSwizzle);
    wgmma_rs<DH>(acc, hi[j], db);
    wgmma_rs<DH>(acc, lo[j], db);
  }
}

// x (an m64n64 accumulator) as A operands: its bf16 rounding and the bf16
// rounding of the rest (x - hi is exact in float32).
__device__ __forceinline__ void split(const float (&x)[kWgStr / 2], uint32_t (&hi)[4][4],
                                      uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < kWgStr / 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = x[8 * j + 2 * i], x1 = x[8 * j + 2 * i + 1];
      hi[j][i] = pack_bf16(x0, x1);
      const float2 hv = unpack_bf16(hi[j][i]);
      lo[j][i] = pack_bf16(x0 - hv.x, x1 - hv.y);
    }
}

__device__ __forceinline__ float dot_bf16x2(uint32_t a, uint32_t c, float acc) {
  const float2 x = unpack_bf16(a), y = unpack_bf16(c);
  return fmaf(x.y, y.y, fmaf(x.x, y.x, acc));
}

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ m_in,
                          const float* __restrict__ l_in, float2* __restrict__ stats,
                          __nv_bfloat16* __restrict__ dq, int T_len, int S, int H, int KV,
                          int T_pad, int q_offset, int w_eff, int causal, float scale,
                          float scale_log2) {
  using Cfg = BwdCfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  const BwdSmem<DH> sm((smem_u32(smem_raw) + 1023) & ~1023u);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * kWgRes;  // the last q tile first
  const int kvh = h / (H / KV);
  // The kv tiles that hold a live key for some row of the block.
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kWgRes, T_len) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  const int lo = q_first - w_eff + 1;
  const int k_begin = lo > 0 ? (lo / kWgStr) * kWgStr : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kWgStr - 1) / kWgStr : 0;

  init_barriers(sm);
  // The warpgroup index through a shuffle, so that ptxas knows every
  // branch on it is warp-uniform and keeps the wgmma pipeline.
  const int wg_idx = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg_idx == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0)
      produce(sm, &tm_q, &tm_do, h, q0, &tm_k, &tm_v, kvh, k_begin, n_tiles, b, nullptr);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = wg_idx - 1;
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane / 4, tig = lane % 4;
    const int wq0 = q0 + 64 * wg;                   // the warpgroup's first row
    const int r0 = wq0 + 16 * warp + g;             // this thread's rows r0, r0 + 8
    const int qpos[2] = {q_offset + r0, q_offset + r0 + 8};
    const int wq_first = q_offset + wq0;
    const int wq_last = q_offset + min(wq0 + 64, T_len) - 1;
    const int64_t bh = (int64_t)b * H + h;
    const int64_t row_stride = (int64_t)H * DH;

    // The rows' statistics: lse = m log2(e) + log2(max(l, 1e-30)), so that
    // P = 2^(S scale log2(e) - lse), and D = rowsum(do * o) (the four
    // threads of a quad sum a quarter of the row each); past T, lse = 1e30
    // (P = 0) and D = 0. Written as float2 [B, H, T_pad] for pass 2.
    float lse[2], dd[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int t = r0 + 8 * rr;
      float d = 0.f;
      if (t < T_len) {
        const int64_t off =
            ((int64_t)b * T_len + t) * row_stride + (int64_t)h * DH + tig * (DH / 4);
        const uint4* op = reinterpret_cast<const uint4*>(o + off);
        const uint4* gp = reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
        for (int i = 0; i < DH / 32; ++i) {
          const uint4 a = op[i], c = gp[i];
          d = dot_bf16x2(a.w, c.w, dot_bf16x2(a.z, c.z, dot_bf16x2(a.y, c.y,
                                                                   dot_bf16x2(a.x, c.x, d))));
        }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      lse[rr] = t < T_len ? fmaf(m_in[bh * T_len + t], kLog2e,
                                 log2f(fmaxf(l_in[bh * T_len + t], 1e-30f)))
                          : kNoRow;
      dd[rr] = d;
      if (tig == 0) stats[bh * T_pad + t] = make_float2(lse[rr], d);
    }

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    mbar_wait(sm.res(), 0);
    const uint32_t q_rows = sm.res_a + 64 * wg * Cfg::kRowBytes;
    const uint32_t do_rows = sm.res_b + 64 * wg * Cfg::kRowBytes;
    float sc[kWgStr / 2], ds[kWgStr / 2];
    uint32_t ds_hi[kWgStr / 16][4], ds_lo[kWgStr / 16][4];
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % Cfg::kStages;
      const int kt = k_begin + n * kWgStr;
      const uint32_t k_tile = sm.str_a + s * Cfg::kStrBytes;
      const uint32_t v_tile = sm.str_b + s * Cfg::kStrBytes;
      mbar_wait(sm.full(s), (n / Cfg::kStages) & 1);
      wgmma_fence();
      issue_abt<DH>(sc, q_rows, k_tile);   // S = Q K^T
      issue_abt<DH>(ds, do_rows, v_tile);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(sc);
      fence_operands(ds);
      const bool all_live = kt + kWgStr <= S && (!causal || kt + kWgStr - 1 <= wq_first) &&
                            kt > wq_last - w_eff;
#pragma unroll
      for (int j = 0; j < kWgStr / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e >> 1;
          float p = ex2(fmaf(sc[4 * j + e], scale_log2, -lse[rr]));
          if (!all_live) {
            const int kpos = kt + 8 * j + 2 * tig + (e & 1);
            bool live = kpos < S && kpos > qpos[rr] - w_eff;
            if (causal) live = live && kpos <= qpos[rr];
            p = live ? p : 0.f;
          }
          ds[4 * j + e] = p * (ds[4 * j + e] - dd[rr]);
        }
      split(ds, ds_hi, ds_lo);
      wgmma_fence();
      issue_ab<DH>(acc, ds_hi, ds_lo, k_tile);  // dQ += dS K
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(acc);
      mbar_arrive(sm.empty(s));
    }

    // dq = acc * scale in bf16, rows past T not written.
    __nv_bfloat16* dqb = dq + ((int64_t)b * T_len * H + h) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      if (r0 < T_len)
        *reinterpret_cast<uint32_t*>(dqb + r0 * row_stride + c) =
            pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      if (r0 + 8 < T_len)
        *reinterpret_cast<uint32_t*>(dqb + (r0 + 8) * row_stride + c) =
            pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const float2* __restrict__ stats, float* __restrict__ dk_part,
                            float* __restrict__ dv_part, int T_len, int S, int H, int KV,
                            int T_pad, int q_offset, int w_eff, int causal, float scale,
                            float scale_log2) {
  using Cfg = BwdCfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const BwdSmem<DH> sm((raw + 1023) & ~1023u);

  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = (int)blockIdx.z * kWgRes;   // the first key tile (the most causal work) first
  const int kvh = h / (H / KV);
  // The q tiles that hold a live query for some key of the block: causal
  // needs qpos >= kpos, the window qpos < kpos + w.
  const int k_last = min(k0 + kWgRes, S) - 1;
  const int t_lo = causal ? max(0, k0 - q_offset) : 0;
  const int t_hi = (int)min((int64_t)T_len, (int64_t)k_last + w_eff - q_offset);
  const int t_begin = (t_lo / kWgStr) * kWgStr;
  const int n_tiles = t_hi > t_begin ? (t_hi - t_begin + kWgStr - 1) / kWgStr : 0;
  const int64_t bh = (int64_t)b * H + h;

  init_barriers(sm);
  const int wg_idx = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg_idx == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0)
      produce(sm, &tm_k, &tm_v, kvh, k0, &tm_q, &tm_do, h, t_begin, n_tiles, b,
              stats + bh * T_pad);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = wg_idx - 1;
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane / 4, tig = lane % 4;
    const int wk0 = k0 + 64 * wg;                  // the warpgroup's first key
    const int kpos[2] = {wk0 + 16 * warp + g, wk0 + 16 * warp + g + 8};  // this thread's keys

    float dk[DH / 2], dv[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(sm.res(), 0);
    const uint32_t k_rows = sm.res_a + 64 * wg * Cfg::kRowBytes;
    const uint32_t v_rows = sm.res_b + 64 * wg * Cfg::kRowBytes;
    float pt[kWgStr / 2], dst[kWgStr / 2];
    uint32_t p_hi[kWgStr / 16][4], p_lo[kWgStr / 16][4];
    uint32_t s_hi[kWgStr / 16][4], s_lo[kWgStr / 16][4];
    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % Cfg::kStages;
      const int qt = t_begin + n * kWgStr;
      const uint32_t q_tile = sm.str_a + s * Cfg::kStrBytes;
      const uint32_t do_tile = sm.str_b + s * Cfg::kStrBytes;
      // (lse, D) of query qt + c at stat[c].
      const float2* stat =
          reinterpret_cast<const float2*>(smem_raw + (sm.stat + s * Cfg::kStatBytes - raw));
      mbar_wait(sm.full(s), (n / Cfg::kStages) & 1);
      wgmma_fence();
      issue_abt<DH>(pt, k_rows, q_tile);    // S^T = K Q^T
      issue_abt<DH>(dst, v_rows, do_tile);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(pt);
      fence_operands(dst);
      const bool all_live = wk0 + 64 <= S && qt + kWgStr <= T_len &&
                            (!causal || wk0 + 63 <= q_offset + qt) &&
                            wk0 > q_offset + qt + kWgStr - 1 - w_eff;
#pragma unroll
      for (int j = 0; j < kWgStr / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * tig + c;
          const float2 st = stat[col];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int e = 4 * j + 2 * rr + c;
            float p = ex2(fmaf(pt[e], scale_log2, -st.x));
            if (!all_live) {
              const int qpos = q_offset + qt + col;
              bool live = kpos[rr] < S && qt + col < T_len && kpos[rr] > qpos - w_eff;
              if (causal) live = live && kpos[rr] <= qpos;
              p = live ? p : 0.f;
            }
            pt[e] = p;
            dst[e] = p * (dst[e] - st.y);
          }
        }
      // dV's products go out before dS^T is split: fewer registers live at
      // once (issued together, ptxas spills and serialises the wgmma).
      split(pt, p_hi, p_lo);
      wgmma_fence();
      issue_ab<DH>(dv, p_hi, p_lo, do_tile);  // dV += P^T dO
      wgmma_commit();
      split(dst, s_hi, s_lo);
      wgmma_fence();
      issue_ab<DH>(dk, s_hi, s_lo, q_tile);   // dK += dS^T Q
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(dv);
      fence_operands(dk);
      mbar_arrive(sm.empty(s));
    }

    // This q head's share, [B, S, H, Dh] float32; keys past S not written.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (kpos[rr] >= S) continue;
      const int64_t row = (((int64_t)b * S + kpos[rr]) * H + h) * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int c = 8 * j + 2 * tig;
        *reinterpret_cast<float2*>(dk_part + row + c) =
            make_float2(dk[4 * j + 2 * rr] * scale, dk[4 * j + 2 * rr + 1] * scale);
        *reinterpret_cast<float2*>(dv_part + row + c) =
            make_float2(dv[4 * j + 2 * rr], dv[4 * j + 2 * rr + 1]);
      }
    }
  }
}

// Rows of the pass-1 statistics for a T-row head: T rounded up to the
// resident tile, so that every row a dq block covers has a slot and every
// q tile pass 2 streams lies inside.
int stat_rows(int T_len) { return (T_len + kWgRes - 1) / kWgRes * kWgRes; }

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* m, const float* l, float* stats, float* dk_part, float* dv_part,
                 void* dq, void* dk, void* dv, int B, int T_len, int S, int H, int KV,
                 int q_offset, int w_eff, int causal, float scale, cudaStream_t st) {
  using Cfg = BwdCfg<DH>;
  // Pass 1 holds Q and dO (128-row boxes) and streams K and V (64-row
  // boxes); pass 2 the other way round.
  CUtensorMap q_res, do_res, k_str, v_str, k_res, v_res, q_str, do_str;
  if (!make_map(&q_res, q, DH, H, T_len, B, Cfg::kPanel, kWgRes) ||
      !make_map(&do_res, dout, DH, H, T_len, B, Cfg::kPanel, kWgRes) ||
      !make_map(&k_str, k, DH, KV, S, B, Cfg::kPanel, kWgStr) ||
      !make_map(&v_str, v, DH, KV, S, B, Cfg::kPanel, kWgStr) ||
      !make_map(&k_res, k, DH, KV, S, B, Cfg::kPanel, kWgRes) ||
      !make_map(&v_res, v, DH, KV, S, B, Cfg::kPanel, kWgRes) ||
      !make_map(&q_str, q, DH, H, T_len, B, Cfg::kPanel, kWgStr) ||
      !make_map(&do_str, dout, DH, H, T_len, B, Cfg::kPanel, kWgStr))
    return -2;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cfg::kSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int T_pad = stat_rows(T_len);
  float2* stats2 = reinterpret_cast<float2*>(stats);
  flash_bwd_dq_wgmma_kernel<DH><<<dim3((unsigned)H, (unsigned)B, (unsigned)(T_pad / kWgRes)),
                                  kWgThreads, Cfg::kSmem, st>>>(
      q_res, do_res, k_str, v_str, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), m, l, stats2, static_cast<__nv_bfloat16*>(dq),
      T_len, S, H, KV, T_pad, q_offset, w_eff, causal, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_wgmma_kernel<DH><<<dim3((unsigned)H, (unsigned)B,
                                         (unsigned)((S + kWgRes - 1) / kWgRes)),
                                    kWgThreads, Cfg::kSmem, st>>>(
      k_res, v_res, q_str, do_str, stats2, dk_part, dv_part, T_len, S, H, KV, T_pad, q_offset,
      w_eff, causal, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce<__nv_bfloat16>(dk_part, dv_part, dk, dv, B, S, H, KV, DH, st);
}

}  // namespace

extern "C" {

// q, o, do, dq: [B, T, H, Dh]; k, v, dk, dv: [B, S, KV, Dh]; all contiguous,
// 16-byte aligned, of one dtype (bf16 != 0: bfloat16, else float32).
// m, l: float32 [B, H, T] from the forward. Scratch the caller allocates:
// dvec float32 [B, H, flash_attention_bwd_dvec_floats(T, bf16)];
// dk_part, dv_part float32 [B, S, H, Dh]. dh is 32, 64 or 128; H % KV == 0;
// float32: B * H < 2^31, T / 64 and S / 64 <= 65535; bfloat16: B, T / 128
// and S / 128 <= 65535. window <= 0 means global. Returns
// cudaGetLastError() after the launches (0 on success), -1 for an
// unsupported head dimension, -2 when a tensor map cannot be made.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const void* m, const void* l, void* dvec,
                               void* dk_part, void* dv_part, void* dq, void* dk, void* dv,
                               int B, int T_len, int S, int H, int KV, int dh, int q_offset,
                               int window, int causal, float scale, int bf16, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || S <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int w_eff = window > 0 ? window : S + T_len;
  const float* mp = static_cast<const float*>(m);
  const float* lp = static_cast<const float*>(l);
  float* dp = static_cast<float*>(dvec);
  float* kpart = static_cast<float*>(dk_part);
  float* vpart = static_cast<float*>(dv_part);
#define BWD_CASE(D)                                                                            \
  if (dh == D)                                                                                 \
    return bf16 ? launch_wgmma<D>(q, k, v, o, dout, mp, lp, dp, kpart, vpart, dq, dk, dv, B,   \
                                  T_len, S, H, KV, q_offset, w_eff, causal, scale, st)         \
                : launch<D>(q, k, v, o, dout, mp, lp, dp, kpart, vpart, dq, dk, dv, B, T_len,  \
                            S, H, KV, q_offset, w_eff, causal, scale, st);
  BWD_CASE(32)
  BWD_CASE(64)
  BWD_CASE(128)
#undef BWD_CASE
  return -1;
}

// Floats of the dvec scratch for each (b, h): float32 keeps D a query row
// (T); bfloat16 keeps (lse, D) a row for T rounded up to 128.
int flash_attention_bwd_dvec_floats(int T_len, int bf16) {
  return bf16 ? 2 * stat_rows(T_len) : T_len;
}

// Dynamic shared memory for head dim dh, in bytes, of the float32 dq
// (which = 0) or dk/dv (which = 1) kernel, or of both bf16 wgmma kernels
// (which = 2); -1 for a head dim they are not built for.
int flash_attention_bwd_smem_bytes(int which, int dh) {
  if (dh != 32 && dh != 64 && dh != 128) return -1;
  if (which == 2)
    return dh == 32 ? (int)BwdCfg<32>::kSmem : dh == 64 ? (int)BwdCfg<64>::kSmem
                                                         : (int)BwdCfg<128>::kSmem;
  if (which == 0)
    return dh == 32 ? (int)dq_smem_bytes<32>() : dh == 64 ? (int)dq_smem_bytes<64>()
                                                           : (int)dq_smem_bytes<128>();
  return dh == 32 ? (int)dkdv_smem_bytes<32>() : dh == 64 ? (int)dkdv_smem_bytes<64>()
                                                           : (int)dkdv_smem_bytes<128>();
}

}  // extern "C"
