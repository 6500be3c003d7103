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
// operations. This first version runs on the CUDA cores in float32, whose
// peak is 67 TFLOP/s (1.28 ms for the same FLOP), and recomputes q k^T and
// do v^T in both of its passes (7 products, not 5): several times the bound
// is expected. Tensor cores (wgmma fed by TMA) are later work; this version
// keeps float32 agreement with the plain version, which bf16 operands for P
// and dS would lose.
//
// Design: three launches on the caller's stream, no atomics, so the result
// is deterministic.
//   1. flash_bwd_dq_kernel, one block per (64-query tile, q head): D for its
//      rows (kept for launch 2), then a loop over the kv tiles with a live
//      key that rebuilds p and ds and accumulates dq in registers.
//   2. flash_bwd_dkdv_kernel, one block per (64-key tile, q head): a loop over
//      the q tiles with a live query that rebuilds p^T and ds^T and
//      accumulates this q head's share of dk and dv in registers, written to
//      float32 scratch [B, S, H, Dh].
//   3. flash_bwd_reduce_kernel: dk, dv = the sum of the H / Kv shares of each
//      kv head, in head order, cast to the output dtype.
// A block is 256 threads; each owns 4 rows x 4 columns of the 64 x 64 score
// tile (rows through warp shuffles, as the float32 forward) and 4 rows x
// Dh / 16 columns of its accumulators. Operand tiles are staged in shared
// memory as float32 with a padded row stride (Dh + 4 words: conflict-free
// float4 reads); bf16 inputs are widened on the way in. The grid puts the
// tile index in y, ordered so that the tiles with the most causal work
// start first. Sums run in another order than the plain version's, so the
// two agree to float32 rounding, not bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;         // queries (or keys) a tile
constexpr int kThreads = 256;
constexpr int kLDP = kB + 4;   // row stride of the p / ds tiles (words)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
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

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* m, const float* l, float* dvec, float* dk_part, float* dv_part, void* dq,
           void* dk, void* dv, int B, int T_len, int S, int H, int KV, int q_offset, int w_eff,
           int causal, float scale, cudaStream_t st) {
  const size_t s1 = dq_smem_bytes<DH>(), s2 = dkdv_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return (int)err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T, DH><<<dim3((unsigned)(B * H), (unsigned)((T_len + kB - 1) / kB)),
                               kThreads, s1, st>>>(
      qp, kp, vp, static_cast<const T*>(o), dop, m, l, dvec, static_cast<T*>(dq), T_len, S, H,
      KV, q_offset, w_eff, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<T, DH><<<dim3((unsigned)(B * H), (unsigned)((S + kB - 1) / kB)),
                                 kThreads, s2, st>>>(
      qp, kp, vp, dop, m, l, dvec, dk_part, dv_part, T_len, S, H, KV, q_offset, w_eff, causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)B * S * KV;
  const int64_t n = rows * DH;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16);
  flash_bwd_reduce_kernel<T><<<blocks, 256, 0, st>>>(dk_part, dv_part, static_cast<T*>(dk),
                                                     static_cast<T*>(dv), rows, H / KV, DH);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o, do, dq: [B, T, H, Dh]; k, v, dk, dv: [B, S, KV, Dh]; all contiguous,
// 16-byte aligned, of one dtype (bf16 != 0: bfloat16, else float32).
// m, l: float32 [B, H, T] from the forward. Scratch the caller allocates:
// dvec float32 [B, H, T]; dk_part, dv_part float32 [B, S, H, Dh]. dh is 32,
// 64 or 128; H % KV == 0; B * H < 2^31, T / 64 and S / 64 <= 65535.
// window <= 0 means global. Returns cudaGetLastError() after the launches
// (0 on success), -1 for an unsupported head dimension.
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
    return bf16 ? launch<__nv_bfloat16, D>(q, k, v, o, dout, mp, lp, dp, kpart, vpart, dq, dk, \
                                           dv, B, T_len, S, H, KV, q_offset, w_eff, causal,    \
                                           scale, st)                                          \
                : launch<float, D>(q, k, v, o, dout, mp, lp, dp, kpart, vpart, dq, dk, dv, B,  \
                                   T_len, S, H, KV, q_offset, w_eff, causal, scale, st);
  BWD_CASE(32)
  BWD_CASE(64)
  BWD_CASE(128)
#undef BWD_CASE
  return -1;
}

// Dynamic shared memory of the dq (which = 0) or dk/dv (which = 1) kernel
// for head dim dh, in bytes (-1 for a head dim it is not built for).
int flash_attention_bwd_smem_bytes(int which, int dh) {
  if (dh != 32 && dh != 64 && dh != 128) return -1;
  if (which == 0)
    return dh == 32 ? (int)dq_smem_bytes<32>() : dh == 64 ? (int)dq_smem_bytes<64>()
                                                           : (int)dq_smem_bytes<128>();
  return dh == 32 ? (int)dkdv_smem_bytes<32>() : dh == 64 ? (int)dkdv_smem_bytes<64>()
                                                           : (int)dkdv_smem_bytes<128>();
}

}  // extern "C"
