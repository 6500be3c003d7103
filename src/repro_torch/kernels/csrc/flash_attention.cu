// Forward flash attention (online softmax over kv tiles) for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention, with the contract of the model's jnp twin
// (src/repro/models/flash_jnp.py::_fwd), which is what the dense layers run:
//   q [B, T, H, Dh], k/v [B, S, Kv, Dh] (GQA: kv head = h / (H / Kv)),
//   o [B, T, H, Dh] in q's dtype;
//   logit(t, s) = (q_t . k_s) * Dh^-0.5 where the key is live, else -1e30;
//   live: s < S, (causal) s <= qpos, and s > qpos - w with
//   w = window > 0 ? window : S + T, qpos = q_offset + t.
//   Running max m starts at -1e30, running sum l and the accumulator at 0,
//   all float32; o = acc / max(l, 1e-30).
// q_offset and window are runtime integers; T and S need not be multiples
// of the tile (ragged edges are masked here: the prefill attends over the
// whole cache, S = prompt + generated tokens).
//
// Bound: at the serving shape (q [4, 2048, 40, 128] bf16 against a
// [4, 2080, 8, 128] cache, causal) the launch does 4 Dh FLOP for each of
// 335.7 M live (query, key) pairs, 1.72e11 FLOP, and moves about 202 MB:
// on an H100 SXM that is 0.174 ms at the bf16 tensor-core peak against
// 0.060 ms of HBM traffic, so it is bound by operations: the products
// belong on the tensor cores. Two kernels share the tiling and the masking:
//   * bfloat16 (the model's dtype): flash_fwd_mma_kernel, both products as
//     mma.sync m16n8k16 (bf16 in, f32 accumulate), 4 warps of 16 query
//     rows; its note below says how it keeps float32 accuracy.
//   * float32 (the tests' and the reduced models' dtype): flash_fwd_kernel,
//     float32 FMAs on the CUDA cores (bf16 tensor cores would round the
//     operands), bound by shared-memory bandwidth.
// wgmma with TMA-fed tiles and warp specialisation is later work.
// What the design does about the bound:
//   * One block per (64 queries, head): the Q tile stays on chip while the
//     block walks the kv tiles of 64 keys; each kv head's K/V tile is read
//     once per query tile (GQA needs no expanded copy).
//   * Tiles that are fully masked for the whole query tile (the future
//     under causality -- at prefill that includes the cache slots not yet
//     written -- and keys older than the window) are never loaded, as the
//     Pallas kernel skips them.
//   * Float32 path: each thread owns 4 query rows x 4 keys of the score
//     tile and 4 rows x Dh/16 columns of the output; Q and K rows are read
//     as float4 from a padded layout (row stride Dh + 4 words:
//     conflict-free), the row max and sum go through warp shuffles, and
//     only P passes through shared memory on its way to the P V product.
//   * m, l and the accumulator stay in registers in float32.
// The arithmetic is the plain version's (kernels/flash_attention.py): a
// masked key is -1e30 (not -inf), so a row that has seen only masked keys
// accumulates exp(0) = 1 weights that the first live key's
// alpha = exp(-1e30 - m) = 0 erases, exactly as in the block scan; a tile
// the kernel skips would have added 0 or been erased. Sums run in another
// order than PyTorch's, so the two agree to float32 rounding, not bit for
// bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // queries per block
constexpr int kBK = 64;       // keys per kv tile
constexpr int kThreads = 256;
constexpr int kLDP = kBK + 4;  // row stride of the P tile (words)
constexpr float kNegInf = -1e30f;

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

template <int DH>
constexpr size_t smem_bytes() {
  // Q and K padded (float4 rows, stride DH + 4), V dense, P padded.
  return sizeof(float) * (2 * kBQ * (DH + 4) + kBK * DH + kBQ * kLDP);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int T_len, int S, int H, int KV, int q_offset,
                 int w_eff, int causal, float scale) {
  constexpr int LDQ = DH + 4;
  constexpr int DJ = DH / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LDQ;
  float* Vs = Ks + kBK * LDQ;
  float* Ps = Vs + kBK * DH;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;   // rows rg*4 .. rg*4+3
  const int cs = tid & 15;   // keys cs + 16 j; output columns cs + 16 j
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int64_t q_stride = (int64_t)H * DH;    // between consecutive t
  const int64_t kv_stride = (int64_t)KV * DH;  // between consecutive s
  const T* qb = q + ((int64_t)b * T_len * H + h) * DH;
  const T* kb = k + ((int64_t)b * S * KV + kvh) * DH;
  const T* vb = v + ((int64_t)b * S * KV + kvh) * DH;
  T* ob = o + ((int64_t)b * T_len * H + h) * DH;

  for (int idx = tid; idx < kBQ * DH / 4; idx += kThreads) {
    const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
    const float4 val = (q0 + r < T_len) ? load4(qb + (int64_t)(q0 + r) * q_stride + c)
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(Qs + r * LDQ + c) = val;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // The kv tiles that hold a live key for some row of this query tile.
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, T_len) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  const int lo = q_first - w_eff + 1;  // first key inside the window of row 0
  const int k_begin = lo > 0 ? (lo / kBK) * kBK : 0;

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < kBK * DH / 4; idx += kThreads) {
      const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (kt + r < S) {
        kv4 = load4(kb + (int64_t)(kt + r) * kv_stride + c);
        vv4 = load4(vb + (int64_t)(kt + r) * kv_stride + c);
      }
      *reinterpret_cast<float4*>(Ks + r * LDQ + c) = kv4;
      *reinterpret_cast<float4*>(Vs + r * DH + c) = vv4;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(Qs + (rg * 4 + i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(Ks + (cs + 16 * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(qv[i].x, kv[j].x, t);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          t = fmaf(qv[i].w, kv[j].w, t);
          s[i][j] = t;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kt + cs + 16 * j;
        bool live = kpos < S && kpos > qpos - w_eff;
        if (causal) live = live && kpos <= qpos;
        s[i][j] = live ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(rg * 4 + i) * kLDP + cs + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(Ps + (rg * 4 + i) * kLDP + c);
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float v0 = Vs[(c + 0) * DH + cs + 16 * j];
        const float v1 = Vs[(c + 1) * DH + cs + 16 * j];
        const float v2 = Vs[(c + 2) * DH + cs + 16 * j];
        const float v3 = Vs[(c + 3) * DH + cs + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float t = acc[i][j];
          t = fmaf(pv[i].x, v0, t);
          t = fmaf(pv[i].y, v1, t);
          t = fmaf(pv[i].z, v2, t);
          t = fmaf(pv[i].w, v3, t);
          acc[i][j] = t;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + rg * 4 + i;
    if (t >= T_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(int64_t)t * q_stride + cs + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

// ------------------------------------------------------------------
// bfloat16 inputs: the two products on the tensor cores (mma.sync
// m16n8k16, bf16 x bf16 -> f32). 4 warps, 16 query rows each; the Q
// fragments stay in registers for the whole kv walk, the K and V tiles go
// through shared memory (rows padded by 8 elements: conflict-free), V is
// read transposed by ldmatrix. The products of two bf16 are exact in f32,
// so Q K^T is the plain version's up to summation order. P is split into a
// bf16 high part and a bf16 low part (P - hi), each multiplied by V, so the
// P V product keeps about 16 bits of P, not 8: the output agrees with the
// float32 plain version to float32 rounding, as the CUDA-core path does.

constexpr int kMmaThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int T_len, int S, int H, int KV, int q_offset, int w_eff, int causal,
                     float scale) {
  constexpr int LDS = DH + 8;  // shared row stride, elements (16-byte multiple)
  constexpr int KS = DH / 16;  // k-steps of Q K^T
  constexpr int NT = DH / 8;   // n-tiles of the output
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int64_t q_stride = (int64_t)H * DH;
  const int64_t kv_stride = (int64_t)KV * DH;
  const __nv_bfloat16* qb = q + ((int64_t)b * T_len * H + h) * DH;
  const __nv_bfloat16* kb = k + ((int64_t)b * S * KV + kvh) * DH;
  const __nv_bfloat16* vb = v + ((int64_t)b * S * KV + kvh) * DH;
  __nv_bfloat16* ob = o + ((int64_t)b * T_len * H + h) * DH;

  // This thread's rows of the warp's 16: r0 and r0 + 8.
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int c = kk * 16 + tig * 2;
    qf[kk][0] = r0 < T_len ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_stride + c) : 0u;
    qf[kk][1] = r1 < T_len ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_stride + c) : 0u;
    qf[kk][2] = r0 < T_len ? *reinterpret_cast<const uint32_t*>(qb + r0 * q_stride + c + 8) : 0u;
    qf[kk][3] = r1 < T_len ? *reinterpret_cast<const uint32_t*>(qb + r1 * q_stride + c + 8) : 0u;
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums (quad-reduced at the end)

  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBQ, T_len) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  const int lo = q_first - w_eff + 1;
  const int k_begin = lo > 0 ? (lo / kBK) * kBK : 0;
  const int qpos[2] = {q_offset + r0, q_offset + r1};

  for (int kt = k_begin; kt < k_end; kt += kBK) {
    __syncthreads();
    for (int idx = tid; idx < kBK * DH / 8; idx += kMmaThreads) {
      const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (kt + r < S) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (int64_t)(kt + r) * kv_stride + c);
        vv4 = *reinterpret_cast<const uint4*>(vb + (int64_t)(kt + r) * kv_stride + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * LDS + c) = kv4;
      *reinterpret_cast<uint4*>(Vs + r * LDS + c) = vv4;
    }
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const __nv_bfloat16* kp = Ks + (n * 8 + g) * LDS + kk * 16 + tig * 2;
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const int kpos = kt + n * 8 + tig * 2 + (e & 1);
        bool live = kpos < S && kpos > qpos[rr] - w_eff;
        if (causal) live = live && kpos <= qpos[rr];
        s[n][e] = live ? s[n][e] * scale : kNegInf;
        mx[rr] = fmaxf(mx[rr], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      alpha[rr] = expf(m[rr] - m_new);
      m[rr] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + sum[rr];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      // The A fragment of keys 16j .. 16j + 15 is the score tiles 2j and
      // 2j + 1 as they lie in the accumulator registers.
      uint32_t hi[4], lo4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x0 = s[2 * j + (i >> 1)][(i & 1) * 2];
        const float x1 = s[2 * j + (i >> 1)][(i & 1) * 2 + 1];
        hi[i] = pack_bf16(x0, x1);
        const float2 hv = unpack_bf16(hi[i]);
        lo4[i] = pack_bf16(x0 - hv.x, x1 - hv.y);
      }
      const uint32_t vrow = static_cast<uint32_t>(
          __cvta_generic_to_shared(Vs + (j * 16 + (lane & 15)) * LDS));
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                     : "=r"(b0), "=r"(b1)
                     : "r"(vrow + n * 16));
        mma_bf16(acc[n], hi, b0, b1);
        mma_bf16(acc[n], lo4, b0, b1);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
  const float d0 = fmaxf(l[0], 1e-30f), d1 = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + tig * 2;
    if (r0 < T_len)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_stride + c) =
          pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
    if (r1 < T_len)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_stride + c) =
          pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
  }
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int T_len, int S,
               int H, int KV, int q_offset, int w_eff, int causal, float scale,
               cudaStream_t st) {
  const dim3 grid((unsigned)((T_len + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_fwd_mma_kernel<DH><<<grid, kMmaThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T_len, S, H, KV,
      q_offset, w_eff, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int T_len, int S,
           int H, int KV, int q_offset, int w_eff, int causal, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T_len + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_fwd_kernel<T, DH><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), T_len, S, H, KV, q_offset, w_eff, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: [B, T, H, Dh]; k, v: [B, S, KV, Dh]; o: [B, T, H, Dh]; all contiguous,
// 16-byte aligned, of one dtype (bf16 != 0: bfloat16, else float32).
// dh is 32, 64 or 128; H % KV == 0; B * H <= 65535. window <= 0 means
// global (the effective window is then S + T, as in the plain version).
// Returns cudaGetLastError() after the launch (0 on success), or -1 for an
// unsupported head dimension.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                           int T_len, int S, int H, int KV, int dh, int q_offset, int window,
                           int causal, float scale, int bf16, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int w_eff = window > 0 ? window : S + T_len;
#define FLASH_CASE(D)                                                                      \
  if (dh == D)                                                                             \
    return bf16 ? launch_mma<D>(q, k, v, o, B, T_len, S, H, KV, q_offset, w_eff, causal,   \
                                scale, st)                                                \
                : launch<float, D>(q, k, v, o, B, T_len, S, H, KV, q_offset, w_eff, causal, \
                                   scale, st);
  FLASH_CASE(32)
  FLASH_CASE(64)
  FLASH_CASE(128)
#undef FLASH_CASE
  return -1;
}

}  // extern "C"
