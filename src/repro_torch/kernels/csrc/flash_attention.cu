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
// of the tile (the prefill attends over the whole cache, S = prompt +
// generated tokens). For training, both kernels also write each query row's
// final m and l (float32 [B, H, T], _fwd's units) in their epilogue, which
// the backward (flash_attention_bwd.cu) reads; serving passes null pointers
// and they write nothing more.
//
// Bound: at the serving shape (q [4, 2048, 40, 128] bf16 against a
// [4, 2080, 8, 128] cache, causal) the launch does 4 Dh FLOP for each of
// 335.7 M live (query, key) pairs, 1.72e11 FLOP, and moves about 202 MB: on
// an H100 SXM (700 W) that is 0.174 ms at the bf16 tensor-core peak against
// 0.060 ms of HBM traffic, so it is bound by operations. This kernel does
// 1.5x those FLOP (P V runs twice, below): 0.26 ms at the peak.
//
// Two kernels share the masking and the online softmax:
//   * bfloat16 (the model's dtype): flash_fwd_wgmma_kernel, for Hopper's
//     tensor cores. It replaces an mma.sync kernel (1.56 ms at the serving
//     shape on an H100 SXM at 700 W, 11% of the bound, against 0.32 ms for
//     PyTorch's SDPA)
//     whose tensor cores waited on synchronous, single-buffered K/V loads,
//     at 168 registers a thread (3 blocks an SM), with Ampere's instruction.
//   * float32 (the tests' and the reduced models' dtype): flash_fwd_kernel,
//     float32 FMAs on the CUDA cores (bf16 tensor cores would round the
//     operands), bound by shared-memory bandwidth.
// What the bf16 design does about the bound:
//   * Warp specialisation: a block is one producer warpgroup and two
//     consumer warpgroups (384 threads) for one (128-query tile, q head).
//     One producer thread issues every load with TMA and its warpgroup
//     gives its registers away (setmaxnreg.dec 24); each consumer
//     warpgroup owns 64 query rows and takes 240 registers a thread.
//   * TMA: 4-D tensor maps over the model's own [B, T, H, Dh] and
//     [B, S, Kv, Dh] tensors, so the GQA cache is read unexpanded and the
//     hardware zero-fills rows past T and S (no padded copies). The Q tile
//     is loaded once; K/V tiles of kWgBK keys go through a ring of kStages
//     buffers with full/empty mbarriers, so the loads run ahead of the
//     products. Tiles are 128-byte swizzled (64-byte at Dh = 32): a row of
//     64 bf16 per box, a head of 128 loaded as two 64-column panels.
//   * wgmma: S = Q K^T reads Q and K from shared memory (both K-major),
//     m64n128k16; P V takes P from registers (the S accumulator's layout is
//     the A fragment's, as in FlashAttention-3) and V as the MN-major B
//     operand (transpose bit), m64nDhk16. Masking and the softmax (base 2,
//     the scale folded into one multiply) stay in registers.
//   * Overlap, as in FlashAttention-3: each consumer issues Q K^T of tile n
//     together with P V of tile n - 1 and runs the softmax of tile n while
//     that P V is on the tensor cores (wgmma.wait_group 1); the two
//     consumers take turns issuing (named barriers 1 and 2), so one's
//     softmax overlaps the other's products. ptxas serialises wgmma that
//     sits on a branch it cannot prove warp-uniform, so the warpgroup index
//     comes through a shuffle and every tile of the block's range is
//     computed (no per-warpgroup branch around the products).
//   * Accuracy: the references compute P in float32. P is split into a
//     bf16 high part and the bf16 rest, each multiplied by V, so P keeps
//     about 16 bits; Q K^T needs nothing (products of two bf16 are exact
//     in f32). The output agrees with the float32 plain version to half a
//     bf16 ulp plus float32 rounding.
//   * Order: the grid runs the H / Kv q heads that share a kv head next to
//     each other (their K/V tiles meet in L2) and the q tiles from the last
//     (the most causal work) to the first. Tiles with no live key for the
//     whole block are never loaded; a consumer masks only tiles that hold a
//     masked key for its rows.
// Float32 path: each thread owns 4 query rows x 4 keys of the score tile
// and 4 rows x Dh/16 columns of the output; Q and K rows are read as float4
// from a padded layout (row stride Dh + 4 words: conflict-free), the row
// max and sum go through warp shuffles, and only P passes through shared
// memory on its way to the P V product; 64 queries and 64 keys a tile.
// Both paths reproduce the plain version's arithmetic
// (kernels/flash_attention.py): a masked key is -1e30 (not -inf), so a row
// that has seen only masked keys accumulates exp(0) = 1 weights that the
// first live key's alpha = exp(-1e30 - m) = 0 erases, exactly as in the
// block scan; a tile the kernel skips would have added 0 or been erased.
// Sums run in another order than PyTorch's, so the two agree to float32
// rounding, not bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, named barriers, tensor maps

namespace {

using namespace hopper;

constexpr int kBQ = 64;       // queries per block
constexpr int kBK = 64;       // keys per kv tile
constexpr int kThreads = 256;
constexpr int kLDP = kBK + 4;  // row stride of the P tile (words)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <int DH>
constexpr size_t smem_bytes() {
  // Q and K padded (float4 rows, stride DH + 4), V dense, P padded.
  return sizeof(float) * (2 * kBQ * (DH + 4) + kBK * DH + kBQ * kLDP);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                 int T_len, int S, int H, int KV, int q_offset, int w_eff, int causal,
                 float scale) {
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
    if (m_out != nullptr && cs == 0) {  // the row statistics [B, H, T], for the backward
      m_out[(int64_t)bh * T_len + t] = m[i];
      l_out[(int64_t)bh * T_len + t] = l[i];
    }
  }
}

// ------------------------------------------------------------------
// bfloat16: the warp-specialised wgmma + TMA kernel.

constexpr int kWgBQ = 128;            // queries per block: two consumer warpgroups of 64
constexpr int kWgBK = 128;            // keys per kv tile (faster than 64 at the serving shape)
constexpr int kWgThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int DH>
struct WgCfg {
  static constexpr int kPanel = DH >= 64 ? 64 : 32;          // bf16 columns a box row holds
  static constexpr int kPanels = DH / kPanel;
  static constexpr int kRowBytes = kPanel * 2;               // = the swizzle width
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 2;
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kWgBQ * DH * 2;
  static constexpr int kKVBytes = kWgBK * DH * 2;               // one K (or V) stage
  static constexpr int kPanelQ = kWgBQ * kRowBytes;          // bytes of one Q panel
  static constexpr int kPanelKV = kWgBK * kRowBytes;
  static constexpr int kTileBytes = kQBytes + 2 * kStages * kKVBytes;
  static constexpr size_t kSmem = kTileBytes + 8 * (2 * kStages + 1) + 1024;  // + barriers, alignment
};

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ m_out, float* __restrict__ l_out, int T_len, int S,
                       int H, int KV, int q_offset, int w_eff, int causal, float scale_log2) {
  using Cfg = WgCfg<DH>;
  constexpr int kStages = Cfg::kStages;
  extern __shared__ uint8_t smem_raw[];
  // Swizzled tiles need 1024-byte alignment.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + Cfg::kQBytes;
  const uint32_t sV = sK + kStages * Cfg::kKVBytes;
  const uint32_t bar0 = base + Cfg::kTileBytes;  // full[kStages], empty[kStages], q
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kStages + s); };
  const uint32_t qbar = bar0 + 16 * kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * kWgBQ;  // the last q tile first
  const int kvh = h / (H / KV);
  // The kv tiles that hold a live key for some row of the block.
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kWgBQ, T_len) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  const int lo = q_first - w_eff + 1;
  const int k_begin = lo > 0 ? (lo / kWgBK) * kWgBK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kWgBK - 1) / kWgBK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup index through a shuffle, so that ptxas knows every
  // branch on it (and on what derives from it) is warp-uniform and keeps
  // the wgmma pipeline (it serialises wgmma on a divergent path).
  const int wg_idx = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg_idx == 0) {
    // ---- producer warpgroup: one thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(qbar, Cfg::kQBytes);
      for (int p = 0; p < Cfg::kPanels; ++p)
        tma_load_4d(sQ + p * Cfg::kPanelQ, &tm_q, qbar, p * Cfg::kPanel, h, q0, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(empty(s), ((n / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * Cfg::kKVBytes);
        const int kt = k_begin + n * kWgBK;
        for (int p = 0; p < Cfg::kPanels; ++p) {
          tma_load_4d(sK + s * Cfg::kKVBytes + p * Cfg::kPanelKV, &tm_k, full(s),
                      p * Cfg::kPanel, kvh, kt, b);
          tma_load_4d(sV + s * Cfg::kKVBytes + p * Cfg::kPanelKV, &tm_v, full(s),
                      p * Cfg::kPanel, kvh, kt, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = wg_idx - 1;
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int g = lane / 4, tig = lane % 4;
    const int wq0 = q0 + 64 * wg;                       // the warpgroup's first row
    const int r0 = wq0 + 16 * warp + g;                 // this thread's rows r0, r0 + 8
    const int qpos[2] = {q_offset + r0, q_offset + r0 + 8};
    const int wq_first = q_offset + wq0;
    const int wq_last = q_offset + min(wq0 + 64, T_len) - 1;

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's part of the row sums (quad-reduced at the end)

    mbar_wait(qbar, 0);
    const uint32_t q_rows = sQ + 64 * wg * Cfg::kRowBytes;
    constexpr uint32_t kSbo = 8 * Cfg::kRowBytes;       // 8-row core-matrix groups

    // Every tile of the block's range is computed (a tile with no live key
    // for these rows adds 0 or is erased, as in the block scan), so the
    // wgmma issue is unconditional: Q K^T of tile n goes out with P V of
    // tile n - 1, and the softmax of tile n runs while that P V is on the
    // tensor cores.
    uint32_t p_hi[kWgBK / 16][4], p_lo[kWgBK / 16][4];
    float sc[kWgBK / 2];
    auto issue_qk = [&](int stage) {
      const uint32_t k_tile = sK + stage * Cfg::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int p = kk / (Cfg::kPanel / 16), off = (kk % (Cfg::kPanel / 16)) * 32;
        wgmma_ss<kWgBK>(sc, gmma_desc(q_rows + p * Cfg::kPanelQ + off, 16, kSbo, Cfg::kSwizzle),
                     gmma_desc(k_tile + p * Cfg::kPanelKV + off, 16, kSbo, Cfg::kSwizzle),
                     kk > 0);
      }
    };
    auto issue_pv = [&](int stage) {
      const uint32_t v_tile = sV + stage * Cfg::kKVBytes;
#pragma unroll
      for (int j = 0; j < kWgBK / 16; ++j) {
        const uint64_t dv = gmma_desc(v_tile + 16 * j * Cfg::kRowBytes, Cfg::kPanelKV, kSbo,
                                      Cfg::kSwizzle);
        wgmma_rs<DH>(acc, p_hi[j], dv);
        wgmma_rs<DH>(acc, p_lo[j], dv);
      }
    };
    float alpha[2];
    // Mask and exponentiate sc in place (base 2), new running max in m.
    auto softmax = [&](int kt) {
      const bool all_live = kt + kWgBK <= S && (!causal || kt + kWgBK - 1 <= wq_first) &&
                            kt > wq_last - w_eff;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kWgBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (!all_live) {
            const int rr = e >> 1;
            const int kpos = kt + 8 * j + 2 * tig + (e & 1);
            bool live = kpos < S && kpos > qpos[rr] - w_eff;
            if (causal) live = live && kpos <= qpos[rr];
            x = live ? x : kNegInf;
          }
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
        mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
        const float m_new = fmaxf(m[rr], mx[rr]);
        alpha[rr] = ex2(m[rr] - m_new);
        m[rr] = m_new;
      }
#pragma unroll
      for (int i = 0; i < kWgBK / 2; ++i) {
        sc[i] = ex2(sc[i] - m[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + sum[rr];
    };
    // Rescale O by alpha and split P into the bf16 A operand.
    auto rescale_and_split = [&]() {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int j = 0; j < kWgBK / 16; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x0 = sc[8 * j + 2 * i], x1 = sc[8 * j + 2 * i + 1];
          p_hi[j][i] = pack_bf16(x0, x1);
          const float2 hv = unpack_bf16(p_hi[j][i]);
          p_lo[j][i] = pack_bf16(x0 - hv.x, x1 - hv.y);
        }
    };
    // The two warpgroups take turns issuing (named barriers 1 and 2,
    // warpgroup 0 first), so one's softmax overlaps the other's products.
    auto my_turn = [&]() { if (wg == 0) named_sync<1>(); else named_sync<2>(); };
    auto their_turn = [&]() { if (wg == 0) named_arrive<2>(); else named_arrive<1>(); };
    if (wg == 1 && n_tiles > 0) named_arrive<1>();
    if (n_tiles > 0) {
      mbar_wait(full(0), 0);
      my_turn();
      wgmma_fence();
      issue_qk(0);
      wgmma_commit();
      if (wg == 0 || n_tiles > 1) their_turn();  // warpgroup 1 gives no turn after its last
      wgmma_wait_all();
      softmax(k_begin);
      rescale_and_split();
    }
    for (int n = 1; n < n_tiles; ++n) {
      const int s = n % kStages, prev = (n - 1) % kStages;
      mbar_wait(full(s), (n / kStages) & 1);
      my_turn();
      wgmma_fence();
      issue_qk(s);
      wgmma_commit();
      issue_pv(prev);
      wgmma_commit();
      if (wg == 0 || n + 1 < n_tiles) their_turn();
      wgmma_wait_1();
      softmax(k_begin + n * kWgBK);
      wgmma_wait_all();
      mbar_arrive(empty(prev));
      rescale_and_split();
    }
    if (n_tiles > 0) {
      const int last = (n_tiles - 1) % kStages;
      wgmma_fence();
      issue_pv(last);
      wgmma_commit();
      wgmma_wait_all();
      mbar_arrive(empty(last));
    }

    // Epilogue: o = acc / max(l, 1e-30), rows past T not written.
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    }
    const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
    const int64_t row_stride = (int64_t)H * DH;
    __nv_bfloat16* ob = o + ((int64_t)b * T_len * H + h) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      if (r0 < T_len)
        *reinterpret_cast<uint32_t*>(ob + r0 * row_stride + c) =
            pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (r0 + 8 < T_len)
        *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * row_stride + c) =
            pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
    // The row statistics in the plain version's units (m of the scaled
    // logits, not of their base-2 form), [B, H, T], for the backward.
    if (m_out != nullptr && tig == 0) {
      const int64_t srow = ((int64_t)b * H + h) * T_len;
      if (r0 < T_len) {
        m_out[srow + r0] = m[0] * kLn2;
        l_out[srow + r0] = l[0];
      }
      if (r0 + 8 < T_len) {
        m_out[srow + r0 + 8] = m[1] * kLn2;
        l_out[srow + r0 + 8] = l[1];
      }
    }
  }
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* m, float* l, int B,
                 int T_len, int S, int H, int KV, int q_offset, int w_eff, int causal,
                 float scale, cudaStream_t st) {
  using Cfg = WgCfg<DH>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, DH, H, T_len, B, Cfg::kPanel, kWgBQ) ||
      !make_map(&tk, k, DH, KV, S, B, Cfg::kPanel, kWgBK) ||
      !make_map(&tv, v, DH, KV, S, B, Cfg::kPanel, kWgBK))
    return -2;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cfg::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)H, (unsigned)B, (unsigned)((T_len + kWgBQ - 1) / kWgBQ));
  flash_fwd_wgmma_kernel<DH><<<grid, kWgThreads, Cfg::kSmem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), m, l, T_len, S, H, KV, q_offset, w_eff,
      causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* m, float* l, int B,
           int T_len, int S, int H, int KV, int q_offset, int w_eff, int causal, float scale,
           cudaStream_t st) {
  const size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((T_len + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_fwd_kernel<T, DH><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), m, l, T_len, S, H, KV, q_offset, w_eff, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: [B, T, H, Dh]; k, v: [B, S, KV, Dh]; o: [B, T, H, Dh]; all contiguous,
// 16-byte aligned, of one dtype (bf16 != 0: bfloat16, else float32).
// m, l: float32 [B, H, T] outputs of each query row's running max and sum
// (as flash_jnp._fwd returns them), or both null when not wanted.
// dh is 32, 64 or 128; H % KV == 0; B, T / 128 <= 65535 (bf16), B * H <= 65535
// (float32). window <= 0 means global (the effective window is then S + T,
// as in the plain version). Returns cudaGetLastError() after the launch
// (0 on success), -1 for an unsupported head dimension, -2 when a tensor
// map cannot be made.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, void* m,
                           void* l, int B, int T_len, int S, int H, int KV, int dh, int q_offset,
                           int window, int causal, float scale, int bf16, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int w_eff = window > 0 ? window : S + T_len;
#define FLASH_CASE(D)                                                                         \
  if (dh == D)                                                                                \
    return bf16 ? launch_wgmma<D>(q, k, v, o, static_cast<float*>(m), static_cast<float*>(l),  \
                                  B, T_len, S, H, KV, q_offset, w_eff, causal, scale, st)     \
                : launch<float, D>(q, k, v, o, static_cast<float*>(m), static_cast<float*>(l), \
                                   B, T_len, S, H, KV, q_offset, w_eff, causal, scale, st);
  FLASH_CASE(32)
  FLASH_CASE(64)
  FLASH_CASE(128)
#undef FLASH_CASE
  return -1;
}

// Dynamic shared memory of the bf16 kernel for head dim dh, in bytes (-1
// for a head dim it is not built for).
int flash_attention_smem_bytes(int dh) {
  return dh == 32    ? (int)WgCfg<32>::kSmem
         : dh == 64  ? (int)WgCfg<64>::kSmem
         : dh == 128 ? (int)WgCfg<128>::kSmem
                     : -1;
}

}  // extern "C"
