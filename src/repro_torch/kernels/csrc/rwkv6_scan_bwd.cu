// Backward of the chunk-parallel RWKV-6 recurrence (rwkv6_scan.cu), for
// Hopper.
//
// Replaces JAX's autodiff of the model's chunk form,
// src/repro/models/rwkv6.py::_rwkv6_chunked (its lax.scan over chunk_fn):
// the reference has no Pallas backward for src/repro/kernels/rwkv6_scan.py.
// Per (batch, head), forward o_t = r_t^T S_{t-1} + (r_t . (u * k_t)) v_t,
// S_t = diag(w_t) S_{t-1} + k_t v_t^T with w_t = exp(logw_t). With G_t the
// gradient of S_t (G_T = dS_final, G_{t-1} = r_t do_t^T + diag(w_t) G_t):
//   dr_t = S_{t-1} do_t + (u * k_t)(v_t . do_t)
//   dk_t = G_t v_t + (u * r_t)(v_t . do_t)
//   dv_t = G_t^T k_t + (r_t . (u * k_t)) do_t
//   dlogw_t[i] = w_t[i] sum_j S_{t-1}[i, j] G_t[i, j]
//   du = sum_{b, t} (r_t * k_t)(v_t . do_t),  dstate = G_0.
//
// Design: the forward's three launches in reverse, plus a reduction.
//   A' (grid: chunks x B*H): the chunk's share of G at its start,
//     dG_c = (r * exp(cum_ex))^T do, into scratch, and its log-decay;
//   B' (grid: B*H*Dh*Dh entries / 256): each thread owns one entry and runs
//     the short reverse scan G <- exp(log_decay_c) G + dG_c from dS_final
//     (or 0), writing each chunk's end gradient Gend_c over dG_c; the last
//     G is dstate;
//   C' (grid: chunks x B*H): the chunk's dr, dk, dv, dlogw and its partial
//     of du, from the chunk-start state the forward kept (its pass B's
//     scratch) and Gend_c;
//   D' (grid: H*Dh / 256): du, the partials summed over b and the chunks in
//     a fixed order -- no float atomics, so two calls give the same bits.
// In C', per chunk, with the forward's sub-chunk anchors (lx, lc, tot; see
// rwkv6_scan.cu), the factors fx = exp(lx), fc = exp(tot[q] - lc),
// eg[p] = exp(totals before p), ex[q] = exp(totals after q) and
// E[p, q] = exp(totals strictly between q and p), every exponent <= 0
// wherever logw <= 0, and bm[t, i] = do_t . v_i, bd[t] = bm[t, t]:
//   dr = fx (eg S_c do + sum_{q<p} E[p, q] bm (k fc)) + in_r + u k bd
//   dk = fc (ex Gend v + sum_{p>q} E[p, q] bm^T (r fx)) + in_k + u r bd
//   dv = att^T do + (k fc ex) Gend + (r . (u k)) do
// where in_r, in_k are the pairs of one sub-chunk with their pairwise
// decays exp(lx[t] - lc[i]) and att is the forward's. dlogw needs each
// token's S_{t-1}; it is taken instead as
//   dlogw[s] = sum_j Send_c Gend_c + sum_{t >= s in c} (r dr')[t+1] - (k dk')[t]
// with dr', dk' the gradients less their u terms and Send_c the state at
// the chunk's end (the forward's next chunk-start, or its final state):
// over the whole sequence dlogw[s] = sum_{t>s} r dr' - sum_{t>=s} k dk'
// (+ sum_j S_T dS_final), and the tokens after chunk c add up to
// sum_j Send_c Gend_c (scaling row i of Send_c is scaling r[i] up and k[i]
// down after it). So the cancellation between the two sums stays inside a
// chunk. kernels/rwkv6_scan.py::rwkv6_scan_bwd_ref repeats this arithmetic
// in PyTorch; the tests hold both against the sequential definition above
// in float64, at strong decays too (logw down to -20).
//
// Bound: at the training shape (B = 1, T = 2048, H = 32, Dh = 64, C = 64,
// bf16 r/k/v, float32 logw and do) the function reads r, k, v (25.2 MB),
// logw and do (33.6 MB) and the forward's chunk states (16.8 MB) and writes
// dr, dk, dv (25.2 MB) and dlogw (16.8 MB): 118.5 MB, 0.035 ms at 3.35 TB/s
// on an H100 SXM. Its products are 4.83 GFLOP (per chunk 8 C Dh^2 for the
// four state products and 10 C^2 Dh for the five intra-chunk ones); as in
// the forward they are float32 FMAs on the CUDA cores (TF32 would miss the
// 1e-4 contract), 0.072 ms at 67 TFLOP/s. This first version keeps the
// forward's structure -- 256 threads a block, register tiles of 4 x 4 from
// float4 shared-memory reads, every operand of C' in shared memory (180 KB:
// one block an SM) -- and does not overlap its loads with its products: C'
// takes most of its time (chip_smoke.py phase 12b and phase (v)'s trace).
//
// Layout: r/k/v (float32 or bfloat16), logw and do (float32) are read, and
// dr/dk/dv (the inputs' type) and dlogw (float32) written, through the
// forward's (b, t, h) strides. u and du are [H, Dh]. A ragged last chunk is
// padded with r = k = v = do = 0, logw = 0 inside the kernel; the pad
// tokens add 0 to every sum and their gradients are not written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rwkv6_tiles.cuh"  // constants, Tile, local_cumsums, run_sum, att_diagonal

namespace {

using namespace rwkv6;

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;        // [H, Dh]
  const float* dout;     // do: float32, the inputs' strides
  const float* d_final;  // [B*H, Dh, Dh] or null (zero)
  const float* states;   // [nc, B*H, Dh, Dh]: the forward's chunk-start states
  const float* s_final;  // [B*H, Dh, Dh]: the forward's final state
  void* dr;
  void* dk;
  void* dv;
  float* dlogw;
  float* du;             // [H, Dh]
  float* dstate;         // [B*H, Dh, Dh]
  float* grads;          // [nc, B*H, Dh, Dh]: dG_c (A'), then Gend_c (B')
  float* log_decay;      // [nc, B*H, Dh]
  float* du_part;        // [nc, B*H, Dh]
  int B, H, T, Dh, C, nc, BH;
  int64_t sB, sT, sH;
  int vec;  // 16-byte loads: see Tile
};

// One [kMaxDh, kMaxDh] state of `src` ([Dh, Dh], contiguous) into a tile,
// zero outside Dh x Dh.
__device__ __forceinline__ void load_state(float* dst, const float* src, int Dh) {
  for (int idx = threadIdx.x; idx < kMaxDh * kMaxDh; idx += kThreads) {
    const int d = idx / kMaxDh, e = idx % kMaxDh;
    dst[d * kLd + e] = (d < Dh && e < Dh) ? src[d * Dh + e] : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[x][y] += s[x] * b4[y] for a 4 x 4 register tile.
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float (&s)[4], float4 b4) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    acc[x][0] = fmaf(s[x], b4.x, acc[x][0]);
    acc[x][1] = fmaf(s[x], b4.y, acc[x][1]);
    acc[x][2] = fmaf(s[x], b4.z, acc[x][2]);
    acc[x][3] = fmaf(s[x], b4.w, acc[x][3]);
  }
}

// Four consecutive elements of row t of an output with the inputs' strides.
template <typename T>
__device__ __forceinline__ void store4(T* dst, const float (&v)[4], int e0, int Dh, int vec);

template <>
__device__ __forceinline__ void store4<float>(float* dst, const float (&v)[4], int e0, int Dh,
                                              int vec) {
  if (vec) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (e0 + j < Dh) dst[j] = v[j];
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst, const float (&v)[4],
                                                      int e0, int Dh, int vec) {
  if (vec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&lo);
    w.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (e0 + j < Dh) dst[j] = __float2bfloat16(v[j]);
}

// --------------------------------------------------------------- pass A'
template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_chunk_grad_kernel(Args a) {
  extern __shared__ float smem[];
  float* R = smem;           // r, then r exp(cum_ex)
  float* DO = R + kTile;
  float* LC = DO + kTile;    // logw, then lc
  float* LX = LC + kTile;
  float* TOT = LX + kTile;   // [kMaxSub, kMaxDh]
  float* EG = TOT + kMaxSub * kMaxDh;

  const int bh = blockIdx.x % a.BH, c = blockIdx.x / a.BH;  // neighbours share c
  const int b = bh / a.H, h = bh % a.H;
  const int64_t base = (int64_t)b * a.sB + (int64_t)h * a.sH;
  const int c0 = c * a.C;
  const T* rp = static_cast<const T*>(a.r);
  Tile<T, Args> tr_;
  Tile<float, Args> tdo, tl;
  tr_.fetch(rp, a, base, c0);
  tdo.fetch(a.dout, a, base, c0);
  tl.fetch(a.logw, a, base, c0);
  tr_.store(R, rp, a, base, c0);
  tdo.store(DO, a.dout, a, base, c0);
  tl.store(LC, a.logw, a, base, c0);
  __syncthreads();
  local_cumsums(LC, LX, TOT);
  __syncthreads();
  const int nsub = (a.C + kSub - 1) / kSub;
  {
    const int q = threadIdx.x / kMaxDh, d = threadIdx.x % kMaxDh;
    EG[threadIdx.x] = expf(run_sum(TOT, 0, q, d));
    if (threadIdx.x < a.Dh)
      a.log_decay[((int64_t)c * a.BH + bh) * a.Dh + threadIdx.x] =
          run_sum(TOT, 0, nsub, threadIdx.x);
  }
  __syncthreads();
  // cum_ex[t] = (totals before t's sub-chunk p) + lx[t]: r exp(lx) eg[p].
  for (int idx = threadIdx.x; idx < kMaxC * kMaxDh / 4; idx += kThreads) {
    const int t = idx / (kMaxDh / 4), d = (idx % (kMaxDh / 4)) * 4, at = t * kLd + d;
    const float4 x = ld4(LX + at), g = ld4(EG + (t / kSub) * kMaxDh + d);
    float4 r = ld4(R + at);
    r.x = r.x * __expf(x.x) * g.x;
    r.y = r.y * __expf(x.y) * g.y;
    r.z = r.z * __expf(x.z) * g.z;
    r.w = r.w * __expf(x.w) * g.w;
    *reinterpret_cast<float4*>(R + at) = r;
  }
  __syncthreads();
  // dG[d, e] = sum_t R[t, d] DO[t, e]: rows d = 4 tr .., columns e = 4 tc ..
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int t = 0; t < a.C; ++t) {
    const float4 rd = ld4(R + t * kLd + 4 * tr);
    const float s[4] = {rd.x, rd.y, rd.z, rd.w};
    outer4(acc, s, ld4(DO + t * kLd + 4 * tc));
  }
  float* dg = a.grads + ((int64_t)c * a.BH + bh) * a.Dh * a.Dh;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int d = 4 * tr + x, e = 4 * tc;
    if (d >= a.Dh || e >= a.Dh) continue;
    store4<float>(dg + d * a.Dh + e, acc[x], e, a.Dh, a.vec);
  }
}

// --------------------------------------------------------------- pass B'
__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_state_scan_kernel(Args a, int64_t n_states) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n_states) return;
  const int64_t dd = (int64_t)a.Dh * a.Dh;
  const int64_t bh = idx / dd;
  const int d = (int)(idx % dd) / a.Dh;
  float G = a.d_final ? a.d_final[idx] : 0.f;
  float* __restrict__ gr = a.grads + idx;
  const float* __restrict__ ld = a.log_decay + bh * a.Dh + d;
  const int64_t g_step = n_states, ld_step = (int64_t)a.BH * a.Dh;
  // Loads of kBatch chunks first, then their steps, last chunk first.
  constexpr int kBatch = 8;
  for (int c1 = a.nc - 1; c1 >= 0; c1 -= kBatch) {
    float dg[kBatch], w[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      dg[j] = 0.f;
      w[j] = 0.f;
      if (c1 - j >= 0) {
        dg[j] = gr[(c1 - j) * g_step];
        w[j] = ld[(c1 - j) * ld_step];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c1 - j >= 0) {
        gr[(c1 - j) * g_step] = G;
        G = fmaf(expf(w[j]), G, dg[j]);
      }
    }
  }
  a.dstate[idx] = G;
}

// --------------------------------------------------------------- pass C'
constexpr size_t kOutSmemFloats = 8 * kTile + 2 * kMaxC * kLdAtt + 3 * kMaxSub * kMaxDh +
                                  kMaxSub * kMaxSub * kMaxDh + 4 * kMaxC + 2 * kMaxSub * kMaxDh;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
rwkv6_bwd_chunk_out_kernel(Args a) {
  extern __shared__ float smem[];
  float* R = smem;            // r
  float* K = R + kTile;       // k
  float* V = K + kTile;       // v
  float* DO = V + kTile;      // do
  float* LX = DO + kTile;     // lx, then fx = exp(lx)
  float* LC = LX + kTile;     // logw, then lc, then fc = exp(tot[q] - lc)
  float* SC = LC + kTile;     // the chunk-start state S_c [kMaxDh, kLd]
  float* GE = SC + kTile;     // Gend_c [kMaxDh, kLd]
  float* BM = GE + kTile;     // [kMaxC, kLdAtt]: do_t . v_i (i <= t), then r dr'
  float* ATT = BM + kMaxC * kLdAtt;  // the forward's att (i < t), then k dk' partial sums
  float* TOT = ATT + kMaxC * kLdAtt;
  float* EG = TOT + kMaxSub * kMaxDh;          // exp(totals before p)
  float* EX = EG + kMaxSub * kMaxDh;           // exp(totals after q)
  float* E = EX + kMaxSub * kMaxDh;            // [p, q]: exp(totals strictly between)
  float* U = E + kMaxSub * kMaxSub * kMaxDh;
  float* KC = U + kMaxC;                       // sum_j Send Gend, per row
  float* BD = KC + kMaxC;                      // bm[t, t]
  float* BONUS = BD + kMaxC;                   // r . (u k)
  float* SUF = BONUS + kMaxC;                  // [q, d]: a sub-chunk's dlogw terms summed
  float* DUQ = SUF + kMaxSub * kMaxDh;         // [q, d]: a sub-chunk's du terms summed

  const int bh = blockIdx.x % a.BH, c = blockIdx.x / a.BH;  // neighbours share c
  const int b = bh / a.H, h = bh % a.H;
  const int64_t base = (int64_t)b * a.sB + (int64_t)h * a.sH;
  const int c0 = c * a.C;
  const int tid = threadIdx.x;
  const int nsub = (a.C + kSub - 1) / kSub;
  const T* rp = static_cast<const T*>(a.r);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  {
    Tile<T, Args> tr_, tk, tv;
    Tile<float, Args> tl;
    tr_.fetch(rp, a, base, c0);
    tk.fetch(kp, a, base, c0);
    tv.fetch(vp, a, base, c0);
    tl.fetch(a.logw, a, base, c0);
    tr_.store(R, rp, a, base, c0);
    tk.store(K, kp, a, base, c0);
    tv.store(V, vp, a, base, c0);
    tl.store(LC, a.logw, a, base, c0);
  }
  {
    Tile<float, Args> tdo;
    tdo.fetch(a.dout, a, base, c0);
    tdo.store(DO, a.dout, a, base, c0);
  }
  const int64_t dd = (int64_t)a.Dh * a.Dh;
  load_state(SC, a.states + ((int64_t)c * a.BH + bh) * dd, a.Dh);
  load_state(GE, a.grads + ((int64_t)c * a.BH + bh) * dd, a.Dh);
  if (tid < kMaxDh) U[tid] = tid < a.Dh ? a.u[(int64_t)h * a.Dh + tid] : 0.f;
  for (int idx = tid; idx < kMaxC * kLdAtt; idx += kThreads) ATT[idx] = 0.f;
  __syncthreads();
  // KC[d] = sum_j Send[d, j] Gend[d, j]: four threads a row d, 16 columns each.
  {
    const float* send = c + 1 < a.nc ? a.states + ((int64_t)(c + 1) * a.BH + bh) * dd
                                     : a.s_final + (int64_t)bh * dd;
    const int d = tid / 4, j0 = (tid % 4) * 16;
    float s = 0.f;
    if (d < a.Dh)
      for (int j = j0; j < j0 + 16 && j < a.Dh; ++j) s = fmaf(send[d * a.Dh + j], GE[d * kLd + j], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (tid % 4 == 0) KC[d] = s;
  }
  local_cumsums(LC, LX, TOT);
  __syncthreads();
  {
    const int p = tid / kMaxDh, d = tid % kMaxDh;
    EG[p * kMaxDh + d] = expf(run_sum(TOT, 0, p, d));
    EX[p * kMaxDh + d] = expf(run_sum(TOT, p + 1, nsub, d));
    for (int q = 0; q < p; ++q) E[(p * kMaxSub + q) * kMaxDh + d] = expf(run_sum(TOT, q + 1, p, d));
  }
  // bm[t, i] = do_t . v_i for the blocks with i <= t: rows t = 4 tr ..,
  // columns i = 4 tc ...
  const int tr = tid / 16, tc = tid % 16;
  const int t0 = 4 * tr, c4 = 4 * tc;
  if (tc <= tr) {
    float acc[4][4] = {};
    for (int e = 0; e < a.Dh; e += 4) {
      float4 dv4[4], vv[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) dv4[x] = ld4(DO + (t0 + x) * kLd + e);
#pragma unroll
      for (int y = 0; y < 4; ++y) vv[y] = ld4(V + (c4 + y) * kLd + e);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = dot4(dv4[x], vv[y], acc[x][y]);
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
      *reinterpret_cast<float4*>(BM + (t0 + x) * kLdAtt + c4) =
          make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
  }
  att_diagonal(R, K, LX, LC, ATT, nsub);
  __syncthreads();
  // The pairs of one sub-chunk, decays pairwise, for the cells of this
  // thread (rows t0 .. t0 + 3 of sub-chunk sp, channels c4 .. c4 + 3):
  //   in_r[t, d] = sum_{i < t} bm[t, i] k[i, d] exp(lx[t, d] - lc[i, d])
  //   in_k[i, d] = sum_{t > i} bm[t, i] r[t, d] exp(lx[t, d] - lc[i, d]).
  const int sp = t0 / kSub, s0 = sp * kSub;
  float g_r[4][4] = {}, g_k[4][4] = {};
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int t = t0 + x;
    const float4 lxt = ld4(LX + t * kLd + c4);
    for (int i = s0; i < t; ++i) {
      const float bti = BM[t * kLdAtt + i];
      const float4 ki = ld4(K + i * kLd + c4), ci = ld4(LC + i * kLd + c4);
      g_r[x][0] = fmaf(bti * ki.x, __expf(lxt.x - ci.x), g_r[x][0]);
      g_r[x][1] = fmaf(bti * ki.y, __expf(lxt.y - ci.y), g_r[x][1]);
      g_r[x][2] = fmaf(bti * ki.z, __expf(lxt.z - ci.z), g_r[x][2]);
      g_r[x][3] = fmaf(bti * ki.w, __expf(lxt.w - ci.w), g_r[x][3]);
    }
    const int i = t0 + x;
    const float4 lci = ld4(LC + i * kLd + c4);
    for (int t2 = i + 1; t2 < s0 + kSub; ++t2) {
      const float bti = BM[t2 * kLdAtt + i];
      const float4 rt = ld4(R + t2 * kLd + c4), xt = ld4(LX + t2 * kLd + c4);
      g_k[x][0] = fmaf(bti * rt.x, __expf(xt.x - lci.x), g_k[x][0]);
      g_k[x][1] = fmaf(bti * rt.y, __expf(xt.y - lci.y), g_k[x][1]);
      g_k[x][2] = fmaf(bti * rt.z, __expf(xt.z - lci.z), g_k[x][2]);
      g_k[x][3] = fmaf(bti * rt.w, __expf(xt.w - lci.w), g_k[x][3]);
    }
  }
  // bd and the bonus r . (u k): four threads a row t, 16 channels each.
  {
    const int t = tid / 4;
    float bonus = 0.f;
#pragma unroll
    for (int n = 0; n < kMaxDh / 16; ++n) {
      const int d = (tid % 4) * 16 + 4 * n, at = t * kLd + d;
      bonus = dot4(mul4(ld4(R + at), ld4(U + d)), ld4(K + at), bonus);
    }
    bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
    bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
    if (tid % 4 == 0) {
      BONUS[t] = bonus;
      BD[t] = BM[t * kLdAtt + t];
    }
  }
  __syncthreads();
  // lx -> fx = exp(lx), lc -> fc = exp(tot[q] - lc), in place.
  for (int idx = tid; idx < kMaxC * kMaxDh / 4; idx += kThreads) {
    const int t = idx / (kMaxDh / 4), d = (idx % (kMaxDh / 4)) * 4, at = t * kLd + d;
    const float4 x = ld4(LX + at), lc = ld4(LC + at), tq = ld4(TOT + (t / kSub) * kMaxDh + d);
    *reinterpret_cast<float4*>(LX + at) =
        make_float4(__expf(x.x), __expf(x.y), __expf(x.z), __expf(x.w));
    *reinterpret_cast<float4*>(LC + at) = make_float4(
        __expf(tq.x - lc.x), __expf(tq.y - lc.y), __expf(tq.z - lc.z), __expf(tq.w - lc.w));
  }
  __syncthreads();
  float* FX = LX;
  float* FC = LC;
  // The off-diagonal blocks of att, as in the forward:
  // att[t, i] = sum_d (r fx)[t, d] E[p, q, d] (k fc)[i, d] for q < p, each
  // thread two rows t by four columns i of one 16 x 16 block.
  const int n_off = nsub * (nsub - 1) / 2;
  for (int idx = tid; idx < n_off * 32; idx += kThreads) {
    int blk = idx / 32, p = 1;
    while (blk >= p) blk -= p++;
    const int q = blk, w = idx % 32;
    const int ta = p * kSub + (w / 4) * 2, i0 = q * kSub + (w % 4) * 4;
    const float* ep = E + (p * kMaxSub + q) * kMaxDh;
    float acc[2][4] = {};
    for (int d = 0; d < kMaxDh; d += 4) {
      const float4 e4 = ld4(ep + d);
      float4 rr[2], kk[4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
        rr[x] = mul4(mul4(ld4(R + (ta + x) * kLd + d), ld4(FX + (ta + x) * kLd + d)), e4);
#pragma unroll
      for (int y = 0; y < 4; ++y) kk[y] = mul4(ld4(K + (i0 + y) * kLd + d), ld4(FC + (i0 + y) * kLd + d));
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = dot4(rr[x], kk[y], acc[x][y]);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x)
      *reinterpret_cast<float4*>(ATT + (ta + x) * kLdAtt + i0) =
          make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
  }
  __syncthreads();
  // dr' = fx (eg S_c do + sum_{q<p} E[p, q] bm (k fc)) + in_r, into g_r.
  {
    float acc[4][4] = {};
    for (int e = 0; e < a.Dh; e += 4) {
      float4 dv4[4], sv[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) dv4[x] = ld4(DO + (t0 + x) * kLd + e);
#pragma unroll
      for (int y = 0; y < 4; ++y) sv[y] = ld4(SC + (c4 + y) * kLd + e);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = dot4(dv4[x], sv[y], acc[x][y]);
    }
    const float4 eg = ld4(EG + sp * kMaxDh + c4);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      acc[x][0] *= eg.x;
      acc[x][1] *= eg.y;
      acc[x][2] *= eg.z;
      acc[x][3] *= eg.w;
    }
    for (int q = 0; q < sp; ++q) {
      float part[4][4] = {};
      for (int i = q * kSub; i < (q + 1) * kSub; ++i) {
        const float s[4] = {BM[t0 * kLdAtt + i], BM[(t0 + 1) * kLdAtt + i],
                            BM[(t0 + 2) * kLdAtt + i], BM[(t0 + 3) * kLdAtt + i]};
        outer4(part, s, mul4(ld4(K + i * kLd + c4), ld4(FC + i * kLd + c4)));
      }
      const float4 e4 = ld4(E + (sp * kMaxSub + q) * kMaxDh + c4);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        acc[x][0] = fmaf(e4.x, part[x][0], acc[x][0]);
        acc[x][1] = fmaf(e4.y, part[x][1], acc[x][1]);
        acc[x][2] = fmaf(e4.z, part[x][2], acc[x][2]);
        acc[x][3] = fmaf(e4.w, part[x][3], acc[x][3]);
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float4 fx = ld4(FX + (t0 + x) * kLd + c4);
      g_r[x][0] = fmaf(fx.x, acc[x][0], g_r[x][0]);
      g_r[x][1] = fmaf(fx.y, acc[x][1], g_r[x][1]);
      g_r[x][2] = fmaf(fx.z, acc[x][2], g_r[x][2]);
      g_r[x][3] = fmaf(fx.w, acc[x][3], g_r[x][3]);
    }
  }
  // dk' = fc (ex Gend v + sum_{p>q} E[p, q] bm^T (r fx)) + in_k, into g_k
  // (rows i = t0 .., sub-chunk sp).
  {
    float acc[4][4] = {};
    for (int e = 0; e < a.Dh; e += 4) {
      float4 vi[4], gv[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) vi[x] = ld4(V + (t0 + x) * kLd + e);
#pragma unroll
      for (int y = 0; y < 4; ++y) gv[y] = ld4(GE + (c4 + y) * kLd + e);
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = dot4(vi[x], gv[y], acc[x][y]);
    }
    const float4 ex = ld4(EX + sp * kMaxDh + c4);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      acc[x][0] *= ex.x;
      acc[x][1] *= ex.y;
      acc[x][2] *= ex.z;
      acc[x][3] *= ex.w;
    }
    for (int p = sp + 1; p < nsub; ++p) {
      float part[4][4] = {};
      for (int t = p * kSub; t < (p + 1) * kSub; ++t) {
        const float4 b4 = ld4(BM + t * kLdAtt + t0);
        const float s[4] = {b4.x, b4.y, b4.z, b4.w};
        outer4(part, s, mul4(ld4(R + t * kLd + c4), ld4(FX + t * kLd + c4)));
      }
      const float4 e4 = ld4(E + (p * kMaxSub + sp) * kMaxDh + c4);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        acc[x][0] = fmaf(e4.x, part[x][0], acc[x][0]);
        acc[x][1] = fmaf(e4.y, part[x][1], acc[x][1]);
        acc[x][2] = fmaf(e4.z, part[x][2], acc[x][2]);
        acc[x][3] = fmaf(e4.w, part[x][3], acc[x][3]);
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float4 fc = ld4(FC + (t0 + x) * kLd + c4);
      g_k[x][0] = fmaf(fc.x, acc[x][0], g_k[x][0]);
      g_k[x][1] = fmaf(fc.y, acc[x][1], g_k[x][1]);
      g_k[x][2] = fmaf(fc.z, acc[x][2], g_k[x][2]);
      g_k[x][3] = fmaf(fc.w, acc[x][3], g_k[x][3]);
    }
  }
  // dv[i, e] = sum_{t > i} att[t, i] do[t, e] + sum_d (k fc ex)[i, d]
  // Gend[d, e] + bonus[i] do[i, e] (rows i = t0 .., columns e = c4 ..).
  const int64_t grad_base = base + (int64_t)c0 * a.sT;
  const bool row_ok[4] = {t0 < a.C && c0 + t0 < a.T, t0 + 1 < a.C && c0 + t0 + 1 < a.T,
                          t0 + 2 < a.C && c0 + t0 + 2 < a.T, t0 + 3 < a.C && c0 + t0 + 3 < a.T};
  {
    float acc[4][4] = {};
    for (int t = t0; t < a.C; ++t) {  // att[t, i] is 0 for t <= i
      const float4 at4 = ld4(ATT + t * kLdAtt + t0);
      const float s[4] = {at4.x, at4.y, at4.z, at4.w};
      outer4(acc, s, ld4(DO + t * kLd + c4));
    }
    for (int d = 0; d < a.Dh; d += 4) {
      const float4 x4 = ld4(EX + sp * kMaxDh + d);
      float4 gv[4];
#pragma unroll
      for (int y = 0; y < 4; ++y) gv[y] = ld4(GE + (d + y) * kLd + c4);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 kq = mul4(mul4(ld4(K + (t0 + x) * kLd + d), ld4(FC + (t0 + x) * kLd + d)), x4);
        const float s[4] = {kq.x, kq.y, kq.z, kq.w};
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          acc[x][0] = fmaf(s[y], gv[y].x, acc[x][0]);
          acc[x][1] = fmaf(s[y], gv[y].y, acc[x][1]);
          acc[x][2] = fmaf(s[y], gv[y].z, acc[x][2]);
          acc[x][3] = fmaf(s[y], gv[y].w, acc[x][3]);
        }
      }
    }
    T* dvp = static_cast<T*>(a.dv) + grad_base;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (!row_ok[x] || c4 >= a.Dh) continue;
      const float4 d4 = ld4(DO + (t0 + x) * kLd + c4);
      const float bt = BONUS[t0 + x];
      const float out[4] = {fmaf(bt, d4.x, acc[x][0]), fmaf(bt, d4.y, acc[x][1]),
                            fmaf(bt, d4.z, acc[x][2]), fmaf(bt, d4.w, acc[x][3])};
      store4<T>(dvp + (int64_t)(t0 + x) * a.sT + c4, out, c4, a.Dh, a.vec);
    }
  }
  // dr = dr' + u k bd and dk = dk' + u r bd, written out; then r dr' and
  // k dk' into BM and ATT for dlogw.
  {
    T* drp = static_cast<T*>(a.dr) + grad_base;
    T* dkp = static_cast<T*>(a.dk) + grad_base;
    const float4 u4 = ld4(U + c4);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (!row_ok[x] || c4 >= a.Dh) continue;
      const int t = t0 + x;
      const float bt = BD[t];
      const float4 r4 = ld4(R + t * kLd + c4), k4 = ld4(K + t * kLd + c4);
      const float or_[4] = {fmaf(u4.x * k4.x, bt, g_r[x][0]), fmaf(u4.y * k4.y, bt, g_r[x][1]),
                            fmaf(u4.z * k4.z, bt, g_r[x][2]), fmaf(u4.w * k4.w, bt, g_r[x][3])};
      const float ok[4] = {fmaf(u4.x * r4.x, bt, g_k[x][0]), fmaf(u4.y * r4.y, bt, g_k[x][1]),
                           fmaf(u4.z * r4.z, bt, g_k[x][2]), fmaf(u4.w * r4.w, bt, g_k[x][3])};
      store4<T>(drp + (int64_t)t * a.sT + c4, or_, c4, a.Dh, a.vec);
      store4<T>(dkp + (int64_t)t * a.sT + c4, ok, c4, a.Dh, a.vec);
    }
  }
  __syncthreads();  // every read of BM and ATT is done
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int t = t0 + x;
    const float4 r4 = ld4(R + t * kLd + c4), k4 = ld4(K + t * kLd + c4);
    *reinterpret_cast<float4*>(BM + t * kLdAtt + c4) =
        make_float4(r4.x * g_r[x][0], r4.y * g_r[x][1], r4.z * g_r[x][2], r4.w * g_r[x][3]);
    *reinterpret_cast<float4*>(ATT + t * kLdAtt + c4) =
        make_float4(k4.x * g_k[x][0], k4.y * g_k[x][1], k4.z * g_k[x][2], k4.w * g_k[x][3]);
  }
  __syncthreads();
  // dlogw: one thread a (sub-chunk q, channel d), its tokens last first:
  // z[t] = (r dr')[t + 1] - (k dk')[t], summed from the chunk's end; each
  // sub-chunk's own sums, then the later sub-chunks' totals and KC. And
  // du's terms r k bd, summed per sub-chunk.
  // (r dr')[t + 1] is carried from one step to the next: a guarded load of
  // row t + 1 inside this loop was compiled (nvcc 12.9, sm_90a) with wrong
  // shared-memory offsets in its unrolled copies.
  {
    const int q = tid / kMaxDh, d = tid % kMaxDh;
    float acc = 0.f, du = 0.f;
    float rn = q + 1 < kMaxSub ? BM[(q + 1) * kSub * kLdAtt + d] : 0.f;
    for (int t = (q + 1) * kSub - 1; t >= q * kSub; --t) {
      acc += rn - ATT[t * kLdAtt + d];
      ATT[t * kLdAtt + d] = acc;
      rn = BM[t * kLdAtt + d];
      du = fmaf(R[t * kLd + d] * K[t * kLd + d], BD[t], du);
    }
    SUF[tid] = acc;
    DUQ[tid] = du;
  }
  __syncthreads();
  {
    const int q = tid / kMaxDh, d = tid % kMaxDh;
    if (d < a.Dh) {
      float later = KC[d];
      for (int j = nsub - 1; j > q; --j) later += SUF[j * kMaxDh + d];
      float* dl = a.dlogw + grad_base + d;
      for (int t = q * kSub; t < (q + 1) * kSub; ++t)
        if (t < a.C && c0 + t < a.T) dl[(int64_t)t * a.sT] = ATT[t * kLdAtt + d] + later;
      if (q == 0) {
        float du = 0.f;
        for (int j = 0; j < kMaxSub; ++j) du += DUQ[j * kMaxDh + d];
        a.du_part[((int64_t)c * a.BH + bh) * a.Dh + d] = du;
      }
    }
  }
}

// --------------------------------------------------------------- pass D'
__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_du_kernel(Args a) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;  // (h, d)
  if (idx >= a.H * a.Dh) return;
  const int h = idx / a.Dh, d = idx % a.Dh;
  float s = 0.f;
  for (int b = 0; b < a.B; ++b)
    for (int c = 0; c < a.nc; ++c) s += a.du_part[((int64_t)c * a.BH + b * a.H + h) * a.Dh + d];
  a.du[idx] = s;
}

constexpr size_t kGradSmem = sizeof(float) * (4 * kTile + 2 * kMaxSub * kMaxDh);
constexpr size_t kOutSmem = sizeof(float) * kOutSmemFloats;

template <typename T>
int launch(const Args& a, cudaStream_t st) {
  const unsigned chunk_blocks = (unsigned)(a.BH * a.nc);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_bwd_chunk_grad_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kGradSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rwkv6_bwd_chunk_out_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kOutSmem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_chunk_grad_kernel<T><<<chunk_blocks, kThreads, kGradSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n_states = (int64_t)a.BH * a.Dh * a.Dh;
  rwkv6_bwd_state_scan_kernel<<<(unsigned)((n_states + kThreads - 1) / kThreads), kThreads, 0,
                                st>>>(a, n_states);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_chunk_out_kernel<T><<<chunk_blocks, kThreads, kOutSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_du_kernel<<<(unsigned)((a.H * a.Dh + kThreads - 1) / kThreads), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v, dr, dk, dv (bf16 != 0: bfloat16, else float32) and logw, dout,
// dlogw (float32): element (b, t, h, d) at b * sB + t * sT + h * sH + d.
// u, du: [H, Dh] float32. d_final (or null), s_final, dstate: [B * H, Dh,
// Dh] float32. states: the forward's [ceil(T / C), B * H, Dh, Dh]
// chunk-start states (its scratch after pass B). grads:
// B * H * ceil(T / C) * Dh * Dh floats of scratch; log_decay and du_part
// B * H * ceil(T / C) * Dh each. 1 <= Dh <= 64, 1 <= C <= 64. Four launches
// on `stream`. Returns cudaGetLastError() after the last launch that was
// made (0 on success), or -1 for an unsupported Dh or C.
int rwkv6_scan_bwd_launch(const void* r, const void* k, const void* v, const void* logw,
                          const void* u, const void* dout, const void* d_final,
                          const void* states, const void* s_final, void* dr, void* dk, void* dv,
                          void* dlogw, void* du, void* dstate, void* grads, void* log_decay,
                          void* du_part, int B, int H, int T_len, int Dh, int C, int64_t sB,
                          int64_t sT, int64_t sH, int bf16, void* stream) {
  if (Dh < 1 || Dh > kMaxDh || C < 1 || C > kMaxC) return -1;
  if (B <= 0 || H <= 0 || T_len <= 0) return (int)cudaGetLastError();
  Args a{r, k, v, static_cast<const float*>(logw), static_cast<const float*>(u),
         static_cast<const float*>(dout), static_cast<const float*>(d_final),
         static_cast<const float*>(states), static_cast<const float*>(s_final), dr, dk, dv,
         static_cast<float*>(dlogw), static_cast<float*>(du), static_cast<float*>(dstate),
         static_cast<float*>(grads), static_cast<float*>(log_decay),
         static_cast<float*>(du_part), B, H, T_len, Dh, C, (T_len + C - 1) / C, B * H, sB, sT,
         sH, 0};
  a.vec = Dh % 8 == 0 && sB % 8 == 0 && sT % 8 == 0 && sH % 8 == 0;
  const void* const ptrs[] = {r, k, v, logw, dout, dr, dk, dv, dlogw, grads};
  for (const void* ptr : ptrs) a.vec = a.vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
}

// Dynamic shared memory of pass 0 (A'), 1 (B'), 2 (C') or 3 (D'), in bytes.
int rwkv6_scan_bwd_smem_bytes(int pass) {
  return pass == 0 ? (int)kGradSmem : pass == 2 ? (int)kOutSmem : 0;
}

}  // extern "C"
