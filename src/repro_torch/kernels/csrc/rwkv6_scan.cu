// Chunk-parallel RWKV-6 (Finch) recurrence for Hopper.
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6_scan.py::rwkv6_scan.
// Per (batch, head), with state S in R^{Dh x Dh} (float32):
//   o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
// in the chunked form of the model's
// src/repro/models/rwkv6.py::_rwkv6_chunked.chunk_fn: per chunk of C
// tokens, with cum the inclusive and cum_ex the exclusive cumulative sum of
// logw over the chunk,
//   o = (r * exp(cum_ex)) S_c + att v + (r . (u * k)) v,
//       att[t, i] = sum_d r[t,d] k[i,d] exp(cum_ex[t,d] - cum[i,d])  (i < t)
//   S_{c+1} = exp(cum[C-1]) * S_c + (k * exp(cum[C-1] - cum))^T v.
//
// It replaces a kernel with one block per (b, h) walking its chunks in
// order: 128 blocks for 132 SMs at the serving shape, so the launch took
// one block's time, 1.58 ms on an H100 SXM at 700 W, and each chunk
// evaluated C (C-1)/2 Dh pairwise exponentials (5.3e8 a launch, 0.126 ms
// of SFU time alone).
//
// Bound: at the serving shape (B = 4, T = 2048, H = 32, Dh = 64, C = 64,
// bf16 r/k/v) the function moves 239 MB (0.071 ms at 3.35 TB/s on an H100
// SXM, 700 W); this design adds the chunk states, written once and read
// twice (67 MB each way), about 440 MB in all, 0.13 ms. Its products are
// 9.7 GFLOP of float32 FMAs on the CUDA cores, 0.145 ms at 67 TFLOP/s:
// TF32 tensor cores keep 10 mantissa bits and would miss the rtol/atol
// 1e-4 contract, so the products stay float32 and the kernel is bound by
// operations on the CUDA cores.
//
// Design: three launches on the caller's stream, no state crossing blocks
// inside a launch.
//   A (grid: chunks x B*H): the chunk's state increment
//     dS_c = (k * exp(cum[C-1] - cum))^T v into scratch, and its log-decay
//     cum[C-1];
//   B (grid: B*H*Dh*Dh states / 256): each thread owns one state entry and
//     runs the short scan S_{c+1} = exp(cum_c[C-1]) S_c + dS_c over the
//     chunks, writing each chunk's starting state over dS_c, then the final
//     state;
//   C (grid: chunks x B*H): the chunk's outputs from its starting state.
// At the serving shape A and C have 4,096 blocks of 256 threads each (C:
// two resident per SM, by its 111 KB of shared memory), not 128. Blocks
// next to each other in the grid share a chunk, and the scratch is
// chunk-major, so each step of B and each wave of A and C touch one
// contiguous slab of states. Every tile is fetched with 16-byte loads into
// registers before any is stored to shared memory (the state's too, in C,
// ahead of the work that precedes its use), so a block waits on its loads
// once; the products are register-tiled 4 x 4 from float4 shared-memory
// reads. A block still fetches and then computes: the loads of A and C
// are not overlapped with their products, which is the next thing to
// change.
//
// Exponentials: each chunk is cut into sub-chunks of kSub = 16 tokens.
// Inside a sub-chunk the pairwise exp(cum_ex[t] - cum[i]) stay (on the
// SFU, __expf); across sub-chunks the decay factors at the last token e of
// i's sub-chunk:
//   exp(cum_ex[t] - cum[i]) = exp(cum_ex[t] - cum[e]) * exp(cum[e] - cum[i]),
// and the first factor again into exp(lx[t]) (t's own sub-chunk) times the
// totals of the sub-chunks between. Every exponent is then <= 0 wherever
// logw <= 0 (the model's -exp(.) decays), so nothing overflows however
// strong the decay, and the off-diagonal blocks of att are plain products
// of scaled r and k tiles. At C = 64 that is about 39 k exponentials a
// chunk instead of 129 k.
// Accuracy: cumulative sums are taken from each sub-chunk's start, and a
// chunk-wide sum is a sum of whole sub-chunk totals, so no exponent is the
// difference of two long sums. The reference's chunk form (and the plain
// version, kernels/rwkv6_scan.py::rwkv6_chunked_ref) loses about one ulp of
// |cum| there: at logw <= -5 and C = 64, up to 1e-3 on o against the
// sequential recurrence, where this arithmetic stays within 2e-5
// (tests/test_torch_lm_kernels.py). rwkv6_chunk_parallel_ref in the same
// module repeats this arithmetic in PyTorch.
//
// Layout: r/k/v (float32 or bfloat16) and logw (float32) are read through
// (b, t, h) strides, so the model hands its [B, T, H, Dh] projections over
// as they are and the Pallas signature's [BH, T, Dh] is the case H = 1. o
// has the inputs' strides. A T that is not a multiple of C is padded inside
// the kernel with r = k = v = 0, logw = 0 -- the model's padding -- and so is
// every chunk shorter than a multiple of kSub: the padded tokens add 0 to
// every sum, so the smem tiles are always kMaxC x kMaxDh. Sums run in
// another order than PyTorch's, so the result agrees with the plain version
// to float32 rounding.
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
  const float* u;
  const float* s0;
  float* o;
  float* s_out;
  float* states;     // [nc, B*H, Dh, Dh]: dS_c (pass A), then S_c (pass B)
  float* log_decay;  // [nc, B*H, Dh]
  int H, T, Dh, C, nc, BH;
  int64_t sB, sT, sH, uB;
  int vec;  // 16-byte loads: see Tile
};

// ---------------------------------------------------------------- pass A
template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_chunk_state_kernel(Args a) {
  extern __shared__ float smem[];
  float* K = smem;          // k, then k * exp(cum[C-1] - cum)
  float* V = K + kTile;
  float* LC = V + kTile;    // logw, then lc
  float* TOT = LC + kTile;  // [kMaxSub, kMaxDh]
  float* OFF = TOT + kMaxSub * kMaxDh;

  const int bh = blockIdx.x % a.BH, c = blockIdx.x / a.BH;  // neighbours share c
  const int b = bh / a.H, h = bh % a.H;
  const int64_t base = (int64_t)b * a.sB + (int64_t)h * a.sH;
  const int c0 = c * a.C;
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  Tile<T, Args> tk, tv;
  Tile<float, Args> tl;
  tk.fetch(kp, a, base, c0);
  tv.fetch(vp, a, base, c0);
  tl.fetch(a.logw, a, base, c0);
  tk.store(K, kp, a, base, c0);
  tv.store(V, vp, a, base, c0);
  tl.store(LC, a.logw, a, base, c0);
  __syncthreads();
  local_cumsums(LC, nullptr, TOT);
  __syncthreads();
  // cum[C-1] - cum[i] = OFF[q] - lc[i] for i in sub-chunk q, with OFF[q]
  // the sum of the later sub-chunks' totals plus q's own.
  const int nsub = (a.C + kSub - 1) / kSub;
  {
    const int q = threadIdx.x / kMaxDh, d = threadIdx.x % kMaxDh;
    OFF[threadIdx.x] = run_sum(TOT, q + 1, nsub, d) + TOT[q * kMaxDh + d];
    if (threadIdx.x < a.Dh)
      a.log_decay[((int64_t)c * a.BH + bh) * a.Dh + threadIdx.x] =
          run_sum(TOT, 0, nsub, threadIdx.x);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kMaxC * kMaxDh / 4; idx += kThreads) {
    const int i = idx / (kMaxDh / 4), d = (idx % (kMaxDh / 4)) * 4, at = i * kLd + d;
    const float4 off = *reinterpret_cast<const float4*>(OFF + (i / kSub) * kMaxDh + d);
    const float4 lc = *reinterpret_cast<const float4*>(LC + at);
    float4 k = *reinterpret_cast<const float4*>(K + at);
    k.x *= __expf(off.x - lc.x);
    k.y *= __expf(off.y - lc.y);
    k.z *= __expf(off.z - lc.z);
    k.w *= __expf(off.w - lc.w);
    *reinterpret_cast<float4*>(K + at) = k;
  }
  __syncthreads();
  // dS[d, e] = sum_i K[i, d] V[i, e]: rows d = 4 tr .. 4 tr + 3, columns
  // e = 4 tc .. 4 tc + 3.
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  float acc[4][4] = {};
  for (int i = 0; i < a.C; ++i) {
    const float4 kd = *reinterpret_cast<const float4*>(K + i * kLd + 4 * tr);
    const float4 vv = *reinterpret_cast<const float4*>(V + i * kLd + 4 * tc);
    const float kr[4] = {kd.x, kd.y, kd.z, kd.w}, vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(kr[r], vc[j], acc[r][j]);
  }
  float* ds = a.states + ((int64_t)c * a.BH + bh) * a.Dh * a.Dh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int d = 4 * tr + r, e = 4 * tc;
    if (d >= a.Dh || e >= a.Dh) continue;
    if (a.vec) {
      *reinterpret_cast<float4*>(ds + d * a.Dh + e) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e + j < a.Dh) ds[d * a.Dh + e + j] = acc[r][j];
    }
  }
}

// ---------------------------------------------------------------- pass B
__global__ void __launch_bounds__(kThreads)
rwkv6_state_scan_kernel(Args a, int64_t n_states) {
  const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n_states) return;
  const int64_t dd = (int64_t)a.Dh * a.Dh;
  const int64_t bh = idx / dd;
  const int de = (int)(idx % dd);
  const int d = de / a.Dh;
  float S = a.s0[idx];
  // Chunk-major scratch: at each step the threads of the grid touch one
  // contiguous [B*H, Dh, Dh] slab.
  float* __restrict__ st = a.states + idx;
  const float* __restrict__ ld = a.log_decay + bh * a.Dh + d;
  const int64_t st_step = n_states, ld_step = (int64_t)a.BH * a.Dh;
  // Loads of kBatch chunks first, then their steps: the loads do not wait
  // on the chain.
  constexpr int kBatch = 8;
  for (int c0 = 0; c0 < a.nc; c0 += kBatch) {
    float ds[kBatch], w[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      ds[j] = 0.f;
      w[j] = 0.f;
      if (c0 + j < a.nc) {
        ds[j] = st[(c0 + j) * st_step];
        w[j] = ld[(c0 + j) * ld_step];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c0 + j < a.nc) {
        st[(c0 + j) * st_step] = S;
        S = fmaf(expf(w[j]), S, ds[j]);
      }
    }
  }
  a.s_out[idx] = S;
}

// ---------------------------------------------------------------- pass C
constexpr size_t kOutSmemFloats =
    5 * kTile + kMaxC * kLdAtt + kMaxSub * kMaxDh * 2 + kMaxSub * kMaxSub * kMaxDh + 2 * kMaxC;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_chunk_out_kernel(Args a) {
  extern __shared__ float smem[];
  float* R = smem;            // r, then rx = r exp(lx)
  float* K = R + kTile;       // k, then kq = k exp(tot[q] - lc)
  float* V = K + kTile;
  float* LX = V + kTile;      // lx; the chunk's state once lx is spent
  float* LC = LX + kTile;     // logw, then lc
  float* S = LX;              // [kMaxDh, kLd]
  float* ATT = LC + kTile;    // [kMaxC, kLdAtt]
  float* TOT = ATT + kMaxC * kLdAtt;
  float* EG = TOT + kMaxSub * kMaxDh;          // exp(sum of the totals before p)
  float* E = EG + kMaxSub * kMaxDh;            // [p, q]: exp(sum strictly between)
  float* BONUS = E + kMaxSub * kMaxSub * kMaxDh;
  float* U = BONUS + kMaxC;

  const int bh = blockIdx.x % a.BH, c = blockIdx.x / a.BH;  // neighbours share c
  const int b = bh / a.H, h = bh % a.H;
  const int64_t base = (int64_t)b * a.sB + (int64_t)h * a.sH;
  const int c0 = c * a.C;
  const int tid = threadIdx.x;
  const int nsub = (a.C + kSub - 1) / kSub;
  // The chunk's starting state into registers now (stored once lx is spent),
  // so its loads overlap the work before.
  constexpr int kStateVecs = kMaxDh * kMaxDh / 4 / kThreads;
  const float* st = a.states + ((int64_t)c * a.BH + bh) * a.Dh * a.Dh;
  float4 s_reg[kStateVecs];
#pragma unroll
  for (int j = 0; j < kStateVecs; ++j) {
    const int idx = tid + j * kThreads, d = idx / (kMaxDh / 4), e = (idx % (kMaxDh / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (d < a.Dh && e < a.Dh) {
      if (a.vec) {
        x = *reinterpret_cast<const float4*>(st + d * a.Dh + e);
      } else {
        x.x = st[d * a.Dh + e];
        if (e + 1 < a.Dh) x.y = st[d * a.Dh + e + 1];
        if (e + 2 < a.Dh) x.z = st[d * a.Dh + e + 2];
        if (e + 3 < a.Dh) x.w = st[d * a.Dh + e + 3];
      }
    }
    s_reg[j] = x;
  }
  const T* rp = static_cast<const T*>(a.r);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
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
  if (tid < kMaxDh) U[tid] = tid < a.Dh ? a.u[(int64_t)b * a.uB + (int64_t)h * a.Dh + tid] : 0.f;
  for (int idx = tid; idx < kMaxC * kLdAtt; idx += kThreads) ATT[idx] = 0.f;
  __syncthreads();
  local_cumsums(LC, LX, TOT);
  __syncthreads();
  {
    const int p = tid / kMaxDh, d = tid % kMaxDh;
    EG[p * kMaxDh + d] = expf(run_sum(TOT, 0, p, d));
    for (int q = 0; q < p; ++q) E[(p * kMaxSub + q) * kMaxDh + d] = expf(run_sum(TOT, q + 1, p, d));
  }
  // Diagonal blocks: the pairs i < t of one sub-chunk, decays pairwise.
  att_diagonal(R, K, LX, LC, ATT, nsub);
  __syncthreads();
  // rx = r exp(lx) over r, kq = k exp(tot[q] - lc) over k, and before
  // that the bonus r . (u * k): four threads a row t, 16 channels each.
  {
    const int t = tid / 4;
    float bonus = 0.f;
#pragma unroll
    for (int n = 0; n < kMaxDh / 16; ++n) {
      const int d = (tid % 4) * 16 + 4 * n, at = t * kLd + d;
      const float4 x = *reinterpret_cast<const float4*>(LX + at);
      const float4 lc = *reinterpret_cast<const float4*>(LC + at);
      const float4 tq = *reinterpret_cast<const float4*>(TOT + (t / kSub) * kMaxDh + d);
      const float4 uu = *reinterpret_cast<const float4*>(U + d);
      float4 r = *reinterpret_cast<const float4*>(R + at);
      float4 k = *reinterpret_cast<const float4*>(K + at);
      bonus = fmaf(r.x * uu.x, k.x, bonus);
      bonus = fmaf(r.y * uu.y, k.y, bonus);
      bonus = fmaf(r.z * uu.z, k.z, bonus);
      bonus = fmaf(r.w * uu.w, k.w, bonus);
      r.x *= __expf(x.x);
      r.y *= __expf(x.y);
      r.z *= __expf(x.z);
      r.w *= __expf(x.w);
      k.x *= __expf(tq.x - lc.x);
      k.y *= __expf(tq.y - lc.y);
      k.z *= __expf(tq.z - lc.z);
      k.w *= __expf(tq.w - lc.w);
      *reinterpret_cast<float4*>(R + at) = r;
      *reinterpret_cast<float4*>(K + at) = k;
    }
    bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
    bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
    if (tid % 4 == 0) BONUS[t] = bonus;
  }
  __syncthreads();
  // The starting state over lx, and the off-diagonal blocks:
  // att[t, i] = sum_d rx[t, d] E[p, q, d] kq[i, d] for q < p, each thread
  // two rows t by four columns i of one 16 x 16 block, 32 threads a block.
#pragma unroll
  for (int j = 0; j < kStateVecs; ++j) {
    const int idx = tid + j * kThreads;
    *reinterpret_cast<float4*>(S + (idx / (kMaxDh / 4)) * kLd + (idx % (kMaxDh / 4)) * 4) = s_reg[j];
  }
  const int n_off = nsub * (nsub - 1) / 2;
  for (int idx = tid; idx < n_off * 32; idx += kThreads) {
    int blk = idx / 32, p = 1;
    while (blk >= p) blk -= p++;
    const int q = blk, w = idx % 32;
    const int t0 = p * kSub + (w / 4) * 2, i0 = q * kSub + (w % 4) * 4;
    const float* ep = E + (p * kMaxSub + q) * kMaxDh;
    float acc[2][4] = {};
    for (int d = 0; d < kMaxDh; d += 4) {
      const float4 e4 = *reinterpret_cast<const float4*>(ep + d);
      float4 rr[2], kk[4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        rr[x] = *reinterpret_cast<const float4*>(R + (t0 + x) * kLd + d);
        rr[x].x *= e4.x;
        rr[x].y *= e4.y;
        rr[x].z *= e4.z;
        rr[x].w *= e4.w;
      }
#pragma unroll
      for (int y = 0; y < 4; ++y) kk[y] = *reinterpret_cast<const float4*>(K + (i0 + y) * kLd + d);
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          float sum = acc[x][y];
          sum = fmaf(rr[x].x, kk[y].x, sum);
          sum = fmaf(rr[x].y, kk[y].y, sum);
          sum = fmaf(rr[x].z, kk[y].z, sum);
          sum = fmaf(rr[x].w, kk[y].w, sum);
          acc[x][y] = sum;
        }
    }
#pragma unroll
    for (int x = 0; x < 2; ++x)
      *reinterpret_cast<float4*>(ATT + (t0 + x) * kLdAtt + i0) =
          make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
  }
  __syncthreads();
  // o[t, e] = sum_d rx[t, d] EG[p, d] S[d, e] + sum_{i < t} att[t, i] v[i, e]
  //         + bonus[t] v[t, e]: rows t = 4 tr .. 4 tr + 3 (one sub-chunk p),
  //         columns e = 4 tc .. 4 tc + 3.
  const int tr = tid / 16, tc = tid % 16;
  const int t0 = 4 * tr, e0 = 4 * tc;
  const float* eg = EG + (t0 / kSub) * kMaxDh;
  float acc[4][4] = {};
  for (int d = 0; d < a.Dh; d += 4) {
    const float4 g4 = *reinterpret_cast<const float4*>(eg + d);
    float4 sv[4];
#pragma unroll
    for (int y = 0; y < 4; ++y) sv[y] = *reinterpret_cast<const float4*>(S + (d + y) * kLd + e0);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float4 ra = *reinterpret_cast<const float4*>(R + (t0 + x) * kLd + d);
      const float rg[4] = {ra.x * g4.x, ra.y * g4.y, ra.z * g4.z, ra.w * g4.w};
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        acc[x][0] = fmaf(rg[y], sv[y].x, acc[x][0]);
        acc[x][1] = fmaf(rg[y], sv[y].y, acc[x][1]);
        acc[x][2] = fmaf(rg[y], sv[y].z, acc[x][2]);
        acc[x][3] = fmaf(rg[y], sv[y].w, acc[x][3]);
      }
    }
  }
  for (int i = 0; i <= t0; i += 4) {  // att[t, i] is 0 for i >= t
    float4 vv[4];
#pragma unroll
    for (int y = 0; y < 4; ++y) vv[y] = *reinterpret_cast<const float4*>(V + (i + y) * kLd + e0);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float4 at4 = *reinterpret_cast<const float4*>(ATT + (t0 + x) * kLdAtt + i);
      const float at[4] = {at4.x, at4.y, at4.z, at4.w};
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        acc[x][0] = fmaf(at[y], vv[y].x, acc[x][0]);
        acc[x][1] = fmaf(at[y], vv[y].y, acc[x][1]);
        acc[x][2] = fmaf(at[y], vv[y].z, acc[x][2]);
        acc[x][3] = fmaf(at[y], vv[y].w, acc[x][3]);
      }
    }
  }
  float* ob = a.o + base;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int t = t0 + x;
    if (t >= a.C || c0 + t >= a.T || e0 >= a.Dh) continue;
    const float4 vt = *reinterpret_cast<const float4*>(V + t * kLd + e0);
    const float bt = BONUS[t];
    const float out[4] = {acc[x][0] + bt * vt.x, acc[x][1] + bt * vt.y, acc[x][2] + bt * vt.z,
                          acc[x][3] + bt * vt.w};
    float* op = ob + (int64_t)(c0 + t) * a.sT + e0;
    if (a.vec) {
      *reinterpret_cast<float4*>(op) = make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e0 + j < a.Dh) op[j] = out[j];
    }
  }
}

constexpr size_t kStateSmem = sizeof(float) * (3 * kTile + 2 * kMaxSub * kMaxDh);
constexpr size_t kOutSmem = sizeof(float) * kOutSmemFloats;

template <typename T>
int launch(const Args& a, cudaStream_t st) {
  const unsigned chunk_blocks = (unsigned)(a.BH * a.nc);
  const size_t smem_a = kStateSmem, smem_c = kOutSmem;
  cudaError_t err = cudaFuncSetAttribute(rwkv6_chunk_state_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rwkv6_chunk_out_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  if (err != cudaSuccess) return (int)err;
  rwkv6_chunk_state_kernel<T><<<chunk_blocks, kThreads, smem_a, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n_states = (int64_t)a.BH * a.Dh * a.Dh;
  rwkv6_state_scan_kernel<<<(unsigned)((n_states + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      a, n_states);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_chunk_out_kernel<T><<<chunk_blocks, kThreads, smem_c, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v (bf16 != 0: bfloat16, else float32) and logw, o (float32): element
// (b, t, h, d) at b * sB + t * sT + h * sH + d. u: float32, element (b, h, d)
// at b * uB + h * Dh + d. s0, s_out: [B * H, Dh, Dh] float32, contiguous.
// states: B * H * ceil(T / C) * Dh * Dh floats and log_decay
// B * H * ceil(T / C) * Dh floats of scratch. 1 <= Dh <= 64, 1 <= C <= 64.
// Three launches on `stream`. Returns cudaGetLastError() after the last
// launch that was made (0 on success), or -1 for an unsupported Dh or C.
int rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* logw,
                      const void* u, const void* s0, void* o, void* s_out, void* states,
                      void* log_decay, int B, int H, int T_len, int Dh, int C, int64_t sB,
                      int64_t sT, int64_t sH, int64_t uB, int bf16, void* stream) {
  if (Dh < 1 || Dh > kMaxDh || C < 1 || C > kMaxC) return -1;
  if (B <= 0 || H <= 0 || T_len <= 0) return (int)cudaGetLastError();
  Args a{r, k, v, static_cast<const float*>(logw), static_cast<const float*>(u),
               static_cast<const float*>(s0), static_cast<float*>(o), static_cast<float*>(s_out),
               static_cast<float*>(states), static_cast<float*>(log_decay), H, T_len, Dh, C,
               (T_len + C - 1) / C, B * H, sB, sT, sH, uB, 0};
  a.vec = Dh % 8 == 0 && sB % 8 == 0 && sT % 8 == 0 && sH % 8 == 0;
  const void* const ptrs[] = {r, k, v, logw, o, states};
  for (const void* ptr : ptrs) a.vec = a.vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
}

// Dynamic shared memory of pass 0 (A), 1 (B) or 2 (C), in bytes.
int rwkv6_scan_smem_bytes(int pass) {
  return pass == 0 ? (int)kStateSmem : pass == 2 ? (int)kOutSmem : 0;
}

}  // extern "C"
