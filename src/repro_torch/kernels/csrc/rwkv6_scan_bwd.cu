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
// Passes: the forward's three launches in reverse, plus a reduction.
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
// In C', per chunk, with the forward's sub-chunk anchors (lc inclusive and
// lx exclusive sums of logw from each sub-chunk's start, tot each
// sub-chunk's total; lx[t] = lc[t - 1] inside a sub-chunk, 0 at its start),
// the factors fx = exp(lx), fc = exp(tot[q] - lc), eg[p] = exp(totals
// before p), ex[q] = exp(totals after q) and E[p, q] = exp(totals strictly
// between q and p), every exponent <= 0 wherever logw <= 0, and
// bm[t, i] = do_t . v_i, bd[t] = bm[t, t]:
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
// on an H100 SXM. The four passes move about 245 MB (A' reads r, do and
// logw and writes dG; B' reads and rewrites it; C' reads every input, S_c,
// Gend and Send and writes the gradients), 0.073 ms. Its products are 4.83
// GFLOP (per chunk 8 C Dh^2 for the four state products and 10 C^2 Dh for
// the intra-chunk ones): 0.072 ms as float32 FMAs at 67 TFLOP/s, and
// 0.029 ms on the tensor cores at 495 TFLOP/s with each product taken three
// times (3xTF32).
//
// What bounds this design, and what it does about each:
// * the products: every matrix product of A' and C' runs on the tensor
//   cores (mma.sync m16n8k8 TF32) in 3xTF32 (tf32_mma.cuh), which holds the
//   float32 contract (within 1e-6 of the largest entry) where one TF32
//   product and a bf16 hi/lo split miss its 5e-6
//   (tests/test_torch_ssm_train.py::test_3xtf32_split_holds_float32_accuracy);
//   a bf16 input (v) is exact in TF32 and takes two products, not three.
//   Each of the 8 warps owns a 16 x 32 tile of every 64 x 64 result: rows
//   one sub-chunk, columns one half. att's six off-diagonal 16 x 16 blocks
//   go one to each of warps 0-5, and the sub-chunk pairs of dr and dk are
//   taken together (three pairs for every warp). The pairwise decays of
//   the diagonal sub-chunk terms are not a product of two matrices and stay
//   on the CUDA cores: one exponential per (t, i, d) for in_r and in_k
//   together, and across the two halves of a sub-chunk the product of two
//   per-token factors, each exponent <= 0;
// * the bytes: the tiles arrive by cp.async, in two groups -- do, v, S_c and
//   Gend, which the first products need, then r, k and logw, which land
//   under those products; C' holds r, k, v in the inputs' type (a bf16
//   tile is half a float32 one), keeps S_c's tile only until its product is
//   taken and then holds bm (lower blocks) and att^T (upper blocks) in it,
//   forms k fc, r fx and their decay factors from lc as each operand is
//   loaded (no factor tiles), and reuses do's and Gend's tiles for dr' and
//   dk'. That is 105 KB of shared memory in bf16 (two blocks, 16 warps an
//   SM, at most 128 registers a thread), 129 KB in float32 (one block);
// * the dependent phases: C' runs about ten of them between
//   __syncthreads(), and a second resident block fills one block's barriers
//   and load waits. At 16 warps an SM its phases stay latency bound
//   (exponentials, shared-memory loads and products in chains), well above
//   the bytes' and the products' times (PERF.md).
// This source is compiled with ptxas -O1 (kernels/build.py, EXTRA_FLAGS):
// ptxas 12.9 at -O2 and -O3 turns C' into code whose outputs are NaN and
// differ from call to call. tools/scan_bwd_ptxas_check.py builds it without
// the flag and runs both builds.
//
// Layout: r/k/v (float32 or bfloat16), logw and do (float32) are read, and
// dr/dk/dv (the inputs' type) and dlogw (float32) written, through the
// forward's (b, t, h) strides. u and du are [H, Dh]. A ragged last chunk is
// padded with r = k = v = do = 0, logw = 0 inside the kernel; the pad
// tokens add 0 to every sum and their gradients are not written. With a.vec
// (Dh and the strides multiples of 8 elements, every tensor 16-byte
// aligned: the model's layout) tiles arrive by 16-byte cp.async copies,
// else one element at a time through registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rwkv6_tiles.cuh"  // constants, to_f32, local_cumsums
#include "tf32_mma.cuh"     // tf32, mma8, cp_async16

namespace {

using namespace rwkv6;
using namespace tf32x3;

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
  int vec;  // 16-byte copies: see Layout above
};

// Row stride of an r/k/v tile in elements: float32 rows 68 floats apart (4
// banks), bf16 rows 72 (144 bytes, 4 banks): the fragment loads below hit
// distinct banks, and every row starts on 16 bytes for cp.async.
template <typename T>
struct TileLd {
  static constexpr int value = kLd;
};
template <>
struct TileLd<__nv_bfloat16> {
  static constexpr int value = kMaxDh + 8;
};

// A TF32 split of x (see tf32_mma.cuh); kSplit false: x is exact in TF32.
template <bool kSplit>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (kSplit) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// acc += A B over k in [k0, k1) (a multiple of 8 apart) for one warp's
// 16 x 32 tile, in 3xTF32: fa(m, k) and fb(k, n) give A's and B's elements
// (m < 16, n < 32 in the tile); n-tile j (columns 8j .. 8j + 7) only where
// use(j). kA / kB false: that operand is exact in TF32 (a bf16 value), so
// its lo product is skipped. acc[j][x] is the element at row g + 8 (x / 2),
// column 8 j + 2 t4 + x % 2 of the tile, g = lane / 4, t4 = lane % 4 (the
// mma's fragment layout).
template <bool kA, bool kB, typename FA, typename FB, typename Use>
__device__ __forceinline__ void warp_mma(float (&acc)[4][4], int k0, int k1, FA fa, FB fb,
                                         Use use) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  for (int k = k0; k < k1; k += 8) {
    uint32_t ah[4], al[4];
    split<kA>(fa(g, k + t4), ah[0], al[0]);
    split<kA>(fa(g + 8, k + t4), ah[1], al[1]);
    split<kA>(fa(g, k + t4 + 4), ah[2], al[2]);
    split<kA>(fa(g + 8, k + t4 + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!use(j)) continue;
      uint32_t bh0, bl0, bh1, bl1;
      split<kB>(fb(k + t4, 8 * j + g), bh0, bl0);
      split<kB>(fb(k + t4 + 4, 8 * j + g), bh1, bl1);
      if (kA) mma8(acc[j], al, bh0, bh1);
      if (kB) mma8(acc[j], ah, bl0, bl1);
      mma8(acc[j], ah, bh0, bh1);
    }
  }
}

struct AllTiles {
  __device__ __forceinline__ bool operator()(int) const { return true; }
};
constexpr AllTiles all_tiles{};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// Four consecutive elements of a tile row as float (16-byte or 8-byte aligned).
__device__ __forceinline__ float4 ld4f(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 ld4f(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&w.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&w.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Elements e0, e0 + 1 of a row of an output with the inputs' strides (e0
// even; with vec, Dh is a multiple of 8 and the pair lies inside it).
template <typename T>
__device__ __forceinline__ void store2(T* dst, float x0, float x1, int e0, int Dh, int vec);

template <>
__device__ __forceinline__ void store2<float>(float* dst, float x0, float x1, int e0, int Dh,
                                             int vec) {
  if (vec) {
    *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
    return;
  }
  if (e0 < Dh) dst[0] = x0;
  if (e0 + 1 < Dh) dst[1] = x1;
}

template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst, float x0, float x1,
                                                      int e0, int Dh, int vec) {
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
    return;
  }
  if (e0 < Dh) dst[0] = __float2bfloat16(x0);
  if (e0 + 1 < Dh) dst[1] = __float2bfloat16(x1);
}

// Rows t < C of chunk c of (b, h) of a (b, t, h, d) tensor into a
// [kMaxC, ld] tile of T, zero where t >= C, d >= Dh or the token lies past
// T: 16-byte cp.async copies with a.vec (in the caller's open group), else
// one element at a time.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, const Args& a,
                                          int64_t base, int c0) {
  if (a.vec) {
    constexpr int kVec = 16 / sizeof(T), kRowVecs = kMaxDh / kVec;
    for (int idx = threadIdx.x; idx < kMaxC * kRowVecs; idx += kThreads) {
      const int t = idx / kRowVecs, d = (idx % kRowVecs) * kVec;
      const bool ok = t < a.C && d < a.Dh && c0 + t < a.T;
      cp_async16(dst + t * ld + d, ok ? src + base + (int64_t)(c0 + t) * a.sT + d : src, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kMaxC * kMaxDh; idx += kThreads) {
    const int t = idx / kMaxDh, d = idx % kMaxDh;
    const bool ok = t < a.C && d < a.Dh && c0 + t < a.T;
    dst[t * ld + d] = ok ? src[base + (int64_t)(c0 + t) * a.sT + d] : from_f32<T>(0.f);
  }
}

// A [Dh, Dh] state (contiguous) into a [kMaxDh, kLd] float tile, zero
// outside Dh x Dh; cp.async with a.vec.
__device__ __forceinline__ void load_state(float* dst, const float* src, const Args& a) {
  if (a.vec) {
    for (int idx = threadIdx.x; idx < kMaxDh * kMaxDh / 4; idx += kThreads) {
      const int d = idx / (kMaxDh / 4), e = (idx % (kMaxDh / 4)) * 4;
      const bool ok = d < a.Dh && e < a.Dh;
      cp_async16(dst + d * kLd + e, ok ? src + d * a.Dh + e : src, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kMaxDh * kMaxDh; idx += kThreads) {
    const int d = idx / kMaxDh, e = idx % kMaxDh;
    dst[d * kLd + e] = (d < a.Dh && e < a.Dh) ? src[d * a.Dh + e] : 0.f;
  }
}

// lx[t, d]: lc of the previous token of t's sub-chunk, 0 at its start (the
// load stays in bounds either way).
__device__ __forceinline__ float lx_at(const float* LC, int t, int d) {
  const bool first = (t & (kSub - 1)) == 0;
  const float prev = LC[(first ? t : t - 1) * kLd + d];
  return first ? 0.f : prev;
}

// RUN[lo][hi][d] = tot[lo] + ... + tot[hi - 1] in that order (0 for
// hi <= lo), lo, hi in 0 .. kMaxSub.
constexpr int kRunN = kMaxSub + 1;
__device__ __forceinline__ void run_sums(const float* TOT, float* RUN) {
  for (int idx = threadIdx.x; idx < kRunN * kMaxDh; idx += kThreads) {
    const int lo = idx / kMaxDh, d = idx % kMaxDh;
    float* out = RUN + lo * kRunN * kMaxDh + d;
    for (int hi = 0; hi <= lo; ++hi) out[hi * kMaxDh] = 0.f;
    float acc = 0.f;
    for (int hi = lo + 1; hi < kRunN; ++hi) {
      acc += TOT[(hi - 1) * kMaxDh + d];
      out[hi * kMaxDh] = acc;
    }
  }
}

// --------------------------------------------------------------- pass A'
template <typename T>
constexpr size_t grad_smem_bytes() {
  return sizeof(T) * kMaxC * TileLd<T>::value +
         sizeof(float) * (2 * kTile + kMaxSub * kMaxDh + kRunN * kRunN * kMaxDh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_bwd_chunk_grad_kernel(Args a) {
  constexpr int ldT = TileLd<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* R = reinterpret_cast<T*>(smem_raw);
  float* DO = reinterpret_cast<float*>(R + kMaxC * ldT);
  float* LC = DO + kTile;    // logw, then lc
  float* TOT = LC + kTile;   // [kMaxSub, kMaxDh]
  float* RUN = TOT + kMaxSub * kMaxDh;

  const int bh = blockIdx.x % a.BH, c = blockIdx.x / a.BH;  // neighbours share c
  const int b = bh / a.H, h = bh % a.H;
  const int64_t base = (int64_t)b * a.sB + (int64_t)h * a.sH;
  const int c0 = c * a.C;
  const int warp = threadIdx.x >> 5, wp = warp >> 1, wc = (warp & 1) * 32;
  load_rows<T>(R, ldT, static_cast<const T*>(a.r), a, base, c0);
  load_rows<float>(DO, kLd, a.dout, a, base, c0);
  load_rows<float>(LC, kLd, a.logw, a, base, c0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  local_cumsums(LC, nullptr, TOT);
  __syncthreads();
  run_sums(TOT, RUN);
  __syncthreads();
  if (threadIdx.x < a.Dh)  // run(0, kMaxSub)
    a.log_decay[((int64_t)c * a.BH + bh) * a.Dh + threadIdx.x] = RUN[kMaxSub * kMaxDh + threadIdx.x];
  // dG[d, e] = sum_t (r exp(lx + totals before t's sub-chunk))[t, d] do[t, e]:
  // the warp's rows d = 16 wp .., columns e = wc ...
  float acc[4][4] = {};
  warp_mma<true, true>(
      acc, 0, kMaxC,
      [&](int m, int t) {
        const int d = 16 * wp + m;
        return to_f32(R[t * ldT + d]) *
               __expf(lx_at(LC, t, d) + RUN[(t / kSub) * kMaxDh + d]);
      },
      [&](int t, int n) { return DO[t * kLd + wc + n]; }, all_tiles);
  float* dg = a.grads + ((int64_t)c * a.BH + bh) * a.Dh * a.Dh;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int d = 16 * wp + g + 8 * hh, e = wc + 8 * j + 2 * t4;
      if (d < a.Dh && e < a.Dh)
        store2<float>(dg + d * a.Dh + e, acc[j][2 * hh], acc[j][2 * hh + 1], e, a.Dh, a.vec);
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
template <typename T>
constexpr size_t out_smem_bytes() {
  return sizeof(T) * 3 * kMaxC * TileLd<T>::value +
         sizeof(float) * (4 * kTile + kRunN * kRunN * kMaxDh + 3 * kMaxSub * kMaxDh +
                          3 * kMaxDh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_bwd_chunk_out_kernel(Args a) {
  constexpr int ldT = TileLd<T>::value;
  constexpr bool kSplitT = sizeof(T) == 4;  // a bf16 input is exact in TF32
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* R = reinterpret_cast<T*>(smem_raw);
  T* K = R + kMaxC * ldT;
  T* V = K + kMaxC * ldT;
  float* DO = reinterpret_cast<float*>(V + kMaxC * ldT);  // do, then dr' less in_r
  float* LC = DO + kTile;                                 // logw, then lc
  float* BMT = LC + kTile;  // S_c, then bm[t][i] (i <= t blocks) and att[t][i] at [i][t] (t > i)
  float* GE = BMT + kTile;  // Gend, then dk' less in_k
  float* RUN = GE + kTile;  // [lo][hi][d]: see run_sums
  float* TOT = RUN + kRunN * kRunN * kMaxDh;
  float* SUF = TOT + kMaxSub * kMaxDh;  // [q, d]: a sub-chunk's dlogw terms summed
  float* DUQ = SUF + kMaxSub * kMaxDh;  // [q, d]: a sub-chunk's du terms summed
  float* U = DUQ + kMaxSub * kMaxDh;
  float* KC = U + kMaxDh;     // sum_j Send Gend, per row
  float* BONUS = KC + kMaxDh; // r . (u k), per token
  float* DR = DO;
  float* DK = GE;

  const int bh = blockIdx.x % a.BH, c = blockIdx.x / a.BH;  // neighbours share c
  const int b = bh / a.H, h = bh % a.H;
  const int64_t base = (int64_t)b * a.sB + (int64_t)h * a.sH;
  const int c0 = c * a.C;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  // The warp's 16 x 32 tile of every [64, 64] result: rows of sub-chunk wp,
  // columns wc .. wc + 31.
  const int warp = tid >> 5, wp = warp >> 1, wc = (warp & 1) * 32;
  const int64_t dd = (int64_t)a.Dh * a.Dh;
  const int64_t st_off = ((int64_t)c * a.BH + bh) * dd;
  const T* rp = static_cast<const T*>(a.r);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  auto run = [&](int lo, int hi, int d) { return RUN[(lo * kRunN + hi) * kMaxDh + d]; };
  // k fc (times exp(x)) and r fx (times exp(x)), formed as they are loaded.
  auto kq = [&](int i, int d, float x) {
    return to_f32(K[i * ldT + d]) * __expf(TOT[(i / kSub) * kMaxDh + d] - LC[i * kLd + d] + x);
  };
  auto rx = [&](int t, int d, float x) {
    return to_f32(R[t * ldT + d]) * __expf(lx_at(LC, t, d) + x);
  };

  // Send (the state at the chunk's end) for KC: rows d = warp + 8 x, columns
  // lane and lane + 32, into registers ahead of everything else.
  float send[kMaxDh / 8][2];
  {
    const float* sp = c + 1 < a.nc ? a.states + st_off + (int64_t)a.BH * dd
                                   : a.s_final + (int64_t)bh * dd;
#pragma unroll
    for (int x = 0; x < kMaxDh / 8; ++x)
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        const int d = warp + 8 * x, e = lane + 32 * y;
        send[x][y] = d < a.Dh && e < a.Dh ? sp[d * a.Dh + e] : 0.f;
      }
  }
  // Loads: do, v, S_c and Gend first (the first products need them), then
  // r, k and logw, which land under those products.
  load_rows<float>(DO, kLd, a.dout, a, base, c0);
  load_rows<T>(V, ldT, vp, a, base, c0);
  load_state(BMT, a.states + st_off, a);
  load_state(GE, a.grads + st_off, a);
  cp_async_commit();
  load_rows<T>(R, ldT, rp, a, base, c0);
  load_rows<T>(K, ldT, kp, a, base, c0);
  load_rows<float>(LC, kLd, a.logw, a, base, c0);
  cp_async_commit();
  if (tid < kMaxDh) U[tid] = tid < a.Dh ? a.u[(int64_t)h * a.Dh + tid] : 0.f;
  cp_async_wait<1>();
  __syncthreads();
  // KC[d] = sum_j Send[d, j] Gend[d, j]: one warp a row, summed across lanes.
#pragma unroll
  for (int x = 0; x < kMaxDh / 8; ++x) {
    const int d = warp + 8 * x;
    float s = fmaf(send[x][1], GE[d * kLd + lane + 32], send[x][0] * GE[d * kLd + lane]);
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) KC[d] = s;
  }
  // S_c do (dr's state term) and bm = do v^T, then bm over S_c's tile (its
  // blocks above the diagonal are overwritten by att below).
  float acc_r[4][4] = {};
  warp_mma<true, true>(
      acc_r, 0, kMaxDh, [&](int m, int e) { return DO[(16 * wp + m) * kLd + e]; },
      [&](int e, int n) { return BMT[(wc + n) * kLd + e]; }, all_tiles);
  {
    float acc[4][4] = {};
    warp_mma<true, kSplitT>(
        acc, 0, kMaxDh, [&](int m, int e) { return DO[(16 * wp + m) * kLd + e]; },
        [&](int e, int n) { return to_f32(V[(wc + n) * ldT + e]); }, all_tiles);
    __syncthreads();  // every read of S_c is done
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(BMT + (16 * wp + g + 8 * hh) * kLd + wc + 8 * j + 2 * t4) =
            make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  local_cumsums(LC, nullptr, TOT);
  // bonus[t] = r_t . (u k_t): four threads a row t, 16 channels each.
  {
    const int t = tid / 4;
    float s = 0.f;
#pragma unroll
    for (int n = 0; n < kMaxDh / 4; n += 4) {
      const int d = (tid % 4) * 16 + n;
      const float4 r4 = ld4f(R + t * ldT + d), k4 = ld4f(K + t * ldT + d), u4 = ld4(U + d);
      s = fmaf(r4.x * u4.x, k4.x, s);
      s = fmaf(r4.y * u4.y, k4.y, s);
      s = fmaf(r4.z * u4.z, k4.z, s);
      s = fmaf(r4.w * u4.w, k4.w, s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (tid % 4 == 0) BONUS[t] = s;
  }
  __syncthreads();
  run_sums(TOT, RUN);
  __syncthreads();
  // The off-diagonal blocks of att, one 16 x 16 block (t in sub-chunk p,
  // i in an earlier q) to each of warps 0-5:
  // att[t, i] = sum_d (r fx E[p, q])[t, d] (k fc)[i, d], written at [i][t].
  if (warp < kMaxSub * (kMaxSub - 1) / 2) {
    const int p = warp == 0 ? 1 : warp < 3 ? 2 : 3, q = warp - p * (p - 1) / 2;
    float acc[4][4] = {};
    warp_mma<true, true>(
        acc, 0, kMaxDh, [&](int m, int d) { return rx(16 * p + m, d, run(q + 1, p, d)); },
        [&](int d, int n) { return kq(16 * q + n, d, 0.f); }, [](int j) { return j < 2; });
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        BMT[(16 * q + 8 * j + 2 * t4 + (x & 1)) * kLd + 16 * p + g + 8 * (x >> 1)] = acc[j][x];
  }
  // The diagonal blocks of att, pairwise decays, one thread a pair (t > i),
  // written at [i][t] over bm's unused upper half of the block.
  {
    constexpr int kPairs = kSub * (kSub - 1) / 2;
    for (int idx = tid; idx < kMaxSub * kPairs; idx += kThreads) {
      const int q = idx / kPairs;
      int pr = idx % kPairs, tl = 1;
      while (pr >= tl) pr -= tl++;
      const int t = q * kSub + tl, i = q * kSub + pr;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);  // four chains, summed at the end
#pragma unroll 4
      for (int d = 0; d < kMaxDh; d += 4) {
        const float4 rt = ld4f(R + t * ldT + d), ki = ld4f(K + i * ldT + d);
        const float4 xt = ld4(LC + (t - 1) * kLd + d), ci = ld4(LC + i * kLd + d);
        acc.x = fmaf(rt.x * ki.x, __expf(xt.x - ci.x), acc.x);
        acc.y = fmaf(rt.y * ki.y, __expf(xt.y - ci.y), acc.y);
        acc.z = fmaf(rt.z * ki.z, __expf(xt.z - ci.z), acc.z);
        acc.w = fmaf(rt.w * ki.w, __expf(xt.w - ci.w), acc.w);
      }
      BMT[i * kLd + t] = (acc.x + acc.y) + (acc.z + acc.w);
    }
  }
  // dr's state term times eg, plus sum_{q<p} E[p, q] bm (k fc); and dk's
  // sum_{p>q} E[p, q] bm^T (r fx) (rows i of sub-chunk wp): three sub-chunk
  // pairs for every warp.
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc_r[j][x] *= expf(run(0, wp, wc + 8 * j + 2 * t4 + (x & 1)));
  for (int q = 0; q < wp; ++q)
    warp_mma<true, true>(
        acc_r, 0, kSub, [&](int m, int i) { return BMT[(16 * wp + m) * kLd + 16 * q + i]; },
        [&](int i, int n) { return kq(16 * q + i, wc + n, run(q + 1, wp, wc + n)); }, all_tiles);
  float acc_k[4][4] = {};
  for (int s = wp + 1; s < kMaxSub; ++s)
    warp_mma<true, true>(
        acc_k, 0, kSub, [&](int m, int t) { return BMT[(16 * s + t) * kLd + 16 * wp + m]; },
        [&](int t, int n) { return rx(16 * s + t, wc + n, run(wp + 1, s, wc + n)); }, all_tiles);
  __syncthreads();  // att is complete
  // dv = att^T do + (k fc ex) Gend + bonus do (rows i of sub-chunk wp).
  {
    float acc[4][4] = {};
    warp_mma<true, true>(
        acc, 16 * wp, kMaxC,
        [&](int m, int t) {
          const int i = 16 * wp + m;
          const float x = BMT[i * kLd + t];
          return t > i ? x : 0.f;
        },
        [&](int t, int n) { return DO[t * kLd + wc + n]; }, all_tiles);
    warp_mma<true, true>(
        acc, 0, kMaxDh, [&](int m, int d) { return kq(16 * wp + m, d, run(wp + 1, kMaxSub, d)); },
        [&](int d, int n) { return GE[d * kLd + wc + n]; }, all_tiles);
    T* dvp = static_cast<T*>(a.dv) + base + (int64_t)c0 * a.sT;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 16 * wp + g + 8 * hh, e = wc + 8 * j + 2 * t4;
        const float bt = BONUS[i];
        const float x0 = fmaf(bt, DO[i * kLd + e], acc[j][2 * hh]);
        const float x1 = fmaf(bt, DO[i * kLd + e + 1], acc[j][2 * hh + 1]);
        if (i < a.C && c0 + i < a.T && e < a.Dh)
          store2<T>(dvp + (int64_t)i * a.sT + e, x0, x1, e, a.Dh, a.vec);
      }
  }
  __syncthreads();  // every read of do is done
  // dr' less in_r = fx (...), over do's tile.
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int t = 16 * wp + g + 8 * (x >> 1), d = wc + 8 * j + 2 * t4 + (x & 1);
      DR[t * kLd + d] = acc_r[j][x] * __expf(lx_at(LC, t, d));
    }
  // dk' less in_k = fc (ex Gend v + the pairs above), over Gend's tile once
  // every read of it is done.
  {
    float acc[4][4] = {};
    warp_mma<kSplitT, true>(
        acc, 0, kMaxDh, [&](int m, int e) { return to_f32(V[(16 * wp + m) * ldT + e]); },
        [&](int e, int n) { return GE[(wc + n) * kLd + e]; }, all_tiles);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        acc_k[j][x] = fmaf(expf(run(wp + 1, kMaxSub, wc + 8 * j + 2 * t4 + (x & 1))), acc[j][x],
                           acc_k[j][x]);
    __syncthreads();  // every read of Gend is done
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = 16 * wp + g + 8 * (x >> 1), d = wc + 8 * j + 2 * t4 + (x & 1);
        DK[i * kLd + d] = acc_k[j][x] * __expf(TOT[wp * kMaxDh + d] - LC[i * kLd + d]);
      }
  }
  __syncthreads();
  // One thread a (sub-chunk q, channel d), inside its warp's tile: the pairs
  // of the sub-chunk, one decay each for both
  //   in_r[t, d] = sum_{i < t} bm[t, i] k[i, d] exp(lx[t, d] - lc[i, d])
  //   in_k[i, d] = sum_{t > i} bm[t, i] r[t, d] exp(lx[t, d] - lc[i, d]);
  // a pair inside one half of the sub-chunk takes its own exponential, a
  // pair across the halves (i < 8 <= t) the product of
  // a[t] = exp(lx[t] - lc[7]) and b[i] = exp(lc[7] - lc[i]), both exponents
  // <= 0 (72 exponentials a thread instead of 120). Then dr = dr' + u k bd
  // and dk = dk' + u r bd written out, r dr' and k dk' left in the tiles for
  // dlogw, and du's terms r k bd summed.
  const int q = tid / kMaxDh, d = tid % kMaxDh, s0 = q * kSub;
  const int64_t grad_base = base + (int64_t)c0 * a.sT;
  {
    T* drp = static_cast<T*>(a.dr) + grad_base + d;
    T* dkp = static_cast<T*>(a.dk) + grad_base + d;
    const float ud = U[d];
    float kk[kSub], lc[kSub], ink[kSub];
#pragma unroll
    for (int x = 0; x < kSub; ++x) {
      kk[x] = to_f32(K[(s0 + x) * ldT + d]);
      lc[x] = LC[(s0 + x) * kLd + d];
      ink[x] = 0.f;
    }
    constexpr int kHalf = kSub / 2;
    float kb[kHalf], bh[kHalf], inkc[kHalf];
#pragma unroll
    for (int x = 0; x < kHalf; ++x) {
      bh[x] = __expf(lc[kHalf - 1] - lc[x]);
      kb[x] = kk[x] * bh[x];
      inkc[x] = 0.f;
    }
    float du = 0.f;
#pragma unroll
    for (int tl = 0; tl < kSub; ++tl) {
      const int t = s0 + tl;
      const float rt = to_f32(R[t * ldT + d]);
      const float lxt = tl ? lc[tl - 1] : 0.f;
      float inr = 0.f;
      if (tl >= kHalf) {
        const float at = __expf(lxt - lc[kHalf - 1]), rat = rt * at;
        float cr = 0.f;
#pragma unroll
        for (int il = 0; il < kHalf; ++il) {
          const float bti = BMT[t * kLd + s0 + il];
          cr = fmaf(bti, kb[il], cr);
          inkc[il] = fmaf(bti, rat, inkc[il]);
        }
        inr = at * cr;
      }
#pragma unroll
      for (int il = tl >= kHalf ? kHalf : 0; il < tl; ++il) {
        const float bti = BMT[t * kLd + s0 + il];
        const float w = __expf(lxt - lc[il]);
        inr = fmaf(bti * kk[il], w, inr);
        ink[il] = fmaf(bti * rt, w, ink[il]);
      }
      const float bd = BMT[t * kLd + t];
      const float drn = DR[t * kLd + d] + inr;
      if (t < a.C && c0 + t < a.T && d < a.Dh)
        drp[(int64_t)t * a.sT] = from_f32<T>(fmaf(ud * kk[tl], bd, drn));
      DR[t * kLd + d] = rt * drn;
      du = fmaf(rt * kk[tl], bd, du);
    }
#pragma unroll
    for (int il = 0; il < kHalf; ++il) ink[il] = fmaf(bh[il], inkc[il], ink[il]);
#pragma unroll
    for (int il = 0; il < kSub; ++il) {
      const int i = s0 + il;
      const float bd = BMT[i * kLd + i];
      const float dkn = DK[i * kLd + d] + ink[il];
      const float x = fmaf(ud * to_f32(R[i * ldT + d]), bd, dkn);
      if (i < a.C && c0 + i < a.T && d < a.Dh) dkp[(int64_t)i * a.sT] = from_f32<T>(x);
      DK[i * kLd + d] = kk[il] * dkn;
    }
    DUQ[tid] = du;
  }
  __syncthreads();
  // dlogw: z[t] = (r dr')[t + 1] - (k dk')[t] summed from the sub-chunk's
  // end, then the later sub-chunks' totals and KC. (r dr')[t + 1] is
  // carried from one step to the next: a guarded load of row t + 1 inside
  // this loop was compiled (nvcc 12.9, sm_90a) with wrong shared-memory
  // offsets in its unrolled copies.
  {
    float acc = 0.f;
    float rn = DR[(q + 1 < kMaxSub ? (q + 1) * kSub : 0) * kLd + d] * (q + 1 < kMaxSub ? 1.f : 0.f);
    for (int t = (q + 1) * kSub - 1; t >= s0; --t) {
      acc += rn - DK[t * kLd + d];
      DK[t * kLd + d] = acc;
      rn = DR[t * kLd + d];
    }
    SUF[tid] = acc;
  }
  __syncthreads();
  {
    float later = KC[d];
    for (int j = kMaxSub - 1; j > q; --j) later += SUF[j * kMaxDh + d];
    float* dl = a.dlogw + grad_base + d;
#pragma unroll
    for (int t = s0; t < s0 + kSub; ++t) {
      const float x = DK[t * kLd + d] + later;
      if (t < a.C && c0 + t < a.T && d < a.Dh) dl[(int64_t)t * a.sT] = x;
    }
    float du = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSub; ++j) du += DUQ[j * kMaxDh + d];
    if (q == 0 && d < a.Dh) a.du_part[((int64_t)c * a.BH + bh) * a.Dh + d] = du;
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

template <typename T>
cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(rwkv6_bwd_chunk_grad_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)grad_smem_bytes<T>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(rwkv6_bwd_chunk_out_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)out_smem_bytes<T>());
  if (err != cudaSuccess) return err;
  // All of the SM's unified L1 as shared memory, so two C' blocks fit.
  err = cudaFuncSetAttribute(rwkv6_bwd_chunk_out_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(rwkv6_bwd_chunk_grad_kernel<T>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int launch(const Args& a, cudaStream_t st) {
  const unsigned chunk_blocks = (unsigned)(a.BH * a.nc);
  cudaError_t err = set_smem<T>();
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_chunk_grad_kernel<T><<<chunk_blocks, kThreads, grad_smem_bytes<T>(), st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n_states = (int64_t)a.BH * a.Dh * a.Dh;
  rwkv6_bwd_state_scan_kernel<<<(unsigned)((n_states + kThreads - 1) / kThreads), kThreads, 0,
                                st>>>(a, n_states);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_chunk_out_kernel<T><<<chunk_blocks, kThreads, out_smem_bytes<T>(), st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_du_kernel<<<(unsigned)((a.H * a.Dh + kThreads - 1) / kThreads), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm(int pass) {
  if (set_smem<T>() != cudaSuccess) return -1;
  int n = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (pass == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rwkv6_bwd_chunk_grad_kernel<T>,
                                                        kThreads, grad_smem_bytes<T>());
  else if (pass == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rwkv6_bwd_state_scan_kernel,
                                                        kThreads, 0);
  else if (pass == 2)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rwkv6_bwd_chunk_out_kernel<T>,
                                                        kThreads, out_smem_bytes<T>());
  else if (pass == 3)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rwkv6_bwd_du_kernel, kThreads, 0);
  return err == cudaSuccess ? n : -1;
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
  const void* const ptrs[] = {r, k, v, logw, dout, dr, dk, dv, dlogw, grads, states};
  for (const void* ptr : ptrs) a.vec = a.vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
}

// Dynamic shared memory of pass 0 (A'), 1 (B'), 2 (C') or 3 (D') for
// bfloat16 (bf16 != 0) or float32 r/k/v, in bytes.
int rwkv6_scan_bwd_smem_bytes(int pass, int bf16) {
  if (pass == 0) return (int)(bf16 ? grad_smem_bytes<__nv_bfloat16>() : grad_smem_bytes<float>());
  if (pass == 2) return (int)(bf16 ? out_smem_bytes<__nv_bfloat16>() : out_smem_bytes<float>());
  return 0;
}

// Blocks of pass 0-3 resident on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// at the launch's shared memory), or -1 on an error.
int rwkv6_scan_bwd_blocks_per_sm(int pass, int bf16) {
  return bf16 ? blocks_per_sm<__nv_bfloat16>(pass) : blocks_per_sm<float>(pass);
}

}  // extern "C"
