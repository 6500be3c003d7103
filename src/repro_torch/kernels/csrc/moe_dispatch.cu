// Top-k token dispatch and combine of the moe family (granite-moe), for Hopper.
//
// Replaces no Pallas kernel. The reference dispatches with dense one-hot
// einsums (src/repro/models/moe.py:86-99): it builds disp [S, k, E, C], the
// product of a token's expert one-hot and its capacity-position one-hot, and
// contracts it with the tokens (sec,sd->ecd) and with the experts' outputs
// (sec,ecd->sd). That is quadratic in the tokens: at granite's prefill (8192
// tokens, k 8, E 32, C 2560) disp is 10.7 GB a layer in bf16 and each
// contraction 1.37 TFLOP. The function itself is a permutation: a token's k
// experts are distinct, so each (expert, slot) holds at most one (token,
// choice). Three kernels compute it directly:
//
//   moe_gather:    out[e, c, :] = scale[v] * src[v / k, :] for the choice
//                  v = s * k + j that holds slot (e, c) (slot[e * C + c] = v),
//                  0 for an empty slot (slot -1). No scale is 1: the dispatch,
//                  a copy of the token's row, bit for bit. With the gates as
//                  the scale it is the combine's backward for the experts'
//                  outputs, each product rounded once. Each output row has
//                  exactly one writer.
//   moe_combine:   out[s, :] = sum_{j < k, row[s, j] >= 0} w[s, j] *
//                  y[row[s, j], :], with row = e * C + pos of a kept choice,
//                  -1 for a dropped one. The sum runs in float32 in the order
//                  j = 0 .. k - 1 (fmaf(w_j, y_j, acc) from acc = 0) and is
//                  rounded once to the output's type. No w is 1: the
//                  dispatch's backward for the tokens.
//   moe_gate_grad: dg[s, j] = <dout[s, :], y[row[s, j], :]> for a kept
//                  choice, 0 for a dropped one: the combine's backward for its
//                  weights, reduced over D in float32 in a fixed order (each
//                  lane's elements in turn, then an xor butterfly), rounded
//                  once.
//
// Bound: HBM bytes. The work is a copy (gather) or a k-term weighted sum
// (combine) of rows, one multiply-add an element at most: at granite's
// training shape (S 2048, k 8, E 32, C 640, D 1024, bf16) the dispatch moves
// 46.2 MB (0.0138 ms at 3.35 TB/s) and the combine 37.8 MB (0.0113 ms); at
// its prefill (S 8192, C 2560) 184.9 and 151.4 MB. So short a kernel is
// held back by how many bytes each SM has in flight, by the last wave of
// blocks and by block turnover, not by its arithmetic.
//
// The first design gave one warp to each row (a slot row of the gather, a
// token of the combine) in blocks of 8 warps. At S 2048 the combine's 256
// blocks left about 15.5 warps on each of the 132 SMs, and each lane walked
// a token's k rows in a loop bounded at run time, one 16-byte load in flight
// at a time: about 8 KB in flight an SM, where Little's law at 3.35 TB/s and
// a DRAM latency near 0.7 us wants 15-20 KB. The gather's 2560 blocks of
// 2 KB-a-warp rows ran in 2.4 waves, the last 40% full. Both sat at 0.26-0.55
// of their bounds at S 2048 and 0.66-0.81 at S 8192.
//
// This design (variants timed by tools/moe_variants.py with every operand
// read from HBM; PERF.md):
//   * The gather keeps one warp a slot row in blocks of 8 warps, but a lane
//     issues all its loads of the row (4 16-byte vectors at D 1024 in bf16)
//     before its first store, and stores with the streaming policy
//     (st.global.cs, evict-first). The gather writes about 10 bytes for
//     each byte it reads (a token's row goes to k slots, and empty slots
//     are written as zeros); with plain stores it ran 9% slower, and with
//     the expert products that read its output next 1% slower: they gain
//     nothing from finding that output in L2. A persistent grid of several
//     rows a warp task ran 5% slower: the writes, not a tail wave, hold the
//     gather.
//   * The combine gives each warp one token's share of its columns: a
//     token's D is split over `parts` warps (1, 2, 4, ...) until the tasks
//     cover every warp that fits on the card (SM count and occupancy asked
//     of the runtime once a device): 4 at S 2048 (64 warps an SM of work
//     where one warp a token gave 15.5), 1 at S 8192. For each 32-lane
//     column chunk a lane issues its rows' loads kGroup (4) at a time
//     before their FMAs: k = 8 (granite) as a template case, any other k in
//     predicated groups of 4. Groups of 8 need about 70 registers and ran
//     slower; a persistent grid that walked the tasks ran no faster.
//   * __launch_bounds__(256, 1): under a bare (256) ptxas gave the combine
//     register targets of 32-64 and spilled.
// Each lane moves 16-byte vectors (8 bf16 or 4 float) of neighbouring
// columns, so a warp's loads and stores are coalesced 512-byte segments. A
// scalar path takes rows whose width or base address does not allow 16-byte
// vectors. The gate gradient keeps the first design: one warp a token.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;              // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 32;              // choices a token (one lane each)
constexpr int kInFlight = 4;           // the gather's loads a lane issues before its stores
constexpr int kGroup = 4;              // the combine's rows a load group
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

template <typename T>
__host__ __device__ constexpr T imin(T a, T b) { return a < b ? a : b; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Elements of T in one 16-byte vector.
template <typename T>
__host__ __device__ constexpr int vec_n() { return 16 / static_cast<int>(sizeof(T)); }

// What a lane moves at a time: a 16-byte vector of neighbouring columns
// (kVec), else one element; its bits as float32, and float32 values rounded
// back into one. store_cs stores with the streaming (evict-first) policy.
template <typename T, bool kVec>
struct Unit {
  using type = T;
  static constexpr int n = 1;
  __device__ static type load(const T* p) { return *p; }
  __device__ static void store_cs(type* p, const type& v) { __stcs(p, v); }
  __device__ static type zero() { return from_f32<T>(0.f); }
  __device__ static void unpack(const type& v, float* f) { f[0] = to_f32(v); }
  __device__ static type pack(const float* f) { return from_f32<T>(f[0]); }
};
template <typename T>
struct Unit<T, true> {
  using type = uint4;
  static constexpr int n = vec_n<T>();
  __device__ static type load(const T* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ static void store_cs(type* p, const type& v) { __stcs(p, v); }
  __device__ static type zero() { return make_uint4(0, 0, 0, 0); }
  __device__ static void unpack(const type& v, float* f) {
    if constexpr (sizeof(T) == 4) {
      f[0] = __uint_as_float(v.x);
      f[1] = __uint_as_float(v.y);
      f[2] = __uint_as_float(v.z);
      f[3] = __uint_as_float(v.w);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(h[i]);
        f[2 * i] = t.x;
        f[2 * i + 1] = t.y;
      }
    }
  }
  __device__ static type pack(const float* f) {
    if constexpr (sizeof(T) == 4) {
      return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                        __float_as_uint(f[3]));
    } else {
      uint4 v;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      return v;
    }
  }
};

// One warp a slot row (E * C rows of width D), in blocks of kWarps: a lane
// loads its kInFlight units of the row before it stores any of them.
template <typename T, bool kVec, bool kScaled>
__global__ void __launch_bounds__(kThreads, 1)
moe_gather_kernel(const T* __restrict__ src, const int* __restrict__ slot,
                  const T* __restrict__ scale, T* __restrict__ out, int64_t rows, int D, int k) {
  using V = Unit<T, kVec>;
  constexpr int N = V::n;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const int nv = D / N;                  // units a row
  const int v = __ldg(slot + r);         // the same for the whole warp
  const T* s = src + static_cast<int64_t>(v < 0 ? 0 : v / k) * D;
  const float sc = kScaled && v >= 0 ? to_f32(scale[v]) : 1.f;
  typename V::type* o = reinterpret_cast<typename V::type*>(out + r * D);
  for (int i0 = lane; i0 < nv; i0 += 32 * kInFlight) {
    typename V::type buf[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * 32;
      buf[u] = v >= 0 && i < nv ? V::load(s + i * N) : V::zero();
    }
    // The output is written once and read by the next kernel: streaming
    // stores keep it from evicting the tokens' rows, read k times, from L2.
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * 32;
      if (i >= nv) break;
      if (kScaled) {
        float x[N];
        V::unpack(buf[u], x);
#pragma unroll
        for (int n = 0; n < N; ++n) x[n] = sc * x[n];
        V::store_cs(o + i, V::pack(x));
      } else {
        V::store_cs(o + i, buf[u]);  // the dispatch: the row's bits
      }
    }
  }
}

// A warp a task: one token's share of its columns, the token's 32-lane
// column chunks p, p + parts, ... (S * parts tasks). K is k when it is 8,
// else 0: any k up to kMaxK in predicated groups of kGroup rows.
template <typename T, bool kVec, int K>
__global__ void __launch_bounds__(kThreads, 1)
moe_combine_kernel(const T* __restrict__ y, const int* __restrict__ row,
                   const T* __restrict__ w, T* __restrict__ out, int64_t S, int D, int k,
                   int parts) {
  using V = Unit<T, kVec>;
  constexpr int N = V::n;
  const int kk = K > 0 ? K : k;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (t >= S * parts) return;
  const int lane = threadIdx.x % 32;
  const int nv = D / N, chunks = (nv + 31) / 32;
  const int64_t s = t / parts;
  // Lane j < k: choice j's slot row (-1 dropped) and its weight (1 without
  // weights); lanes past k hold -1.
  int r = -1;
  float wt = 1.f;
  if (lane < kk) {
    r = __ldg(row + s * kk + lane);
    if (w != nullptr) wt = to_f32(w[s * kk + lane]);
  }
  for (int c = static_cast<int>(t - s * parts); c < chunks; c += parts) {
    const int i = c * 32 + lane;
    float acc[N];
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] = 0.f;
    for (int j0 = 0; j0 < kk; j0 += kGroup) {
      typename V::type buf[kGroup];
      int rj[kGroup];
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        rj[jj] = __shfl_sync(kFull, r, j0 + jj);  // -1 past k
        buf[jj] = rj[jj] >= 0 && i < nv ? V::load(y + static_cast<int64_t>(rj[jj]) * D + i * N)
                                        : V::zero();
      }
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const float wj = __shfl_sync(kFull, wt, j0 + jj);
        if (rj[jj] < 0) continue;
        float f[N];
        V::unpack(buf[jj], f);
#pragma unroll
        for (int n = 0; n < N; ++n) acc[n] = fmaf(wj, f[n], acc[n]);
      }
    }
    if (i < nv) reinterpret_cast<typename V::type*>(out + s * D)[i] = V::pack(acc);
  }
}

// A token's k routing entries, one lane each, staged in the warp's shared
// memory: the slot row of each choice.
__device__ __forceinline__ void stage_choices(const int* __restrict__ row, int64_t s, int k,
                                              int lane, int* rs) {
  if (lane < k) rs[lane] = __ldg(row + s * k + lane);
  __syncwarp();
}

// One warp a token: its k dot products in turn.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
moe_gate_grad_kernel(const T* __restrict__ dout, const T* __restrict__ y,
                     const int* __restrict__ row, T* __restrict__ dg, int64_t S, int D, int k) {
  __shared__ int rs_all[kWarps][kMaxK];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (s >= S) return;
  int* rs = rs_all[warp];
  stage_choices(row, s, k, lane, rs);
  const T* a = dout + s * D;
  using V = Unit<T, true>;
  constexpr int N = V::n;
  for (int j = 0; j < k; ++j) {
    const int r = rs[j];  // the same for the whole warp
    float part = 0.f;
    if (r >= 0) {
      const T* b = y + static_cast<int64_t>(r) * D;
      if (kVec) {
        for (int i = lane; i < D / N; i += 32) {
          float fa[N], fb[N];
          V::unpack(V::load(a + i * N), fa);
          V::unpack(V::load(b + i * N), fb);
#pragma unroll
          for (int n = 0; n < N; ++n) part = fmaf(fa[n], fb[n], part);
        }
      } else {
        for (int d = lane; d < D; d += 32) part = fmaf(to_f32(a[d]), to_f32(b[d]), part);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) part += __shfl_xor_sync(kFull, part, off);
    if (lane == 0) dg[s * k + j] = from_f32<T>(part);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

unsigned grid_for(int64_t rows) { return static_cast<unsigned>((rows + kWarps - 1) / kWarps); }

// The card's SM count and the blocks of `kKernel` that fit on one of its
// SMs, asked of the runtime once a device (a failed query leaves its error
// for the launch's cudaGetLastError).
struct Fit {
  int sms, blocks;
};
template <auto kKernel>
Fit fit() {
  static int sms[kMaxDevices], blocks[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) dev = 0;
  if (blocks[dev] == 0) {
    int n = 0, b = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kKernel, kThreads, 0);
    sms[dev] = n > 0 ? n : 1;
    blocks[dev] = b > 0 ? b : 1;
  }
  return {sms[dev], blocks[dev]};
}

// One launch: its blocks, the blocks that fit on an SM, the SM count, and
// the warps a row (1 for the gather, the combine's `parts`).
struct Plan {
  unsigned grid;
  int blocks_per_sm, sms, per;
};

template <typename T, bool kVec, bool kScaled>
Plan gather_plan(int64_t rows) {
  const Fit f = fit<&moe_gather_kernel<T, kVec, kScaled>>();
  return {grid_for(rows), f.blocks, f.sms, 1};
}

// The combine splits a token's D over `parts` warps (1, 2, 4, ...) until
// its tasks cover every warp that fits on the card.
template <typename T, bool kVec, int K>
Plan combine_plan(int64_t S, int D) {
  const int nv = kVec ? D / vec_n<T>() : D;
  const int chunks = (nv + 31) / 32;
  const Fit f = fit<&moe_combine_kernel<T, kVec, K>>();
  const int64_t resident = static_cast<int64_t>(f.sms) * f.blocks * kWarps;
  int parts = 1;
  while (parts * 2 <= chunks && S * parts < resident) parts *= 2;
  return {grid_for(S * parts), f.blocks, f.sms, parts};
}

template <typename T, bool kVec, bool kScaled>
int gather_as(const void* src, const int* slot, const void* scale, void* out, int64_t rows,
              int D, int k, cudaStream_t st) {
  moe_gather_kernel<T, kVec, kScaled><<<grid_for(rows), kThreads, 0, st>>>(
      static_cast<const T*>(src), slot, static_cast<const T*>(scale), static_cast<T*>(out), rows,
      D, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
bool gather_vec(const void* src, const void* out, int D) {
  return D % vec_n<T>() == 0 && aligned16(src) && aligned16(out);
}

template <typename T>
int gather(const void* src, const int* slot, const void* scale, void* out, int64_t rows, int D,
           int k, cudaStream_t st) {
  const bool vec = gather_vec<T>(src, out, D);
  if (scale == nullptr) {
    return vec ? gather_as<T, true, false>(src, slot, scale, out, rows, D, k, st)
               : gather_as<T, false, false>(src, slot, scale, out, rows, D, k, st);
  }
  return vec ? gather_as<T, true, true>(src, slot, scale, out, rows, D, k, st)
             : gather_as<T, false, true>(src, slot, scale, out, rows, D, k, st);
}

template <typename T, bool kVec, int K>
int combine_as(const void* y, const int* row, const void* w, void* out, int64_t S, int D, int k,
               cudaStream_t st) {
  const Plan p = combine_plan<T, kVec, K>(S, D);
  moe_combine_kernel<T, kVec, K><<<p.grid, kThreads, 0, st>>>(
      static_cast<const T*>(y), row, static_cast<const T*>(w), static_cast<T*>(out), S, D, k,
      p.per);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int combine(const void* y, const int* row, const void* w, void* out, int64_t S, int D, int k,
            cudaStream_t st) {
  const bool vec = gather_vec<T>(y, out, D);
  if (k == 8) {
    return vec ? combine_as<T, true, 8>(y, row, w, out, S, D, k, st)
               : combine_as<T, false, 8>(y, row, w, out, S, D, k, st);
  }
  return vec ? combine_as<T, true, 0>(y, row, w, out, S, D, k, st)
             : combine_as<T, false, 0>(y, row, w, out, S, D, k, st);
}

template <typename T>
int gate_grad(const void* dout, const void* y, const int* row, void* dg, int64_t S, int D, int k,
              cudaStream_t st) {
  const bool vec = D % vec_n<T>() == 0 && aligned16(dout) && aligned16(y);
  const T* ap = static_cast<const T*>(dout);
  const T* yp = static_cast<const T*>(y);
  T* gp = static_cast<T*>(dg);
  if (vec) {
    moe_gate_grad_kernel<T, true><<<grid_for(S), kThreads, 0, st>>>(ap, yp, row, gp, S, D, k);
  } else {
    moe_gate_grad_kernel<T, false><<<grid_for(S), kThreads, 0, st>>>(ap, yp, row, gp, S, D, k);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Plan plan_of(int kernel, int64_t rows, int D, int k, bool vec) {
  if (kernel == 0) return vec ? gather_plan<T, true, false>(rows)
                              : gather_plan<T, false, false>(rows);
  if (kernel == 1) return vec ? gather_plan<T, true, true>(rows)
                              : gather_plan<T, false, true>(rows);
  if (k == 8) return vec ? combine_plan<T, true, 8>(rows, D) : combine_plan<T, false, 8>(rows, D);
  return vec ? combine_plan<T, true, 0>(rows, D) : combine_plan<T, false, 0>(rows, D);
}

bool bad_sizes(int64_t rows, int D, int k) {
  return D <= 0 || k < 1 || k > kMaxK || (rows + kWarps - 1) / kWarps > 0x7fffffff;
}

}  // namespace

extern "C" {

// src [S, D], out [rows = E * C, D], scale [S, k] or null (1): all one type
// (bf16 != 0: bfloat16, else float32); slot [rows] int32 (s * k + j, or -1).
// All contiguous. One launch on `stream`. Returns cudaGetLastError() after it
// (0 on success), or -1 for a width, k or grid the kernel does not take.
int moe_gather_launch(const void* src, const void* slot, const void* scale, void* out,
                      int64_t rows, int D, int k, int bf16, void* stream) {
  if (bad_sizes(rows, D, k)) return -1;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slot);
  return bf16 ? gather<__nv_bfloat16>(src, sl, scale, out, rows, D, k, st)
              : gather<float>(src, sl, scale, out, rows, D, k, st);
}

// y [E * C, D], out [S, D], w [S, k] or null (1): one type; row [S, k] int32
// (e * C + pos, or -1). Launch and return as moe_gather_launch.
int moe_combine_launch(const void* y, const void* row, const void* w, void* out, int64_t S,
                       int D, int k, int bf16, void* stream) {
  if (bad_sizes(S, D, k)) return -1;
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* rw = static_cast<const int*>(row);
  return bf16 ? combine<__nv_bfloat16>(y, rw, w, out, S, D, k, st)
              : combine<float>(y, rw, w, out, S, D, k, st);
}

// dout [S, D], y [E * C, D], dg [S, k]: one type; row as moe_combine_launch.
int moe_gate_grad_launch(const void* dout, const void* y, const void* row, void* dg, int64_t S,
                         int D, int k, int bf16, void* stream) {
  if (bad_sizes(S, D, k)) return -1;
  if (S <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* rw = static_cast<const int*>(row);
  return bf16 ? gate_grad<__nv_bfloat16>(dout, y, rw, dg, S, D, k, st)
              : gate_grad<float>(dout, y, rw, dg, S, D, k, st);
}

// The launch that moe_gather_launch (kernel 0; 1 with a scale) or
// moe_combine_launch (kernel 2) makes for `rows` slot rows or tokens of
// width D on the current device, on the 16-byte vector path (vec != 0) or
// the scalar one: out[0] its blocks, out[1] the blocks that fit on an SM,
// out[2] the SM count, out[3] the warps a row: 1 for the gather, the
// combine's warps a token. Returns cudaGetLastError() (0 on success), or -1
// for sizes the kernels do not take.
int moe_launch_plan(int kernel, int64_t rows, int D, int k, int bf16, int vec, int* out) {
  if (bad_sizes(rows, D, k) || rows <= 0 || kernel < 0 || kernel > 2) return -1;
  const Plan p = bf16 ? plan_of<__nv_bfloat16>(kernel, rows, D, k, vec != 0)
                      : plan_of<float>(kernel, rows, D, k, vec != 0);
  out[0] = static_cast<int>(p.grid);
  out[1] = p.blocks_per_sm;
  out[2] = p.sms;
  out[3] = p.per;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
