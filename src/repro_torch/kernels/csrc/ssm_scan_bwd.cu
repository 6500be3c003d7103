// The selective scan's backward for Hopper: the gradients of ssm_scan.cu's
// recurrence (hymba's SSM heads) for training.
//
// Replaces no Pallas kernel: the reference differentiates ssm_parallel's
// jax.lax.associative_scan (src/repro/models/ssm.py:80) with JAX's autodiff.
// With decay_t = exp(dt_t * A), A = -exp(log_a), and g_t the gradient of h_t
// (per (b, di, s)):
//
//   g_{T-1} = C_{T-1} dy_{T-1} + d_final,  g_t = C_t dy_t + decay_{t+1} g_{t+1}
//   du_t    = dt_t sum_s g_t B_t + d_skip dy_t
//   ddt_t   = sum_s g_t (A decay_t h_{t-1} + u_t B_t)
//   dB_t[s] = sum_di g_t dt_t u_t        dC_t[s] = sum_di dy_t h_t
//   dlog_a  = A sum_{b,t} g_t decay_t h_{t-1} dt_t
//   dd_skip = sum_{b,t} dy_t u_t         dstate0 = decay_0 g_0
//
// Two launches:
//   * ssm_bwd_chunk_kernel: one thread a (b, di, s), kChains = 32 chains of
//     one b a block (512 threads). A block walks the forward's chunks of
//     kChunk tokens from the last to the first. For each it stages the
//     chunk's u, dt, dy, B and C in shared memory by cp.async (the next
//     chunk's copies in flight while this one is worked), recomputes h from
//     the chunk's saved start state with the forward's arithmetic (the same
//     ex2 of dt * a and fmaf, so h has the forward's bits) into shared
//     memory, then sweeps back: g, the per-token sums over s by xor
//     shuffles inside a chain's 16 lanes (du and ddt split over the two
//     halves, then summed), dlog_a's and dd_skip's terms in registers over
//     t. dB and dC sum over the block's 32 chains: the warp's two chains by
//     one shuffle, then the block's 16 warps in order at the chunk's end,
//     written to a partial per block.
//   * ssm_bwd_reduce_kernel: dB and dC over the blocks in order, dlog_a and
//     dd_skip over b in order. Every sum has a fixed order: the bits are the
//     same from call to call.
//
// What bounds it. At hymba's training shape (u [1, 2048, 3200] bf16, S = 16)
// the call must read u, dt, dy, B, C and the states and write du, ddt, dB,
// dC, dstate0 and the parameter gradients: 111 MB, 0.033 ms at 3.35 TB/s; the
// partials add 26 MB written and read. It forms every decay twice (the
// recompute and the sweep): 209.7 M ex2, 0.050 ms on the SFU at 16 a clock
// an SM and 1.98 GHz -- twice the forward's floor, above the bytes. This
// simple first design gives each state a thread: a chain's 16 threads all
// load its u, dt and dy and sum over its states by shuffles, about 57
// instructions a state and token, and its 100 blocks of 16 warps (h's chunk
// takes 128 KB of shared memory, one block an SM) leave 32 of the 132 SMs
// idle: 0.24 ms of issue at best, 0.48 ms measured (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssm_exp2.cuh"
#include "tf32_mma.cuh"  // cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int kMaxS = 16;                   // the largest state the kernel takes
constexpr int kChains = 32;                 // chains a block
constexpr int kThreads = kChains * kMaxS;   // a thread a (chain, state)
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                  // ssm_scan.cu's: tokens between saved states
constexpr int kRed = 2 * kMaxS;             // a partial's row: dB's S, then dC's
constexpr int kReduceThreads = 256;
static_assert(kMaxS == 16 && kThreads % 32 == 0, "a warp holds two chains' 16 states");

constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kAll = 0xffffffffu;

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

// One chunk's operands: u, dt, dy of the block's chains and B, C of its b,
// token-major (zeros past T, past Di and past S).
template <typename TU>
struct alignas(16) Tile {
  TU u[kChunk * kChains];
  float dt[kChunk * kChains];
  float dy[kChunk * kChains];
  float b[kChunk * kMaxS];
  float c[kChunk * kMaxS];
};

template <typename TU>
constexpr int smem_bytes() {
  return 2 * static_cast<int>(sizeof(Tile<TU>)) + kChunk * kThreads * 4;
}

template <typename TU, bool kVec>
__device__ __forceinline__ void load_chunk(Tile<TU>& tl, const TU* __restrict__ u,
                                           const float* __restrict__ dt,
                                           const float* __restrict__ dy,
                                           const float* __restrict__ bm,
                                           const float* __restrict__ cm, int64_t b, int T,
                                           int Di, int S, int di0, int t0, int tid) {
  using tf32x3::cp_async16;
  if (kVec) {
    constexpr int kUe = 16 / sizeof(TU);
    constexpr int kUp = kChains / kUe;
    constexpr int kFp = kChains / 4;
    constexpr int kSp = kMaxS / 4;
    for (int i = tid; i < kChunk * kUp; i += kThreads) {
      const int r = i / kUp, e = (i % kUp) * kUe, t = t0 + r;
      const bool ok = t < T && di0 + e < Di;
      cp_async16(&tl.u[r * kChains + e], ok ? u + ((b * T + t) * Di + di0 + e) : u, ok);
    }
    for (int i = tid; i < kChunk * kFp; i += kThreads) {
      const int r = i / kFp, e = (i % kFp) * 4, t = t0 + r;
      const bool ok = t < T && di0 + e < Di;
      const int64_t at = (b * T + t) * Di + di0 + e;
      cp_async16(&tl.dt[r * kChains + e], ok ? dt + at : dt, ok);
      cp_async16(&tl.dy[r * kChains + e], ok ? dy + at : dy, ok);
    }
    for (int i = tid; i < kChunk * kSp; i += kThreads) {
      const int r = i / kSp, e = (i % kSp) * 4, t = t0 + r;
      const bool ok = t < T;
      cp_async16(&tl.b[r * kMaxS + e], ok ? bm + (b * T + t) * kMaxS + e : bm, ok);
      cp_async16(&tl.c[r * kMaxS + e], ok ? cm + (b * T + t) * kMaxS + e : cm, ok);
    }
  } else {
    for (int i = tid; i < kChunk * kChains; i += kThreads) {
      const int r = i / kChains, ch = i % kChains, t = t0 + r;
      const bool ok = t < T && di0 + ch < Di;
      const int64_t at = (b * T + t) * Di + di0 + ch;
      tl.u[i] = ok ? u[at] : from_f32<TU>(0.f);
      tl.dt[i] = ok ? dt[at] : 0.f;
      tl.dy[i] = ok ? dy[at] : 0.f;
    }
    for (int i = tid; i < kChunk * kMaxS; i += kThreads) {
      const int r = i / kMaxS, s = i % kMaxS, t = t0 + r;
      const bool ok = t < T && s < S;
      tl.b[i] = ok ? bm[(b * T + t) * S + s] : 0.f;
      tl.c[i] = ok ? cm[(b * T + t) * S + s] : 0.f;
    }
  }
}

template <typename TU, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) ssm_bwd_chunk_kernel(
    const TU* __restrict__ u, const float* __restrict__ dt, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ log_a,
    const float* __restrict__ d_skip, const float* __restrict__ dy,
    const float* __restrict__ d_final, const float* __restrict__ states, TU* __restrict__ du,
    float* __restrict__ ddt, float* __restrict__ dstate0, float* __restrict__ part,
    float* __restrict__ dla_part, float* __restrict__ dds_part, int B, int T, int Di, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using tf32x3::cp_async_commit;
  using tf32x3::cp_async_wait;
  Tile<TU>* tiles = reinterpret_cast<Tile<TU>*>(smem_raw);
  // h of the chunk, hb[r * kThreads + tid]: each thread reads and writes
  // only its own column until the chunk's end, where the column holds the
  // warp's pair sums of dB and dC instead.
  float* hb = reinterpret_cast<float*>(smem_raw + 2 * sizeof(Tile<TU>));
  const int tid = threadIdx.x, lane = tid & 31;
  const int s = tid % kMaxS, chain = tid / kMaxS;
  const int nblk = (Di + kChains - 1) / kChains;
  const int blk = static_cast<int>(blockIdx.x % nblk);
  const int64_t b = blockIdx.x / nblk;
  const int di0 = blk * kChains;
  const bool live = di0 + chain < Di;
  const int di = live ? di0 + chain : di0;
  const bool on = live && s < S;
  // The forward's a = -expf(log_a) * log2(e), so that h has its bits.
  const float A = s < S ? -expf(log_a[static_cast<int64_t>(di) * S + s]) : 0.f;
  const float a = A * kLog2e;
  const float dsk = d_skip[di];
  const int nc = (T + kChunk - 1) / kChunk;
  float carry = d_final != nullptr && on ? d_final[(b * Di + di) * S + s] : 0.f;
  float dla = 0.f, dds = 0.f;

  load_chunk<TU, kVec>(tiles[0], u, dt, dy, bm, cm, b, T, Di, S, di0, (nc - 1) * kChunk, tid);
  cp_async_commit();
  for (int k = 0; k < nc; ++k) {
    const int c = nc - 1 - k;
    if (c > 0)
      load_chunk<TU, kVec>(tiles[(k + 1) & 1], u, dt, dy, bm, cm, b, T, Di, S, di0,
                           (c - 1) * kChunk, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const Tile<TU>& tl = tiles[k & 1];
    const int t0 = c * kChunk;
    const int len = T - t0 < kChunk ? T - t0 : kChunk;
    const float h0 = on ? states[((b * nc + c) * Di + di) * S + s] : 0.f;
    float h = h0;
    for (int r = 0; r < len; ++r) {
      const float cd = tl.dt[r * kChains + chain];
      const float dtu = cd * to_f32(tl.u[r * kChains + chain]);
      h = fmaf(ssm_exp2(cd * a), h, dtu * tl.b[r * kMaxS + s]);
      hb[r * kThreads + tid] = h;
    }
    for (int r = len - 1; r >= 0; --r) {
      const float cd = tl.dt[r * kChains + chain];
      const float cu = to_f32(tl.u[r * kChains + chain]);
      const float dyv = tl.dy[r * kChains + chain];
      const float bv = tl.b[r * kMaxS + s];
      const float dec = ssm_exp2(cd * a);
      const float ht = hb[r * kThreads + tid];
      const float hp = r > 0 ? hb[(r - 1) * kThreads + tid] : h0;
      const float g = fmaf(tl.c[r * kMaxS + s], dyv, carry);
      carry = dec * g;
      const float hd = dec * hp;
      dla = fmaf(g * hd, cd, dla);
      // du's and ddt's sums over the chain's 16 states: lanes 0-7 of the
      // chain keep du's terms and take their partner's, lanes 8-15 ddt's;
      // then each half sums over itself.
      const float pdu = g * bv;
      const float pddt = g * fmaf(A, hd, cu * bv);
      const bool upper = s >= kMaxS / 2;
      float v = (upper ? pddt : pdu) + __shfl_xor_sync(kAll, upper ? pdu : pddt, kMaxS / 2);
#pragma unroll
      for (int o = kMaxS / 4; o >= 1; o /= 2) v += __shfl_xor_sync(kAll, v, o);
      const int64_t at = (b * T + t0 + r) * Di + di;
      if (live && s == 0) du[at] = from_f32<TU>(fmaf(cd, v, dsk * dyv));
      if (live && s == kMaxS / 2) ddt[at] = v;
      if (s == 0) dds = fmaf(dyv, cu, dds);
      // dB's and dC's terms, summed over the warp's two chains: lanes 0-15
      // end with dB[s], lanes 16-31 with dC[s].
      const bool second = lane >= kMaxS;
      const float pb = on ? g * (cd * cu) : 0.f, pc = on ? dyv * ht : 0.f;
      hb[r * kThreads + tid] = (second ? pc : pb) + __shfl_xor_sync(kAll, second ? pb : pc, 16);
    }
    __syncthreads();
    // The block's sums of dB and dC over its warps, in warp order.
    for (int i = tid; i < len * kRed; i += kThreads) {
      const int r = i / kRed, v = i % kRed;
      float sum = hb[r * kThreads + v];
      for (int w = 1; w < kWarps; ++w) sum += hb[r * kThreads + w * 32 + v];
      part[((static_cast<int64_t>(blk) * B + b) * T + t0 + r) * kRed + v] = sum;
    }
  }
  if (on) {
    dstate0[(b * Di + di) * S + s] = carry;
    dla_part[(b * Di + di) * S + s] = dla;
  }
  if (live && s == 0) dds_part[b * Di + di] = dds;
}

__global__ void __launch_bounds__(kReduceThreads) ssm_bwd_reduce_kernel(
    const float* __restrict__ part, const float* __restrict__ dla_part,
    const float* __restrict__ dds_part, const float* __restrict__ log_a, float* __restrict__ dbm,
    float* __restrict__ dcm, float* __restrict__ dlog_a, float* __restrict__ dd_skip, int B,
    int T, int Di, int S, int nblk) {
  const int64_t bt = static_cast<int64_t>(B) * T;
  const int64_t n1 = bt * S, n2 = static_cast<int64_t>(Di) * S, total = 2 * n1 + n2 + Di;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * kReduceThreads) {
    if (i < 2 * n1) {
      const int kind = i >= n1;
      const int64_t j = kind ? i - n1 : i;
      const int64_t row = j / S;
      const int col = kind * kMaxS + static_cast<int>(j % S);
      float sum = 0.f;
      for (int k = 0; k < nblk; ++k) sum += part[(k * bt + row) * kRed + col];
      (kind ? dcm : dbm)[j] = sum;
    } else if (i < 2 * n1 + n2) {
      const int64_t j = i - 2 * n1;
      float sum = 0.f;
      for (int k = 0; k < B; ++k) sum += dla_part[k * n2 + j];
      dlog_a[j] = -expf(log_a[j]) * sum;
    } else {
      const int64_t j = i - 2 * n1 - n2;
      float sum = 0.f;
      for (int k = 0; k < B; ++k) sum += dds_part[k * static_cast<int64_t>(Di) + j];
      dd_skip[j] = sum;
    }
  }
}

template <typename TU, bool kVec>
int launch_chunks(const TU* u, const float* const f[], TU* du, float* const o[], int B, int T,
                  int Di, int S, cudaStream_t st) {
  const int64_t blocks = static_cast<int64_t>(B) * ((Di + kChains - 1) / kChains);
  if (blocks > 0x7fffffff) return -1;
  constexpr int smem = smem_bytes<TU>();
  // Once a kernel: not a stream operation, so later launches can be
  // captured into a CUDA graph.
  static const cudaError_t e = cudaFuncSetAttribute(
      ssm_bwd_chunk_kernel<TU, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssm_bwd_chunk_kernel<TU, kVec><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      u, f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], du, o[0], o[1], o[2], o[3], o[4], B, T,
      Di, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename TU>
int launch(const void* u, const float* const f[], void* du, float* const o[],
           float* const r[], int B, int T, int Di, int S, cudaStream_t st) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = S == kMaxS && Di % (16 / static_cast<int>(sizeof(TU))) == 0 && aligned(u) &&
                   aligned(f[0]) && aligned(f[1]) && aligned(f[2]) && aligned(f[5]);
  const TU* up = static_cast<const TU*>(u);
  TU* dup = static_cast<TU*>(du);
  const int err = vec ? launch_chunks<TU, true>(up, f, dup, o, B, T, Di, S, st)
                      : launch_chunks<TU, false>(up, f, dup, o, B, T, Di, S, st);
  if (err != 0) return err;
  const int nblk = (Di + kChains - 1) / kChains;
  const int64_t total = 2 * static_cast<int64_t>(B) * T * S + static_cast<int64_t>(Di) * S + Di;
  int64_t grid = (total + kReduceThreads - 1) / kReduceThreads;
  if (grid > 132 * 16) grid = 132 * 16;
  ssm_bwd_reduce_kernel<<<static_cast<unsigned>(grid), kReduceThreads, 0, st>>>(
      o[2], o[3], o[4], f[3], r[0], r[1], r[2], r[3], B, T, Di, S, nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The selective scan's gradients. Inputs: u [B, T, Di] (bf16 != 0:
// bfloat16, else float32); dt [B, T, Di], bm and cm [B, T, S], log_a [Di, S],
// d_skip [Di], dy [B, T, Di], d_final [B, Di, S] or null (zero), states
// [B, ceil(T / 64), Di, S] as selective_scan_states_launch wrote them: all
// float32 and contiguous. Outputs: du [B, T, Di] in u's dtype; ddt [B, T, Di],
// dbm and dcm [B, T, S], dlog_a [Di, S], dd_skip [Di], dstate0 [B, Di, S],
// float32. Scratch: part [ceil(Di / 32) * B * T * 32], dla_part [B * Di * S],
// dds_part [B * Di], float32. 1 <= S <= 16, T >= 1. Two launches on
// `stream`; returns cudaGetLastError() after them (0 on success), or -1 for
// an unsupported S or a grid too large.
int selective_scan_bwd_launch(const void* u, const void* dt, const void* bm, const void* cm,
                              const void* log_a, const void* d_skip, const void* dy,
                              const void* d_final, const void* states, void* du, void* ddt,
                              void* dbm, void* dcm, void* dlog_a, void* dd_skip, void* dstate0,
                              void* part, void* dla_part, void* dds_part, int B, int T, int Di,
                              int S, int bf16, void* stream) {
  if (S < 1 || S > kMaxS) return -1;
  if (B <= 0 || T <= 0 || Di <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(dt),     static_cast<const float*>(bm),
                      static_cast<const float*>(cm),     static_cast<const float*>(log_a),
                      static_cast<const float*>(d_skip), static_cast<const float*>(dy),
                      static_cast<const float*>(d_final), static_cast<const float*>(states)};
  float* o[] = {static_cast<float*>(ddt), static_cast<float*>(dstate0),
                static_cast<float*>(part), static_cast<float*>(dla_part),
                static_cast<float*>(dds_part)};
  float* r[] = {static_cast<float*>(dbm), static_cast<float*>(dcm), static_cast<float*>(dlog_a),
                static_cast<float*>(dd_skip)};
  return bf16 ? launch<__nv_bfloat16>(u, f, du, o, r, B, T, Di, S, st)
              : launch<float>(u, f, du, o, r, B, T, Di, S, st);
}

// Dynamic shared memory of the chunk kernel, in bytes.
int selective_scan_bwd_smem_bytes(int bf16) {
  return bf16 ? smem_bytes<__nv_bfloat16>() : smem_bytes<float>();
}

}  // extern "C"
