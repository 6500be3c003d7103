// Selective (Mamba-style) diagonal state-space scan for Hopper: the hybrid
// family's SSM heads (hymba), forward.
//
// Replaces no Pallas kernel. The reference evaluates this recurrence with
// jax.lax.associative_scan over (decay, drive) pairs in ssm_parallel
// (src/repro/models/ssm.py:80), which materialises decay = exp(dt * A) and
// drive = (dt * u) * B as [B, T, Di, S] float32 arrays. This kernel forms
// both on the fly, token by token, and never writes them out. Per (b, di)
// and state s, with A = -exp(log_a[di, s]):
//
//   h_t[s] = exp(dt_t * A[s]) * h_{t-1}[s] + (dt_t * u_t) * B_t[s]
//   y_t    = sum_s C_t[s] * h_t[s] + d_skip * u_t
//
// from h_{-1} = state0; it returns y [B, T, Di] and h_{T-1} [B, Di, S] in
// float32, and, when asked (training), h at the start of every chunk of
// kChunk tokens into states [B, ceil(T / kChunk), Di, S] (chunk 0: state0),
// from which ssm_scan_bwd.cu recomputes h. T is any length: the reference's
// chunks of 2048 tokens, padded with decay 1 and drive 0, give this same
// recurrence.
//
// What bounds it. At hymba's prefill (u [4, 2048, 3200] bf16, S = 16) the
// call must move 265 MB (u, dt read; y written; B, C per (b, t)): 0.079 ms at
// 3.35 TB/s. It must also form 419.4 M decays, one ex2 each on the
// special-function unit: 16 a clock an SM, 4 on each of its four quadrants
// (the card gives 4.185e12 a second in all, one warp an SM 9.7e11:
// tools/sfu_rate.cu), a floor of 0.100 ms when every quadrant is busy. Each
// warp stays on one quadrant, and 1,600 one-warp blocks over 528 quadrants
// put 3 or 4 on each: the quadrants that hold 4 need 0.132 ms of ex2 alone,
// and at about 41 issued instructions a thread and token (34 of them the
// recurrence, y and its stores; the rest the copies and the loop) 0.17 ms of
// issue. In-order issue behind the SFU and the loads' and shuffles' latency
// take the rest: 0.23 ms measured (PERF.md), 0.106 ms at the training
// shape [1, 2048, 3200], where fewer than one warp shares a quadrant.
//
// The design:
//   * One chain a (b, di), kLanes = 4 threads a chain, each with 4 of its 16
//     states in registers; a block is one warp of kChains = 8 neighbouring
//     di of one b. The per-token arithmetic is the first design's (commit
//     eaa80de) instruction for instruction -- the same ex2 of dt * a, the
//     same fmaf for h, the same fmaf order over four states for each partial
//     of y, the same pairing of the partials -- so y and the states come out
//     with its bits (tools/ssm_scan_variants.py holds them bit for bit).
//   * Operands arrive through shared memory: a ring of kStages tiles of
//     kTile tokens (u and dt of the block's chains, B and C of its b), filled
//     kStages - 1 tiles ahead by cp.async (16-byte copies that skip the
//     registers; commit/wait groups). Each lane's pieces of a tile are worked
//     out once, so a tile's copies cost a few instructions a piece. About 12
//     blocks an SM keep roughly 100 KB a SM in flight, where streaming at
//     3.35 TB/s needs about 20 KB; the first design held 4 tokens ahead in
//     registers, about 2.3 KB a SM.
//   * A tile whose tokens all come before T runs straight-line code; the
//     decays of kGroup tokens are formed before the FMAs that use them, and
//     the compiler interleaves the ex2 with the previous tokens' FMAs.
//   * The four threads of a chain exchange their partial sums of y for four
//     tokens at once (3 shuffles where one token at a time takes 8); thread
//     q ends with token q's sum, and the warp stores four tokens' y in one
//     instruction.
//   * One-warp blocks spread the chains evenly over the SMs: 12 or 13 an SM
//     at the prefill shape, where four-warp blocks put 3 or 4.
// Two threads a chain (kLanes = 2, each with two partials of y) give the
// same bits with fewer instructions a chain but half the warps: the same
// time at the prefill shape, two thirds slower at the training shape. A
// shape the 16-byte copies do not fit (S != 16, or a row of u or dt that is
// not a whole number of 16-byte pieces) fills the same ring by plain loads
// and stores. tools/ssm_scan_variants.py builds this source with other lane
// counts, tile lengths and groups beside any other ssm_scan.cu (the first
// design's), holds every build against this one bit for bit and times them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "ssm_exp2.cuh"
#include "tf32_mma.cuh"  // cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int kMaxS = 16;                   // the largest state the kernel takes
constexpr int kQuad = 4;                    // states of one y partial (the first design's lane)
constexpr int kLanes = 4;                   // threads per (b, di): 4 or 2
constexpr int kPer = kMaxS / kLanes;        // states per thread
constexpr int kQuads = kPer / kQuad;        // y partials per thread
constexpr int kThreads = 32;                // one warp a block
constexpr int kChains = kThreads / kLanes;  // chains a block
constexpr int kTile = 16;                   // tokens a ring stage
constexpr int kStages = 4;                  // ring stages (kStages - 1 tiles ahead)
constexpr int kGroup = 8;                   // tokens whose decays are formed together
constexpr int kChunk = 16;                  // tokens between saved states (ssm_scan_bwd.cu
                                            // recomputes h that many at a time)
static_assert((kLanes == 4 || kLanes == 2) && kPer % kQuad == 0, "whole quads a thread");
static_assert(kTile % kGroup == 0 && kGroup % kLanes == 0 && kChunk % kTile == 0, "tiling");

constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// One ring stage: kTile tokens of the block's chains (u, dt; token-major)
// and of its b (B, C; kMaxS a token, states past S zero).
template <typename TU>
struct alignas(16) Stage {
  TU u[kTile * kChains];
  float dt[kTile * kChains];
  float b[kTile * kMaxS];
  float c[kTile * kMaxS];
};

// The 16-byte pieces one lane copies into every stage on the vector path:
// the stage's u rows, then its dt, B and C rows, dealt out over the warp's
// lanes. Worked out once; a tile's copy is then a 64-bit add, a compare and
// the cp.async for each piece.
template <typename TU>
struct Pieces {
  static constexpr int kU = kTile * kChains * static_cast<int>(sizeof(TU)) / 16;
  static constexpr int kD = kTile * kChains * 4 / 16;
  static constexpr int kS = kTile * kMaxS * 4 / 16;
  static constexpr int kAll = kU + kD + 2 * kS;
  static constexpr int kEach = (kAll + kThreads - 1) / kThreads;
  const char* src[kEach];  // the piece at tile 0
  int64_t step[kEach];     // bytes from one tile to the next
  int dst[kEach];          // byte offset in a stage; -1: this lane has no such piece
  int row[kEach];          // token in the tile; kOutside past the operand's Di columns
  static constexpr int kOutside = 0x3fffffff;

  __device__ __forceinline__ Pieces(const TU* u, const float* dt, const float* bm,
                                    const float* cm, int64_t b, int T, int Di, int di0,
                                    int lane) {
    constexpr int kUe = 16 / sizeof(TU);  // u elements a piece
#pragma unroll
    for (int k = 0; k < kEach; ++k) {
      int i = lane + k * kThreads;
      dst[k] = -1;
      src[k] = nullptr;
      step[k] = 0;
      row[k] = 0;
      if (i < kU) {
        const int r = i / (kU / kTile), e = (i % (kU / kTile)) * kUe;
        src[k] = reinterpret_cast<const char*>(u + ((b * T + r) * Di + di0 + e));
        step[k] = static_cast<int64_t>(kTile) * Di * sizeof(TU);
        dst[k] = static_cast<int>(offsetof(Stage<TU>, u) + (r * kChains + e) * sizeof(TU));
        row[k] = di0 + e < Di ? r : kOutside;
      } else if ((i -= kU) < kD) {
        const int r = i / (kD / kTile), e = (i % (kD / kTile)) * 4;
        src[k] = reinterpret_cast<const char*>(dt + ((b * T + r) * Di + di0 + e));
        step[k] = static_cast<int64_t>(kTile) * Di * 4;
        dst[k] = static_cast<int>(offsetof(Stage<TU>, dt) + (r * kChains + e) * 4);
        row[k] = di0 + e < Di ? r : kOutside;
      } else if ((i -= kD) < 2 * kS) {
        const bool c = i >= kS;
        const int j = c ? i - kS : i, r = j / (kS / kTile), e = (j % (kS / kTile)) * 4;
        src[k] = reinterpret_cast<const char*>((c ? cm : bm) + (b * T + r) * kMaxS + e);
        step[k] = static_cast<int64_t>(kTile) * kMaxS * 4;
        dst[k] = static_cast<int>((c ? offsetof(Stage<TU>, c) : offsetof(Stage<TU>, b))
                                  + (r * kMaxS + e) * 4);
        row[k] = r;
      }
    }
  }

  // Tile n into `stage` (zeros past T and past Di; a piece that is not
  // copied is not read).
  __device__ __forceinline__ void copy(unsigned char* stage, int n, int T) const {
    const int rows = T - n * kTile;
#pragma unroll
    for (int k = 0; k < kEach; ++k)
      if (dst[k] >= 0) tf32x3::cp_async16(stage + dst[k], src[k] + n * step[k], row[k] < rows);
  }
};

// Fill `st` with tokens t0 .. t0 + kTile - 1 (zeros past T and past Di) by
// plain loads and stores: the path of shapes the 16-byte pieces do not fit.
template <typename TU>
__device__ __forceinline__ void load_tile_plain(Stage<TU>& st, const TU* __restrict__ u,
                                                const float* __restrict__ dt,
                                                const float* __restrict__ bm,
                                                const float* __restrict__ cm, int64_t b, int T,
                                                int Di, int S, int di0, int t0, int lane) {
  for (int i = lane; i < kTile * kChains; i += kThreads) {
    const int r = i / kChains, ch = i % kChains, t = t0 + r;
    const bool ok = t < T && di0 + ch < Di;
    const int64_t at = (b * T + t) * Di + di0 + ch;
    st.u[i] = ok ? u[at] : zero<TU>();
    st.dt[i] = ok ? dt[at] : 0.f;
  }
  for (int i = lane; i < kTile * kMaxS; i += kThreads) {
    const int r = i / kMaxS, s = i % kMaxS, t = t0 + r;
    const bool ok = t < T && s < S;
    st.b[i] = ok ? bm[(b * T + t) * S + s] : 0.f;
    st.c[i] = ok ? cm[(b * T + t) * S + s] : 0.f;
  }
}

// One group of kGroup tokens in registers: u and dt of the thread's chain
// and the decays of its states.
struct Group {
  float cu[kGroup], cd[kGroup], dec[kGroup][kPer];
};

// Group g of stage `st`: its operands and decays (tokens past T read the
// stage's zero fill and are not used).
template <typename TU>
__device__ __forceinline__ void form_decays(const Stage<TU>& st, int g, int chain,
                                            const float (&a)[kPer], Group& gr) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    gr.cu[k] = to_f32(st.u[(g + k) * kChains + chain]);
    gr.cd[k] = st.dt[(g + k) * kChains + chain];
  }
#pragma unroll
  for (int k = 0; k < kGroup; ++k)
#pragma unroll
    for (int j = 0; j < kPer; ++j) gr.dec[k][j] = ssm_exp2(gr.cd[k] * a[j]);
}

// Group g of stage `st`, tokens tg .. tg + kGroup - 1, on its decays: h's
// updates and y (kFull when every token comes before T, else each checks).
// y_chain points at y[b, 0, di].
//
// y's sum over the 16 states keeps the first design's order: a partial a_p
// is an fmaf chain over the 4 states 4p .. 4p + 3 from 0, and y = (a_0 + a_1)
// + (a_2 + a_3). Four lanes a chain hold one partial each and exchange the
// sums of four tokens at once: lane q keeps the tokens whose bit 0 (then bit
// 1) is its own and hands the others to its partner, so it ends with token
// q's (a_q + a_q^1) + (a_q^2 + a_q^3) -- the same value, the terms of each
// addition swapped. Two lanes a chain hold two partials each, add them
// (lane 0: a_0 + a_1, lane 1: a_2 + a_3) and exchange two tokens' sums.
template <bool kFull, typename TU>
__device__ __forceinline__ void advance(const Stage<TU>& st, int g, int tg, int T, int chain,
                                        int q, const Group& gr, float (&h)[kPer], float dsk,
                                        bool live, float* __restrict__ y_chain, int Di) {
  float acc[kGroup][kQuads];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const float dtu = gr.cd[k] * gr.cu[k];
#pragma unroll
    for (int p = 0; p < kQuads; ++p) {
      const int s0 = q * kPer + p * kQuad;
      const float4 bv = *reinterpret_cast<const float4*>(&st.b[(g + k) * kMaxS + s0]);
      const float4 cv = *reinterpret_cast<const float4*>(&st.c[(g + k) * kMaxS + s0]);
      const float bb[kQuad] = {bv.x, bv.y, bv.z, bv.w};
      const float cc[kQuad] = {cv.x, cv.y, cv.z, cv.w};
      float sum = 0.f;
      if (kFull || tg + k < T) {
#pragma unroll
        for (int j = 0; j < kQuad; ++j) {
          float& hj = h[p * kQuad + j];
          hj = fmaf(gr.dec[k][p * kQuad + j], hj, dtu * bb[j]);
          sum = fmaf(hj, cc[j], sum);
        }
      }
      acc[k][p] = sum;
    }
  }
#pragma unroll
  for (int k0 = 0; k0 < kGroup; k0 += kLanes) {
    float mine;
    if constexpr (kLanes == 4) {
      const bool odd = q & 1, high = q & 2;
      float lo = odd ? acc[k0 + 1][0] : acc[k0][0];
      float hi = odd ? acc[k0 + 3][0] : acc[k0 + 2][0];
      lo += __shfl_xor_sync(kAll, odd ? acc[k0][0] : acc[k0 + 1][0], 1);
      hi += __shfl_xor_sync(kAll, odd ? acc[k0 + 2][0] : acc[k0 + 3][0], 1);
      mine = high ? hi : lo;
      mine += __shfl_xor_sync(kAll, high ? lo : hi, 2);
    } else {
      const float first = acc[k0][0] + acc[k0][kQuads - 1];
      const float second = acc[k0 + 1][0] + acc[k0 + 1][kQuads - 1];
      mine = q ? second : first;
      mine += __shfl_xor_sync(kAll, q ? first : second, 1);
    }
    const int t = tg + k0 + q;
    if (live && (kFull || t < T))
      y_chain[static_cast<int64_t>(t) * Di] =
          mine + dsk * to_f32(st.u[(g + k0 + q) * kChains + chain]);
  }
}

// The kTile tokens of one stage, from t0, group after group: kFull when all
// of them come before T (straight-line code the compiler schedules across
// tokens and groups), else each token checks T.
template <bool kFull, typename TU>
__device__ __forceinline__ void scan_tile(const Stage<TU>& st, int t0, int T, int chain, int q,
                                          const float (&a)[kPer], float (&h)[kPer], float dsk,
                                          bool live, float* __restrict__ y_chain, int Di) {
#pragma unroll
  for (int g = 0; g < kTile; g += kGroup) {
    if (!kFull && t0 + g >= T) break;  // uniform: every chain has the same T
    Group gr;
    form_decays(st, g, chain, a, gr);
    advance<kFull>(st, g, t0 + g, T, chain, q, gr, h, dsk, live, y_chain, Di);
  }
}

template <typename TU, bool kVec>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const TU* __restrict__ u, const float* __restrict__ dt, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ log_a,
    const float* __restrict__ d_skip, const float* __restrict__ s0, float* __restrict__ y,
    float* __restrict__ s_out, float* __restrict__ states, int T, int Di, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage<TU>* ring = reinterpret_cast<Stage<TU>*>(smem_raw);  // kStages stages
  using tf32x3::cp_async_commit;
  using tf32x3::cp_async_wait;
  const int lane = threadIdx.x;
  const int q = lane % kLanes;
  const int chain = lane / kLanes;
  const int nblk = (Di + kChains - 1) / kChains;
  const int64_t b = blockIdx.x / nblk;
  const int di0 = static_cast<int>(blockIdx.x % nblk) * kChains;
  // A chain past Di computes on zero operands with the block's first
  // chain's parameters and stores nothing: every lane takes part in the
  // shuffles.
  const bool live = di0 + chain < Di;
  const int di = live ? di0 + chain : di0;

  // a = A * log2(e): exp(dt * A) = 2^(dt * a).
  float a[kPer], h[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = q * kPer + j;
    a[j] = s < S ? -expf(log_a[static_cast<int64_t>(di) * S + s]) * kLog2e : 0.f;
    h[j] = s < S ? s0[(b * Di + di) * S + s] : 0.f;
  }
  const float dsk = d_skip[di];
  const int nt = (T + kTile - 1) / kTile;
  const int nc = (T + kChunk - 1) / kChunk;

  const Pieces<TU> pieces(u, dt, bm, cm, b, T, Di, di0, lane);
  const auto load = [&](int n) {
    if (kVec)
      pieces.copy(reinterpret_cast<unsigned char*>(&ring[n % kStages]), n, T);
    else
      load_tile_plain(ring[n % kStages], u, dt, bm, cm, b, T, Di, S, di0, n * kTile, lane);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nt) load(i);
    cp_async_commit();
  }
  float* y_chain = y + b * T * Di + di;
  for (int i = 0; i < nt; ++i) {
    // Tile i has landed, and every lane is done with the stage refilled next.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < nt) load(i + kStages - 1);
    cp_async_commit();
    const Stage<TU>& st = ring[i % kStages];
    const int t0 = i * kTile;
    if (states != nullptr && t0 % kChunk == 0 && live) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int s = q * kPer + j;
        if (s < S) states[((b * nc + t0 / kChunk) * Di + di) * S + s] = h[j];
      }
    }
    if (t0 + kTile <= T)
      scan_tile<true>(st, t0, T, chain, q, a, h, dsk, live, y_chain, Di);
    else
      scan_tile<false>(st, t0, T, chain, q, a, h, dsk, live, y_chain, Di);
  }
  cp_async_wait<0>();
  if (live) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int s = q * kPer + j;
      if (s < S) s_out[(b * Di + di) * S + s] = h[j];
    }
  }
}

// Ask for the largest shared-memory carveout, once a kernel: about 13
// blocks of 12 KB share an SM. Not a stream operation, so a launch can be
// captured into a CUDA graph after the first call.
template <auto kKernel>
void prefer_shared() {
  static const bool done = cudaFuncSetAttribute(kKernel,
                                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                                cudaSharedmemCarveoutMaxShared) == cudaSuccess;
  (void)done;
}

template <typename TU>
int launch(const void* u, const float* dt, const float* bm, const float* cm, const float* log_a,
           const float* d_skip, const float* s0, float* y, float* s_out, float* states, int B,
           int T, int Di, int S, cudaStream_t st) {
  const int64_t blocks = static_cast<int64_t>(B) * ((Di + kChains - 1) / kChains);
  if (blocks > 0x7fffffff) return -1;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = S == kMaxS && Di % (16 / static_cast<int>(sizeof(TU))) == 0 && aligned(u) &&
                   aligned(dt) && aligned(bm) && aligned(cm);
  const TU* up = static_cast<const TU*>(u);
  const unsigned grid = static_cast<unsigned>(blocks);
  constexpr int smem = kStages * static_cast<int>(sizeof(Stage<TU>));
  if (vec) {
    prefer_shared<selective_scan_kernel<TU, true>>();
    selective_scan_kernel<TU, true><<<grid, kThreads, smem, st>>>(
        up, dt, bm, cm, log_a, d_skip, s0, y, s_out, states, T, Di, S);
  } else {
    prefer_shared<selective_scan_kernel<TU, false>>();
    selective_scan_kernel<TU, false><<<grid, kThreads, smem, st>>>(
        up, dt, bm, cm, log_a, d_skip, s0, y, s_out, states, T, Di, S);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_any(const void* u, const void* dt, const void* bm, const void* cm, const void* log_a,
               const void* d_skip, const void* s0, void* y, void* s_out, void* states, int B,
               int T, int Di, int S, int bf16, void* stream) {
  if (S < 1 || S > kMaxS) return -1;
  if (B <= 0 || T <= 0 || Di <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(dt), static_cast<const float*>(bm),
                      static_cast<const float*>(cm), static_cast<const float*>(log_a),
                      static_cast<const float*>(d_skip), static_cast<const float*>(s0)};
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(s_out);
  float* sts = static_cast<float*>(states);
  return bf16 ? launch<__nv_bfloat16>(u, f[0], f[1], f[2], f[3], f[4], f[5], yo, so, sts, B, T,
                                      Di, S, st)
              : launch<float>(u, f[0], f[1], f[2], f[3], f[4], f[5], yo, so, sts, B, T, Di, S,
                              st);
}

}  // namespace

extern "C" {

// u [B, T, Di] (bf16 != 0: bfloat16, else float32); dt [B, T, Di], bm and cm
// [B, T, S], log_a [Di, S], d_skip [Di], s0 [B, Di, S]: float32. Outputs y
// [B, T, Di] and s_out [B, Di, S], float32. All contiguous. 1 <= S <= 16,
// T >= 1. One launch on `stream`. Returns cudaGetLastError() after it (0 on
// success), or -1 for an unsupported S or a grid too large.
int selective_scan_launch(const void* u, const void* dt, const void* bm, const void* cm,
                          const void* log_a, const void* d_skip, const void* s0, void* y,
                          void* s_out, int B, int T, int Di, int S, int bf16, void* stream) {
  return launch_any(u, dt, bm, cm, log_a, d_skip, s0, y, s_out, nullptr, B, T, Di, S, bf16,
                    stream);
}

// The same launch, which also writes h at the start of every chunk of
// selective_scan_chunk() tokens into states [B, ceil(T / chunk), Di, S]
// float32 (chunk 0: s0).
int selective_scan_states_launch(const void* u, const void* dt, const void* bm, const void* cm,
                                 const void* log_a, const void* d_skip, const void* s0, void* y,
                                 void* s_out, void* states, int B, int T, int Di, int S,
                                 int bf16, void* stream) {
  return launch_any(u, dt, bm, cm, log_a, d_skip, s0, y, s_out, states, B, T, Di, S, bf16,
                    stream);
}

// Tokens between the saved states.
int selective_scan_chunk() { return kChunk; }

}  // extern "C"
