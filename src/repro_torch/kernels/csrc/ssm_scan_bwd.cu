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
// What bounds it. Numbers are for an H100 80GB HBM3 at a 700 W limit, at
// hymba's training shape (u [1, 2048, 3200] bf16, S = 16; B = 1, so the only
// parallelism besides the 3,200 channels is along T). The gradients need u,
// dt, dy, B, C, the parameters and state0 read and du, ddt, dB, dC, dstate0
// and the parameters' gradients written: 106.2 MB, 0.0317 ms at 3.35 TB/s
// (the forward's kept states are a design's, not counted). Their 104.9 M
// (t, di, s) each need a decay in the recompute of h and another in the
// reverse sweep: 209.7 M ex2, 0.050 ms on the special-function unit (16 a
// clock an SM at 1.98 GHz). The first design (commit 5b5dfe8) swept each
// chain's whole T in one block, a thread a state: 57 instructions a state
// and token, 100 blocks of 188 KB of shared memory on the 132 SMs, 0.494 ms
// from graphs over operands in HBM (PERF.md).
//
// This design splits the reverse sweep over T. The only value that crosses
// a chunk of kChunk tokens going backward is the carry c_t = decay_t g_t,
// and it is linear in the carry that enters the chunk: a chunk hands the
// chunk before it P * carry_in + L, with P = 2^(a sum_t dt_t) its decays'
// product and L what it hands on from carry_in = 0. Four launches:
//   * ssm_bwd_carry_kernel, a block a (b, chunk, 32 chains): L and sum dt
//     of its chunk from dt, dy and C only (one ex2 a state and token).
//   * ssm_bwd_fold_kernel, a thread a (b, di, s): from d_final down the
//     chunks, carry <- P_c carry + L_c, in chunk order; it writes the carry
//     that enters every chunk.
//   * ssm_bwd_chunk_kernel, a block a (b, chunk, 32 chains): the gradients
//     of its chunk from its folded carry. h is recomputed with the forward's
//     arithmetic (the same ex2 of dt * a and fmaf) from the states the
//     forward kept every kSub tokens, kSub tokens at a time into registers,
//     then swept back (a second ex2 a state and token). Four threads a
//     chain, four states a thread, as in the forward: each thread loads a
//     token's u, dt and dy once for its four states and B and C as 16-byte
//     vectors; du's and ddt's sums over the states are in-register sums
//     over the thread's four, then xor shuffles over the chain's four lanes
//     (du's on lanes 0-1, ddt's on 2-3). du and ddt go back into the tile
//     in place of u and dt, which is written out whole at the chunk's end.
//     dB's and dC's terms of kGroup tokens go to shared memory (16-byte
//     pieces swizzled so that a quarter-warp's stores meet no bank twice)
//     and are summed over the block's chains in a fixed order, a thread an
//     output. dlog_a's and dd_skip's terms sum in registers over the chunk.
//   * ssm_bwd_reduce_kernel: dB and dC over the blocks of chains in order,
//     dlog_a and dd_skip over (b, chunk) in order; consecutive threads read
//     consecutive words.
// Every sum has a fixed order and no atomics: the bits are the same from
// call to call. A block's operands arrive by cp.async, each thread's 16-byte
// pieces worked out once. At the training shape the two block passes have
// 32 chunks x 100 chain groups = 3,200 blocks of 4 warps (the chunk pass 4
// resident an SM at 125 registers: all 132 SMs busy over six waves), where
// the first design had 100. It forms three ex2 a state and token (316.2 M,
// 0.076 ms) and its passes move about 278 MB (0.083 ms): the forward's
// states every 16 tokens (26.2 MB) read, dt and dy read twice, the dB/dC
// partials (26.2 MB) and the carries' scratch written and read once.
//
// Measured (PERF.md): 0.242 ms a call from graphs (the first design
// 0.494 in the same session); by kernel the carry pass 0.036, the fold
// 0.006, the chunk pass 0.158, the reduction 0.018. The chunk pass issues
// about 123 instructions a thread and token (20 a state and token of float
// work, two ex2 among them; the in-block dB/dC sums about 24 a thread and
// token) at about 0.6 of the issue rate; it is bound by issue, not by the
// SFU or the bytes. Variants timed and dropped (tools/ssm_scan_bwd_variants.py):
// 3 blocks an SM at up to 168 registers, 64 chains a block, dB/dC summed
// over 8 tokens or by warp shuffles, a copy group a sub-chunk, the
// states staged in shared memory (2% faster, but it spills at 128
// registers), the reduction's long sums split over four threads (1%).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssm_exp2.cuh"
#include "tf32_mma.cuh"  // cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int kMaxS = 16;                  // the largest state the kernels take
constexpr int kLanes = 4;                  // threads a chain
constexpr int kPer = kMaxS / kLanes;       // states a thread
constexpr int kChains = 32;                // chains a block of the two block passes
constexpr int kThreads = kChains * kLanes;
constexpr int kMinBlocks = 4;              // the chunk kernel's blocks an SM (16-byte path)
constexpr int kChunk = 64;                 // tokens a block: the carries' chunk
constexpr int kSub = 16;                   // ssm_scan.cu's kChunk: tokens between saved states
constexpr int kGroup = 4;                  // tokens whose dB/dC terms are summed together
constexpr int kRed = 2 * kMaxS;            // a partial's row: dB's S, then dC's
constexpr int kFoldThreads = 256;
constexpr int kReduceThreads = 256;
constexpr int64_t kReduceMaxBlocks = 132 * 16;  // its grid-stride loop: 16 an H100 SM
static_assert(kPer == 4 && kLanes == 4, "a thread's states are one 16-byte piece of B or C");
static_assert(kChunk % kSub == 0 && kSub % kGroup == 0, "tiling");
static_assert(kChains % 2 == 0 && kRed == 8 * kPer, "the swizzle pairs neighbouring chains");

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
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

// The carry pass's operands: dt, dy and C only.
struct alignas(16) CarryTile {
  float dt[kChunk * kChains];
  float dy[kChunk * kChains];
  float c[kChunk * kMaxS];
};

template <typename TU>
constexpr int chunk_smem_bytes() {
  return static_cast<int>(sizeof(Tile<TU>)) + kGroup * kChains * kRed * 4;
}

// One 16-byte piece that a thread copies into every sub-chunk of a tile on
// the path of 16-byte copies: worked out once a block, so that a
// sub-chunk's copy is a pointer add, a compare and the cp.async. A thread
// without such a piece has dst == nullptr.
struct Piece {
  static constexpr int kOutside = 0x3fffffff;
  const char* src = nullptr;    // the piece of sub-chunk 0
  int64_t step = 0;             // bytes from one sub-chunk to the next
  unsigned char* dst = nullptr; // its place in the tile's sub-chunk 0
  int dst_step = 0;             // bytes in the tile from one sub-chunk to the next
  int row = 0;                  // its token in the sub-chunk; kOutside past Di

  // Sub-chunk sb, of which `rows` tokens come before T (zeros after them).
  __device__ __forceinline__ void copy(int sb, int rows) const {
    if (dst != nullptr) tf32x3::cp_async16(dst + sb * dst_step, src + sb * step, row < rows);
  }
};

// Piece i of a sub-chunk of a per-chain operand x [B, T, Di] (kSub rows of
// the block's chains at token t0 into tile[r * kChains + chain]).
template <typename E>
__device__ __forceinline__ Piece chain_piece(const E* x, E* tile, int64_t b, int T, int Di,
                                             int di0, int t0, int i) {
  constexpr int kE = 16 / static_cast<int>(sizeof(E));
  constexpr int kP = kChains / kE;
  static_assert(kSub * kP <= kThreads, "a piece a thread");
  Piece pc;
  if (i >= 0 && i < kSub * kP) {
    const int r = i / kP, e = (i % kP) * kE;
    pc.src = reinterpret_cast<const char*>(x + ((b * T + t0 + r) * Di + di0 + e));
    pc.step = static_cast<int64_t>(kSub) * Di * static_cast<int>(sizeof(E));
    pc.dst = reinterpret_cast<unsigned char*>(tile + r * kChains + e);
    pc.dst_step = kSub * kChains * static_cast<int>(sizeof(E));
    pc.row = di0 + e < Di ? r : Piece::kOutside;
  }
  return pc;
}

// Piece i of a sub-chunk of B or C [B, T, kMaxS] (into tile[r * kMaxS + s]).
__device__ __forceinline__ Piece state_piece(const float* x, float* tile, int64_t b, int T,
                                             int t0, int i) {
  constexpr int kP = kMaxS / 4;
  Piece pc;
  if (i >= 0 && i < kSub * kP) {
    const int r = i / kP, e = (i % kP) * 4;
    pc.src = reinterpret_cast<const char*>(x + (b * T + t0 + r) * kMaxS + e);
    pc.step = static_cast<int64_t>(kSub) * kMaxS * 4;
    pc.dst = reinterpret_cast<unsigned char*>(tile + r * kMaxS + e);
    pc.dst_step = kSub * kMaxS * 4;
    pc.row = r;
  }
  return pc;
}

// The plain-load path (S < 16 or pieces that do not fit): sub-chunk sb of a
// per-chain operand, zeros past T and Di.
template <typename E>
__device__ __forceinline__ void stage_chains_plain(E* tile, const E* __restrict__ x, int64_t b,
                                                   int T, int Di, int di0, int t0, int sb,
                                                   int tid) {
  for (int i = tid; i < kSub * kChains; i += kThreads) {
    const int r = sb * kSub + i / kChains, ch = i % kChains, t = t0 + r;
    const bool ok = t < T && di0 + ch < Di;
    tile[r * kChains + ch] = ok ? x[(b * T + t) * Di + di0 + ch] : from_f32<E>(0.f);
  }
}

// The same for B or C [B, T, S] (zeros past T and S).
__device__ __forceinline__ void stage_states_plain(float* tile, const float* __restrict__ x,
                                                   int64_t b, int T, int S, int t0, int sb,
                                                   int tid) {
  for (int i = tid; i < kSub * kMaxS; i += kThreads) {
    const int r = sb * kSub + i / kMaxS, s = i % kMaxS, t = t0 + r;
    tile[r * kMaxS + s] = t < T && s < S ? x[(b * T + t) * S + s] : 0.f;
  }
}

// Rows 0 .. len - 1 of src[r * kChains + chain] into the chunk at token t0
// of x [B, T, Di] for the block's chains (16-byte stores on the vector
// path; nothing past Di).
template <bool kVec, typename E>
__device__ __forceinline__ void unstage_chains(E* __restrict__ x, const E* src, int64_t b,
                                               int T, int Di, int di0, int t0, int len,
                                               int tid) {
  if (kVec) {
    constexpr int kE = 16 / static_cast<int>(sizeof(E));
    constexpr int kP = kChains / kE;
    for (int i = tid; i < len * kP; i += kThreads) {
      const int r = i / kP, e = (i % kP) * kE;
      if (di0 + e < Di)
        *reinterpret_cast<uint4*>(x + ((b * T + t0 + r) * Di + di0 + e)) =
            *reinterpret_cast<const uint4*>(src + r * kChains + e);
    }
  } else {
    for (int i = tid; i < len * kChains; i += kThreads) {
      const int r = i / kChains, ch = i % kChains;
      if (di0 + ch < Di) x[(b * T + t0 + r) * Di + di0 + ch] = src[r * kChains + ch];
    }
  }
}


__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A block of the two block passes: (b, chunk c, chain group) from
// blockIdx.x, groups fastest.
struct Place {
  int64_t b, bc;  // bc = b * nc + c
  int c, grp, di0, di, chain, q, t0;
  bool live;
  __device__ __forceinline__ Place(int T, int Di) {
    const int ngrp = (Di + kChains - 1) / kChains, nc = (T + kChunk - 1) / kChunk;
    grp = static_cast<int>(blockIdx.x % ngrp);
    bc = blockIdx.x / ngrp;
    c = static_cast<int>(bc % nc);
    b = bc / nc;
    q = threadIdx.x % kLanes;
    chain = threadIdx.x / kLanes;
    di0 = grp * kChains;
    t0 = c * kChunk;
    // A chain past Di computes on zero operands with the group's first
    // chain's parameters and writes nothing: every lane takes part in the
    // shuffles and barriers.
    live = di0 + chain < Di;
    di = live ? di0 + chain : di0;
  }
};

// Pass 1: what chunk c hands the chunk before it when its own carry-in is
// zero, L (per state), and its sum of dt (per chain), for the fold.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) ssm_bwd_carry_kernel(
    const float* __restrict__ dt, const float* __restrict__ cm, const float* __restrict__ log_a,
    const float* __restrict__ dy, float* __restrict__ lpart, float* __restrict__ sdt_part, int T,
    int Di, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CarryTile& tl = *reinterpret_cast<CarryTile*>(smem_raw);
  const Place p(T, Di);
  const int tid = threadIdx.x;
  if (kVec) {
    const Piece pdt = chain_piece(dt, tl.dt, p.b, T, Di, p.di0, p.t0, tid);
    const Piece pdy = chain_piece(dy, tl.dy, p.b, T, Di, p.di0, p.t0, tid);
    const Piece pc = state_piece(cm, tl.c, p.b, T, p.t0, tid);
#pragma unroll
    for (int sb = 0; sb < kChunk / kSub; ++sb) {
      const int rows = T - p.t0 - sb * kSub;
      pdt.copy(sb, rows);
      pdy.copy(sb, rows);
      pc.copy(sb, rows);
    }
    tf32x3::cp_async_commit();
  } else {
    for (int sb = kChunk / kSub - 1; sb >= 0; --sb) {
      stage_chains_plain(tl.dt, dt, p.b, T, Di, p.di0, p.t0, sb, tid);
      stage_chains_plain(tl.dy, dy, p.b, T, Di, p.di0, p.t0, sb, tid);
      stage_states_plain(tl.c, cm, p.b, T, S, p.t0, sb, tid);
    }
  }
  float a[kPer], l[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = p.q * kPer + j;
    a[j] = s < S ? -expf(log_a[static_cast<int64_t>(p.di) * S + s]) * kLog2e : 0.f;
    l[j] = 0.f;
  }
  float sdt = 0.f;
  tf32x3::cp_async_wait<0>();
  __syncthreads();
  // Tokens past T read the zero fill: decay 1, no term.
#pragma unroll 16
  for (int r = kChunk - 1; r >= 0; --r) {
    const float cd = tl.dt[r * kChains + p.chain], dyv = tl.dy[r * kChains + p.chain];
    const float4 cv = ld4(&tl.c[r * kMaxS + p.q * kPer]);
    const float cc[kPer] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int j = 0; j < kPer; ++j) l[j] = ssm_exp2(cd * a[j]) * fmaf(cc[j], dyv, l[j]);
    sdt += cd;
  }
  if (!p.live) return;
  const int64_t row = p.bc * Di + p.di;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = p.q * kPer + j;
    if (s < S) lpart[row * S + s] = l[j];
  }
  if (p.q == 0) sdt_part[row] = sdt;
}

// Pass 2: the carry that enters every chunk, from d_final down the chunks in
// order: carry_{c-1} = 2^(a sum dt_c) carry_c + L_c.
__global__ void __launch_bounds__(kFoldThreads) ssm_bwd_fold_kernel(
    const float* __restrict__ log_a, const float* __restrict__ d_final,
    const float* __restrict__ lpart, const float* __restrict__ sdt_part,
    float* __restrict__ carries, int B, int T, int Di, int S) {
  const int64_t n = static_cast<int64_t>(Di) * S;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kFoldThreads + threadIdx.x;
  if (i >= B * n) return;
  const int64_t b = i / n, j = i % n, di = j / S;
  const int nc = (T + kChunk - 1) / kChunk;
  const float a = -expf(log_a[j]) * kLog2e;
  float carry = d_final != nullptr ? d_final[i] : 0.f;
#pragma unroll 8
  for (int c = nc - 1; c >= 0; --c) {
    const int64_t bc = b * nc + c;
    carries[bc * n + j] = carry;
    if (c > 0) carry = fmaf(ssm_exp2(a * sdt_part[bc * Di + di]), carry, lpart[bc * n + j]);
  }
}

// Pass 3: the gradients of chunk c from its folded carry. The plain-load
// path (S < 16, or rows that are not whole 16-byte pieces) is bounded at
// one block an SM fewer: at kMinBlocks it spills.
template <typename TU, bool kVec>
__global__ void __launch_bounds__(kThreads, kVec ? kMinBlocks : kMinBlocks - 1)
    ssm_bwd_chunk_kernel(
    const TU* __restrict__ u, const float* __restrict__ dt, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ log_a,
    const float* __restrict__ d_skip, const float* __restrict__ dy,
    const float* __restrict__ states, const float* __restrict__ carries, TU* __restrict__ du,
    float* __restrict__ ddt, float* __restrict__ dstate0, float* __restrict__ part,
    float* __restrict__ dla_part, float* __restrict__ dds_part, int B, int T, int Di, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile<TU>& tl = *reinterpret_cast<Tile<TU>*>(smem_raw);
  // dB's and dC's terms of kGroup tokens, red[(k * kChains + chain) * kRed
  // + v]; the 16-byte pieces of an odd chain's row swap halves (dB's and
  // dC's), so that two chains of a quarter-warp store to distinct banks.
  float* red = reinterpret_cast<float*>(smem_raw + sizeof(Tile<TU>));
  const Place p(T, Di);
  const int tid = threadIdx.x, q = p.q, chain = p.chain;
  if (kVec) {
    constexpr int kStatePieces = kSub * kMaxS / 4;
    static_assert(2 * kStatePieces <= kThreads, "B's and C's pieces, one a thread");
    const Piece pu = chain_piece(u, tl.u, p.b, T, Di, p.di0, p.t0, tid);
    const Piece pdt = chain_piece(dt, tl.dt, p.b, T, Di, p.di0, p.t0, tid);
    const Piece pdy = chain_piece(dy, tl.dy, p.b, T, Di, p.di0, p.t0, tid);
    const Piece pbc = tid < kStatePieces ? state_piece(bm, tl.b, p.b, T, p.t0, tid)
                                         : state_piece(cm, tl.c, p.b, T, p.t0, tid - kStatePieces);
#pragma unroll
    for (int sb = 0; sb < kChunk / kSub; ++sb) {
      const int rows = T - p.t0 - sb * kSub;
      pu.copy(sb, rows);
      pdt.copy(sb, rows);
      pdy.copy(sb, rows);
      pbc.copy(sb, rows);
    }
    tf32x3::cp_async_commit();
  } else {
    for (int sb = kChunk / kSub - 1; sb >= 0; --sb) {
      stage_chains_plain(tl.u, u, p.b, T, Di, p.di0, p.t0, sb, tid);
      stage_chains_plain(tl.dt, dt, p.b, T, Di, p.di0, p.t0, sb, tid);
      stage_chains_plain(tl.dy, dy, p.b, T, Di, p.di0, p.t0, sb, tid);
      stage_states_plain(tl.b, bm, p.b, T, S, p.t0, sb, tid);
      stage_states_plain(tl.c, cm, p.b, T, S, p.t0, sb, tid);
    }
  }
  const int nsub = (T + kSub - 1) / kSub;
  const int64_t row = p.bc * Di + p.di;
  // The forward's a = -expf(log_a) * log2(e), so that h has its bits.
  float a[kPer], carry[kPer], dla[kPer];
  bool on[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = q * kPer + j;
    on[j] = p.live && s < S;
    a[j] = s < S ? -expf(log_a[static_cast<int64_t>(p.di) * S + s]) * kLog2e : 0.f;
    carry[j] = on[j] ? carries[row * S + s] : 0.f;
    dla[j] = 0.f;
  }
  const float dsk = d_skip[p.di];
  float dds = 0.f;
  const int len = T - p.t0 < kChunk ? T - p.t0 : kChunk;
  const int sw = (chain & 1) * 4;
  float* const red_b = red + chain * kRed + ((q ^ sw) * kPer);
  float* const red_c = red + chain * kRed + (((q + kLanes) ^ sw) * kPer);
  tf32x3::cp_async_wait<0>();
  __syncthreads();
  for (int sb = (len + kSub - 1) / kSub - 1; sb >= 0; --sb) {
    const int r0 = sb * kSub;
    // h of the sub-chunk's kSub tokens, from the state the forward kept at
    // its start (tokens past T read the zero fill: h stays).
    float h0[kPer], h[kSub][kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      h0[j] = on[j] ? states[((p.b * nsub + (p.t0 + r0) / kSub) * Di + p.di) * S + q * kPer + j]
                    : 0.f;
#pragma unroll
    for (int k = 0; k < kSub; ++k) {
      const int r = r0 + k;
      const float cd = tl.dt[r * kChains + chain];
      const float dtu = cd * to_f32(tl.u[r * kChains + chain]);
      const float4 bv = ld4(&tl.b[r * kMaxS + q * kPer]);
      const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        h[k][j] = fmaf(ssm_exp2(cd * a[j]), k > 0 ? h[k - 1][j] : h0[j], dtu * bb[j]);
    }
    // The sweep back, kGroup tokens at a time.
#pragma unroll
    for (int g0 = kSub - kGroup; g0 >= 0; g0 -= kGroup) {
#pragma unroll
      for (int kk = kGroup - 1; kk >= 0; --kk) {
        const int k = g0 + kk, r = r0 + k;
        const float cd = tl.dt[r * kChains + chain];
        const float cu = to_f32(tl.u[r * kChains + chain]);
        const float dyv = tl.dy[r * kChains + chain];
        const float4 bv = ld4(&tl.b[r * kMaxS + q * kPer]);
        const float4 cv = ld4(&tl.c[r * kMaxS + q * kPer]);
        const float bb[kPer] = {bv.x, bv.y, bv.z, bv.w};
        const float cc[kPer] = {cv.x, cv.y, cv.z, cv.w};
        const float dtu = cd * cu;
        // ddt = ln(2) sum_s a g decay h_{t-1} + u sum_s g B (A = a ln 2):
        // its second sum is du's.
        float sgb = 0.f, sga = 0.f, pb[kPer], pc[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float dec = ssm_exp2(cd * a[j]);
          const float g = fmaf(cc[j], dyv, carry[j]);
          carry[j] = dec * g;
          const float gh = g * (dec * (k > 0 ? h[k - 1][j] : h0[j]));
          dla[j] = fmaf(gh, cd, dla[j]);
          sgb = fmaf(g, bb[j], sgb);
          sga = fmaf(a[j], gh, sga);
          pb[j] = g * dtu;
          pc[j] = dyv * h[k][j];
        }
        // The two sums over the chain's 16 states: lanes 0-1 keep sum g B
        // and take their partner's, lanes 2-3 sum a g decay h; each pair
        // then sums over itself, and lanes 2-3 take sum g B from 0-1. du and
        // ddt replace the token's u and dt in the tile (every lane of the
        // chain has read them: the shuffles come after), which goes out
        // whole at the chunk's end.
        const bool upper = q >= 2;
        float v = (upper ? sga : sgb) + __shfl_xor_sync(kAll, upper ? sgb : sga, 2);
        v += __shfl_xor_sync(kAll, v, 1);
        const float other = __shfl_xor_sync(kAll, v, 2);
        if (q == 0) tl.u[r * kChains + chain] = from_f32<TU>(fmaf(cd, v, dsk * dyv));
        if (q == 2) tl.dt[r * kChains + chain] = fmaf(cu, other, v * kLn2);
        dds = fmaf(dyv, cu, dds);
        *reinterpret_cast<float4*>(red_b + kk * kChains * kRed) =
            make_float4(pb[0], pb[1], pb[2], pb[3]);
        *reinterpret_cast<float4*>(red_c + kk * kChains * kRed) =
            make_float4(pc[0], pc[1], pc[2], pc[3]);
      }
      __syncthreads();
      // The block's sums of dB and dC over its chains, in chain order.
      for (int o = tid; o < kGroup * kRed; o += kThreads) {
        const int kk = o / kRed, v = o % kRed, t = p.t0 + r0 + g0 + kk;
        const float* col = red + kk * kChains * kRed + v % kPer;
        const int even = (v / kPer) * kPer, odd = ((v / kPer) ^ 4) * kPer;
        // Four running sums (chains 4i + k), then (s0 + s1) + (s2 + s3).
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ch = 0; ch < kChains; ++ch)
          acc[ch % 4] += col[ch * kRed + (ch & 1 ? odd : even)];
        const float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        if (t < T) part[((static_cast<int64_t>(p.grp) * B + p.b) * T + t) * kRed + v] = sum;
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int s = q * kPer + j;
    if (!on[j]) continue;
    dla_part[row * S + s] = dla[j];
    if (p.c == 0) dstate0[(p.b * Di + p.di) * S + s] = carry[j];
  }
  if (p.live && q == 0) dds_part[row] = dds;
  __syncthreads();
  unstage_chains<kVec>(du, tl.u, p.b, T, Di, p.di0, p.t0, len, tid);
  unstage_chains<kVec>(ddt, tl.dt, p.b, T, Di, p.di0, p.t0, len, tid);
}

// Pass 4: dB and dC over the chain groups in order, dlog_a and dd_skip over
// (b, chunk) in order.
__global__ void __launch_bounds__(kReduceThreads) ssm_bwd_reduce_kernel(
    const float* __restrict__ part, const float* __restrict__ dla_part,
    const float* __restrict__ dds_part, const float* __restrict__ log_a, float* __restrict__ dbm,
    float* __restrict__ dcm, float* __restrict__ dlog_a, float* __restrict__ dd_skip, int B,
    int T, int Di, int S) {
  const int ngrp = (Di + kChains - 1) / kChains;
  const int nk = B * ((T + kChunk - 1) / kChunk);
  const int64_t n1 = static_cast<int64_t>(B) * T * kRed, n2 = static_cast<int64_t>(Di) * S;
  const int64_t total = n1 + n2 + Di;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * kReduceThreads) {
    if (i < n1) {
      const int64_t row = i / kRed;
      const int col = static_cast<int>(i % kRed), s = col % kMaxS;
      if (s >= S) continue;
      float sum = 0.f;
#pragma unroll 16
      for (int k = 0; k < ngrp; ++k) sum += part[k * n1 + i];
      (col < kMaxS ? dbm : dcm)[row * S + s] = sum;
    } else if (i < n1 + n2) {
      const int64_t j = i - n1;
      float sum = 0.f;
#pragma unroll 8
      for (int k = 0; k < nk; ++k) sum += dla_part[k * n2 + j];
      dlog_a[j] = -expf(log_a[j]) * sum;
    } else {
      const int64_t j = i - n1 - n2;
      float sum = 0.f;
#pragma unroll 8
      for (int k = 0; k < nk; ++k) sum += dds_part[k * static_cast<int64_t>(Di) + j];
      dd_skip[j] = sum;
    }
  }
}

// Ask once a kernel for the shared memory it takes beyond 48 KB. Not a
// stream operation, so later launches can be captured into a CUDA graph.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The grid of pass `kernel` (0 carry, 1 fold, 2 chunk, 3 reduce), in blocks.
int64_t pass_blocks(int kernel, int B, int T, int Di, int S) {
  const int64_t nc = (T + kChunk - 1) / kChunk, ngrp = (Di + kChains - 1) / kChains;
  if (kernel == 0 || kernel == 2) return B * nc * ngrp;
  if (kernel == 1) return (static_cast<int64_t>(B) * Di * S + kFoldThreads - 1) / kFoldThreads;
  if (kernel != 3) return -1;
  const int64_t total = static_cast<int64_t>(B) * T * kRed + static_cast<int64_t>(Di) * S + Di;
  const int64_t blocks = (total + kReduceThreads - 1) / kReduceThreads;
  return blocks < kReduceMaxBlocks ? blocks : kReduceMaxBlocks;
}

// Floats of scratch buffer `i`: 0 part (dB's and dC's partial sums a chain
// group), 1 spart (per (b, chunk, di, s): L, the carries, dlog_a's terms), 2
// cpart (per (b, chunk, di): the sums of dt, dd_skip's terms).
int64_t scratch_floats(int i, int B, int T, int Di, int S) {
  const int64_t nc = (T + kChunk - 1) / kChunk, ngrp = (Di + kChains - 1) / kChains;
  if (i == 0) return ngrp * B * T * kRed;
  if (i == 1) return 3 * B * nc * Di * S;
  if (i == 2) return 2 * B * nc * Di;
  return -1;
}

template <typename TU, bool kVec>
int launch_passes(const TU* u, const float* const f[], TU* du, float* const o[],
                  float* const r[], int B, int T, int Di, int S, cudaStream_t st) {
  const int64_t blocks = pass_blocks(0, B, T, Di, S), fold_blocks = pass_blocks(1, B, T, Di, S);
  if (blocks > 0x7fffffff || fold_blocks > 0x7fffffff) return -1;
  const int64_t per_state = scratch_floats(1, B, T, Di, S) / 3;
  const int64_t per_chain = scratch_floats(2, B, T, Di, S) / 2;
  float* const lpart = o[3];
  float* const carries = o[3] + per_state;
  float* const dla_part = o[3] + 2 * per_state;
  float* const sdt_part = o[4];
  float* const dds_part = o[4] + per_chain;
  const unsigned grid = static_cast<unsigned>(blocks);
  constexpr int carry_smem = static_cast<int>(sizeof(CarryTile));
  constexpr int chunk_smem = chunk_smem_bytes<TU>();
  static const cudaError_t e = allow_smem(ssm_bwd_chunk_kernel<TU, kVec>, chunk_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssm_bwd_carry_kernel<kVec><<<grid, kThreads, carry_smem, st>>>(f[0], f[2], f[3], f[5], lpart,
                                                                 sdt_part, T, Di, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_bwd_fold_kernel<<<static_cast<unsigned>(fold_blocks), kFoldThreads, 0, st>>>(
      f[3], f[6], lpart, sdt_part, carries, B, T, Di, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_bwd_chunk_kernel<TU, kVec><<<grid, kThreads, chunk_smem, st>>>(
      u, f[0], f[1], f[2], f[3], f[4], f[5], f[7], carries, du, o[0], o[1], o[2], dla_part,
      dds_part, B, T, Di, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_bwd_reduce_kernel<<<static_cast<unsigned>(pass_blocks(3, B, T, Di, S)), kReduceThreads, 0,
                          st>>>(o[2], dla_part, dds_part, f[3], r[0], r[1], r[2], r[3], B, T, Di,
                                S);
  return static_cast<int>(cudaGetLastError());
}

template <typename TU>
int launch(const void* u, const float* const f[], void* du, float* const o[],
           float* const r[], int B, int T, int Di, int S, cudaStream_t st) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = S == kMaxS && Di % (16 / static_cast<int>(sizeof(TU))) == 0 && aligned(u) &&
                   aligned(f[0]) && aligned(f[1]) && aligned(f[2]) && aligned(f[5]) &&
                   aligned(du) && aligned(o[0]);
  const TU* up = static_cast<const TU*>(u);
  TU* dup = static_cast<TU*>(du);
  return vec ? launch_passes<TU, true>(up, f, dup, o, r, B, T, Di, S, st)
             : launch_passes<TU, false>(up, f, dup, o, r, B, T, Di, S, st);
}

}  // namespace

extern "C" {

// The selective scan's gradients. Inputs: u [B, T, Di] (bf16 != 0:
// bfloat16, else float32); dt [B, T, Di], bm and cm [B, T, S], log_a [Di, S],
// d_skip [Di], dy [B, T, Di], d_final [B, Di, S] or null (zero), states
// [B, ceil(T / 16), Di, S] as selective_scan_states_launch wrote them: all
// float32 and contiguous. Outputs: du [B, T, Di] in u's dtype; ddt [B, T, Di],
// dbm and dcm [B, T, S], dlog_a [Di, S], dd_skip [Di], dstate0 [B, Di, S],
// float32. Scratch, float32: part, spart and cpart of
// selective_scan_bwd_scratch_floats(0 | 1 | 2, ...) floats. 1 <= S <= 16,
// T >= 1. Four launches on `stream`; returns cudaGetLastError() after each
// (0 on success), or -1 for an unsupported S or a grid too large.
int selective_scan_bwd_launch(const void* u, const void* dt, const void* bm, const void* cm,
                              const void* log_a, const void* d_skip, const void* dy,
                              const void* d_final, const void* states, void* du, void* ddt,
                              void* dbm, void* dcm, void* dlog_a, void* dd_skip, void* dstate0,
                              void* part, void* spart, void* cpart, int B, int T, int Di, int S,
                              int bf16, void* stream) {
  if (S < 1 || S > kMaxS) return -1;
  if (B <= 0 || T <= 0 || Di <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f[] = {static_cast<const float*>(dt),     static_cast<const float*>(bm),
                      static_cast<const float*>(cm),     static_cast<const float*>(log_a),
                      static_cast<const float*>(d_skip), static_cast<const float*>(dy),
                      static_cast<const float*>(d_final), static_cast<const float*>(states)};
  float* o[] = {static_cast<float*>(ddt), static_cast<float*>(dstate0),
                static_cast<float*>(part), static_cast<float*>(spart),
                static_cast<float*>(cpart)};
  float* r[] = {static_cast<float*>(dbm), static_cast<float*>(dcm), static_cast<float*>(dlog_a),
                static_cast<float*>(dd_skip)};
  return bf16 ? launch<__nv_bfloat16>(u, f, du, o, r, B, T, Di, S, st)
              : launch<float>(u, f, du, o, r, B, T, Di, S, st);
}

// Floats of scratch buffer `i` (0 part, 1 spart, 2 cpart) at (B, T, Di, S);
// -1 for another i.
long long selective_scan_bwd_scratch_floats(int i, int B, int T, int Di, int S) {
  return scratch_floats(i, B, T, Di, S);
}

// Blocks of pass `kernel` (0 carry, 1 fold, 2 chunk, 3 reduce) at (B, T, Di,
// S), as selective_scan_bwd_launch launches them; -1 for another kernel.
long long selective_scan_bwd_grid(int kernel, int B, int T, int Di, int S) {
  return pass_blocks(kernel, B, T, Di, S);
}

// The ex2 the four passes form at (B, T, Di, S): the carry pass one a state
// and token, the chunk pass two (its recompute and its sweep), both over
// whole chunks; the fold one a state and chunk after the last.
long long selective_scan_bwd_exp2_count(int B, int T, int Di, int S) {
  const int64_t nc = (T + kChunk - 1) / kChunk, states = static_cast<int64_t>(B) * Di * S;
  return 3 * states * nc * kChunk + states * (nc - 1);
}

// Tokens between the forward's saved states that the backward reads
// (ssm_scan.cu's kChunk).
int selective_scan_bwd_state_interval() { return kSub; }

// Dynamic shared memory of pass `kernel` (0 carry, 1 fold, 2 chunk, 3
// reduce), in bytes.
int selective_scan_bwd_smem_bytes(int kernel, int bf16) {
  if (kernel == 0) return static_cast<int>(sizeof(CarryTile));
  if (kernel == 2) return bf16 ? chunk_smem_bytes<__nv_bfloat16>() : chunk_smem_bytes<float>();
  return 0;
}

// Resident blocks an SM of pass `kernel` on the path of 16-byte copies, as
// the runtime reckons them (-1 on an error).
int selective_scan_bwd_blocks_per_sm(int kernel, int bf16) {
  int n = -1;
  const int smem = selective_scan_bwd_smem_bytes(kernel, bf16);
  cudaError_t e = cudaSuccess;
  if (kernel == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssm_bwd_carry_kernel<true>, kThreads,
                                                      smem);
  } else if (kernel == 1) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssm_bwd_fold_kernel, kFoldThreads, 0);
  } else if (kernel == 2) {
    e = bf16 ? allow_smem(ssm_bwd_chunk_kernel<__nv_bfloat16, true>, smem)
             : allow_smem(ssm_bwd_chunk_kernel<float, true>, smem);
    if (e == cudaSuccess)
      e = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, ssm_bwd_chunk_kernel<__nv_bfloat16, true>, kThreads, smem)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, ssm_bwd_chunk_kernel<float, true>, kThreads, smem);
  } else if (kernel == 3) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssm_bwd_reduce_kernel, kReduceThreads,
                                                      0);
  }
  return e == cudaSuccess ? n : -1;
}

}  // extern "C"
