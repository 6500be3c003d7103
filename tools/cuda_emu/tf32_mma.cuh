// The helpers of src/repro_torch/kernels/csrc/tf32_mma.cuh on the CPU, for
// tools/scan_bwd_emulate.py and tools/ssm_emulate.py (they put this file
// where the sources' #include "tf32_mma.cuh" finds it).
//
// tf32: cvt.rna.tf32.f32 on the bits (round half away from zero to 10
// mantissa bits). mma8: the warp's fragments are exchanged through a
// per-warp array between two warp barriers (a: rows g, g + 8, columns t4,
// t4 + 4; b: rows t4, t4 + 4, column g; c: rows g, g + 8, columns 2 t4,
// 2 t4 + 1, with g = lane / 4, t4 = lane % 4), each operand cut to its TF32
// bits as the tensor cores read it, the sum taken in double. cp_async16:
// with EMU_CP_DEFER each thread keeps its copies and makes them only when
// cp_async_wait retires their group (a read of the tile before the wait
// and the barrier after it then sees the 0xff fill); without it the copy
// is made at once (a write that lands while others still read shows).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace tf32x3 {

inline uint32_t tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

inline void mma8(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int w = emu::warp_of(), l = threadIdx.x & 31;
  for (int i = 0; i < 4; ++i) emu::frag_a[w][l][i] = a[i];
  emu::frag_b[w][l][0] = b0;
  emu::frag_b[w][l][1] = b1;
  __syncwarp();
  const int g = l >> 2, t4 = l & 3;
  auto A = [&](int row, int k) {
    const int lane = (row % 8) * 4 + (k % 4), reg = (row < 8 ? 0 : 1) + (k < 4 ? 0 : 2);
    return (double)__uint_as_float(emu::frag_a[w][lane][reg] & 0xffffe000u);
  };
  auto B = [&](int k, int n) {
    return (double)__uint_as_float(emu::frag_b[w][n * 4 + (k % 4)][k < 4 ? 0 : 1] & 0xffffe000u);
  };
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t4 + (i & 1);
    double s = d[i];
    for (int k = 0; k < 8; ++k) s += A(row, k) * B(k, col);
    d[i] = (float)s;
  }
  __syncwarp();
}

inline void copy16(void* dst, const void* src, bool valid) {
  if (valid)
    std::memcpy(dst, src, 16);
  else
    std::memset(dst, 0, 16);
}

#ifdef EMU_CP_DEFER
struct Copy {
  void* dst;
  const void* src;
  bool valid;
};
inline thread_local std::vector<std::vector<Copy>> cp_groups;
inline thread_local std::vector<Copy> cp_open;
inline void cp_async16(void* dst, const void* src, bool valid) { cp_open.push_back({dst, src, valid}); }
inline void cp_async_commit() {
  cp_groups.push_back(std::move(cp_open));
  cp_open.clear();
}
template <int n>
inline void cp_async_wait() {
  while ((int)cp_groups.size() > n) {
    for (const Copy& c : cp_groups.front()) copy16(c.dst, c.src, c.valid);
    cp_groups.erase(cp_groups.begin());
  }
}
#else
inline void cp_async16(void* dst, const void* src, bool valid) { copy16(dst, src, valid); }
inline void cp_async_commit() {}
template <int n>
inline void cp_async_wait() {}
#endif

}  // namespace tf32x3
