// src/repro_torch/kernels/csrc/ssm_exp2.cuh on the CPU: 2^x by the C
// library, where the card takes it from the special-function unit
// (ex2.approx.ftz, about 2^-22 relative). The emulated scans are held
// against their plain versions within float32 rounding, not bit for bit.
#pragma once

#include <cmath>

#include "cuda_runtime.h"

inline float ssm_exp2(float x) { return std::exp2(x); }
