// Shared pieces of the four ballistic backprojection kernels.
//
// Forward:  dose(Zf, YX)    = sum_a Pz_a(Zf, U) @ B_a(U, YX)
// Adjoint:  Pzbar_a(Zf, U)  = dL(Zf, YX) @ B_a^T
// B_a[i, j] = W_aj * max(0, 1 - |u_aj - i|) has two nonzeros per column
// j: the linear-interpolation taps at i0 = floor(u_aj) and i0 + 1. On
// the TPU B is built densely in VMEM and contracted on the MXU, because
// gathers are slow there; here each kernel applies the two taps
// directly. A dense B on wgmma would do U/2 times the useful work, so
// the kernels stay on FMAs and spend their design on memory traffic.
//
// Two kernel templates serve the four entry points: the windowed
// forward (bp_fwd_kernel.cuh) and the gather adjoint
// (bp_bwd_kernel.cuh). The banded pair differs from the dense one only
// in which taps count, and that is fixed by the layout the engine builds
// (column windows, voxel lists), not by the kernels.
#pragma once

#include <cuda_runtime.h>

namespace bp {

struct Taps {
  int c0, c1;    // tap columns relative to the column base
  float w0, w1;  // tap weights, 0 for a tap outside [base, base + n)
};

// The two taps of one field cell (W, u). A tap is kept only if its
// column i lies in [base, base + n); a dropped tap gets weight 0 and
// relative column 0, so it contributes exactly nothing. Empty cells and
// padding carry W = 0 and u = -2: both taps fall outside any range.
__device__ __forceinline__ Taps make_taps(float W, float u, int base,
                                          int n) {
  const float fl = floorf(u);
  const int i0 = (int)fl - base;
  const float f = u - fl;
  const bool ok0 = i0 >= 0 && i0 < n;
  const bool ok1 = i0 + 1 >= 0 && i0 + 1 < n;
  Taps t;
  t.c0 = ok0 ? i0 : 0;
  t.w0 = ok0 ? W * (1.0f - f) : 0.0f;
  t.c1 = ok1 ? i0 + 1 : 0;
  t.w1 = ok1 ? W * f : 0.0f;
  return t;
}

// Asynchronous 4-byte copy global -> shared (cp.async, Ampere and
// later), and its group commit / wait.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace bp
