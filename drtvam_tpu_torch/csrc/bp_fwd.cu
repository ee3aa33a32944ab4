// Dense ballistic backprojection, forward.
//
// Replaces drtvam_tpu/ops/backproject.py:_fwd_pallas (kernel body
// _make_fwd_kernel): dose(Zf, YX) = sum_a sum_taps W * Pz[a, z, tap].
//
// Bound on the H100: the work is 2 FMAs per (angle, tap-carrying voxel,
// z), 18.8 GFLOP for the 36.7 M taps of the synthetic bench fields,
// against 0.44 GB of compulsory traffic, so the roofline is the float32
// FMA rate (0.28 ms, PERF.md). What holds a gather kernel back is the
// operand traffic around the FMAs: each FMA needs one Pz value, read
// from shared memory.
//
// The kernel is the windowed forward of bp_fwd_kernel.cuh (its design
// is described there), on raster fields F[a, 0 | 1, y * X + x]. Each
// (angle, 32x32 tile)'s window holds every tap of the tile in [0, U),
// so a tap outside it is outside [0, U) and is dropped, as in the plain
// version.
#include "bp_fwd_kernel.cuh"

// Pz (A, Zf, U), F (A, 2, Y*X) raster packed fields, win (A, T, 2),
// maxw, out (Zf, Y*X): see fwd_run.
extern "C" int bp_fwd(const float* Pz, const float* F, const int* win,
                      float* out, int A, int Zf, int U, int Y, int X,
                      int maxw, void* stream) {
  return fwd_run<float, RasterFields>(Pz, F, win, nullptr, out, A, Zf, U, Y,
                                      X, maxw, stream);
}
