// Banded ballistic backprojection, forward.
//
// Replaces drtvam_tpu/ops/backproject.py:_fwd_banded (kernel body
// _make_fwd_banded_kernel): the forward of bp_fwd, with each voxel's taps
// kept only inside its (angle, 32 x 64 film block)'s band of 256 DMD
// columns, [u0[a, block], min(u0 + 256, U)).
//
// On the TPU the band is a staging width: B_a is built densely in VMEM
// and the band cuts its contraction from U rows to 256. On Hopper no B
// is built, and the band is a mask on the layout: each (angle, 32x32
// tile)'s column window is computed from the band-masked taps
// (ops/backproject.py tile_windows with the band starts), and every
// 32x32 tile lies inside one 32 x 64 block, so the window holds exactly
// the tile's in-band taps. make_taps with the window as its range then
// drops exactly the taps outside the band. A window is at most 256
// columns wide, so there is no limit on U.
//
// Bound on the H100: as bp_fwd, 2 FMAs per (angle, in-band tap, z):
// 18.8 GFLOP for the synthetic bench fields against 0.44 GB of
// compulsory traffic, the float32 FMA rate (0.28 ms, PERF.md). The
// kernel is bp_fwd's (bp_fwd_kernel.cuh, design there), reading the
// block-major fields in place.
#include "bp_fwd_kernel.cuh"

// Pz (A, Zf, U); F (A, 2, T * 2048) block-major packed fields; win
// (A, ceil(Y/32) * ceil(X/32), 2) the band-masked column windows, maxw
// the widest; out (Zf, Y * X) raster. Y % 32 == 0, X % 64 == 0. See
// fwd_run.
extern "C" int bp_fwd_band(const float* Pz, const float* F, const int* win,
                           float* out, int A, int Zf, int U, int Y, int X,
                           int maxw, void* stream) {
  return fwd_run<float, BlockMajorFields>(Pz, F, win, nullptr, out, A, Zf,
                                          U, Y, X, maxw, stream);
}
