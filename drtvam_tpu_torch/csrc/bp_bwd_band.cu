// Banded ballistic backprojection, adjoint.
//
// Replaces drtvam_tpu/ops/backproject.py:_bwd_banded (kernel body
// _make_bwd_banded_kernel): the exact transpose of bp_fwd_band, each
// (angle, 32 x 64 film block) adding into Pzbar[a, :, u0 : u0 + 256].
//
// On the TPU the band is a staging width: each (angle, block) builds
// its 256-column slice of B_a^T in VMEM and adds a 256-column result
// into the output. On Hopper no B is built, and the band is a mask on
// the layout: the engine's voxel lists (ops/backproject.py voxel_lists
// with the band starts) hold each voxel's band-masked taps, with its
// raster index, so the gather walks exactly the in-band taps and reads
// dL in raster order.
//
// Bound on the H100: as bp_bwd, 2 FMAs per (angle, in-band tap, z), the
// float32 FMA rate (0.28 ms for the synthetic bench fields, PERF.md);
// what holds it back is reading each voxel's dL line once per angle
// through L2. The kernel is bp_bwd's gather (bp_bwd_kernel.cuh, design
// there): no atomics, every output element written once, in a fixed
// order, so the result is bitwise reproducible and the output is not
// zeroed first.
#include "bp_bwd_kernel.cuh"

// dL (Zf, Y * X) raster; ptr, ent the band-masked voxel lists; dLt
// (YX, Zp) scratch; out (A, Zf, U): see bwd_run.
extern "C" int bp_bwd_band(const float* dL, const int* ptr, const int* ent,
                           float* dLt, float* out, int A, int Zf, int U,
                           int YX, void* stream) {
  return bwd_run<float>(dL, ptr, ent, dLt, out, A, Zf, U, YX, stream);
}
