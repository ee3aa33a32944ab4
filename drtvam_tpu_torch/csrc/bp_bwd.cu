// Dense ballistic backprojection, adjoint.
//
// Replaces drtvam_tpu/ops/backproject.py:_bwd_pallas (kernel body
// _make_bwd_kernel): Pzbar[a, z, i] = sum_j dL[z, j] * B_a[i, j], the
// exact transpose of bp_fwd.
//
// Bound on the H100: 2 FMAs per (angle, tap-carrying voxel, z), the
// same work as the forward (18.8 GFLOP for the 36.7 M taps of the
// synthetic bench fields), against 0.44 GB of compulsory traffic: the
// float32 FMA rate bounds it (0.28 ms, PERF.md). A scatter form (each
// voxel adds into its two columns) is held back by contended atomics: a
// warp's 32 neighbouring voxels land on one to three columns. This
// kernel is in gather (owner-computes) form instead, and what bounds it
// is reading each voxel's dL line once per angle (A x |dL| through L2).
//
// The kernel is the gather of bp_bwd_kernel.cuh (its design is
// described there), on voxel lists of the taps in [0, U).
#include "bp_bwd_kernel.cuh"

// dL (Zf, YX); ptr, ent the voxel lists of the packed fields; dLt
// (YX, Zp) scratch; out (A, Zf, U): see bwd_run.
extern "C" int bp_bwd(const float* dL, const int* ptr, const int* ent,
                      float* dLt, float* out, int A, int Zf, int U, int YX,
                      void* stream) {
  return bwd_run<float>(dL, ptr, ent, dLt, out, A, Zf, U, YX, stream);
}
