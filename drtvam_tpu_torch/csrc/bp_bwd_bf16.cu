// Dense ballistic backprojection, adjoint, bf16 operand.
//
// Replaces drtvam_tpu/ops/backproject.py:_bwd_pallas(bf16=True) (kernel
// body _make_bwd_kernel, bf16 branch): Pzbar[a, z, i] = sum_j bf16(dL[z,
// j]) * bf16(B_a[i, j]), float32 sums; the exact adjoint of bp_fwd_bf16
// on the rounded operands, as the JAX package's custom_vjp pairs them.
//
// Bound on the H100: as bp_bwd, 2 FMAs per (angle, tap-carrying voxel,
// z) at the float32 rate; what holds the gather back is reading each
// voxel's dL line once per angle through L2. The kernel is bp_bwd's
// gather (bp_bwd_kernel.cuh, design there) with T = __nv_bfloat16: dL is
// rounded as it is re-laid out, so a 128-row line is 256 bytes, half of
// bp_bwd's, and each list entry's weights are rounded as they load. No
// atomics; bitwise reproducible.
#include "bp_bwd_kernel.cuh"

// dL (Zf, YX) float32; ptr, ent the voxel lists of the packed fields;
// dLt (YX, Zp) bf16 scratch; out (A, Zf, U): see bwd_run.
extern "C" int bp_bwd_bf16(const float* dL, const int* ptr, const int* ent,
                           __nv_bfloat16* dLt, float* out, int A, int Zf,
                           int U, int YX, void* stream) {
  return bwd_run<__nv_bfloat16>(dL, ptr, ent, dLt, out, A, Zf, U, YX, stream);
}
