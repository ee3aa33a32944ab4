// Banded ballistic backprojection, adjoint, bf16 operand.
//
// Replaces drtvam_tpu/ops/backproject.py:_bwd_banded(bf16=True) (kernel
// body _make_bwd_banded_kernel, bf16 branch): the exact transpose of
// bp_fwd_band_bf16, dL and each in-band tap weight rounded to bfloat16,
// float32 sums.
//
// As in bp_bwd_band, the band is a mask on the layout (the band-masked
// voxel lists, raster voxel indices), and the kernel is bp_bwd's gather
// (bp_bwd_kernel.cuh) with T = __nv_bfloat16 (see bp_bwd_bf16.cu).
// Bound: 2 FMAs per (angle, in-band tap, z) at the float32 rate. No
// atomics; bitwise reproducible.
#include "bp_bwd_kernel.cuh"

// dL (Zf, Y * X) float32 raster; ptr, ent the band-masked voxel lists;
// dLt (YX, Zp) bf16 scratch; out (A, Zf, U): see bwd_run.
extern "C" int bp_bwd_band_bf16(const float* dL, const int* ptr,
                                const int* ent, __nv_bfloat16* dLt,
                                float* out, int A, int Zf, int U, int YX,
                                void* stream) {
  return bwd_run<__nv_bfloat16>(dL, ptr, ent, dLt, out, A, Zf, U, YX, stream);
}
