// Banded ballistic backprojection, forward, bf16 operand.
//
// Replaces drtvam_tpu/ops/backproject.py:_fwd_banded(bf16=True) (kernel
// body _make_fwd_banded_kernel, bf16 branch): the forward of
// bp_fwd_bf16 with each voxel's taps kept only inside its (angle,
// 32 x 64 film block)'s band of 256 DMD columns. Pz and every kept tap
// weight rounded to bfloat16, float32 sums.
//
// As in bp_fwd_band, the band is a mask on the layout (the band-masked
// column windows), and the kernel is bp_fwd_kernel.cuh reading the
// block-major fields in place, here with T = __nv_bfloat16 (see
// bp_fwd_bf16.cu). Bound: 2 FMAs per (angle, in-band tap, z) at the
// float32 rate.
#include "bp_fwd_kernel.cuh"

// Pz (A, Zf, U) float32; F (A, 2, T * 2048) block-major packed fields;
// win the band-masked column windows, maxw the widest; Pt (A, U, Zp)
// bf16 scratch, Zp = Zf rounded up to 8; out (Zf, Y * X) raster.
// Y % 32 == 0, X % 64 == 0. See fwd_run.
extern "C" int bp_fwd_band_bf16(const float* Pz, const float* F,
                                const int* win, __nv_bfloat16* Pt, float* out,
                                int A, int Zf, int U, int Y, int X, int maxw,
                                void* stream) {
  return fwd_run<__nv_bfloat16, BlockMajorFields>(Pz, F, win, Pt, out, A, Zf,
                                                  U, Y, X, maxw, stream);
}
