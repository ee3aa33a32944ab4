// Dense ballistic backprojection, forward, bf16 operand.
//
// Replaces drtvam_tpu/ops/backproject.py:_fwd_pallas(bf16=True) (kernel
// body _make_fwd_kernel, bf16 branch): dose(Zf, YX) = sum_a bf16(Pz_a) @
// bf16(B_a), float32 sums. On the TPU the point was to halve the Pz
// stream from HBM into the MXU; the MXU rounds each interpolation weight
// of B to bfloat16 as well, and so does this kernel.
//
// Bound on the H100: as bp_fwd, 2 FMAs per (angle, tap-carrying voxel,
// z) at the float32 rate (the bytes, Pz at 2 bytes, take less). The
// kernel is bp_fwd's windowed forward (bp_fwd_kernel.cuh, design there)
// with T = __nv_bfloat16: Pz is first rounded into a copy laid out
// (A, U, Zp), z innermost, so a window is staged in 16-byte copies and
// one 16-byte shared load gives a tap eight z-rows (four in float32):
// half the shared-memory bytes that hold bp_fwd back.
#include "bp_fwd_kernel.cuh"

// Pz (A, Zf, U) float32, F (A, 2, Y*X) raster packed fields, win
// (A, T, 2), Pt (A, U, Zp) bf16 scratch with Zp = Zf rounded up to 8,
// out (Zf, Y*X): see fwd_run.
extern "C" int bp_fwd_bf16(const float* Pz, const float* F, const int* win,
                           __nv_bfloat16* Pt, float* out, int A, int Zf,
                           int U, int Y, int X, int maxw, void* stream) {
  return fwd_run<__nv_bfloat16, RasterFields>(Pz, F, win, Pt, out, A, Zf, U,
                                              Y, X, maxw, stream);
}
