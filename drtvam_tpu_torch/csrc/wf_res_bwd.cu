// Hybrid engine's scattered residual, adjoint: the pattern gradient.
//
// Replaces the adjoint of drtvam_tpu/ops/march.py:913 trace_wavefront in
// its residual modes (XLA): the forward's paths replayed from the same
// counter-based random stream, each deposit gathering dL, a pixel's
// lanes summed in lane order on one thread and written once (times the
// ray weight), so the result is bitwise reproducible. The kernel and its
// per-lane set-up are wf_residual.cuh's (one pass for every estimator).
//
// Bound on the H100: the per-lane work, as wf_res_fwd; the few gathers
// read a dL volume that need not fit L2.
#include "wf_residual.cuh"

// P, M, tris, mask, active_pixels, order, starts, chords, chord_tab as
// for wf_res_fwd (chords null in a first-scatter mode: the geometric
// prologue); dL (n_cells,) loss gradient of the flat accumulator; grad
// (n_active,) output; counters (8,), (9,) with the prologue's, or null.
// Returns cudaGetLastError().
extern "C" int wf_res_bwd(const WfParams* P, const wf::WfMesh* M,
                          const float4* tris, const unsigned char* mask,
                          const float* dL, const int* active_pixels,
                          const int* order, const int* starts,
                          const float* chords, const float4* chord_tab,
                          float* grad, unsigned long long* counters,
                          void* stream) {
  const wf::ResArgs a = {*M,     tris,      mask,    dL,     active_pixels,
                         order,  starts,    chords,  chord_tab, grad,
                         counters, nullptr, nullptr, 0,      0};
  return wf::res_launch<false, false>(P, a, P->resy * P->n_groups, stream);
}

// The launch shape of P's instantiation (flags: bit 0 the counting one,
// bit 1 the prologue's; wf::info): 8 ints into info.
extern "C" int wf_res_bwd_info(const WfParams* P, int flags, int* info) {
  return wf::res_info<false, false>(P, flags, info);
}
