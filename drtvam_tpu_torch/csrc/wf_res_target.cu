// The dda residual forward's path pass with the target kept: persistent
// threads refilled lane by lane, the target's banks staged where they fit
// (wf_res_target.cuh, where the design is described).
//
// Replaces the primal of drtvam_tpu/ops/march.py:913 trace_wavefront in
// its residual modes for a scene that keeps the target mesh (the first
// scatter :328, :966-1002, or without a chord bank the geometric prologue
// :198-325; intersect_scene's MESH branch :151-190; the
// two-channel segments :405-417; dda_segment :586 as records; XLA). Its
// records are the one-pass path pass's (wf_res_path), in another order;
// wf_res_walk walks them.
//
// Bound on the H100: the bounces (~90 float32 operations each) and the
// target's grid walks (~20 operations a grid cell, ~40 a triangle test).
#include "wf_res_target.cuh"

// Whether the form runs P (a dda residual that keeps the target and
// transmits only): *runs 1 or 0. Returns 0.
extern "C" int wf_res_tgt_runs(const WfParams* P, int* runs) {
  *runs = wf::res_tgt_pick<false, true>(*P) != nullptr ? 1 : 0;
  return 0;
}

// The path pass over CTAs [c0, c1) of the launch order, arguments as
// wf_res_path's (wf_res_fwd.cu): each dda segment a record in recs at the
// next slot of *n_recs (zeroed by the caller; slots from cap on counted,
// not written); counters (8,) ((9,) without a chord bank: the
// prologue's iterations last) and slots (2,) or null; the banks staged
// where they fit smem_limit bytes and a CTA's share of the SM, else read
// from global memory. Returns cudaGetLastError().
extern "C" int wf_res_tgt_path(const WfParams* P, const wf::WfMesh* M,
                               const float4* tris, const unsigned char* mask,
                               int c0, int c1, const float* data,
                               const int* active_pixels, const int* order,
                               const int* starts, const float* chords,
                               const float4* chord_tab, float4* recs,
                               unsigned* n_recs, unsigned cap,
                               unsigned long long* counters,
                               unsigned long long* slots, int smem_limit,
                               void* stream) {
  const wf::ResArgs a = {*M,     tris,   mask,   data,   active_pixels,
                         order,  starts, chords, chord_tab, nullptr,
                         counters, recs, n_recs, cap,    c0,
                         slots};
  return wf::res_tgt_launch(P, a, c1, smem_limit, stream);
}

// The launch shape of P's instantiation at smem_limit (flags: bit 0 the
// counting one, bit 1 the prologue's): 8 ints into info (wf::info's).
extern "C" int wf_res_tgt_info(const WfParams* P, const wf::WfMesh* M,
                               int flags, int smem_limit, int* info) {
  return wf::res_tgt_info(P, M, flags, smem_limit, info);
}
