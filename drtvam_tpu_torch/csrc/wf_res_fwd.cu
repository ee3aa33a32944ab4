// Hybrid engine's scattered residual, forward: the flat dose accumulator
// of the deposits made after a path's first scatter.
//
// Replaces the primal of drtvam_tpu/ops/march.py:913 trace_wavefront in
// its residual modes (XLA: scattered_only :1064-1066, the chord-bank
// first scatter :328-420 with :966-1002, the geometric prologue in its
// place without a bank :198-325, the fast convex event loop :433-549). The kernels are wf_residual.cuh's: one lane a thread, one CTA
// per DMD row and angle group, no home-slice tile (a deposit follows a
// scatter into any direction, so it is one float atomicAdd into acc); the
// dda modes in two passes, the lanes' paths (wf_res_path) and then the
// walks of their segments (wf_res_walk). The sums are not bitwise
// reproducible from launch to launch.
//
// Bound on the H100: the delta fast loop by its per-lane work (the ray's
// draws, the first scatter, one or two events, each a few transcendentals);
// the dda walks by their voxel steps, each ~20 float32 operations and one
// float atomic into a dose grid larger than L2.
#include "wf_residual.cuh"

// P: scene and sampling parameters, P->residual the mode (SCAT_ONLY,
// FIRST_SCATTER or FAST_RESIDUAL; scattering and transmission only), the
// ratio and delta estimators (the dda's forward is wf_res_path then
// wf_res_walk); M, tris: the target's mesh and triangle rows (read when
// P->target is not 0; tris may be null otherwise); mask (Z, Y, X) the
// inside mask, read on a two-channel film (P->target 2) by the first
// scatter's seed and the fast residual's events (may be null otherwise);
// data (n_active,) pattern values; active_pixels, order, starts as for
// wf_fwd; chords (A * resx, 12) the chord bank and chord_tab (A * resx,
// 4) its table (wf_res_chords; both unused, may be null, for SCAT_ONLY;
// chord_tab null: each lane computes its entry; chords null in a
// first-scatter mode: each lane marches to its chord, the geometric
// prologue); acc (n_cells,) zeroed; counters (8,) as for wf_fwd, (9,)
// with the prologue's iterations last, or null. Returns
// cudaGetLastError().
extern "C" int wf_res_fwd(const WfParams* P, const wf::WfMesh* M,
                          const float4* tris, const unsigned char* mask,
                          const float* data, const int* active_pixels,
                          const int* order, const int* starts,
                          const float* chords, const float4* chord_tab,
                          float* acc, unsigned long long* counters,
                          void* stream) {
  const wf::ResArgs a = {*M,     tris,      mask, data,     active_pixels,
                         order,  starts,    chords, chord_tab, acc,
                         counters, nullptr, nullptr, 0,      0};
  return wf::res_launch<true, false>(P, a, P->resy * P->n_groups, stream);
}

// The dda forward's path pass over CTAs [c0, c1) of the launch order
// (P, M, tris, mask as for wf_res_fwd): each dda segment of the lanes
// becomes a record (8 floats) in recs at the next slot of *n_recs
// (zeroed by the caller); slots from cap on are counted, not written.
// counters (8,): the bounce iterations and the target's grid cells,
// triangles and walks ((9,) without a chord bank: the prologue's
// iterations last), and slots (2,): the lane slots of the bounce
// iterations and of the triangle tests; or null.
extern "C" int wf_res_path(const WfParams* P, const wf::WfMesh* M,
                           const float4* tris, const unsigned char* mask,
                           int c0, int c1, const float* data,
                           const int* active_pixels, const int* order,
                           const int* starts, const float* chords,
                           const float4* chord_tab, float4* recs,
                           unsigned* n_recs, unsigned cap,
                           unsigned long long* counters,
                           unsigned long long* slots, void* stream) {
  const wf::ResArgs a = {*M,     tris,   mask,   data,   active_pixels,
                         order,  starts, chords, chord_tab, nullptr,
                         counters, recs, n_recs, cap,    c0,
                         slots};
  return wf::res_launch<true, true>(P, a, c1, stream);
}

// The walk pass: the n records of recs walked into acc (n_cells,), the
// deposits in z-slices [zlo, zhi) (on a two-channel film, P->target 2,
// to the channel in the sign of each record's maxt); next a zeroed
// counter. counters (5,): the walking threads' steps, the steps and
// deposits (global) in the slab and the lane slots, or null.
extern "C" int wf_res_walk(const WfParams* P, const float4* recs, unsigned n,
                           unsigned* next, int zlo, int zhi, float* acc,
                           unsigned long long* counters, void* stream) {
  return wf::walk_launch(P, recs, n, next, zlo, zhi, acc, counters, stream);
}

// The chord table tab (n, 4) float4 of the chord bank (n, 12) at sigma_t st
extern "C" int wf_res_chords(const float* bank, int n, float st,
                             float4* tab, void* stream) {
  if (n <= 0) return 0;
  wf::chord_table_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      bank, n, st, tab);
  return (int)cudaGetLastError();
}

// The launch shape of P's per-lane instantiation (the dda: its path
// pass; flags: bit 0 the counting one, bit 1 the prologue's), and of the
// walk pass (two: its two-channel instantiation): 8 ints into info
// (wf::info's).
extern "C" int wf_res_fwd_info(const WfParams* P, int flags, int* info) {
  return P->estimator == wf::DDA ? wf::res_info<true, true>(P, flags, info)
                                 : wf::res_info<true, false>(P, flags, info);
}
extern "C" int wf_res_walk_info(int count, int two, int* info) {
  return wf::walk_info(count, two, info);
}
