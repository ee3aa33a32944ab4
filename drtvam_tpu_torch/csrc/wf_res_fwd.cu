// Hybrid engine's scattered residual, forward: the flat dose accumulator
// of the deposits made after a path's first scatter.
//
// Replaces the primal of drtvam_tpu/ops/march.py:913 trace_wavefront in
// its residual modes (XLA: scattered_only :1064-1066, the chord-bank
// first scatter :328-420 with :966-1002, the fast convex event loop
// :433-549). A thread traces one lane of the per-lane template of
// wf_trace.cuh in the launch order of wf_fwd (one CTA per DMD row and
// angle group), but with no home-slice tile: a deposit follows a scatter
// into any direction, so it is one float atomicAdd into acc (n_cells,).
// The sums are not bitwise reproducible from launch to launch.
//
// Bound on the H100: at the bench scene's albedo 0.5 and optical depth
// a lane makes about one deposit, so the kernel is bound by its per-lane
// work (the ray set-up, 5-6 random draws, the 48-byte chord record, two
// phase samples, a few expf / log1pf), not by the atomics.
#include "wf_trace.cuh"

// P: scene and sampling parameters, P->residual the mode (SCAT_ONLY,
// FIRST_SCATTER or FAST_RESIDUAL; scattering and transmission only);
// data (n_active,) pattern values; active_pixels, order, starts as for
// wf_fwd; chords (A * resx, 12) the chord bank (FIRST_SCATTER and
// FAST_RESIDUAL; unused, may be null, for SCAT_ONLY); acc (n_cells,)
// zeroed; counters (5,) as for wf_fwd, or null. Returns
// cudaGetLastError().
extern "C" int wf_res_fwd(const WfParams* P, const float* data,
                          const int* active_pixels, const int* order,
                          const int* starts, const float* chords, float* acc,
                          unsigned long long* counters, void* stream) {
  return wf::launch<true, true>(P, data, active_pixels, order, starts,
                                nullptr, chords, acc, counters, stream);
}

// The launch shape of P's instantiation (wf::info): 8 ints into info.
extern "C" int wf_res_fwd_info(const WfParams* P, int count, int* info) {
  return wf::info<true, true>(P, count, info);
}
