// Wavefront path tracer, adjoint: the pattern gradient.
//
// Replaces the adjoint of drtvam_tpu/ops/march.py:913 trace_wavefront
// (XLA): the same paths are replayed from the same counter-based
// random stream, each deposit gathers dL instead of adding, and a
// pixel's lanes are summed in lane order and written once (times the
// ray weight), so the result is bitwise reproducible.
//
// Bound on the H100: the float32 work of the voxel steps (see
// wf_trace.cuh). The gathers read a 67 MB volume at the bench scene's
// 256^3 film; each CTA traces one DMD row, whose deposits mostly land
// in one z-slice, so its gathers mostly hit L1 (the kernel leaves the
// SM's shared memory to L1). The kernel is the per-lane template of
// wf_trace.cuh (its design is described there).
#include "wf_trace.cuh"

// P, M, tris as for wf_fwd; dL (n_cells,) loss gradient of the
// flat accumulator; active_pixels, order, starts as for wf_fwd, rows
// unused (the adjoint takes no tile); grad (n_active,) output; counters
// (5,) or null. Returns cudaGetLastError().
extern "C" int wf_bwd(const WfParams* P, const wf::WfMesh* M,
                      const float4* tris, const float* dL,
                      const int* active_pixels, const int* order,
                      const int* starts, const int4* rows,
                      float* grad, unsigned long long* counters,
                      void* stream) {
  return wf::launch<false>(P, M, tris, dL, active_pixels, order, starts,
                           rows, grad, counters, stream);
}

// The launch shape of P's instantiation (wf::info): 8 ints into info.
extern "C" int wf_bwd_info(const WfParams* P, int count, int* info) {
  return wf::info<false>(P, count, info);
}
