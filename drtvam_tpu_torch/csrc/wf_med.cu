// Wavefront path tracer, adjoint with the medium cotangents: the pattern
// gradient (bitwise wf_bwd's, or the one-pass target form's on a scene
// with mesh surfaces) and the summed d loss / d sigma_t and
// d loss / d sigma_s (wf_med.cuh, where the design is described).
//
// Replaces the medium-gradient branches of drtvam_tpu/ops/march.py
// dda_segment, ratio_segment and delta_segment (:586, :747, :865) and
// their sums in trace_wavefront (:913; XLA). Built with --fmad=false as
// the other wavefront sources.
#include "wf_med.cuh"

// P, M, tris as for wf_bwd; dL (n_cells,) the loss gradient of the flat
// accumulator; data (n_active,) the patterns; active_pixels, order,
// starts as for wf_bwd; task_base (CTAs + 1,) the warp tasks before each
// CTA of the launch order; grad (n_active,) output; partials (n_tasks, 2)
// scratch, every entry written; sums (2,) output: (stg, ssg). Returns
// cudaGetLastError().
extern "C" int wf_med(const WfParams* P, const wf::WfMesh* M,
                      const float4* tris, const float* dL, const float* data,
                      const int* active_pixels, const int* order,
                      const int* starts, const int* task_base, float* grad,
                      float* partials, int n_tasks, float* sums,
                      void* stream) {
  return wf::med_launch(P, M, tris, dL, data, active_pixels, order, starts,
                        task_base, grad, reinterpret_cast<float2*>(partials),
                        n_tasks, sums, stream);
}

// The launch shape of P's instantiation (wf::info's 8 ints into info).
extern "C" int wf_med_info(const WfParams* P, int count, int* info) {
  (void)count;
  return wf::med_info(P, info);
}
