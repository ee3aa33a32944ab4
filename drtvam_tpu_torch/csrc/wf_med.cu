// Wavefront path tracer, the adjoint's paths for the medium cotangents
// alone: the summed d loss / d sigma_t and d loss / d sigma_s, no pattern
// gradient, over the pixels whose emitted intensity is not 0, compacted
// per CTA (wf_med.cuh, where the design is described).
//
// Replaces the medium-gradient branches of drtvam_tpu/ops/march.py
// dda_segment, ratio_segment and delta_segment (:586, :747, :865) and
// their sums in trace_wavefront (:913; XLA) under the JAX driver's
// jax.grad in (sigma_t, albedo) (drtvam_tpu/opt/optimize.py:453-468).
// Built with --fmad=false as the other wavefront sources.
#include "wf_med.cuh"

// P, M, tris as for wf_bwd; dL (n_cells,) the loss gradient of the flat
// accumulator; data (n_active,) the patterns; active_pixels, order,
// starts as for wf_bwd; task_base (CTAs + 1,) the adjoint's warp tasks
// before each CTA of the launch order; cidx (n_active,) scratch: each
// CTA's emitting pixels, compacted; count (CTAs,) output: each CTA's
// emitting pixels; partials (n_tasks, 2) scratch, every entry written (a
// CTA's slots past its compacted tasks 0); sums (2,) output: (stg, ssg);
// staged: the banks staged in each CTA's shared memory (wf_med_fits).
// Returns cudaGetLastError(); cudaErrorInvalidConfiguration when staged
// banks do not fit.
extern "C" int wf_med(const WfParams* P, const wf::WfMesh* M,
                      const float4* tris, const float* dL, const float* data,
                      const int* active_pixels, const int* order,
                      const int* starts, const int* task_base, int* cidx,
                      int* count, float* partials, int n_tasks, float* sums,
                      int staged, void* stream) {
  return wf::med_launch(P, M, tris, dL, data, active_pixels, order, starts,
                        task_base, cidx, count,
                        reinterpret_cast<float2*>(partials), n_tasks, sums,
                        staged, stream);
}

// Whether the staged instantiation for P fits the banks M into a CTA:
// *fits 1 or 0. Returns a cudaError_t.
extern "C" int wf_med_fits(const WfParams* P, const wf::WfMesh* M,
                           int* fits) {
  return wf::med_fits(P, M, fits);
}

// The launch shape of P's instantiation (staged or not; wf::info's 8
// ints into info).
extern "C" int wf_med_info(const WfParams* P, const wf::WfMesh* M,
                           int staged, int* info) {
  return wf::med_info(P, M, staged, info);
}
