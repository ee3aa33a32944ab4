// Wavefront path tracer, forward: the flat dose accumulator.
//
// Replaces the primal of drtvam_tpu/ops/march.py:913 trace_wavefront
// (XLA; the JAX package stages per-step deposits and flushes them with
// one scatter-add per 32 steps because TPU scatters serialize). Here
// each deposit is one float atomicAdd into acc (n_cells,), so the sums
// are not bitwise reproducible from launch to launch.
//
// Bound on the H100: the float32 work of the voxel steps (see
// wf_trace.cuh) and the atomics into a dose grid larger than L2 at the
// bench scene's 256^3 film. The kernel is the per-lane template of
// wf_trace.cuh (its design is described there).
#include "wf_trace.cuh"

// P: scene and sampling parameters; data (n_active,) pattern values;
// active_pixels (n_active,) flat DMD indices (unused for the identity
// store); acc (n_cells,) zeroed; counters (2,) bounce iterations and
// estimator steps, or null. Returns cudaGetLastError().
extern "C" int wf_fwd(const WfParams* P, const float* data,
                      const int* active_pixels, float* acc,
                      unsigned long long* counters, void* stream) {
  return wf::launch<true>(P, data, active_pixels, acc, counters, stream);
}
