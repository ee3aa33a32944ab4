// Wavefront path tracer, forward: the flat dose accumulator.
//
// Replaces the primal of drtvam_tpu/ops/march.py:913 trace_wavefront
// (XLA; the JAX package stages per-step deposits and flushes them with
// one scatter-add per 32 steps because TPU scatters serialize). Here a
// deposit in the home z-slice of the CTA's DMD row is an atomic add
// into that slice's tile in the CTA's shared memory, flushed once per
// CTA with one global atomic per nonzero voxel; any other deposit is
// one float atomicAdd into acc (n_cells,). The sums are not bitwise
// reproducible from launch to launch.
//
// Bound on the H100: the float32 work of the voxel steps (see
// wf_trace.cuh), then the float atomics into a dose grid larger than
// L2 (the bench scene's 256^3 film), which the home-slice tile keeps
// mostly on chip. The kernel is the per-lane template of wf_trace.cuh
// (its design is described there).
#include "wf_trace.cuh"

// P: scene and sampling parameters; M: the scene's mesh surfaces and
// banks, tris their triangle rows (read when P->target is not 0: the
// scene keeps the target; tris may be null otherwise); data
// (n_active,) pattern values; active_pixels (n_active,) flat DMD
// indices, order (n_active,) and starts (resy * n_groups + 1,) the
// sorted launch order (all three unused, may be null, for the identity
// store); rows (resy,) the tile's row table (unused when P->tile_n is
// 0); acc (n_cells,) zeroed (n_cells: two floats a voxel when P->target
// is 2); counters (5,) bounce iterations, estimator steps, tile
// deposits, global deposits and lane slots, or null. Returns
// cudaGetLastError().
extern "C" int wf_fwd(const WfParams* P, const wf::WfMesh* M,
                      const float4* tris, const float* data,
                      const int* active_pixels, const int* order,
                      const int* starts, const int4* rows,
                      float* acc, unsigned long long* counters,
                      void* stream) {
  return wf::launch<true>(P, M, tris, data, active_pixels, order, starts,
                          rows, acc, counters, stream);
}

// The launch shape of P's instantiation (wf::info): 8 ints into info.
extern "C" int wf_fwd_info(const WfParams* P, int count, int* info) {
  return wf::info<true>(P, count, info);
}
