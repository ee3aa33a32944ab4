// The corner-filter render: which active pixels a square vial's corners
// leave unblocked.
//
// Replaces drtvam_tpu/ops/render.py:226 render_corner (XLA: one
// intersect_scene over chunks of lanes, scatter-added into the image).
// Here one thread takes one active pixel's lane (regular sampling, spp 1)
// through the per-lane template's ray set-up (wf_trace.cuh, lane mode
// CORNER; its angle's frame from the launch's frame table) and one
// intersection of the scene, the target mesh included (wf_mesh.cuh, its
// banks in shared memory: wf_cull.cuh), and writes the pixel once: the ray
// weight where the hit lies at least radius from both corners' position
// (|x|, |y|) = (dist, dist), else 0.
//
// Bound on the H100: the operations of one intersection a lane (the
// analytic surfaces, and the mesh's grid walk where the ray reaches its
// box); the image (4 bytes a pixel) is written once.
// Launch shape (PERF.md section 6, tools/wf_variants.py cull): 3 CTAs of
// 256 threads an SM at 80 registers, with no spill
#ifndef WF_CULL_THREADS
#define WF_CULL_THREADS 256
#endif
#ifndef WF_CULL_MIN_CTAS
#define WF_CULL_MIN_CTAS 3
#endif
#include "wf_cull.cuh"

// P: scene parameters (regular sampling, no time sampling, spp 1); M and
// A as for wf_radon (A->dist, A->radius: the corner's distance from the
// axis along x and y, and the radius it blocks; the counters' iterations
// 0). Returns cudaGetLastError().
extern "C" int wf_corner(const WfParams* P, const wf::WfMesh* M,
                         const wf::CullArgs* A, void* stream) {
  return wf::cull_launch<wf::CORNER>(P, M, A, stream);
}

// The launch shape, as wf_radon_info.
extern "C" int wf_corner_info(const WfParams* P, const wf::CullArgs* A,
                              int count, int* out) {
  return wf::cull_info<wf::CORNER>(P, A, count, out);
}
