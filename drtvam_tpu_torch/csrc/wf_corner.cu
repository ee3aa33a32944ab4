// The corner-filter render: which active pixels a square vial's corners
// leave unblocked.
//
// Replaces drtvam_tpu/ops/render.py:226 render_corner (XLA: one
// intersect_scene over chunks of lanes, scatter-added into the image).
// Here one thread takes one active pixel's lane (regular sampling, spp 1)
// through the per-lane template's ray set-up (wf_trace.cuh, lane mode
// CORNER) and one intersection of the scene, the target mesh included
// (wf_mesh.cuh), and writes the pixel once: the ray weight where the hit
// lies at least radius from both corners' position (|x|, |y|) = (dist,
// dist), else 0.
//
// Bound on the H100: the operations of one intersection a lane (the
// analytic surfaces, and the mesh's grid walk where the ray reaches its
// box); the image (4 bytes a pixel) is written once.
#include "wf_trace.cuh"

// P: scene parameters (regular sampling, no time sampling, spp 1); M: the
// mesh banks; active_pixels as for wf_radon; dist, radius: the corner's
// distance from the axis along x and y, and the radius it blocks; img
// (n_patterns * resy * resx,) zeroed; counters (3,) as for wf_radon (the
// iterations 0), or null. Returns cudaGetLastError().
extern "C" int wf_corner(const WfParams* P, const wf::WfMesh* M,
                         const int* active_pixels, float dist, float radius,
                         float* img, unsigned long long* counters,
                         void* stream) {
  return wf::cull_launch<wf::CORNER>(P, M, active_pixels, dist, radius, img,
                                     counters, stream);
}
