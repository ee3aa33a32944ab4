// The radon culling render: each active pixel's in-target absorption.
//
// Replaces drtvam_tpu/ops/render.py:193 render_radon (XLA: the wavefront
// march in its radon mode, drtvam_tpu/ops/march.py:917-923, a
// lax.while_loop over chunks of lanes scatter-added into the image). Here
// one thread traces one active pixel's spp lanes through the per-lane
// template (wf_trace.cuh, lane mode RADON: scattering off, no deposits,
// every random draw in its slot), the scene's target mesh intersected
// through its uniform grid (wf_mesh.cuh), and writes the pixel once: no
// atomics, so the image is bitwise reproducible.
//
// Bound on the H100: the operations of the lanes' surface intersections,
// per bounce iteration the analytic surfaces (~30 float32 operations
// each) and the mesh (its grid cells, ~20 operations, and triangles, ~40,
// with three 12-byte reads of a bank of a few tens of KB); the image
// (4 bytes a pixel) is written once.
#include "wf_trace.cuh"

// P: scene and sampling parameters (a radon static: P->spp lanes a pixel,
// P->ray_w the ray weight at spp); M: the mesh banks; active_pixels
// (n_active,) flat DMD indices (unused for the identity store); img
// (n_patterns * resy * resx,) zeroed, the active pixels written; counters
// (3,) bounce iterations, grid cells and triangles, or null. Returns
// cudaGetLastError().
extern "C" int wf_radon(const WfParams* P, const wf::WfMesh* M,
                        const int* active_pixels, float* img,
                        unsigned long long* counters, void* stream) {
  return wf::cull_launch<wf::RADON>(P, M, active_pixels, 0.0f, 0.0f, img,
                                    counters, stream);
}
