// The radon culling render: each active pixel's in-target absorption.
//
// Replaces drtvam_tpu/ops/render.py:193 render_radon (XLA: the wavefront
// march in its radon mode, drtvam_tpu/ops/march.py:917-923, a
// lax.while_loop over chunks of lanes scatter-added into the image). Here
// one thread traces one active pixel's spp lanes through the per-lane
// template (wf_trace.cuh, lane mode RADON: scattering off, no deposits,
// every random draw in its slot), the scene's target mesh intersected
// through its uniform grid (wf_mesh.cuh), in the culling kernel's
// persistent CTAs with the mesh banks in shared memory (wf_cull.cuh), and
// writes the pixel once: no atomics, so the image is bitwise reproducible.
//
// Bound on the H100: the operations of the lanes' surface intersections,
// per bounce iteration the analytic surfaces (~30 float32 operations
// each) and the mesh (its grid cells, ~20 operations, and triangles, ~40,
// with three 16-byte rows of a bank of a few tens of KB); the image (4
// bytes a pixel) is written once.
// Launch shape (PERF.md section 6, tools/wf_variants.py cull): 2 CTAs of
// 512 threads an SM at 64 registers, faster on an H100 than 3 of 256 at
// 80 despite its spills
#ifndef WF_CULL_THREADS
#define WF_CULL_THREADS 512
#endif
#ifndef WF_CULL_MIN_CTAS
#define WF_CULL_MIN_CTAS 2
#endif
#include "wf_cull.cuh"

// P: scene and sampling parameters (a radon static: P->spp lanes a pixel,
// P->ray_w the ray weight at spp); M: the mesh surfaces and banks; A: the
// launch's buffers (wf_cull.cuh CullArgs; A->img zeroed, its active pixels
// written; A->counters the CULL_COUNTERS, or null). Returns
// cudaGetLastError().
extern "C" int wf_radon(const WfParams* P, const wf::WfMesh* M,
                        const wf::CullArgs* A, void* stream) {
  return wf::cull_launch<wf::RADON>(P, M, A, stream);
}

// The launch shape of the instantiation P and A select (count: the
// counting one), as wf::cull_info.
extern "C" int wf_radon_info(const WfParams* P, const wf::CullArgs* A,
                             int count, int* out) {
  return wf::cull_info<wf::RADON>(P, A, count, out);
}
