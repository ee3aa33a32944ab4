// Wavefront path tracer with the target kept: the staged adjoint, the dda
// and ratio forwards' path and walk passes and the delta forward
// (wf_target.cuh, where the design is described).
//
// Replaces drtvam_tpu/ops/march.py:913 trace_wavefront for a scene that
// keeps the target mesh (intersect_scene's MESH branch :151-190, the
// two-channel deposits :556-565 and :1092-1093; XLA). The forward's float
// atomics sum in launch order, so its sums are not bitwise reproducible;
// the adjoint writes each pixel's gradient once, in lane order, and is.
//
// Bound on the H100: the dda walk's voxel steps, ratio tracking's steps,
// delta's deposits and the target's grid walks (~20 float32 operations a
// voxel step or a grid cell, ~40 a triangle test).
#include "wf_target.cuh"

// Whether the target forms run P (the scene keeps the target, the analog
// pair, its banks M fit a CTA's shared memory): *fits 1 or 0. Returns a
// cudaError_t.
extern "C" int wf_tgt_fits(const WfParams* P, const wf::WfMesh* M,
                           int* fits) {
  bool f = false;
  const int e = (int)wf::tgt_fits(*P, *M, f);
  *fits = f ? 1 : 0;
  return e;
}

// The adjoint with the banks staged (P, M, tris, dL, active_pixels, order,
// starts as for wf_bwd; grad (n_active,) output; counters (8,) or null).
// Returns cudaGetLastError(); cudaErrorInvalidConfiguration when the
// banks do not fit (wf_tgt_fits).
extern "C" int wf_tgt_bwd(const WfParams* P, const wf::WfMesh* M,
                          const float4* tris, const float* dL,
                          const int* active_pixels, const int* order,
                          const int* starts, float* grad,
                          unsigned long long* counters, void* stream) {
  return wf::tgt_bwd_launch(P, M, tris, dL, active_pixels, order, starts,
                            grad, counters, stream);
}

// The dda or ratio forward's path pass over the batch A's units (P, M,
// tris, data, active_pixels, order, starts as for wf_fwd): the lanes'
// segments as records in their unit's region of A->recs (wf::TgtArgs; a
// ratio record's stream in A->keys), those past it walked into A->acc.
// counters (8,): the bounce iterations, the target's grid cells,
// triangles and walks, and the steps and global deposits of the segments
// walked at once, or null.
extern "C" int wf_tgt_path(const WfParams* P, const wf::WfMesh* M,
                           const float4* tris, const float* data,
                           const int* active_pixels, const int* order,
                           const int* starts, const wf::TgtArgs* A,
                           unsigned long long* counters, void* stream) {
  return wf::tgt_path_launch(P, M, tris, data, active_pixels, order, starts,
                             A, counters, stream);
}

// The delta forward over the units [A->u0, A->u1) (arguments as
// wf_tgt_path's; of A the units and acc alone): every lane's deposits
// added into A->acc (n_cells,). counters (8,): the bounce iterations, the
// steps (deposits), the global deposits, the lane slots and the target's
// grid cells, triangles and walks, or null.
extern "C" int wf_tgt_delta(const WfParams* P, const wf::WfMesh* M,
                            const float4* tris, const float* data,
                            const int* active_pixels, const int* order,
                            const int* starts, const wf::TgtArgs* A,
                            unsigned long long* counters, void* stream) {
  return wf::tgt_path_launch(P, M, tris, data, active_pixels, order, starts,
                             A, counters, stream, true);
}

// The walk pass (dda, ratio): the batch A's records walked into A->acc
// (n_cells,), each unit's through its DMD row's home-slice tile (rows: the
// tile's row table, as for wf_fwd). counters (8,): the steps, the tile and
// global deposits and the lane slots, or null.
extern "C" int wf_tgt_walk(const WfParams* P, const wf::TgtArgs* A,
                           const int4* rows, unsigned long long* counters,
                           void* stream) {
  return wf::tgt_walk_launch(P, A, rows, counters, stream);
}

// The launch shape of pass `pass` (0 the path pass, 1 the walk pass, 2 the
// staged adjoint, 3 the delta form): 8 ints into info (wf::info's).
extern "C" int wf_tgt_info(const WfParams* P, const wf::WfMesh* M, int pass,
                           int count, int* info) {
  return wf::tgt_info(P, M, pass, count, info);
}
