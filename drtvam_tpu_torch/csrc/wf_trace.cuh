// The wavefront path tracer, one template for the whole per-lane path
// loop: ray sampling, Russian roulette, the free-flight / surface race,
// the dose estimator's segment (dda, ratio or delta), the target parity
// flip, the dielectric BSDF (transmission-only or reflecting), diffuse
// occlusions, phase sampling and the medium-transition bookkeeping.
//
// Replaces drtvam_tpu/ops/march.py:913 trace_wavefront (XLA, no Pallas
// kernel on this path): the JAX package marches a wavefront of lanes in
// lock step with per-lane masks and stages its deposits because TPU
// scatters serialize. Here a thread traces one lane (lane = pixel * spp
// + k) with all its state in registers: nothing per lane goes to device
// memory, so there is no chunking. Two entry points instantiate it:
//   wf_fwd.cu  (PRIMAL)   one lane a thread; adds each deposit into the
//                          flat dose accumulator (n_cells,);
//   wf_bwd.cu  (adjoint)  one pixel a thread, its spp lanes one after
//                          another; gathers dL at each deposit and writes
//                          one pattern-gradient value per pixel, summed
//                          over its lanes in lane order: bitwise
//                          reproducible.
// wf_med.cu runs the adjoint's paths for the medium cotangents alone
// through wf_kernel's CTA (wf_cta) with its own sink (wf_med.cuh
// MedSink, MED): it sums each deposit's d / d sigma_t and d / d sigma_s,
// from the segment's history and the deposit's factors the template
// hands it (DdaWalk::step, ratio_segment, the delta deposit), and
// replaces the CTA's task hooks (Sink::begin, Sink::task); every other
// sink compiles none of it.
// Two more, wf_res_fwd.cu and wf_res_bwd.cu, instantiate it in the hybrid
// engine's residual modes (template parameter RES, see below) through the
// residual family's own kernels (wf_residual.cuh). The DMD-pixel culling
// renders, wf_radon.cu and wf_corner.cu, run it in two lane modes of their
// own through wf_cull.cuh's kernel (one thread an active pixel, its lanes
// one after another, the pixel written once): RADON (drtvam_tpu/ops/
// march.py:917-923: scattering off, no deposits, the lane's in-target
// absorption A exp(-st total_t) (1 - exp(-st t)) summed while it is inside
// the target and in the medium, total_t over every segment, every draw in
// its slot) and CORNER (the ray's set-up and one intersection). Their
// scenes keep the target mesh, intersected by intersect_scene<MESH_ON>
// through wf_mesh.cuh, as are the four loop entry points' target
// instantiations (TGT, below); every other instantiation compiles it
// with MESH_ON false.
//
// Bound on the H100: a DDA voxel step is ~20 float32 operations and two
// expf; at the bench scene's ~10^10 steps per render that is a few ms at
// the float32 peak. Past that, a deposit is a read-modify-write (or a
// read) of a dose grid that need not fit the 50 MB L2 (67 MB at a 256^3
// film), and the lanes of a warp diverge on paths of different lengths.
//
// The launch groups lanes by their home z-slice. A collimated ray on a
// circular motion is horizontal and stays so through the vial (the
// cylinder's normals have n.z = 0), so every deposit of a DMD row's
// rays lands in the z-slice at the row's height, at every angle. So one
// CTA of 1024 threads traces one DMD row over a group of P.group angles
// (the active pixels sorted by row, angle, pixel; warps take 32
// neighbours at a time from a counter in shared memory). The forward
// holds that row's home slice in its shared memory: the slice's voxels
// where the medium may lie (a disk of 47,416 voxels, 187 KB with its row
// table, at the bench scene's 256^2 slice and 4.75 mm vial), row by row
// through a table the wrapper builds once per scene. It adds a deposit
// there with a shared atomic and flushes the tile's nonzero voxels with
// one global atomic each at the end; every other deposit (rays sampled
// across a slice boundary, scattering, reflections out of the plane,
// telecentric and lens rays, a tile that does not fit) is a global
// atomic as before. The adjoint gathers dL through L1, which the
// grouping keeps on the one slice the SM's CTA reads. Lane ids do not
// change with the order, and the random stream is counter-based per
// lane, so the grouping changes no value. A float atomic add in shared
// memory is a compare-and-swap loop on this card, so the tile takes the
// forward from L2's atomic rate to the shared memory's, not to the
// adjoint's time. (Measured on an H100 and left, PERF.md section 6: a
// whole slice split over a 4-CTA thread block cluster and reached
// through distributed shared memory, whose remote float atomics and
// loads made both kernels slower than global ones; the adjoint's tile
// staged in shared memory, slower than L1, whose room it takes.)
//
// The arithmetic is the plain version's (drtvam_tpu_torch/ops/march.py
// and models/projector.py), operation for operation and in the same
// order, and the sources are built with --fmad=false, so every float
// operation rounds as torch's separate elementwise ops do. The random
// stream is the JAX package's PCG3D in native uint32: a lane makes the
// same draws in the same order (4 per bounce, 5 words in sample_rays
// over 3 draws; ratio tracking one per step, its own stream).
//
// Template parameters: the estimator, scattering and transmission_only,
// so each instantiation carries only the state it uses, the residual
// mode, whether the launch counts (iterations, steps, deposits by
// destination, lane slots) and whether the scene has mesh surfaces (the
// sink's TGT). The projector kind, the surfaces (at most WF_MAX_SURF
// analytic cylinders or boxes, and with TGT meshes: the target, a custom
// vial's walls, occlusions), the phase function and the film's channels
// are runtime parameters.
//
// Mesh surfaces (TGT: the target kept on a surface-aware film,
// drtvam_tpu/ops/march.py:556-565, 1092-1093, or in the final render of a
// surface-aware scene; a mesh vial; occlusions, each with its BSDF and
// medium side). The lane intersects each mesh through wf_mesh.cuh, by
// brute force or its grid walk, the banks read from global memory (tens
// of KB; the forward's shared memory holds the home-slice tile), and
// flips its inside flag at each crossing of the target. On a two-channel film (P.target 2) a deposit goes to channel
// 2 flat + (outside) of the accumulator; the first-scatter residual
// seeds the flag from the inside mask at its first scatter event and the
// fast residual reads the mask at each event voxel. The forward's tile
// holds both channels of a voxel side by side, over the widest rows of
// the home slice that fit (shape()); a deposit elsewhere is a global
// atomic, as for one channel. Every instantiation without TGT
// compiles none of this: a scene without a mesh runs the code it ran
// before.
//
// The residual modes (RES; the hybrid engine's scattered residual,
// drtvam_tpu/ops/march.py:107-144, XLA there): ANALOG is the full dose;
// SCAT_ONLY the analog paths with every deposit before the first scatter
// dropped; FIRST_SCATTER starts the lane at its forced first scatter
// event, sampled on its pixel's in-medium chord (its entry in the chord
// table, read at the pixel's centre column: chord_entry; without a chord
// bank, the GEO instantiations, on the 3D chord the lane's own
// transmission-only march records: chord_march, the geometric prologue
// of drtvam_tpu/ops/march.py:198-325), then runs the general loop from
// depth 1; FAST_RESIDUAL (delta, one convex medium
// region) starts the same way and then runs max_depth - 1 scatter events
// against one convex exit distance each (fast_residual). Every mode draws
// in the plain version's order, so the adjoint replays the forward's
// paths. A residual deposit follows a scatter into any 3D direction, so
// it leaves the DMD row's z-slice: the residual kernels take no
// home-slice tile. What bounds them on the H100 (PERF.md section 6,
// measured): the delta fast loop (0.22 deposits a lane at the bench
// scene's albedo and optical depth) by its per-lane work, of which the
// ray's set-up is a quarter, the first scatter a fifth and the one or
// two events the rest once the set-up takes its angle's frame and its
// chord's masses from tables (LaneSetup); the dda walks (~194 voxel
// steps a lane in the final render) by their float atomics into a dose
// grid larger than L2, not by their operations, once the walks are
// split from the paths (wf_residual.cuh) and no warp waits on its
// longest lane.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define WF_MAX_SURF 8

// Mirror of WfParams in drtvam_tpu_torch/ops/render.py: 4-byte fields.
struct WfParams {
  int kind;  // 0 collimated, 1 telecentric, 2 lens
  int n_patterns, resx, resy, n_active, identity, spp;
  int regular_sampling, sample_time, clockwise;
  float pixel_size[2], aperture_radius, focus_distance, motion_distance;
  float ray_w;
  int res[3];
  float bbox_min[3], bbox_max[3];
  float sigma_t, albedo, phase_g, majorant;
  int phase;  // 0 rayleigh, 1 hg, 2 isotropic, 3 forward_delta
  int estimator, has_scattering, transmission_only;
  int max_depth, rr_depth, dda_max_steps;
  unsigned seed;
  int n_surf;
  int surf_kind[WF_MAX_SURF], surf_bsdf[WF_MAX_SURF];
  int surf_medium_side[WF_MAX_SURF], surf_is_target[WF_MAX_SURF];
  float surf_params[3 * WF_MAX_SURF], surf_eta[WF_MAX_SURF];
  float surf_refl[WF_MAX_SURF];
  // the launch order: angle groups per DMD row, angles per group; the
  // home-slice tile's voxels (0: no tile)
  int n_groups, group, tile_n;
  // the residual mode (wf::ANALOG .. wf::FAST_RESIDUAL) and the fast
  // residual's medium surface
  int residual, res_surf;
  // the target: 0 not in the scene; 1 kept (its mesh intersected, the
  // lanes' inside flag flipped at its crossings), one channel; 2 kept,
  // a two-channel film (deposits to channel 0 inside the target, 1
  // outside)
  int target;
};

namespace wf {

enum { DDA = 0, RATIO = 1, DELTA = 2 };
enum { CYLINDER = 0, BOX = 1, MESH = 2 };
enum { DIELECTRIC = 0, NULL_BSDF = 1, ABSORB = 2, DIFFUSE = 3 };
enum { ANALOG = 0, SCAT_ONLY = 1, FIRST_SCATTER = 2, FAST_RESIDUAL = 3 };
// the culling renders' lane modes (RES beside the residual modes): the
// radon mode's in-target absorption, the corner filter's one hit
enum { RADON = 4, CORNER = 5 };

constexpr float RAY_EPS = 1e-4f;
constexpr float U_MAX = (float)(1.0 - 1e-7);
constexpr float TWO_PI = (float)(2.0 * 3.14159265358979323846);
constexpr float QUARTER_PI = (float)(3.14159265358979323846 / 4.0);
constexpr float HALF_PI = (float)(3.14159265358979323846 / 2.0);
constexpr int RATIO_MAX_STEPS = 65536;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }
// torch.minimum / maximum / clamp on non-NaN values
__device__ __forceinline__ float mn(float a, float b) { return b < a ? b : a; }
__device__ __forceinline__ float mx(float a, float b) { return b > a ? b : a; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ float comp(const V3& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : v.z);
}
__device__ __forceinline__ float dot3(const V3& a, const V3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float norm3(const V3& v) {
  return sqrtf(v.x * v.x + v.y * v.y + v.z * v.z);
}
__device__ __forceinline__ V3 div3(const V3& v, float s) {
  return {v.x / s, v.y / s, v.z / s};
}
__device__ __forceinline__ V3 cross3(const V3& a, const V3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
// sum_j cols[j] * v_j, in index order
__device__ __forceinline__ V3 rotate(const V3& c0, const V3& c1,
                                     const V3& c2, const V3& v) {
  return {c0.x * v.x + c1.x * v.y + c2.x * v.z,
          c0.y * v.x + c1.y * v.y + c2.y * v.z,
          c0.z * v.x + c1.z * v.y + c2.z * v.z};
}
// o + t * d
__device__ __forceinline__ V3 along(const V3& o, float t, const V3& d) {
  return {o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
}

// ---- PCG3D, the JAX package's counter-based sampler --------------------

struct Rng {
  uint32_t key, lane, ctr;
  __device__ __forceinline__ void hash(uint32_t& x, uint32_t& y,
                                       uint32_t& z) {
    x = key * 1664525u + 1013904223u;
    y = lane * 1664525u + 1013904223u;
    z = ctr * 1664525u + 1013904223u;
    x += y * z;
    y += z * x;
    z += x * y;
    x ^= x >> 16;
    y ^= y >> 16;
    z ^= z >> 16;
    x += y * z;
    y += z * x;
    z += x * y;
    ++ctr;
  }
  __device__ __forceinline__ static float unit(uint32_t b) {
    return (float)(b >> 8) * (1.0f / 16777216.0f);
  }
  __device__ __forceinline__ float next1() {
    uint32_t x, y, z;
    hash(x, y, z);
    return unit(x);
  }
  __device__ __forceinline__ float2 next2() {
    uint32_t x, y, z;
    hash(x, y, z);
    return make_float2(unit(x), unit(y));
  }
};

// ---- warps, medium, fresnel ---------------------------------------------

__device__ __forceinline__ float2 disk_concentric(float2 u) {
  float x = 2.0f * u.x - 1.0f;
  float y = 2.0f * u.y - 1.0f;
  bool use_x = fabsf(x) > fabsf(y);
  float r = use_x ? x : y;
  bool origin = (x == 0.0f) && (y == 0.0f);
  float safe = origin ? 1.0f : r;
  float ratio = use_x ? y / safe : x / safe;
  float phi = use_x ? QUARTER_PI * ratio : HALF_PI - QUARTER_PI * ratio;
  if (origin) phi = 0.0f;
  return make_float2(r * cosf(phi), r * sinf(phi));
}

__device__ __forceinline__ V3 cosine_hemisphere(float2 u) {
  float2 d = disk_concentric(u);
  float z = sqrtf(mx(1.0f - (d.x * d.x + d.y * d.y), 0.0f));
  return {d.x, d.y, z};
}

__device__ __forceinline__ void onb(const V3& n, V3& t, V3& bt) {
  float s = n.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (s + n.z);
  float b = n.x * n.y * a;
  t = {1.0f + s * (n.x * n.x) * a, s * b, -s * n.x};
  bt = {b, s + (n.y * n.y) * a, -n.y};
}

__device__ __forceinline__ float phase_cos(int phase, float u, float g) {
  switch (phase) {
    case 0: {  // rayleigh: pow(., 1/3) as torch.pow in the plain version
      float c = 4.0f * (2.0f * u - 1.0f);
      float w = powf(c * 0.5f + sqrtf(c * c * 0.25f + 1.0f), 1.0f / 3.0f);
      return clampf(w - 1.0f / w, -1.0f, 1.0f);
    }
    case 1: {  // henyey-greenstein
      float sqr = (1.0f - g * g) / (1.0f - g + 2.0f * g * u);
      float cos_iso = 1.0f - 2.0f * u;
      float cos_hg = (1.0f + g * g - sqr * sqr) /
                     (2.0f * (g == 0.0f ? 1.0f : g));
      return clampf(g == 0.0f ? cos_iso : cos_hg, -1.0f, 1.0f);
    }
    case 2:
      return 1.0f - 2.0f * u;
    default:
      return 1.0f;
  }
}

__device__ __forceinline__ V3 sample_phase(int phase, float g, const V3& d,
                                           float u1, float u2) {
  float cos_t = phase_cos(phase, u1, g);
  float sin_t = sqrtf(mx(1.0f - cos_t * cos_t, 0.0f));
  float phi = TWO_PI * u2;
  V3 t1, t2;
  onb(d, t1, t2);
  float a = sin_t * cosf(phi), b = sin_t * sinf(phi);
  return {a * t1.x + b * t2.x + cos_t * d.x, a * t1.y + b * t2.y + cos_t * d.y,
          a * t1.z + b * t2.z + cos_t * d.z};
}

__device__ __forceinline__ float free_flight(float u, float sigma) {
  return -log1pf(-clampf(u, 0.0f, U_MAX)) / sigma;
}

// refract d at a surface with outward normal n, int/ext IOR ratio eta
__device__ __forceinline__ void refract(const V3& d, const V3& n, float eta,
                                        V3& d_t, V3& d_r, float& F,
                                        bool& tir, float& eta_rel) {
  float cos_i = -dot3(d, n);
  bool outside = cos_i > 0.0f;
  eta_rel = outside ? eta : 1.0f / eta;
  V3 nl = outside ? n : V3{-n.x, -n.y, -n.z};
  // the Fresnel terms take |cos_i| clipped to [0, 1], the directions
  // the unclipped value, as in the plain version
  float ci = fabsf(cos_i);
  float cc = clampf(ci, 0.0f, 1.0f);
  float sin_t2 = (1.0f - cc * cc) / (eta_rel * eta_rel);
  tir = sin_t2 >= 1.0f;
  float ct = sqrtf(mx(1.0f - sin_t2, 0.0f));
  float r_par = (eta_rel * cc - ct) / (eta_rel * cc + ct);
  float r_perp = (cc - eta_rel * ct) / (cc + eta_rel * ct);
  F = tir ? 1.0f : 0.5f * (r_par * r_par + r_perp * r_perp);
  if (tir) ct = 0.0f;
  float inv_eta = 1.0f / eta_rel;
  float k = inv_eta * ci - ct;
  d_t = {inv_eta * d.x + k * nl.x, inv_eta * d.y + k * nl.y,
         inv_eta * d.z + k * nl.z};
  float c2 = 2.0f * ci;
  d_r = {d.x + c2 * nl.x, d.y + c2 * nl.y, d.z + c2 * nl.z};
}

// ---- analytic intersection ------------------------------------------------

__device__ __forceinline__ float ray_cylinder(const V3& o, const V3& d,
                                              float r, float z0, float z1,
                                              V3& n) {
  float a = d.x * d.x + d.y * d.y;
  float b = 2.0f * (o.x * d.x + o.y * d.y);
  float c = o.x * o.x + o.y * o.y - r * r;
  float disc = b * b - 4.0f * a * c;
  bool big = a > 1e-20f;
  bool ok = disc >= 0.0f && big;
  float sq = sqrtf(mx(disc, 0.0f));
  float inv2a = 0.5f / (big ? a : 1.0f);
  float t0 = (-b - sq) * inv2a;
  float t1 = (-b + sq) * inv2a;
  float za = o.z + t0 * d.z, zb = o.z + t1 * d.z;
  float t0v = (ok && t0 > RAY_EPS && za >= z0 && za <= z1) ? t0 : inf();
  float t1v = (ok && t1 > RAY_EPS && zb >= z0 && zb <= z1) ? t1 : inf();
  float t = mn(t0v, t1v);
  float inv_r = 1.0f / r;
  n = {(o.x + t * d.x) * inv_r, (o.y + t * d.y) * inv_r, 0.0f};
  return t;
}

__device__ __forceinline__ float ray_box(const V3& o, const V3& d,
                                         const float* h, V3& n) {
  float near_v[3], far_v[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float dk = comp(d, k), ok = comp(o, k);
    float inv = 1.0f / (fabsf(dk) > 1e-20f ? dk : 1e-20f);
    float lo = (-h[k] - ok) * inv;
    float hi = (h[k] - ok) * inv;
    near_v[k] = mn(lo, hi);
    far_v[k] = mx(lo, hi);
  }
  float t_near = mx(mx(near_v[0], near_v[1]), near_v[2]);
  float t_far = mn(mn(far_v[0], far_v[1]), far_v[2]);
  bool hit = t_near <= t_far;
  float t_n = (hit && t_near > RAY_EPS) ? t_near : inf();
  float t_f = (hit && t_far > RAY_EPS) ? t_far : inf();
  float t = mn(t_n, t_f);
  int axis;
  if (t == t_n) {
    axis = near_v[0] == t_near ? 0 : (near_v[1] == t_near ? 1 : 2);
  } else {
    axis = far_v[0] == t_far ? 0 : (far_v[1] == t_far ? 1 : 2);
  }
  float p = comp(o, axis) + t * comp(d, axis);
  float sgn = p > 0.0f ? 1.0f : (p < 0.0f ? -1.0f : 0.0f);
  n = {axis == 0 ? sgn : 0.0f, axis == 1 ? sgn : 0.0f,
       axis == 2 ? sgn : 0.0f};
  return t;
}

#include "wf_mesh.cuh"

// nearest surface: returns t (inf on a miss), its normal and surface id.
// MESH_ON: mesh surfaces are intersected too (the radon and corner modes
// and the TGT instantiations, whose scenes keep the target mesh; M the
// mesh surfaces, B the banks the tests read, in shared memory when
// STAGED, c the counters): a mesh's normal is its hit triangle's
// (triangle 0's on a miss), as drtvam_tpu/ops/march.py:190 takes it.
// Every other instantiation compiles the analytic surfaces alone
template <bool MESH_ON = false, bool COUNT = false, bool STAGED = false>
__device__ __forceinline__ float intersect_scene(
    const WfParams& P, const V3& o, const V3& d, V3& n_best, int& sid,
    const WfMesh* M = nullptr, const MeshBanks* B = nullptr,
    MeshCount* c = nullptr) {
  float t_best = inf();
  n_best = {0.0f, 0.0f, 0.0f};
  sid = -1;
  for (int i = 0; i < P.n_surf; ++i) {
    const float* p = P.surf_params + 3 * i;
    V3 n;
    float t;
    if (P.surf_kind[i] == CYLINDER) {
      t = ray_cylinder(o, d, p[0], p[1], p[2], n);
    } else if (!MESH_ON || P.surf_kind[i] == BOX) {
      t = ray_box(o, d, p, n);
    } else {
      int tri = -1;
      t = inf();
      if constexpr (MESH_ON) {
        t = ray_mesh<COUNT, STAGED>(*M, *B, i, o, d, tri, *c);
        const int last = M->tri_count[i] - 1;
        n = load3(M->n, M->tri_start[i] + (tri < 0 ? 0 : (tri > last ? last
                                                                     : tri)));
      }
    }
    if (t < t_best) {
      t_best = t;
      n_best = n;
      sid = i;
    }
  }
  return t_best;
}

// ---- the film -----------------------------------------------------------

struct Grid {
  float bmin[3], bmax[3], vs[3], inv_vs[3];
  int res[3];
  __device__ void init(const WfParams& P) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      bmin[k] = P.bbox_min[k];
      bmax[k] = P.bbox_max[k];
      res[k] = P.res[k];
      vs[k] = (bmax[k] - bmin[k]) / (float)res[k];
      inv_vs[k] = 1.0f / vs[k];
    }
  }
  __device__ __forceinline__ int flat(int v0, int v1, int v2) const {
    return v0 + res[0] * (v1 + res[1] * v2);
  }
  // voxel of p at inv voxels per unit length (default 1 / voxel size);
  // false outside the grid
  __device__ __forceinline__ bool voxel_of(const V3& p, int v[3],
                                           const float* inv = nullptr) const {
    if (inv == nullptr) inv = inv_vs;
    v[0] = (int)floorf((p.x - bmin[0]) * inv[0]);
    v[1] = (int)floorf((p.y - bmin[1]) * inv[1]);
    v[2] = (int)floorf((p.z - bmin[2]) * inv[2]);
    return v[0] >= 0 && v[1] >= 0 && v[2] >= 0 && v[0] < res[0] &&
           v[1] < res[1] && v[2] < res[2];
  }
};

// the home z-slice of DMD row py: the film slice holding the row centre's
// height, where a collimated ray of the row deposits (sample_rays: o.z =
// (0.5 - sy) * ey on a circular motion); -1 when it lies outside the film
__device__ __forceinline__ int home_slice(const WfParams& P, const Grid& G,
                                          int py) {
  const float ey = (float)P.resy * P.pixel_size[1];
  const float sy = ((float)py + 0.5f) / (float)P.resy;
  const float k = floorf(((0.5f - sy) * ey - G.bmin[2]) * G.inv_vs[2]);
  return (k >= 0.0f && k < (float)G.res[2]) ? (int)k : -1;
}

// One deposit: the primal adds into the tile when the voxel is one of
// the home slice's tile voxels, else into the flat global accumulator;
// the adjoint gathers from the flat global dL (its home slice stays in
// L1: the launch leaves the adjoint's shared memory to it). The tile
// holds the home slice's voxels where the medium may lie, row by row:
// for film row y, the n columns from lo at tile index base + x,
// rows[y] = (lo, n, base, 0). COUNT: counts bounce iterations,
// estimator steps and deposits by destination, and with TGT the target's
// grid walks, cells and triangles (mc). TGT: the scene keeps the target
// (the mesh banks and the inside mask below; STAGED: the banks lie in
// the CTA's shared memory); on a two-channel film (two) a deposit goes to
// channel chan of its voxel, in the tile (its two channels side by side)
// as in global memory
template <bool PRIMAL_, bool COUNT_, bool TGT_ = false, bool STAGED_ = false>
struct Sink {
  static constexpr bool PRIMAL = PRIMAL_, COUNT = COUNT_, TGT = TGT_;
  static constexpr bool STAGED = STAGED_;
  // RECORDS: a dda segment is recorded for a later walk (PathSink), not
  // walked; RATIO_RECORDS: a ratio-tracking segment too (wf_target.cuh
  // TgtPathSink); MED: the adjoint also sums the medium cotangents
  // (wf_med.cuh MedSink)
  static constexpr bool RECORDS = false, RATIO_RECORDS = false, MED = false;
  float* acc;        // primal: the flat dose accumulator
  const float* dL;   // adjoint: the flat loss gradient
  float* tile;       // primal: the home slice's tile (shared memory)
  const int4* rows;  // its row table (shared memory)
  int home;          // the home z-slice; -1: no tile
  float g;           // adjoint: the lane's emitter gradient
  unsigned long long iters, steps, n_tile, n_global;
  // TGT: a two-channel film, and the lane's channel (0 inside the target,
  // 1 outside); the target mesh and the banks its tests read; the inside
  // mask (Z, Y, X) of the two-channel residual; the mesh work (COUNT)
  bool two = false;
  int chan = 0;
  const WfMesh* mesh = nullptr;
  MeshBanks banks = {nullptr, nullptr, nullptr};
  const unsigned char* mask = nullptr;
  MeshCount mc = {0, 0, 0, 0};
  // COUNT: the lane slots the CTA's warps spent (32 a step of a task's
  // longest lane); the geometric first-scatter prologue's iterations
  unsigned long long slots = 0, pro_iters = 0;

  __device__ __forceinline__ void iter() {
    if (COUNT) ++iters;
  }
  __device__ __forceinline__ void pro_iter() {
    if (COUNT) ++pro_iters;
  }
  __device__ __forceinline__ void step() {
    if (COUNT) ++steps;
  }
  // The CTA's task loop (wf_cta) through two hooks, which a sink may
  // replace (the medium adjoint's, wf_med.cuh MedSink); defined with
  // wf_cta. begin: the CTA's task count, after the barrier that publishes
  // its task counter; task: task t's work for lane l (trace_task, and
  // with COUNT the warp's lane slots)
  template <int THREADS>
  __device__ __forceinline__ unsigned begin(const WfParams& P,
                                            const int* order, int lo,
                                            int hi);
  template <int EST, bool SCAT, bool TONLY>
  __device__ __forceinline__ void task(const WfParams& P, const Grid& G,
                                       const int* order, int lo, int hi,
                                       int t, int l, const float* in,
                                       const int* active_pixels, float* out);
  // the tile index of voxel (vx, vy, vz) of the grid, or -1
  __device__ __forceinline__ int slot(int vx, int vy, int vz) const {
    if (!PRIMAL || vz != home) return -1;
    const int4 r = rows[vy];
    return (unsigned)(vx - r.x) < (unsigned)r.y ? r.z + vx : -1;
  }
  __device__ __forceinline__ void deposit(int slot, int flat, float val) {
    if (TGT && two) {
      flat = 2 * flat + chan;
      if (slot >= 0) slot = 2 * slot + chan;
    }
    if (COUNT) {
      n_tile += slot >= 0 ? 1 : 0;
      n_global += slot >= 0 ? 0 : 1;
    }
    if (PRIMAL) {
      if (slot >= 0) {
        atomicAdd(tile + slot, val);
      } else {
        atomicAdd(acc + flat, val);
      }
    } else {
      g = g + val * __ldg(dL + flat);
    }
  }
  // keeps v computed in a build that stops a lane early (WF_RES_STOP,
  // the per-lane timings of tools/wf_variants.py): a deposit that never
  // happens for a finite position or direction
  __device__ __forceinline__ void keep(float v) {
    if (v == 1.0e-30f) deposit(-1, 0, v);
  }
};

// The culling renders' sink (RES RADON or CORNER): no deposits; the
// lane's value L (the radon mode's in-target absorption, the corner
// mode's keep flag), the scene's mesh surfaces and the banks their tests
// read (in shared memory when STAGED), and the corner's distance from the
// axis and radius. COUNT: counts bounce iterations, grid cells, grid
// walks and triangles tested
template <bool COUNT_, bool STAGED_>
struct MeshSink {
  static constexpr bool PRIMAL = true, COUNT = COUNT_, RECORDS = false;
  static constexpr bool RATIO_RECORDS = false, TGT = false, MED = false;
  static constexpr bool STAGED = STAGED_;
  const WfMesh* mesh;
  MeshBanks banks;
  float dist, radius;
  float L;
  unsigned long long iters;
  MeshCount mc;
  __device__ __forceinline__ void iter() {
    if (COUNT) ++iters;
  }
  // the deposit interface, never reached in these modes
  __device__ __forceinline__ int slot(int, int, int) const { return -1; }
  __device__ __forceinline__ void deposit(int, int, float) {}
  __device__ __forceinline__ void step() {}
  __device__ __forceinline__ void keep(float) {}
};

// ---- dose estimators: one straight segment [o, o + maxt d] ---------------

// The Amanatides-Woo walk of one segment, as a state that steps: init is
// the segment's set-up, step one voxel (its deposit and the move to the
// next voxel). dda_segment runs them back to back; the residual's walk
// pass (wf_residual.cuh) runs a recorded segment's walk on another thread
// with the same arithmetic, so its deposits and steps are the same
struct DdaWalk {
  float dtmax[3], tstep[3], t, remaining;
  int voxel[3], end_voxel[3], step_dir[3], i;

  // false: the segment makes no voxel step
  __device__ __forceinline__ bool init(const WfParams& P, const Grid& G,
                                       const V3& o, const V3& d,
                                       float maxt) {
    float od[3] = {o.x, o.y, o.z}, dd[3] = {d.x, d.y, d.z};
    float safe_d[3];
    float mint_box = -inf(), maxt_box = inf();
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      safe_d[k] = fabsf(dd[k]) > 1e-20f ? dd[k] : 1e-20f;
      float b0 = (G.bmin[k] - od[k]) / safe_d[k];
      float b1 = (G.bmax[k] - od[k]) / safe_d[k];
      mint_box = mx(mint_box, mn(b0, b1));
      maxt_box = mn(maxt_box, mx(b0, b1));
    }
    mint_box = mx(mint_box, 0.0f);
    float t_start = mx(mint_box, 0.0f);
    float t_end = mn(maxt_box, maxt);
    if (!(isfinite(t_start) && isfinite(t_end) && t_start < t_end))
      return false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float gs = od[k] + t_start * dd[k];
      float ge = od[k] + t_end * dd[k];
      step_dir[k] = dd[k] > 0.0f ? 1 : -1;
      int sv = (int)((gs - G.bmin[k]) / G.vs[k]);
      int ev = (int)((ge - G.bmin[k]) / G.vs[k]);
      voxel[k] = sv < 0 ? 0 : (sv > G.res[k] - 1 ? G.res[k] - 1 : sv);
      end_voxel[k] = ev < 0 ? 0 : (ev > G.res[k] - 1 ? G.res[k] - 1 : ev);
      float nvp = G.bmin[k] + (float)(voxel[k] + step_dir[k]) * G.vs[k] +
                  (dd[k] < 0.0f ? G.vs[k] : 0.0f);
      bool valid_dir = fabsf(dd[k]) > 1e-8f;
      float dm = valid_dir ? (nvp - gs) / safe_d[k] : inf();
      dtmax[k] = dm < 0.0f ? inf() : dm;
      tstep[k] = valid_dir ? G.vs[k] / safe_d[k] * (float)step_dir[k] : inf();
    }
    t = t_start;
    remaining = t_end - t_start;
    i = 0;
    return P.dda_max_steps > 0;
  }

  // does the walk reach z-slices [zlo, zhi)? Its voxel's z moves one
  // way (step_dir[2], or not at all); it ends at end_voxel's z, up to a
  // voxel of rounding (SLAB_MARGIN)
  static constexpr int SLAB_MARGIN = 2;
  __device__ __forceinline__ bool meets(int zlo, int zhi) const {
    if (!(tstep[2] < inf())) return voxel[2] >= zlo && voxel[2] < zhi;
    return step_dir[2] > 0
               ? voxel[2] < zhi && end_voxel[2] + SLAB_MARGIN >= zlo
               : voxel[2] >= zlo && end_voxel[2] - SLAB_MARGIN < zhi;
  }

  // one voxel: its deposit base exp(-st t) (1 - exp(-st dt)); false when
  // the walk ends here. SLAB: only the deposits in z-slices [zlo, zhi)
  // are made (and counted), and the walk ends where it leaves them
  template <bool SLAB = false, class SinkT>
  __device__ __forceinline__ bool step(const WfParams& P, const Grid& G,
                                       SinkT& S, float base, float st,
                                       int zlo = 0, int zhi = 0) {
    const int vz = voxel[2];
    float t_at = t;
    float dt = mn(mn(mn(dtmax[0], dtmax[1]), dtmax[2]), remaining);
    const int flat = G.flat(voxel[0], voxel[1], voxel[2]);
    const int slot = S.slot(voxel[0], voxel[1], voxel[2]);
    remaining = remaining - dt;
    bool act = (end_voxel[0] != voxel[0] || end_voxel[1] != voxel[1] ||
                end_voxel[2] != voxel[2]) &&
               remaining > 1e-6f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      bool m = dtmax[k] == dt;
      dtmax[k] = m ? tstep[k] : dtmax[k] - dt;
      if (act && m) voxel[k] += step_dir[k];
    }
    act = act && voxel[0] >= 0 && voxel[1] >= 0 && voxel[2] >= 0 &&
          voxel[0] < G.res[0] && voxel[1] < G.res[1] && voxel[2] < G.res[2];
    if (act) t = t + dt;
    if constexpr (SinkT::MED) {
      // the deposit's factors E = exp(-st t) and G = 1 - exp(-st dt)
      // for the medium cotangents; the sink carries E as a running
      // product of exp(-st dt) from the walk's start (MedSink::walk, dda)
      const float E = S.E;
      const float dtc = mx(dt, 0.0f);
      const float expdt = expf(-st * dtc);
      const float Gf = 1.0f - expdt;
      S.deposit(slot, flat, base * E * Gf);
      S.dda(E, Gf, dtc, expdt, t_at);
      return act && ++i < P.dda_max_steps;
    }
    float contrib = base * expf(-st * t_at) * (1.0f - expf(-st * mx(dt, 0.0f)));
    if (!SLAB || (unsigned)(vz - zlo) < (unsigned)(zhi - zlo)) {
      S.deposit(slot, flat, contrib);
      S.step();
    }
    if (SLAB && (step_dir[2] > 0 ? voxel[2] >= zhi : voxel[2] < zlo))
      return false;
    return act && ++i < P.dda_max_steps;
  }
};

// the walk of one segment, deposit by deposit
template <class SinkT>
__device__ __forceinline__ void dda_walk(const WfParams& P, const Grid& G,
                                         SinkT& S, const V3& o, const V3& d,
                                         float maxt, float base, float st) {
  DdaWalk w;
  if (!w.init(P, G, o, d, maxt)) return;
  if constexpr (SinkT::MED) S.walk(st, w.t);
  while (w.step(P, G, S, base, st)) {
  }
}

// A recording sink (wf_residual.cuh PathSink, wf_target.cuh TgtPathSink)
// records the segment in place of the walk; a sink with RATIO_RECORDS
// records a ratio-tracking segment too (ratio_segment)
template <class SinkT>
__device__ void dda_segment(const WfParams& P, const Grid& G, SinkT& S,
                            const V3& o, const V3& d, float maxt, float base,
                            float st) {
  if constexpr (SinkT::RECORDS) {
    S.record(P, G, o, d, maxt, base, st);
  } else {
    dda_walk(P, G, S, o, d, maxt, base, st);
  }
}

template <class SinkT>
__device__ void ratio_segment(const WfParams& P, const Grid& G, SinkT& S,
                              Rng& rng, const V3& o, const V3& d, float maxt,
                              float base, float st) {
  if constexpr (SinkT::RATIO_RECORDS) {
    S.ratio_record(P, G, rng, o, d, maxt, base, st);
    return;
  }
  float M = P.majorant;
  base = base * (st / M);
  float log_ratio = logf(mx(1.0f - st / M, 1e-30f));
  float t = 0.0f, k = 0.0f;
  for (int i = 0; i < RATIO_MAX_STEPS; ++i) {
    float u = rng.next1();
    t = t + free_flight(u, M);
    S.step();
    if (!(t < maxt)) break;
    int v[3];
    bool in_grid = G.voxel_of(along(o, t, d), v);
    float ratio_k = expf(k * log_ratio);
    const float k_at = k;
    k = k + 1.0f;
    if (in_grid) {
      S.deposit(S.slot(v[0], v[1], v[2]), G.flat(v[0], v[1], v[2]),
                base * ratio_k);
      if constexpr (SinkT::MED) S.ratio(base * ratio_k, ratio_k, k_at);
    }
  }
}

// ---- the hybrid residual: the forced first scatter, the fast event loop ---

// One chord's entry in the chord table (4 float4, 64 bytes): from the
// chord bank's record rec (12 floats: the K = 2 segments' entry points x0
// y0 x1 y1, directions, lengths, amplitudes; ops/transport2d.py
// chord_pack) and sigma_t, the parts of the first scatter that depend on
// the chord alone, as the plain version computes them: mass_k = amp_k
// exp(-st tau_k) (1 - exp(-st L_k)) (tau_0 = 0: amp_0 exp(-0) is amp_0
// exactly) and the segments' exp(-st L_k):
//   e[0] = (m0, m1, M = m0 + m1, 0)    e[1] = (L0, L1, exp(-st L0), exp(-st L1))
//   e[2 + k] = (x_k, y_k, dx_k, dy_k)
// The residual kernels read a lane's entry as three 16-byte loads
// (e[0], e[1], e[2 + k]); without the table a lane computes it
__device__ __forceinline__ void chord_entry(const float* __restrict__ rec,
                                            float st, float4* e) {
  const float L0 = rec[8], L1 = rec[9];
  const float e0 = expf(-st * L0), e1 = expf(-st * L1);
  const float m0 = rec[10] * (1.0f - e0);
  const float m1 = rec[11] * e0 * (1.0f - e1);
  e[0] = make_float4(m0, m1, m0 + m1, 0.0f);
  e[1] = make_float4(L0, L1, e0, e1);
  e[2] = make_float4(rec[0], rec[1], rec[4], rec[5]);
  e[3] = make_float4(rec[2], rec[3], rec[6], rec[7]);
}

// The first scatter's segment and distance on a chord of masses m = (m0,
// m1, M, 0) and lengths L = (L0, L1, exp(-st L0), exp(-st L1)): segment k
// with probability mass_k / M, then the truncated exponential along it
// (draw u1). Sets pick1 (segment 1) and t_ev
__device__ __forceinline__ void chord_event(const WfParams& P, Rng& rng,
                                            const float4& m, const float4& L,
                                            bool& pick1, float& t_ev) {
  const float st = P.sigma_t;
  const float M = m.z;
  const float u1 = rng.next1();
  pick1 = (u1 * M > m.x) && (L.y > 0.0f);
  const float L_k = pick1 ? L.y : L.x, m_k = pick1 ? m.y : m.x;
  const float e_k = pick1 ? L.w : L.z;
  const float um = clampf((u1 * M - (pick1 ? m.x : 0.0f)) / mx(m_k, 1e-30f),
                          0.0f, U_MAX);
  t_ev = -log1pf(-um * (1.0f - e_k)) / mx(st, 1e-30f);
  t_ev = mn(mx(t_ev, 0.0f), L_k);
}

// The first scatter event on the chord entry e, lifted to 3D at the
// lane's z = o.z: the segment and distance (chord_event), then the phase
// sample (draws u1, u2). Sets (o, d) to the post-event ray and M; false
// when the chord holds no mass (the lane is dead)
__device__ __forceinline__ bool first_scatter(const WfParams& P, Rng& rng,
                                              const float4* __restrict__ e,
                                              V3& o, V3& d, float& M) {
  const float4 m = e[0], L = e[1];
  M = m.z;
  if (!(M > 1e-12f)) return false;
  bool pick1;
  float t_ev;
  chord_event(P, rng, m, L, pick1, t_ev);
  const float4 sg = pick1 ? e[3] : e[2];
  const V3 o_k = {sg.x, sg.y, o.z};
  const V3 d_k = {sg.z, sg.w, 0.0f};
  o = along(o_k, t_ev, d_k);
  const float2 u2 = rng.next2();
  d = sample_phase(P.phase, P.phase_g, d_k, u2.x, u2.y);
  return true;
}

// A lane's in-medium chord as the geometric prologue records it: up to K
// = 2 straight 3D segments (o, d), their masses m and lengths L as
// chord_event reads them
struct Chord3 {
  float4 m, L;
  V3 o0, d0, o1, d1;
};

// The geometric first-scatter prologue (drtvam_tpu/ops/march.py:198-325),
// the chord bank's counterpart for a scene without one: the lane marches
// from its ray (o, d) through the scene's surfaces (intersect_scene;
// MESH_ON: the mesh surfaces too, the sink's banks), transmitting only,
// with no draw and no deposit. A dielectric refracts with weight (1 - F)
// / eta_rel^2 (0 at TIR), a null surface passes, any other absorbs; a
// crossing that enters the medium (its medium side, or the target) opens
// or extends the chord's current segment, a dielectric or a change of
// medium closes it into slot min(count, 1). The lane ends on a miss, at
// amplitude 0, or after 2 n_surf + 8 iterations, and an open segment is
// then closed. Then the masses as chord_entry's: mass_k = amp_k
// exp(-st tau_k) (1 - exp(-st L_k)), tau_0 = 0. The plain version's
// operations in its order (ops/march.py _first_scatter_prologue)
template <bool MESH_ON, class SinkT>
__device__ __forceinline__ void chord_march(const WfParams& P, SinkT& S,
                                            V3 o, V3 d, Chord3& c) {
  float L0 = 0.0f, L1 = 0.0f, amp0 = 0.0f, amp1 = 0.0f;
  c.o0 = c.d0 = c.o1 = c.d1 = V3{0.0f, 0.0f, 0.0f};
  V3 cs_o = {0.0f, 0.0f, 0.0f}, cs_d = {0.0f, 0.0f, 0.0f};
  float cs_L = 0.0f, cs_amp = 0.0f, amp = 1.0f;
  bool in_medium = false, opened = false;
  int cnt = 0;
  // the open segment into slot min(cnt, 1)
  auto flush = [&]() {
    if (cnt == 0) {
      c.o0 = cs_o;
      c.d0 = cs_d;
      L0 = cs_L;
      amp0 = cs_amp;
    } else {
      c.o1 = cs_o;
      c.d1 = cs_d;
      L1 = cs_L;
      amp1 = cs_amp;
    }
    ++cnt;
    opened = false;
  };
  const int max_iters = 2 * P.n_surf + 8;
  for (int it = 0; it < max_iters; ++it) {
    S.pro_iter();
    V3 n_si;
    int sid;
    float t_si;
    if constexpr (MESH_ON) {
      t_si = intersect_scene<true, SinkT::COUNT, SinkT::STAGED>(
          P, o, d, n_si, sid, S.mesh, &S.banks, &S.mc);
    } else {
      t_si = intersect_scene(P, o, d, n_si, sid);
    }
    if (!isfinite(t_si)) break;
    const bool hit_target = P.surf_is_target[sid] != 0;
    if (in_medium) {
      // open a segment at the start of an in-medium stretch
      if (!opened) {
        cs_o = o;
        cs_d = d;
        cs_amp = amp;
        cs_L = 0.0f;
        opened = true;
      }
      cs_L = cs_L + t_si;
    }
    const int kind = P.surf_bsdf[sid];
    const bool is_diel = kind == DIELECTRIC;
    float w = kind == NULL_BSDF ? 1.0f : 0.0f;
    V3 d_new = d;
    if (is_diel) {
      V3 d_t, d_r;
      float F, eta_rel;
      bool tir;
      refract(d, n_si, P.surf_eta[sid], d_t, d_r, F, tir, eta_rel);
      w = tir ? 0.0f : (1.0f - F) / (eta_rel * eta_rel);
      d_new = d_t;
    }
    o = along(o, t_si, d);
    d = d_new;
    amp = amp * w;
    const int ms = P.surf_medium_side[sid];
    const float dn = dot3(d, n_si);
    const bool enters = (ms == 1 && dn < 0.0f) || (ms == 2 && dn > 0.0f);
    const bool in_med_next = hit_target || enters;
    // the stretch ends where the direction or the medium changes; a null
    // or target crossing that stays in the medium extends it
    if (opened && in_medium && (is_diel || !in_med_next)) flush();
    in_medium = in_med_next;
    if (!(amp > 0.0f)) break;
  }
  if (opened) flush();  // the iteration cap's flush
  const float st = P.sigma_t;
  const float e0 = expf(-st * L0), e1 = expf(-st * L1);
  const float m0 = amp0 * (1.0f - e0);
  const float m1 = amp1 * e0 * (1.0f - e1);
  c.m = make_float4(m0, m1, m0 + m1, 0.0f);
  c.L = make_float4(L0, L1, e0, e1);
}

// The first scatter event on the prologue's chord c (3D segments: a
// segment keeps its own direction, d.z != 0 under a non-collimated
// projector): first_scatter's draws and arithmetic on them. Sets (o, d)
// to the post-event ray and M; false when the chord holds no mass
__device__ __forceinline__ bool first_scatter3(const WfParams& P, Rng& rng,
                                               const Chord3& c, V3& o, V3& d,
                                               float& M) {
  M = c.m.z;
  if (!(M > 1e-12f)) return false;
  bool pick1;
  float t_ev;
  chord_event(P, rng, c.m, c.L, pick1, t_ev);
  const V3 o_k = pick1 ? c.o1 : c.o0;
  const V3 d_k = pick1 ? c.d1 : c.d0;
  o = along(o_k, t_ev, d_k);
  const float2 u2 = rng.next2();
  d = sample_phase(P.phase, P.phase_g, d_k, u2.x, u2.y);
  return true;
}

// The convex medium region's exit distance from inside: a cylinder's far
// side root (0 when it lies beyond the open tube's z range, so the lane
// dies without an event, as in the general loop) or a box's far slab
__device__ __forceinline__ float exit_distance(const WfParams& P,
                                               const V3& o, const V3& d) {
  const float* mp = P.surf_params + 3 * P.res_surf;
  if (P.surf_kind[P.res_surf] == CYLINDER) {
    const float r = mp[0];
    const float a = d.x * d.x + d.y * d.y;
    const float b = 2.0f * (o.x * d.x + o.y * d.y);
    const float c = o.x * o.x + o.y * o.y - r * r;
    const float disc = mx(b * b - 4.0f * a * c, 0.0f);
    const float t_side =
        a > 1e-20f ? (-b + sqrtf(disc)) * 0.5f / mx(a, 1e-20f) : inf();
    const float z_hit = o.z + t_side * d.z;
    const bool ok = isfinite(t_side) && z_hit >= mp[1] && z_hit <= mp[2];
    return ok ? mx(t_side, 0.0f) : 0.0f;
  }
  float t_far = inf();
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float dk = comp(d, k), ok = comp(o, k);
    const float inv = 1.0f / (fabsf(dk) > 1e-20f ? dk : 1e-20f);
    t_far = mn(t_far, mx((-mp[k] - ok) * inv, (mp[k] - ok) * inv));
  }
  return mx(t_far, 0.0f);
}

// the inside mask at p, its voxel at inv voxels per unit length; false
// outside the film
__device__ __forceinline__ bool inside_at(const Grid& G,
                                          const unsigned char* mask,
                                          const V3& p, const float* inv) {
  int v[3];
  return G.voxel_of(p, v, inv) && mask[G.flat(v[0], v[1], v[2])] != 0;
}

// voxels per unit length as the first-scatter seed and the fast residual
// take them: res / extent, as the plain version
__device__ __forceinline__ void inv_extent(const Grid& G, float* inv) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    inv[k] = (float)G.res[k] / (G.bmax[k] - G.bmin[k]);
}

// The delta residual's events after the forced first scatter (weight A):
// per event Russian roulette past rr_depth, the free flight against the
// exit distance (reaching it ends the lane), the deposit A ((1 - albedo)
// em) at the event voxel, the albedo factor and the phase sample; draws
// u_rr, u_ff, u_b (unused) and u_ph, the general loop's order. The voxel
// is taken at res / extent voxels per unit length, as the plain version
template <class SinkT>
__device__ void fast_residual(const WfParams& P, const Grid& G, SinkT& S,
                              Rng& rng, V3 o, V3 d, float A, float em) {
  const float al = P.albedo;
  const float inv_st = 1.0f / mx(P.sigma_t, 1e-30f);
  const float base_w = (1.0f - al) * (SinkT::PRIMAL ? em : 1.0f);
  float inv_ext[3];
  inv_extent(G, inv_ext);
  for (int j = 0; j < P.max_depth - 1; ++j) {
    S.iter();
    const float u_rr = rng.next1();
    if (j + 1 > P.rr_depth) {
      const float q = mn(A, 0.99f);
      if (!(u_rr < q)) return;
      A = A / mx(q, 1e-12f);
    }
    const float t_exit = exit_distance(P, o, d);
    const float t = -log1pf(-clampf(rng.next1(), 0.0f, U_MAX)) * inv_st;
    if (!(t < t_exit)) return;
    const V3 p = along(o, t, d);
    int v[3];
    if (G.voxel_of(p, v, inv_ext)) {
      const int flat = G.flat(v[0], v[1], v[2]);
      // the event voxel's channel from the inside mask
      if constexpr (SinkT::TGT) S.chan = S.two && S.mask[flat] != 0 ? 0 : 1;
      S.deposit(S.slot(v[0], v[1], v[2]), flat, A * base_w);
      S.step();
    }
    A = A * al;
    rng.next1();  // u_b: the BSDF's draw, unused at a medium event
    const float2 u_ph = rng.next2();
    d = sample_phase(P.phase, P.phase_g, d, u_ph.x, u_ph.y);
    o = p;
  }
}

// ---- the per-lane path loop -----------------------------------------------

// The camera frame of circular motion at `time` (models/projector.py
// sample_rays' look-at): world origin and the columns left, up2, dirw
struct Frame {
  V3 origin, left, up2, dirw;
};
__device__ __forceinline__ Frame frame_at(const WfParams& P, float time) {
  float alpha = TWO_PI * time;
  if (P.clockwise) alpha = -alpha;
  const float md = P.motion_distance;
  Frame F;
  F.origin = {md * cosf(alpha), md * sinf(alpha), md * 0.0f};
  F.dirw = div3({-F.origin.x, -F.origin.y, -F.origin.z}, norm3(F.origin));
  V3 left = cross3({0.0f, 0.0f, 1.0f}, F.dirw);
  F.left = div3(left, norm3(left));
  F.up2 = cross3(F.dirw, F.left);
  return F;
}
// the frame of angle a without time sampling: time = a / n_patterns, as
// a lane computes it; the residual kernels hold their CTA's angles' frames
// in shared memory
__device__ __forceinline__ Frame angle_frame(const WfParams& P, int a) {
  return frame_at(P, (float)a / (float)P.n_patterns);
}

// What the residual kernels hand a lane from its launch order and their
// tables (wf_residual.cuh): its emitter (angle), DMD row and column, its
// angle's frame (null with time sampling: computed per lane) and its
// chord table entry (null: computed from the chord bank)
struct LaneSetup {
  int emitter, py, px;
  const Frame* frame;
  const float4* chord;
};

// RES: the residual mode; chords: the chord bank (FIRST_SCATTER,
// FAST_RESIDUAL), (A * resx, 12) floats; GEO: those modes without a bank,
// each lane marching to its chord (chord_march); su: the residual
// kernels' set-up (null: the lane derives its indices, frame and chord
// entry itself)
template <int EST, bool SCAT, bool TONLY, int RES = ANALOG, bool GEO = false,
          class SinkT>
__device__ void trace_lane(const WfParams& P, const Grid& G, uint32_t lane,
                           int aidx, const int* __restrict__ active_pixels,
                           float em, SinkT& S,
                           const float* __restrict__ chords = nullptr,
                           const LaneSetup* su = nullptr) {
  Rng rng{P.seed + 0x9E3779B9u, lane, 0u};

  // ---- ray generation (models/projector.py sample_rays)
  const int w = P.resx, h = P.resy;
  int emitter, py, px;
  if (su != nullptr) {
    emitter = su->emitter;
    py = su->py;
    px = su->px;
  } else {
    const int idx = P.identity ? aidx : active_pixels[aidx];
    emitter = idx / (h * w);
    const int pixel = idx % (h * w);
    py = pixel / w;
    px = pixel - py * w;
  }
  float2 u_pos = rng.next2();
  float sx = P.regular_sampling ? (float)px + 0.5f : (float)px + u_pos.x;
  float sy = P.regular_sampling ? (float)py + 0.5f : (float)py + u_pos.y;
  sx = sx / (float)w;
  sy = sy / (float)h;
  float u_t = rng.next1();
  float time = (float)emitter;
  if (P.sample_time) time = time + u_t;
  time = time / (float)P.n_patterns;
  float2 u_ap = rng.next2();

  const float ex = (float)w * P.pixel_size[0];
  const float ey = (float)h * P.pixel_size[1];
  const float focus = P.focus_distance;
  V3 o_cam, d_cam;
  if (P.kind == 0) {
    o_cam = {(0.5f - sx) * ex, (0.5f - sy) * ey, 0.0f};
    d_cam = {0.0f, 0.0f, 1.0f};
  } else {
    float2 dk = disk_concentric(u_ap);
    float apx = P.aperture_radius * dk.x, apy = P.aperture_radius * dk.y;
    V3 dd;
    if (P.kind == 1) {
      o_cam = {(0.5f - sx) * ex + apx, (0.5f - sy) * ey + apy, 0.0f};
      dd = {-apx, -apy, 0.0f + focus};
    } else {
      o_cam = {apx, apy, 0.0f};
      dd = {(0.5f - sx) * ex - apx, (0.5f - sy) * ey - apy,
            (0.0f + focus) - 0.0f};
    }
    d_cam = div3(dd, norm3(dd));
  }
  const Frame F = (su != nullptr && su->frame != nullptr) ? *su->frame
                                                          : frame_at(P, time);
  V3 o = rotate(F.left, F.up2, F.dirw, o_cam);
  o = {o.x + F.origin.x, o.y + F.origin.y, o.z + F.origin.z};
  V3 d = rotate(F.left, F.up2, F.dirw, d_cam);
  if constexpr (RES == CORNER) {
    // the corner filter: one intersection; the lane is kept unless its
    // hit lies within radius of a corner at dist from the axis
    V3 n_c;
    int sid_c;
    const float t = intersect_scene<true, SinkT::COUNT, SinkT::STAGED>(
        P, o, d, n_c, sid_c, S.mesh, &S.banks, &S.mc);
    const V3 p = along(o, t, d);
    const float ax = fabsf(p.x) - S.dist, ay = fabsf(p.y) - S.dist;
    S.L = isfinite(t) && sqrtf(ax * ax + ay * ay) >= S.radius ? 1.0f : 0.0f;
    return;
  }
#ifdef WF_RES_STOP
  if (RES != ANALOG && WF_RES_STOP == 1) {
    S.keep(RES == SCAT_ONLY ? o.x + o.y + o.z + d.x + d.y + d.z : o.z);
    return;
  }
#endif

  // ---- the bounce loop (ops/march.py trace_wavefront)
  const float st = P.sigma_t;
  const float sa_over_st = 1.0f - P.albedo;
  float A = 1.0f, total_t = 0.0f;
  bool inside_target = false, in_medium = false;
  int depth = 0;
  bool scattered = false;  // SCAT_ONLY: n_scat > 0
  if (RES == FIRST_SCATTER || RES == FAST_RESIDUAL) {
    // the lane starts at its forced first scatter (n_scat 1): the
    // pre-scatter attenuation and the event's albedo are in A
    float M;
    bool alive;
    if constexpr (GEO) {
      Chord3 c;
      chord_march<SinkT::TGT>(P, S, o, d, c);
      alive = first_scatter3(P, rng, c, o, d, M);
    } else if (su != nullptr && su->chord != nullptr) {
      alive = first_scatter(P, rng, su->chord, o, d, M);
    } else {
      float4 e[4];
      chord_entry(chords + 12 * (emitter * w + px), P.sigma_t, e);
      alive = first_scatter(P, rng, e, o, d, M);
    }
    if (!alive) return;
#ifdef WF_RES_STOP
    if (WF_RES_STOP == 2) {
      S.keep(o.x + o.y + o.z + d.x + d.y + d.z + M);
      return;
    }
#endif
    A = P.albedo * M;
    if constexpr (SinkT::TGT) {
      // the inside flag at the first scatter event, from the inside mask
      if (S.two) {
        float inv[3];
        inv_extent(G, inv);
        inside_target = inside_at(G, S.mask, o, inv);
      }
    }
    if (RES == FAST_RESIDUAL) {
      fast_residual(P, G, S, rng, o, d, A, em);
      return;
    }
    in_medium = true;
    depth = 1;
  }
  if constexpr (SinkT::MED) S.nsc = 0.0f;  // the lane's n_scat
  const int max_iters = 2 * P.max_depth + 16;
  for (int it = 0; it < max_iters; ++it) {
    S.iter();
    // Russian roulette (the radon mode's reads the scene's scattering)
    const bool rr_scat = RES == RADON ? P.has_scattering != 0 : SCAT;
    float rr_A = rr_scat ? A : A * expf(-st * total_t);
    float q = mn(rr_A, 0.99f);
    bool perform_rr = depth > P.rr_depth;
    float u_rr = rng.next1();
    if (perform_rr) {
      if (!(u_rr < q)) break;
      A = A / mx(q, 1e-12f);
    }
    if (A == 0.0f) break;

    // next surface
    V3 n_si;
    int sid;
    float t_si;
    if constexpr (RES == RADON || SinkT::TGT) {
      t_si = intersect_scene<true, SinkT::COUNT, SinkT::STAGED>(
          P, o, d, n_si, sid, S.mesh, &S.banks, &S.mc);
    } else {
      t_si = intersect_scene(P, o, d, n_si, sid);
    }
    if (!isfinite(t_si)) break;
    const bool hit_target = P.surf_is_target[sid] != 0;

    // medium interaction sampling
    float u_ff = rng.next1();
    float mei_t = inf();
    bool reached_surface = in_medium;
    float w_med = 1.0f;
    if (SCAT) {
      mei_t = free_flight(u_ff, st);
      reached_surface = in_medium && (t_si < mei_t);
      if (reached_surface) mei_t = inf();
      w_med = reached_surface ? 1.0f : 1.0f / st;
    }
    const bool medium_event = in_medium && !reached_surface;

    // dose deposit along this segment (the residual drops the deposits
    // before the first scatter: the ballistic engine owns them); the
    // radon mode's in-target absorption in its place
    if constexpr (RES == RADON) {
      if (inside_target && in_medium)
        S.L = S.L + A * expf(-st * total_t) * (1.0f - expf(-st * t_si));
    } else if (in_medium && (RES != SCAT_ONLY || scattered)) {
      if constexpr (SinkT::TGT) S.chan = inside_target ? 0 : 1;
      float base;
      if constexpr (SinkT::MED) {
        // the history (A, without scattering A exp(-st t_prev)) apart
        const float hist = SCAT ? A : A * expf(-st * total_t);
        S.segment(hist, em, total_t);
        base = hist * sa_over_st;
      } else {
        base = (SCAT ? A : A * expf(-st * total_t)) * sa_over_st;
      }
      if (SinkT::PRIMAL) base = base * em;
      if (EST == DDA) {
        dda_segment(P, G, S, o, d, t_si, base, st);
      } else if (EST == RATIO) {
        ratio_segment(P, G, S, rng, o, d, t_si, base, st);
      } else if (isfinite(mei_t)) {
        int v[3];
        if (G.voxel_of(along(o, mei_t, d), v)) {
          S.deposit(S.slot(v[0], v[1], v[2]), G.flat(v[0], v[1], v[2]),
                    base);
          if constexpr (SinkT::MED) S.delta(mei_t);
          S.step();
        }
      }
    }

    // inside / outside parity flip (may leak, as the reference's)
    inside_target = inside_target != hit_target;

    // BSDF sampling at surfaces
    const bool active_surface = !medium_event;
    float u_b = rng.next1();
    float2 u_ph = rng.next2();
    const int kind = P.surf_bsdf[sid];
    V3 d_new = d;
    float w_bsdf = kind == NULL_BSDF ? 1.0f : 0.0f;
    if (kind == DIELECTRIC) {
      V3 d_t, d_r;
      float F, eta_rel;
      bool tir;
      refract(d, n_si, P.surf_eta[sid], d_t, d_r, F, tir, eta_rel);
      float inv_eta2 = 1.0f / (eta_rel * eta_rel);
      float w_tr = tir ? 0.0f : (1.0f - F) * inv_eta2;
      if (TONLY || depth == 0) {
        d_new = d_t;
        w_bsdf = w_tr;
      } else {
        bool reflectp = u_b < F;
        d_new = reflectp ? d_r : d_t;
        w_bsdf = reflectp ? 1.0f : inv_eta2;
      }
    }
    if (!TONLY && kind == DIFFUSE && depth != 0) {
      // cosine-hemisphere reflection on the incident side, weight =
      // reflectance
      V3 nl = dot3(d, n_si) < 0.0f ? n_si : V3{-n_si.x, -n_si.y, -n_si.z};
      V3 tg, btg;
      onb(nl, tg, btg);
      V3 hh = cosine_hemisphere(u_ph);
      d_new = {hh.x * tg.x + hh.y * btg.x + hh.z * nl.x,
               hh.x * tg.y + hh.y * btg.y + hh.z * nl.y,
               hh.x * tg.z + hh.y * btg.z + hh.z * nl.z};
      w_bsdf = P.surf_refl[sid];
    }

    // phase sampling at medium events, position and attenuation update
    const float seg_t = medium_event ? mei_t : t_si;
    o = along(o, seg_t, d);
    if (medium_event) {
      d = sample_phase(P.phase, P.phase_g, d, u_ph.x, u_ph.y);
      A = A * (w_med * (st * P.albedo));
      scattered = true;
      if constexpr (SinkT::MED) S.nsc = S.nsc + 1.0f;
    } else {
      d = d_new;
      A = A * w_bsdf;
    }
    if constexpr (RES == RADON) {
      total_t = total_t + t_si;  // every segment, as the reference's radon
    } else {
      if (in_medium) total_t = total_t + seg_t;
    }

    // medium transition: does the new direction enter the medium?
    const int ms = P.surf_medium_side[sid];
    const float dn = dot3(d, n_si);
    const bool enters = (ms == 1 && dn < 0.0f) || (ms == 2 && dn > 0.0f);
    in_medium = (in_medium && !reached_surface) ||
                (active_surface && (hit_target || enters));
    if (!(active_surface || in_medium) || A == 0.0f) break;
    if (!hit_target) ++depth;
    if (depth >= P.max_depth) break;
  }
}

// ---- the launch order: lanes grouped by their home z-slice ---------------

// Block c traces DMD row py = c / n_groups over angle group
// c % n_groups: positions [lo, hi) of the active pixels sorted by (row,
// angle, pixel). The identity store's order is arithmetic; a sparse
// store's is the permutation `order` with each block's first position
// in `starts` (ops/render.py block_order).
__device__ __forceinline__ void block_range(const WfParams& P,
                                              const int* starts, int c,
                                              int& lo, int& hi, int& py) {
  py = c / P.n_groups;
  if (P.identity) {
    const int g = c - py * P.n_groups;
    const int row = P.n_patterns * P.resx;  // one DMD row, every angle
    const int a1 = (g + 1) * P.group;
    lo = py * row + g * P.group * P.resx;
    hi = py * row + (a1 < P.n_patterns ? a1 : P.n_patterns) * P.resx;
  } else {
    lo = starts[c];
    hi = starts[c + 1];
  }
}

// A block's warps trace its range [lo, hi) in tasks of 32 neighbouring
// positions. The forward gives each thread one lane (task t: positions
// lo + 32 (t / spp) + l, lane t % spp of each pixel), so that a warp's
// threads start and end together; the adjoint gives each thread all the
// lanes of its pixel (task t: positions lo + 32 t + l), whose sum it
// takes in lane order
template <bool PRIMAL>
__device__ __forceinline__ int task_count(const WfParams& P, int lo,
                                          int hi) {
  return (PRIMAL ? P.spp : 1) * ((hi - lo + 31) / 32);
}

// the active index at sorted position j
__device__ __forceinline__ int lane_aidx(const WfParams& P, const int* order,
                                         int j) {
  if (!P.identity) return order[j];
  const int row = P.n_patterns * P.resx;
  const int py = j / row;
  const int r = j - py * row;
  const int a = r / P.resx;
  const int px = r - a * P.resx;
  return (a * P.resy + py) * P.resx + px;
}

// Task t's work for lane l: the forward traces lane t % spp of the
// pixel at position lo + 32 (t / spp) + l, the adjoint all the lanes of
// the pixel at lo + 32 t + l, summed in lane order, and writes the
// pixel's gradient (the sum times the ray weight) once. Positions from
// hi on are none. Returns the pixel's active index, or -1 for none
template <int EST, bool SCAT, bool TONLY, class SinkT>
__device__ __forceinline__ int trace_task(const WfParams& P, const Grid& G,
                                           const int* order, int lo, int hi,
                                           int t, int l, const float* in,
                                           const int* active_pixels,
                                           float* out, SinkT& S) {
  if (SinkT::PRIMAL) {
    const int j = lo + 32 * (t / P.spp) + l;
    if (j >= hi) return -1;
    const int aidx = lane_aidx(P, order, j);
    // em = pattern value x ray weight; a pixel at 0 deposits only zeros
    const float em = in[aidx] * P.ray_w;
    if (em == 0.0f) return aidx;
    // the one lane, as a loop that runs once: nvcc's code for this form
    // ran 6 % faster on an H100 than a plain call (PERF.md section 6)
    for (int k = t % P.spp; k < P.spp; k += P.spp) {
      trace_lane<EST, SCAT, TONLY>(
          P, G, (uint32_t)aidx * (uint32_t)P.spp + (uint32_t)k, aidx,
          active_pixels, em, S);
    }
    return aidx;
  }
  const int j = lo + 32 * t + l;
  if (j >= hi) return -1;
  const int aidx = lane_aidx(P, order, j);
  // the adjoint's deposits take no em
  float em = 1.0f;
  float gsum = 0.0f;
  for (int k = 0; k < P.spp; ++k) {
    S.g = 0.0f;
    trace_lane<EST, SCAT, TONLY>(
        P, G, (uint32_t)aidx * (uint32_t)P.spp + (uint32_t)k, aidx,
        active_pixels, em, S);
    gsum = k == 0 ? S.g : gsum + S.g;
  }
  out[aidx] = gsum * P.ray_w;
  return aidx;
}

#ifdef __CUDACC__
// (everything above is plain C++ on stubs of the CUDA names, so the
// per-lane template and the launch order also build with a host
// compiler: tests/test_torch_wf_template.py holds them to the plain
// version there, tracing in this kernel's order)

// threads a CTA: one CTA an SM (the tile takes most of its shared
// memory), 32 warps, at most 64 registers a thread
constexpr int WF_THREADS = 1024;

// The home-slice tile of a CTA's DMD row: the row table (rows, the
// film's resy rows) copied into srows and the tile's values zeroed
// (tile_zero), then each nonzero value added to the accumulator out with
// one global atomic (tile_flush), by the CTA's n_warps warps. TGT: the
// tile holds ch floats a voxel and keeps the rows that end within
// P.tile_n voxels (shape())
template <bool TGT>
__device__ __forceinline__ void tile_zero(const WfParams& P, const Grid& G,
                                          const int4* __restrict__ rows,
                                          int4* srows, float* tile, int ch,
                                          int warp, int lane, int n_warps) {
  for (int y = warp; y < G.res[1]; y += n_warps) {
    int4 r = __ldg(rows + y);
    // a row that ends past the tile shape() kept holds no voxel
    if (TGT && r.z + r.x + r.y > P.tile_n) r.y = 0;
    if (lane == 0) srows[y] = r;
    if constexpr (TGT) {
      for (int i = ch * (r.z + r.x) + lane; i < ch * (r.z + r.x + r.y);
           i += 32)
        tile[i] = 0.0f;
    } else {
      for (int x = r.x + lane; x < r.x + r.y; x += 32) tile[r.z + x] = 0.0f;
    }
  }
}
template <bool TGT>
__device__ __forceinline__ void tile_flush(const Grid& G, const int4* srows,
                                           const float* tile, int home,
                                           int ch, float* __restrict__ out,
                                           int warp, int lane, int n_warps) {
  const int slice0 = home * G.res[0] * G.res[1];
  for (int y = warp; y < G.res[1]; y += n_warps) {
    const int4 r = srows[y];
    if constexpr (TGT) {
      // value i of the row: voxel r.x + i / ch, channel i % ch
      const int row0 = slice0 + y * G.res[0] + r.x;
      for (int i = lane; i < ch * r.y; i += 32) {
        const float v = tile[ch * (r.z + r.x) + i];
        if (v != 0.0f) atomicAdd(out + ch * row0 + i, v);
      }
    } else {
      for (int x = r.x + lane; x < r.x + r.y; x += 32) {
        const float v = tile[r.z + x];
        if (v != 0.0f) atomicAdd(out + slice0 + y * G.res[0] + x, v);
      }
    }
  }
}

// a launch's counters (ops/render.py COUNTERS): iterations, steps, tile
// and global deposits, lane slots, and the target's grid cells,
// triangles and grid walks; each warp's sums added with one atomic each
constexpr int WF_N_COUNTERS = 8;
__device__ __forceinline__ void add_counters(
    unsigned long long* c, int lane, unsigned long long* __restrict__ out) {
#pragma unroll
  for (int k = 0; k < WF_N_COUNTERS; ++k) {
    for (int off = 16; off > 0; off >>= 1)
      c[k] += __shfl_down_sync(0xffffffffu, c[k], off);
    if (lane == 0 && c[k] != 0) atomicAdd(out + k, c[k]);
  }
}

// the geometric prologue's iterations c (the instantiations without a
// chord bank): each warp's sum added with one atomic into
// out[WF_N_COUNTERS], after the COUNTERS
__device__ __forceinline__ void add_prologue_count(
    unsigned long long c, int lane, unsigned long long* __restrict__ out) {
  for (int off = 16; off > 0; off >>= 1)
    c += __shfl_down_sync(0xffffffffu, c, off);
  if (lane == 0 && c != 0) atomicAdd(out + WF_N_COUNTERS, c);
}

// Sink's task hooks (declared with it): the task counter published, the
// CTA's tasks; task t by trace_task and, with COUNT, the lane slots a
// warp spends, 32 on each step of its longest lane
template <bool PRIMAL_, bool COUNT_, bool TGT_, bool STAGED_>
template <int THREADS>
__device__ __forceinline__ unsigned Sink<PRIMAL_, COUNT_, TGT_, STAGED_>::begin(
    const WfParams& P, const int*, int lo, int hi) {
  __syncthreads();
  return (unsigned)task_count<PRIMAL>(P, lo, hi);
}
template <bool PRIMAL_, bool COUNT_, bool TGT_, bool STAGED_>
template <int EST, bool SCAT, bool TONLY>
__device__ __forceinline__ void Sink<PRIMAL_, COUNT_, TGT_, STAGED_>::task(
    const WfParams& P, const Grid& G, const int* order, int lo, int hi, int t,
    int l, const float* in, const int* active_pixels, float* out) {
  const unsigned long long s0 = steps;
  trace_task<EST, SCAT, TONLY>(P, G, order, lo, hi, t, l, in, active_pixels,
                               out, *this);
  if (COUNT) {
    unsigned long long d = steps - s0;
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, d, off);
      d = o > d ? o : d;
    }
    if (l == 0) slots += 32 * d;
  }
}

// One CTA of THREADS threads per (DMD row, angle group); its warps take
// 32 neighbouring positions of the CTA's range at a time from a counter
// in shared memory. The forward's dynamic shared memory holds the tile's
// row table (the film's resy rows) and then the tile (P.tile_n voxels, a
// float for each of their channels), zeroed before the first barrier and
// flushed with one global atomic per nonzero value after the second. The
// adjoint takes no tile (P.tile_n 0). The analog instantiations only (RES
// ANALOG): the residual family has its own kernels (wf_residual.cuh). TGT:
// the scene keeps the target, M its mesh, tris the triangle rows its
// tests read (ops/render.py cull_rows), in global memory, or STAGED in the
// adjoint's dynamic shared memory (wf_target.cuh). SinkT: the sink, its
// task hooks the CTA's loop (Sink::begin, Sink::task); bind: the sink's
// own launch arguments, each handed to its bind() after the CTA's set-up
// (the medium adjoint's, wf_med.cuh)
template <int EST, bool SCAT, bool TONLY, bool PRIMAL, bool COUNT, bool TGT,
          int THREADS, bool STAGED, class SinkT, class... Bind>
__device__ __forceinline__ void wf_cta(
    const WfParams& P, const WfMesh& M, const float4* __restrict__ tris,
    const float* __restrict__ in, const int* __restrict__ active_pixels,
    const int* __restrict__ order, const int* __restrict__ starts,
    const int4* __restrict__ rows, float* __restrict__ out,
    unsigned long long* __restrict__ counters, const Bind&... bind) {
  static_assert(!(STAGED && PRIMAL), "the forward's shared memory is its tile");
  extern __shared__ int4 smem[];
  __shared__ unsigned next_task;
  int lo, hi, py;
  block_range(P, starts, blockIdx.x, lo, hi, py);
  Grid G;
  G.init(P);
  int4* srows = smem;
  float* tile = reinterpret_cast<float*>(smem + G.res[1]);
  const int home = P.tile_n > 0 ? home_slice(P, G, py) : -1;
  SinkT S{out, in, tile, srows, home, 0.0f, 0, 0, 0, 0};
  (S.bind(bind), ...);
  // the tile's floats a voxel
  const int ch = (TGT && P.target == 2) ? 2 : 1;
  if constexpr (TGT) {
    S.two = P.target == 2;
    S.mesh = &M;
    S.banks = {tris, M.cell_start, M.tri_ids};
    if constexpr (STAGED)
      S.banks = stage_banks(S.banks, M.n_rows, M.n_cell_start, M.n_tri_ids,
                            reinterpret_cast<float4*>(smem), threadIdx.x,
                            THREADS);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int n_warps = THREADS / 32;
  if (PRIMAL && home >= 0)
    tile_zero<TGT>(P, G, rows, srows, tile, ch, warp, lane, n_warps);
  if (threadIdx.x == 0) next_task = 0;
  const unsigned n_tasks = S.template begin<THREADS>(P, order, lo, hi);

  for (;;) {
    unsigned t = 0;
    if (lane == 0) t = atomicAdd(&next_task, 1u);
    t = __shfl_sync(0xffffffffu, t, 0);
    if (t >= n_tasks) break;
    S.template task<EST, SCAT, TONLY>(P, G, order, lo, hi, (int)t, lane, in,
                                      active_pixels, out);
  }

  if (PRIMAL && home >= 0) {
    __syncthreads();
    tile_flush<TGT>(G, srows, tile, home, ch, out, warp, lane, n_warps);
  }
  if (COUNT) {
    unsigned long long c[WF_N_COUNTERS] = {
        S.iters, S.steps, S.n_tile, S.n_global, S.slots, S.mc.cells,
        S.mc.tris, S.mc.walks};
    add_counters(c, lane, counters);
  }
}

// wf_kernel: the CTA above with the pair's sink
template <int EST, bool SCAT, bool TONLY, int RES, bool PRIMAL, bool COUNT,
          bool TGT, int THREADS = WF_THREADS, int MIN_CTAS = 1,
          bool STAGED = false>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    wf_kernel(const WfParams P, const __grid_constant__ WfMesh M,
              const float4* __restrict__ tris, const float* __restrict__ in,
              const int* __restrict__ active_pixels,
              const int* __restrict__ order, const int* __restrict__ starts,
              const int4* __restrict__ rows, float* __restrict__ out,
              unsigned long long* __restrict__ counters) {
  wf_cta<EST, SCAT, TONLY, PRIMAL, COUNT, TGT, THREADS, STAGED,
         Sink<PRIMAL, COUNT, TGT, STAGED>>(P, M, tris, in, active_pixels,
                                           order, starts, rows, out,
                                           counters);
}

using KernelFn = void (*)(const WfParams, const WfMesh, const float4*,
                          const float*, const int*, const int*, const int*,
                          const int4*, float*, unsigned long long*);

// The analog instantiation for P (wf_fwd, wf_bwd) by estimator,
// scattering, transmission_only and whether the scene keeps the target;
// nullptr for a residual P (the residual family is wf_residual.cuh's)
template <bool PRIMAL, bool COUNT, bool TGT>
KernelFn pick_target(const WfParams& P) {
  const int key = P.estimator * 4 + (P.has_scattering ? 2 : 0) +
                  (P.transmission_only ? 1 : 0);
#define WF_CASE(E, SC, TO)                  \
  case E * 4 + (SC ? 2 : 0) + (TO ? 1 : 0): \
    return wf_kernel<E, SC, TO, ANALOG, PRIMAL, COUNT, TGT>;
  switch (key) {
    WF_CASE(DDA, false, false)
    WF_CASE(DDA, false, true)
    WF_CASE(DDA, true, false)
    WF_CASE(DDA, true, true)
    WF_CASE(RATIO, false, false)
    WF_CASE(RATIO, false, true)
    WF_CASE(RATIO, true, false)
    WF_CASE(RATIO, true, true)
    WF_CASE(DELTA, false, false)
    WF_CASE(DELTA, false, true)
    WF_CASE(DELTA, true, false)
    WF_CASE(DELTA, true, true)
    default:
      return nullptr;
  }
#undef WF_CASE
}

template <bool PRIMAL, bool COUNT>
KernelFn pick(const WfParams& P) {
  if (P.residual != ANALOG) return nullptr;
  return P.target ? pick_target<PRIMAL, COUNT, true>(P)
                  : pick_target<PRIMAL, COUNT, false>(P);
}

// The dynamic shared memory a CTA takes, with the kernel's limit raised
// to it. A target instantiation keeps the first P.tile_n voxels that fit
// beside the kernel's static shared memory (the kernel drops the rows
// that end past them; ops/render.py tile_rows lays a two-channel tile
// out widest row first); any other clears P.tile_n (no tile) when the
// whole tile does not fit
template <class K>
inline cudaError_t shape(K k, WfParams& P, size_t& smem) {
  int dev, optin;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, (const void*)k);
  if (e != cudaSuccess) return e;
  const size_t ch = P.target == 2 ? 2 : 1;
  const size_t table = (size_t)P.res[1] * sizeof(int4);
  if (P.target && P.tile_n > 0 &&
      table + fa.sharedSizeBytes < (size_t)optin) {
    const size_t fit =
        ((size_t)optin - fa.sharedSizeBytes - table) / (ch * sizeof(float));
    if ((size_t)P.tile_n > fit) P.tile_n = (int)fit;
  }
  smem = P.tile_n > 0 ? table + (size_t)P.tile_n * ch * sizeof(float) : 0;
  if (smem + fa.sharedSizeBytes > (size_t)optin) {
    P.tile_n = 0;
    smem = 0;
  }
  return cudaFuncSetAttribute((const void*)k,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// P's instantiation, P.tile_n cleared for the adjoint (it takes no tile)
template <bool PRIMAL>
KernelFn pick_for(WfParams& P, bool count) {
  if (!PRIMAL) P.tile_n = 0;
  return count ? pick<PRIMAL, true>(P) : pick<PRIMAL, false>(P);
}

template <bool PRIMAL>
int launch(const WfParams* p, const WfMesh* M, const float4* tris,
           const float* in, const int* active_pixels, const int* order,
           const int* starts, const int4* rows, float* out,
           unsigned long long* counters, void* stream) {
  WfParams P = *p;
  if (P.n_active <= 0) return 0;
  if (P.n_surf > WF_MAX_SURF || P.n_groups <= 0 || P.group <= 0 ||
      (!P.identity && (order == nullptr || starts == nullptr)) ||
      (P.tile_n > 0 && rows == nullptr) || M == nullptr ||
      (P.target && tris == nullptr))
    return (int)cudaErrorInvalidValue;
  KernelFn k = pick_for<PRIMAL>(P, counters != nullptr);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  size_t smem;
  cudaError_t e = shape(k, P, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(unsigned)P.resy * P.n_groups, WF_THREADS, smem,
      (cudaStream_t)stream>>>(P, *M, tris, in, active_pixels, order, starts,
                              rows, out, counters);
  return (int)cudaGetLastError();
}

// The launch shape of P's instantiation (count: the counting one):
// {threads a CTA, CTAs, dynamic shared bytes a CTA, static shared bytes,
// registers a thread, local (stack and spill) bytes a thread, CTAs an
// SM holds, tile voxels (0: none)}
template <bool PRIMAL>
int info(const WfParams* p, int count, int* out) {
  WfParams P = *p;
  KernelFn k = pick_for<PRIMAL>(P, count != 0);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  size_t smem;
  cudaFuncAttributes fa;
  cudaError_t e = shape(k, P, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, (const void*)k);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, WF_THREADS,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  const int v[8] = {WF_THREADS, P.resy * P.n_groups, (int)smem,
                    (int)fa.sharedSizeBytes, fa.numRegs,
                    (int)fa.localSizeBytes, per_sm, P.tile_n};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
#endif  // __CUDACC__

}  // namespace wf
