// The residual pair's target path pass on the H100: the dda residual
// forward's path pass for a scene that keeps the target (the final render
// of a surface-aware scene, one channel; a two-channel film), behind
// wf_res_target.cu.
//
// Replaces the primal of drtvam_tpu/ops/march.py:913 trace_wavefront in
// its residual modes with the target mesh in the scene: the first scatter
// from the chord bank (_first_scatter_from_chords :328, :966-1002), the
// MESH branch of intersect_scene (:151-190) at every bounce, the
// two-channel segments (:405-417) and dda_segment (:586), whose segments
// become records (XLA, no Pallas kernel on this path).
//
// The one-pass instantiation it replaces (wf_residual.cuh res_kernel with
// PATH and TGT: 256 threads, the banks in global memory) gives each
// thread a lane's whole path. A residual lane starts at its first
// scatter, so the 32 lanes of a warp fly off in 32 directions: their
// paths take different numbers of bounces (a SIMT efficiency of 0.48 on
// cell (a)'s final render), and at each bounce their walks through the
// target's grid meet different cells, whose triangles each thread tests
// one by one while the warp waits on its longest walk (0.22 for the
// tests; ~66 tests a walk, ~28 a cell; PERF.md section 6). The design,
// each part measured on an H100 (tools/wf_variants.py res_target):
//   * one CTA per launch-order CTA (a DMD row and angle group) of
//     WF_RTP_THREADS threads, its angles' frames and, where they fit its
//     share of the SM, the target's banks staged in its shared memory
//     (wf_mesh.cuh stage_banks, dynamic shared memory past 48 KB), so
//     that the grid walk's chain of loads runs at shared memory's latency
//     (else the banks are read from global memory, the same kernel);
//   * persistent threads that refill lane by lane: a thread keeps its
//     lane between bounces (LaneState) and runs one iteration of the
//     bounce loop a turn; a thread whose lane has ended takes the next
//     lane of its CTA from its warp's chunk of lanes (WF_RTP_CHUNK,
//     claimed with one atomic in shared memory), the warp's needy threads
//     served together in lane order, as the walk pass refills from its
//     records (wf_residual.cuh walk_kernel). A warp no longer waits on
//     its longest path;
//   * the warp walks the target's grid together, one ray at a time: at a
//     bounce, each thread sets up its own ray's walk (wf_mesh.cuh
//     grid_walk_init, all at once), and the rays that enter the grid's
//     box are walked in lane order by all 32 threads, which take the
//     ray and its set-up from its thread and test each cell's triangles
//     side by side (share_nearest). A thread keeps its first hit at its
//     least t, the warp the least t after each cell (its stop rule), and
//     the walk's triangle is the first hit at that t in cell then list
//     order (grid_walk_cells): the walk's cells, stop rule, t, triangle
//     and counts are one thread's walk's;
//   * without a chord bank (res_tgt_prologue_kernel) a lane's start marches
//     it to its chord (wf_trace.cuh chord_march), the target's mesh
//     intersected by the thread alone: the start is a divergent section
//     of the refill, and the prologue a lane's fixed cost before its
//     bounces;
//   * each lane keeps its own random stream (its lane id), so each record
//     (o, d, maxt, base; PathSink's, the channel in the sign of maxt on a
//     two-channel film) is the one-pass instantiation's: the set of
//     records is the same, only their order moves. The walk pass
//     (wf_res_walk) walks them unchanged.
// ops/render.py res_tgt_route routes every such path pass here
// (wf_res_tgt_runs), before the launch; the launch stages the banks where
// they fit a CTA's share of the SM and reads them from global memory
// where they do not (res_tgt_shape). The one-pass instantiation stays for
// the scenes this form has no instantiation for (a reflecting surface)
// and as the tests' reference for the record set.
//
// Bound on the H100: the lanes' set-up and bounces (~90 float32
// operations each), the target's grid walks (~20 a cell, ~40 a triangle
// test) and the records, 32 bytes a segment, written once.
#pragma once

#include "wf_residual.cuh"

// Launch shape, chosen on an H100 (tools/wf_variants.py res_target):
// threads a CTA, CTAs an SM, lanes a warp claims at a time
#ifndef WF_RTP_THREADS
#define WF_RTP_THREADS 1024
#endif
#ifndef WF_RTP_MIN_CTAS
#define WF_RTP_MIN_CTAS 1
#endif
#ifndef WF_RTP_CHUNK
#define WF_RTP_CHUNK 32
#endif

namespace wf {

// trace_lane in parts (wf_trace.cuh), as this form's threads keep a lane
// between bounces: the lane's start (res_lane_start) and one iteration of
// the bounce loop in two parts around the intersection (res_bounce_start,
// res_bounce_end), with trace_lane's operations in its order on its state
// (LaneState), for the instantiations this form runs (the dda estimator,
// scattering, transmission only; RES FIRST_SCATTER or SCAT_ONLY; the
// target kept). trace_lane keeps its one piece: the other kernels built
// from these parts spilled more (the staged analog adjoint 12 more bytes
// of spill loads and 1.7 % more time on an H100, PERF.md section 6). The
// tests hold the two to the same records and counts (tests/
// test_torch_wf_template.py, this form against the one-pass
// instantiation).

// A lane between two iterations of the bounce loop: its random stream,
// ray, weight and the loop's flags (trace_lane's locals; the scene
// scatters, so no attenuation is carried), and the iterations so far
struct LaneState {
  Rng rng;
  V3 o, d;
  float A, em;
  int depth, it;
  bool inside_target, in_medium, scattered;
};

// The lane's ray (models/projector.py sample_rays) and, FIRST_SCATTER,
// its forced first scatter (GEO: from the geometric prologue, the lane's
// own march, the target's mesh intersected by the thread alone); false
// when it finds no mass. Arguments as trace_lane's
template <int RES, bool GEO, class SinkT>
__device__ __forceinline__ bool res_lane_start(
    const WfParams& P, const Grid& G, uint32_t lane, int aidx, float em,
    SinkT& S, const float* __restrict__ chords, const LaneSetup& su,
    LaneState& L) {
  L.rng = Rng{P.seed + 0x9E3779B9u, lane, 0u};
  Rng& rng = L.rng;
  L.em = em;
  L.it = 0;
  const int w = P.resx, h = P.resy;
  float2 u_pos = rng.next2();
  float sx = P.regular_sampling ? (float)su.px + 0.5f : (float)su.px + u_pos.x;
  float sy = P.regular_sampling ? (float)su.py + 0.5f : (float)su.py + u_pos.y;
  sx = sx / (float)w;
  sy = sy / (float)h;
  float u_t = rng.next1();
  float time = (float)su.emitter;
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
  const Frame F = su.frame != nullptr ? *su.frame : frame_at(P, time);
  V3& o = L.o;
  V3& d = L.d;
  o = rotate(F.left, F.up2, F.dirw, o_cam);
  o = {o.x + F.origin.x, o.y + F.origin.y, o.z + F.origin.z};
  d = rotate(F.left, F.up2, F.dirw, d_cam);

  L.A = 1.0f;
  L.inside_target = false;
  L.in_medium = false;
  L.depth = 0;
  L.scattered = false;  // SCAT_ONLY: n_scat > 0
  if (RES == FIRST_SCATTER) {
    // the lane starts at its forced first scatter (n_scat 1): the
    // pre-scatter attenuation and the event's albedo are in A
    float M;
    bool alive;
    if constexpr (GEO) {
      Chord3 c;
      chord_march<true>(P, S, o, d, c);
      alive = first_scatter3(P, rng, c, o, d, M);
    } else if (su.chord != nullptr) {
      alive = first_scatter(P, rng, su.chord, o, d, M);
    } else {
      float4 e[4];
      chord_entry(chords + 12 * (su.emitter * w + su.px), P.sigma_t, e);
      alive = first_scatter(P, rng, e, o, d, M);
    }
    if (!alive) return false;
    L.A = P.albedo * M;
    // the inside flag at the first scatter event, from the inside mask
    if (S.two) {
      float inv[3];
      inv_extent(G, inv);
      L.inside_target = inside_at(G, S.mask, o, inv);
    }
    L.in_medium = true;
    L.depth = 1;
  }
  return true;
}

// A bounce's Russian roulette; false when the lane ends
template <class SinkT>
__device__ __forceinline__ bool res_bounce_start(const WfParams& P, SinkT& S,
                                                 LaneState& L) {
  S.iter();
  float q = mn(L.A, 0.99f);
  bool perform_rr = L.depth > P.rr_depth;
  float u_rr = L.rng.next1();
  if (perform_rr) {
    if (!(u_rr < q)) return false;
    L.A = L.A / mx(q, 1e-12f);
  }
  return L.A != 0.0f;
}

// The rest of the bounce after its intersection (t_si, n_si, sid): the
// medium event or the surface, the segment's record, the BSDF or phase
// sample; false when the lane ends
template <int RES, class SinkT>
__device__ __forceinline__ bool res_bounce_end(const WfParams& P,
                                               const Grid& G, SinkT& S,
                                               LaneState& L, float t_si,
                                               const V3& n_si, int sid) {
  Rng& rng = L.rng;
  V3& o = L.o;
  V3& d = L.d;
  float& A = L.A;
  const float st = P.sigma_t;
  const float sa_over_st = 1.0f - P.albedo;
  if (!isfinite(t_si)) return false;
  const bool hit_target = P.surf_is_target[sid] != 0;

  // medium interaction sampling
  float u_ff = rng.next1();
  float mei_t = free_flight(u_ff, st);
  const bool reached_surface = L.in_medium && (t_si < mei_t);
  if (reached_surface) mei_t = inf();
  const float w_med = reached_surface ? 1.0f : 1.0f / st;
  const bool medium_event = L.in_medium && !reached_surface;

  // the segment's record (the residual drops the deposits before the
  // first scatter: the ballistic engine owns them)
  if (L.in_medium && (RES != SCAT_ONLY || L.scattered)) {
    S.chan = L.inside_target ? 0 : 1;
    const float base = A * sa_over_st * L.em;
    dda_segment(P, G, S, o, d, t_si, base, st);
  }

  // inside / outside parity flip (may leak, as the reference's)
  L.inside_target = L.inside_target != hit_target;

  // BSDF sampling at surfaces: transmission only
  const bool active_surface = !medium_event;
  rng.next1();  // u_b: the BSDF's draw, unused transmitting
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
    d_new = d_t;
    w_bsdf = tir ? 0.0f : (1.0f - F) * inv_eta2;
  }

  // phase sampling at medium events, position and weight update
  const float seg_t = medium_event ? mei_t : t_si;
  o = along(o, seg_t, d);
  if (medium_event) {
    d = sample_phase(P.phase, P.phase_g, d, u_ph.x, u_ph.y);
    A = A * (w_med * (st * P.albedo));
    L.scattered = true;
  } else {
    d = d_new;
    A = A * w_bsdf;
  }

  // medium transition: does the new direction enter the medium?
  const int ms = P.surf_medium_side[sid];
  const float dn = dot3(d, n_si);
  const bool enters = (ms == 1 && dn < 0.0f) || (ms == 2 && dn > 0.0f);
  L.in_medium = (L.in_medium && !reached_surface) ||
                (active_surface && (hit_target || enters));
  if (!(active_surface || L.in_medium) || A == 0.0f) return false;
  if (!hit_target) ++L.depth;
  return L.depth < P.max_depth;
}

// The path sink of the form: records as PathSink's, the target kept, its
// banks staged (STAGED) or in global memory
template <bool COUNT, bool STAGED>
using RtpSink = PathSink<COUNT, true, STAGED>;

// Lane i of CTA C (i < 32 task_count: res_task's task i / 32, thread
// i % 32) started into L: false when the position lies past the CTA's
// range, its pixel is 0 (no deposit) or its first scatter finds no
// mass (GEO: the prologue's first scatter)
template <int RES, bool GEO = false, class SinkT>
__device__ __forceinline__ bool res_path_start(
    const WfParams& P, const Grid& G, const ResCta& C, const Frame* frames,
    unsigned i, const float* in, const int* ap, const int* order,
    const float* chords, const float4* chord_tab, SinkT& S, LaneState& L) {
  LaneSetup su;
  int k0;
  const int aidx = res_position<true>(P, C, frames, (int)(i >> 5),
                                      (int)(i & 31u), ap, order, chord_tab,
                                      su, k0);
  if (aidx < 0) return false;
  const float em = in[aidx] * P.ray_w;
  if (em == 0.0f) return false;
  return res_lane_start<RES, GEO>(
      P, G, (uint32_t)aidx * (uint32_t)P.spp + (uint32_t)k0, aidx, em, S,
      chords, su, L);
}

// intersect_scene with the target's mesh walked by the warp: every thread
// of the warp calls it, busy those with a ray. The analytic surfaces each
// thread tests alone; a mesh surface the warp walks one ray at a time, the
// rays that enter its grid's box in lane order, its 32 threads testing
// each cell's triangles together (ray_mesh_warp). Each thread sets up its
// own ray's walk first (grid_walk_init, all together), which the warp
// takes from it with the ray. Surface by surface in the scene's order, so
// t, the normal and the surface are intersect_scene's, as are each ray's
// counts. rounds: the warp's triangle test rounds (thread 0's). On the
// host the thread walks its own ray
template <bool COUNT, bool STAGED>
__device__ __forceinline__ float intersect_scene_warp(
    const WfParams& P, bool busy, const V3& o, const V3& d, V3& n_best,
    int& sid, const WfMesh& M, const MeshBanks& B, MeshCount& c, int lane,
    unsigned long long* rounds) {
  float t_best = inf();
  n_best = {0.0f, 0.0f, 0.0f};
  sid = -1;
  for (int i = 0; i < P.n_surf; ++i) {
    const float* p = P.surf_params + 3 * i;
    V3 n = {0.0f, 0.0f, 0.0f};
    float t = inf();
    if (P.surf_kind[i] == CYLINDER) {
      if (busy) t = ray_cylinder(o, d, p[0], p[1], p[2], n);
    } else if (P.surf_kind[i] == BOX) {
      if (busy) t = ray_box(o, d, p, n);
    } else {
      int tri = -1;
      GridWalk W;
      const bool walks = busy && mesh_walks(M, i, o, d, W);
#ifdef __CUDA_ARCH__
      constexpr unsigned FULL = 0xffffffffu;
      unsigned want = __ballot_sync(FULL, walks);
      while (want != 0u) {
        const int src = __ffs(want) - 1;
        want &= want - 1u;
        const V3 ro = {__shfl_sync(FULL, o.x, src), __shfl_sync(FULL, o.y, src),
                       __shfl_sync(FULL, o.z, src)};
        const V3 rd = {__shfl_sync(FULL, d.x, src), __shfl_sync(FULL, d.y, src),
                       __shfl_sync(FULL, d.z, src)};
        GridWalk Ws;
        if (M.grid_res[3 * i] > 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            Ws.iv[k] = __shfl_sync(FULL, W.iv[k], src);
            Ws.step[k] = __shfl_sync(FULL, W.step[k], src);
            Ws.tmaxv[k] = __shfl_sync(FULL, W.tmaxv[k], src);
            Ws.tdelta[k] = __shfl_sync(FULL, W.tdelta[k], src);
          }
          Ws.t_exit = __shfl_sync(FULL, W.t_exit, src);
        }
        int tr;
        const float tw = ray_mesh_warp<COUNT, STAGED>(
            M, B, i, ro, rd, Ws, tr, c, lane, lane == src,
            lane == 0 ? rounds : nullptr);
        if (lane == src) {
          t = tw;
          tri = tr;
        }
      }
#else
      if (walks)
        t = ray_mesh_warp<COUNT, STAGED>(M, B, i, o, d, W, tri, c, lane, true,
                                         rounds);
#endif
      const int last = M.tri_count[i] - 1;
      n = load3(M.n, M.tri_start[i] + (tri < 0 ? 0 : (tri > last ? last
                                                                 : tri)));
    }
    if (busy && t < t_best) {
      t_best = t;
      n_best = n;
      sid = i;
    }
  }
  return t_best;
}

// One turn of a thread: one bounce of its lane (busy: it has one; every
// thread of the warp takes the turn), the target's mesh walked by the
// warp. false when the lane ends (trace_lane's end: the loop's own, or
// its 2 max_depth + 16 iterations). rounds as intersect_scene_warp's
template <int RES, class SinkT>
__device__ __forceinline__ bool res_path_turn(const WfParams& P,
                                              const Grid& G, const WfMesh& M,
                                              SinkT& S, LaneState& L,
                                              bool busy, int lane,
                                              unsigned long long* rounds) {
  const bool go = busy && res_bounce_start(P, S, L);
  V3 n_si;
  int sid;
  const float t_si = intersect_scene_warp<SinkT::COUNT, SinkT::STAGED>(
      P, go, L.o, L.d, n_si, sid, M, S.banks, S.mc, lane, rounds);
  return go && res_bounce_end<RES>(P, G, S, L, t_si, n_si, sid) &&
         ++L.it < 2 * P.max_depth + 16;
}

#ifdef __CUDACC__

// The path pass over CTAs [A.c0, A.c0 + gridDim.x) of the launch order,
// the banks staged in dynamic shared memory (STAGED) or read from global
// memory. COUNT: the bounce iterations, the target's grid cells,
// triangles and walks (counters; GEO: the prologue's iterations after
// them), and the lane slots of the bounces (32 for each turn of a warp's
// loop with a lane) and of the triangle tests (32 for each of the warp's
// test rounds) into A.slots. GEO: the first scatter from the geometric
// prologue (no chord bank). The body of res_tgt_path_kernel and
// res_tgt_prologue_kernel
template <int RES, bool COUNT, bool STAGED, bool GEO>
__device__ __forceinline__ void res_tgt_path_body(const WfParams& P,
                                                  const ResArgs& A) {
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ float4 bank_smem[];
  __shared__ Frame frames[WF_RES_MAX_GROUP];
  __shared__ unsigned next_lane;
  const ResCta C = res_cta(P, A.starts, A.c0 + (int)blockIdx.x);
  Grid G;
  G.init(P);
  if (!P.sample_time)
    for (int i = threadIdx.x; i < C.n_angles; i += WF_RTP_THREADS)
      frames[i] = angle_frame(P, C.a0 + i);
  if (threadIdx.x == 0) next_lane = 0;
  RtpSink<COUNT, STAGED> S{
      {nullptr, A.in, nullptr, nullptr, -1, 0.0f, 0, 0, 0, 0},
      A.recs,
      A.n_recs,
      A.cap};
  S.two = P.target == 2;
  S.mesh = &A.mesh;
  S.banks = {A.tris, A.mesh.cell_start, A.mesh.tri_ids};
  S.mask = A.mask;
  if constexpr (STAGED)
    S.banks = stage_banks(S.banks, A.mesh.n_rows, A.mesh.n_cell_start,
                          A.mesh.n_tri_ids, bank_smem, threadIdx.x,
                          WF_RTP_THREADS);
  __syncthreads();

  const unsigned n_lanes = 32u * (unsigned)task_count<true>(P, C.lo, C.hi);
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  LaneState L;
  bool busy = false, drained = false;
  unsigned cur = 0, end = 0;  // the warp's chunk, the same on every lane
  unsigned long long it_slots = 0, rounds = 0;
  for (;;) {
    // the threads without a lane take the chunk's next ones, in lane
    // order, until every thread has one or the CTA's lanes run out
    while (!drained) {
      const unsigned need = __ballot_sync(FULL, !busy);
      if (need == 0u) break;
      if (cur >= end) {
        unsigned b = 0;
        if (lane == 0) b = atomicAdd(&next_lane, (unsigned)WF_RTP_CHUNK);
        b = __shfl_sync(FULL, b, 0);
        if (b >= n_lanes) {
          drained = true;
          break;
        }
        cur = b;
        end = n_lanes - b < (unsigned)WF_RTP_CHUNK ? n_lanes
                                                   : b + WF_RTP_CHUNK;
      }
      const unsigned rank = __popc(need & below);
      if (!busy && rank < end - cur)
        busy = res_path_start<RES, GEO>(P, G, C, frames, cur + rank, A.in,
                                        A.active_pixels, A.order, A.chords,
                                        A.chord_tab, S, L);
      const unsigned took = (unsigned)__popc(need);
      cur = end - cur < took ? end : cur + took;
    }
    const unsigned active = __ballot_sync(FULL, busy);
    if (active == 0u) break;
    busy = res_path_turn<RES>(P, G, A.mesh, S, L, busy, lane,
                              COUNT ? &rounds : nullptr);
    if (COUNT && lane == 0) it_slots += 32;
  }
  if (COUNT) {
    const unsigned long long tri_slots = 32 * rounds;
    unsigned long long c[WF_N_COUNTERS] = {S.iters, 0, 0, 0, 0, S.mc.cells,
                                           S.mc.tris, S.mc.walks};
    add_counters(c, lane, A.counters);
    if (lane == 0 && A.slots != nullptr) {
      atomicAdd(A.slots, it_slots);
      atomicAdd(A.slots + 1, tri_slots);
    }
    if constexpr (GEO) add_prologue_count(S.pro_iters, lane, A.counters);
  }
}

// the form with the chord bank (or without a first scatter)
template <int RES, bool COUNT, bool STAGED>
__global__ void __launch_bounds__(WF_RTP_THREADS, WF_RTP_MIN_CTAS)
    res_tgt_path_kernel(const WfParams P, const __grid_constant__ ResArgs A) {
  res_tgt_path_body<RES, COUNT, STAGED, false>(P, A);
}

// the first-scatter form with the geometric prologue in place of the bank
template <bool COUNT, bool STAGED>
__global__ void __launch_bounds__(WF_RTP_THREADS, WF_RTP_MIN_CTAS)
    res_tgt_prologue_kernel(const WfParams P,
                            const __grid_constant__ ResArgs A) {
  res_tgt_path_body<FIRST_SCATTER, COUNT, STAGED, true>(P, A);
}

using RtpFn = void (*)(const WfParams, const ResArgs);

// the form's instantiation for P: the dda's first-scatter and
// scattered-only residuals of a scene that keeps the target and transmits
// only (geo: the first scatter from the prologue, no chord bank); nullptr
// for any other P
template <bool COUNT, bool STAGED>
RtpFn res_tgt_pick(const WfParams& P, bool geo = false) {
  if (!P.target || P.estimator != DDA || !P.has_scattering ||
      !P.transmission_only)
    return nullptr;
  if (P.residual == FIRST_SCATTER && geo)
    return res_tgt_prologue_kernel<COUNT, STAGED>;
  if (P.residual == FIRST_SCATTER)
    return res_tgt_path_kernel<FIRST_SCATTER, COUNT, STAGED>;
  if (P.residual == SCAT_ONLY)
    return res_tgt_path_kernel<SCAT_ONLY, COUNT, STAGED>;
  return nullptr;
}

// the instantiation k of a launch for P (count: the counting one; geo:
// the prologue's) and its dynamic shared memory: the banks staged where
// they fit limit bytes and a CTA's share of the SM (stage_shape, the
// limit raised to them), else read from global memory (smem 0). k
// nullptr: the form has none for P
inline cudaError_t res_tgt_shape(const WfParams& P, const WfMesh& M,
                                 bool count, bool geo, int limit, RtpFn& k,
                                 size_t& smem) {
  k = count ? res_tgt_pick<true, true>(P, geo)
            : res_tgt_pick<false, true>(P, geo);
  smem = 0;
  if (k == nullptr) return cudaSuccess;
  bool fits = false;
  if (limit > 0 &&
      bank_bytes(M.n_rows, M.n_cell_start, M.n_tri_ids) <= (size_t)limit) {
    const cudaError_t e =
        stage_shape((const void*)k, M, WF_RTP_MIN_CTAS, smem, fits);
    if (e != cudaSuccess) return e;
  }
  if (!fits) {
    k = count ? res_tgt_pick<true, false>(P, geo)
              : res_tgt_pick<false, false>(P, geo);
    smem = 0;
  }
  return cudaSuccess;
}

// The path pass over CTAs [A.c0, c1), the banks staged where they fit
// limit bytes; a first scatter without a chord bank (chords null) runs
// the prologue's instantiation
inline int res_tgt_launch(const WfParams* p, const ResArgs& A, int c1,
                          int limit, void* stream) {
  WfParams P = *p;
  P.tile_n = 0;
  if (P.n_active <= 0 || c1 <= A.c0) return 0;
  if (P.n_surf > WF_MAX_SURF || P.n_groups <= 0 || P.group <= 0 ||
      P.group > WF_RES_MAX_GROUP || A.c0 < 0 || c1 > P.resy * P.n_groups ||
      (!P.identity && (A.order == nullptr || A.starts == nullptr)) ||
      A.recs == nullptr || A.n_recs == nullptr || A.tris == nullptr ||
      (P.target == 2 && P.residual == FIRST_SCATTER && A.mask == nullptr))
    return (int)cudaErrorInvalidValue;
  RtpFn k;
  size_t smem;
  const cudaError_t e = res_tgt_shape(
      P, A.mesh, A.counters != nullptr,
      P.residual == FIRST_SCATTER && A.chords == nullptr, limit, k, smem);
  if (e != cudaSuccess) return (int)e;
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  k<<<(unsigned)(c1 - A.c0), WF_RTP_THREADS, smem, (cudaStream_t)stream>>>(
      P, A);
  return (int)cudaGetLastError();
}

// The launch shape of P's instantiation at limit (flags: bit 0 the
// counting one, bit 1 the prologue's), 8 ints as wf::info's (the staged
// banks' bytes as the dynamic shared memory, 0 with the banks in global
// memory; tile voxels 0)
inline int res_tgt_info(const WfParams* p, const WfMesh* M, int flags,
                        int limit, int* out) {
  RtpFn k;
  size_t smem;
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t e = res_tgt_shape(*p, *M, (flags & 1) != 0, (flags & 2) != 0,
                                limit, k, smem);
  if (e == cudaSuccess && k == nullptr) e = cudaErrorInvalidValue;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, (const void*)k);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k,
                                                      WF_RTP_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const int v[8] = {WF_RTP_THREADS, p->resy * p->n_groups, (int)smem,
                    (int)fa.sharedSizeBytes, fa.numRegs,
                    (int)fa.localSizeBytes, per_sm, 0};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
#endif  // __CUDACC__

}  // namespace wf
