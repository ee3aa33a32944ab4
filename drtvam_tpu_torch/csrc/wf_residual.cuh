// The residual family of the wavefront template: the kernels behind
// wf_res_fwd.cu and wf_res_bwd.cu (the hybrid engine's scattered residual,
// wf_trace.cuh's RES modes), with their own launch shape and per-lane
// set-up.
//
// Replaces drtvam_tpu/ops/march.py:913 trace_wavefront in its residual
// modes (:966-1002, with _first_scatter_from_chords :328,
// _sample_first_scatter :373, _fast_residual_loop :433, dda_segment :586;
// XLA, no Pallas kernel on this path).
//
// Set-up. A residual lane uses little of its ray: the first scatter takes
// the pixel's chord and only the ray's z. What depends on the angle alone
// (the camera frame: cosf, sinf, two norms, two cross products, the
// divides) a CTA computes once for each of its angles into shared memory
// (angle_frame, with the lane's own operations: the same bits); what
// depends on the chord alone (its masses and exp(-st L_k)) the chord table
// holds, computed once per engine on the card (chord_entry, the lane's
// own operations) and read as three 16-byte loads; the lane's angle and
// column come from the launch order with multiply-high divisions by the
// launch's sizes (FastDiv), not integer divides. A first-scatter launch
// without a chord bank (chords null) runs the prologue's instantiations
// (res_prologue_kernel, a template flag, so the bank's instantiations
// compile as before): each lane marches from its ray to its 3D chord
// (wf_trace.cuh chord_march, ~5 surface intersections a lane in an
// analytic vial) and samples its first scatter there (first_scatter3);
// the rest of the lane is the bank form's.
//
// The dda residual forward in two passes. In a dda residual a lane's path
// does not depend on its deposits: the walk of a segment is a side effect
// of (o, d, maxt, base). A lane that walks from its first scatter to the
// vial wall takes 1 to ~400 voxels, so in one pass a warp waits on its
// longest lane (a SIMT efficiency of 0.28 on the bench scene's final
// render, PERF.md section 6). The path pass (res_kernel with a PathSink)
// traces the lanes and appends each dda segment as one 32-byte record;
// the walk pass (walk_kernel) walks the records with persistent threads:
// a thread whose walk ends takes the next record, the warp's needy
// threads served together from a chunk of records the warp claims with
// one atomic, so the warp stays full until the records run out. Each
// step is DdaWalk::step, dda_segment's own, so the steps and deposits are
// the single pass's; only the order of the float atomics changes. The
// wrapper (ops/render.py) runs the passes in batches of CTAs whose
// records fit its buffer. A scene that keeps the target runs the path
// pass of wf_res_target.cuh where the target's banks fit a CTA (and on
// the card a batch's walk beside the next batch's path pass).
//
// Bound on the H100: the dda walk's voxel steps (~20 float32 operations
// each, two expf) and one float atomic into the dose grid each; the delta
// fast loop's per-lane work (the ray's draws, the first scatter, one or
// two events).
#pragma once

#include "wf_trace.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
#endif

// Launch shapes, chosen on an H100 (PERF.md section 6, tools/wf_variants.py)
#ifndef WF_RES_THREADS
#define WF_RES_THREADS 256
#endif
#ifndef WF_RES_MIN_CTAS
#define WF_RES_MIN_CTAS 4
#endif
#ifndef WF_WALK_THREADS
#define WF_WALK_THREADS 256
#endif
#ifndef WF_WALK_MIN_CTAS
#define WF_WALK_MIN_CTAS 4
#endif
// records a warp of the walk pass claims at a time
#ifndef WF_WALK_CHUNK
#define WF_WALK_CHUNK 64
#endif
// the set-up levers, each on (1) unless a measurement build turns it off
// (tools/wf_variants.py): the CTA's frame table, the chord table, the
// lane's indices by multiply-high
#ifndef WF_RES_FRAMES
#define WF_RES_FRAMES 1
#endif
#ifndef WF_RES_CHORDS
#define WF_RES_CHORDS 1
#endif
#ifndef WF_RES_DIVS
#define WF_RES_DIVS 1
#endif
// angles a CTA holds frames for (ops/render.py ANGLES_PER_GROUP: 25)
#define WF_RES_MAX_GROUP 32

namespace wf {

__device__ __forceinline__ uint32_t umulhi(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// n / d for n < 2^32 and a divisor 1 <= d < 2^31 fixed for a launch: one
// multiply-high, an add and a shift (round-up method: s = ceil(log2 d),
// m = floor(2^32 (2^s - d) / d) + 1, n / d = (umulhi(n, m) + n) >> s)
struct FastDiv {
  uint32_t m, s;
  __device__ __forceinline__ void init(uint32_t d) {
    s = 0;
    while ((1u << s) < d) ++s;
    m = (uint32_t)(((uint64_t)1 << 32) * (((uint64_t)1 << s) - d) / d + 1);
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (uint32_t)(((uint64_t)umulhi(n, m) + n) >> s);
  }
};

// A residual CTA: its range [lo, hi) of the launch order (block_range),
// its DMD row, its angles [a0, a0 + n_angles) and the divisors of its
// lanes' indices
struct ResCta {
  int lo, hi, py, a0, n_angles;
  FastDiv spp, w, hw;
};

__device__ __forceinline__ ResCta res_cta(const WfParams& P,
                                          const int* starts, int c) {
  ResCta C;
  block_range(P, starts, c, C.lo, C.hi, C.py);
  C.a0 = (c - C.py * P.n_groups) * P.group;
  const int left = P.n_patterns - C.a0;
  C.n_angles = left < P.group ? left : P.group;
  C.spp.init((uint32_t)P.spp);
  C.w.init((uint32_t)P.resx);
  C.hw.init((uint32_t)(P.resx * P.resy));
  return C;
}

// The active index at sorted position j of CTA C, with the lane's
// emitter, row and column (a sparse store's pixel lies in the CTA's row)
__device__ __forceinline__ int res_lane(const WfParams& P, const ResCta& C,
                                        const int* order, const int* ap,
                                        int j, LaneSetup& su) {
#if WF_RES_DIVS
  su.py = C.py;
  if (P.identity) {
    const int r = j - C.py * (P.n_patterns * P.resx);
    su.emitter = (int)C.w.div((uint32_t)r);
    su.px = r - su.emitter * P.resx;
    return (su.emitter * P.resy + C.py) * P.resx + su.px;
  }
  const int aidx = order[j];
  const int idx = ap[aidx];
  su.emitter = (int)C.hw.div((uint32_t)idx);
  su.px = idx - su.emitter * (P.resy * P.resx) - C.py * P.resx;
  return aidx;
#else
  // integer divides, as trace_lane without a set-up
  const int aidx = lane_aidx(P, order, j);
  const int idx = P.identity ? aidx : ap[aidx];
  su.emitter = idx / (P.resy * P.resx);
  const int pixel = idx % (P.resy * P.resx);
  su.py = pixel / P.resx;
  su.px = pixel - su.py * P.resx;
  return aidx;
#endif
}

// The path pass's sink: a dda segment becomes one record (o.x o.y o.z d.x
// | d.y d.z maxt base) at the next free slot of recs; slots from cap on
// are counted in n_recs but not written (the wrapper then runs the batch
// again in smaller parts). On a two-channel film the record's maxt
// carries the lane's channel in its sign (maxt > 0: a surface lies
// beyond RAY_EPS): -maxt for the channel outside the target
template <bool COUNT_, bool TGT_ = false, bool STAGED_ = false>
struct PathSink : Sink<true, COUNT_, TGT_, STAGED_> {
  static constexpr bool RECORDS = true;
  float4* recs;
  unsigned* n_recs;
  unsigned cap;

  __device__ __forceinline__ void record(const WfParams&, const Grid&,
                                         const V3& o, const V3& d, float maxt,
                                         float base, float) {
#ifdef __CUDACC__
    // one atomic for the threads of the warp that record together
    namespace cg = cooperative_groups;
    cg::coalesced_group g = cg::coalesced_threads();
    unsigned r0 = 0;
    if (g.thread_rank() == 0) r0 = atomicAdd(n_recs, g.size());
    const unsigned r = g.shfl(r0, 0) + g.thread_rank();
#else
    const unsigned r = (*n_recs)++;
#endif
    if (TGT_ && this->two && this->chan != 0) maxt = -maxt;
    if (r < cap) {
      recs[2 * r] = make_float4(o.x, o.y, o.z, d.x);
      recs[2 * r + 1] = make_float4(d.y, d.z, maxt, base);
    }
  }
};

// The pixel of task t, lane l of CTA C, as res_task finds it (the
// residual's target path pass, wf_res_target.cuh): the forward's task t
// holds lane t % spp of the pixel at position lo + 32 (t / spp) + l (k0 =
// t % spp), the adjoint's all the lanes of the pixel at lo + 32 t + l (k0
// = 0). Sets the lane's set-up su (frames: the CTA's angles' frames;
// chord_tab the chord table, null: each lane computes its entry from the
// chord bank). Returns the pixel's active index, or -1 for none
template <bool PRIMAL>
__device__ __forceinline__ int res_position(
    const WfParams& P, const ResCta& C, const Frame* frames, int t, int l,
    const int* ap, const int* order, const float4* chord_tab, LaneSetup& su,
    int& k0) {
  int j;
  k0 = 0;
  if (PRIMAL) {
    const int q = (int)C.spp.div((uint32_t)t);
    j = C.lo + 32 * q + l;
    k0 = t - q * P.spp;
  } else {
    j = C.lo + 32 * t + l;
  }
  if (j >= C.hi) return -1;
  const int aidx = res_lane(P, C, order, ap, j, su);
  su.frame = (P.sample_time || !WF_RES_FRAMES || frames == nullptr)
                 ? nullptr
                 : frames + (su.emitter - C.a0);
  su.chord = (chord_tab == nullptr || !WF_RES_CHORDS)
                 ? nullptr
                 : chord_tab + 4 * (su.emitter * P.resx + su.px);
  return aidx;
}

// Task t's work for lane l of CTA C, as trace_task: the forward traces
// lane t % spp of the pixel at position lo + 32 (t / spp) + l, the
// adjoint all the lanes of the pixel at lo + 32 t + l, summed in lane
// order. frames: the CTA's angles' frames; chord_tab the chord table
// (null: each lane computes its entry from the chord bank `chords`);
// GEO: no bank, each lane marches to its chord (the geometric prologue).
// Returns the pixel's active index, or -1 for none
template <int EST, int RES, bool GEO = false, class SinkT>
__device__ __forceinline__ int res_task(
    const WfParams& P, const Grid& G, const ResCta& C, const Frame* frames,
    int t, int l, const float* in, const int* ap, const int* order,
    const float* chords, const float4* chord_tab, float* out, SinkT& S) {
  int j, k0 = 0;
  if (SinkT::PRIMAL) {
    const int q = (int)C.spp.div((uint32_t)t);
    j = C.lo + 32 * q + l;
    k0 = t - q * P.spp;
  } else {
    j = C.lo + 32 * t + l;
  }
  if (j >= C.hi) return -1;
  LaneSetup su;
  const int aidx = res_lane(P, C, order, ap, j, su);
  su.frame = (P.sample_time || !WF_RES_FRAMES || frames == nullptr)
                 ? nullptr
                 : frames + (su.emitter - C.a0);
  su.chord = (chord_tab == nullptr || !WF_RES_CHORDS)
                 ? nullptr
                 : chord_tab + 4 * (su.emitter * P.resx + su.px);
  const uint32_t lane0 = (uint32_t)aidx * (uint32_t)P.spp;
  if (SinkT::PRIMAL) {
    // em = pattern value x ray weight; a pixel at 0 deposits only zeros
    const float em = in[aidx] * P.ray_w;
    if (em != 0.0f)
      trace_lane<EST, true, true, RES, GEO>(P, G, lane0 + (uint32_t)k0, aidx,
                                            ap, em, S, chords, &su);
    return aidx;
  }
  float gsum = 0.0f;
  for (int k = 0; k < P.spp; ++k) {
    S.g = 0.0f;
    trace_lane<EST, true, true, RES, GEO>(P, G, lane0 + (uint32_t)k, aidx,
                                          ap, 1.0f, S, chords, &su);
    gsum = k == 0 ? S.g : gsum + S.g;
  }
  out[aidx] = gsum * P.ray_w;
  return aidx;
}

#ifdef __CUDACC__

// What a residual launch takes besides WfParams
struct ResArgs {
  WfMesh mesh;               // the target mesh (P.target), else unread
  const float4* tris;        // its triangle rows, global memory
  const unsigned char* mask; // the inside mask (Z, Y, X) (P.target 2)
  const float* in;  // forward: pattern values; adjoint: dL
  const int *active_pixels, *order, *starts;
  const float* chords;       // the chord bank (A * resx, 12), or null
  const float4* chord_tab;   // the chord table (A * resx, 4), or null
  float* out;                // forward: the accumulator; adjoint: grad
  unsigned long long* counters;
  float4* recs;              // the path pass: the segment records
  unsigned* n_recs;          // their count (zeroed by the wrapper)
  unsigned cap;              // records recs holds
  int c0;                    // the launch's first CTA
  // the path pass counting: the lane slots of its bounce iterations and
  // of its triangle tests (32 for each of a warp's longest lane's), or
  // null
  unsigned long long* slots;
};

// the warp's largest d
__device__ __forceinline__ unsigned long long warp_max(unsigned long long d) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, d, off);
    d = o > d ? o : d;
  }
  return d;
}

// S with the target's mesh, banks and mask of A (TGT)
template <class SinkT>
__device__ __forceinline__ SinkT with_target(SinkT S, const WfParams& P,
                                             const ResArgs& A) {
  if constexpr (SinkT::TGT) {
    S.two = P.target == 2;
    S.mesh = &A.mesh;
    S.banks = {A.tris, A.mesh.cell_start, A.mesh.tri_ids};
    S.mask = A.mask;
  }
  return S;
}

template <bool PRIMAL, bool COUNT, bool PATH, bool TGT>
__device__ __forceinline__ auto res_sink(const WfParams& P,
                                         const ResArgs& A) {
  if constexpr (PATH)
    return with_target(
        PathSink<COUNT, TGT>{
            {A.out, A.in, nullptr, nullptr, -1, 0.0f, 0, 0, 0, 0},
            A.recs,
            A.n_recs,
            A.cap},
        P, A);
  else
    return with_target(Sink<PRIMAL, COUNT, TGT>{A.out, A.in, nullptr, nullptr,
                                                -1, 0.0f, 0, 0, 0, 0},
                       P, A);
}

// One CTA per (DMD row, angle group) from CTA A.c0 on, its warps taking
// 32 neighbouring positions at a time from a counter in shared memory
// (wf_kernel's order, without the tile); PATH: the dda forward's path
// pass. COUNT: iterations, steps, deposits and lane slots as wf_kernel,
// a delta lane's slots counted on its events, and with GEO the
// prologue's iterations after them. TGT: the scene keeps the target (its
// mesh and, on a two-channel film, the inside mask in A). GEO: the
// first scatter from the geometric prologue (no chord bank). The body of
// res_kernel and res_prologue_kernel
template <int EST, int RES, bool PRIMAL, bool COUNT, bool PATH, bool TGT,
          bool GEO>
__device__ __forceinline__ void res_cta_body(const WfParams& P,
                                             const ResArgs& A) {
  __shared__ Frame frames[WF_RES_MAX_GROUP];
  __shared__ unsigned next_task;
  const ResCta C = res_cta(P, A.starts, A.c0 + (int)blockIdx.x);
  Grid G;
  G.init(P);
  if (!P.sample_time)
    for (int i = threadIdx.x; i < C.n_angles; i += WF_RES_THREADS)
      frames[i] = angle_frame(P, C.a0 + i);
  if (threadIdx.x == 0) next_task = 0;
  __syncthreads();

  auto S = res_sink<PRIMAL, COUNT, PATH, TGT>(P, A);
  const int lane = threadIdx.x & 31;
  const unsigned n_tasks = (unsigned)task_count<PRIMAL>(P, C.lo, C.hi);
  unsigned long long slots = 0, it_slots = 0, tri_slots = 0;
  for (;;) {
    unsigned t = 0;
    if (lane == 0) t = atomicAdd(&next_task, 1u);
    t = __shfl_sync(0xffffffffu, t, 0);
    if (t >= n_tasks) break;
    // a lane's work: its events (delta: a deposit is an event's side
    // effect) or its estimator steps (dda, ratio)
    const unsigned long long s0 = EST == DELTA ? S.iters : S.steps;
    const unsigned long long i0 = S.iters, t0 = S.mc.tris;
    res_task<EST, RES, GEO>(P, G, C, frames, (int)t, lane, A.in,
                            A.active_pixels, A.order, A.chords, A.chord_tab,
                            A.out, S);
    if (COUNT) {
      // a warp spends 32 lane slots on each unit of its longest lane's work
      const unsigned long long d =
          warp_max((EST == DELTA ? S.iters : S.steps) - s0);
      if (lane == 0) slots += 32 * d;
      if (PATH) {
        // the path pass: on its longest lane's bounce iterations and
        // triangle tests
        const unsigned long long di = warp_max(S.iters - i0);
        const unsigned long long dt = warp_max(S.mc.tris - t0);
        if (lane == 0) {
          it_slots += 32 * di;
          tri_slots += 32 * dt;
        }
      }
    }
  }
  if (COUNT) {
    unsigned long long c[WF_N_COUNTERS] = {
        S.iters, S.steps, S.n_tile, S.n_global, slots, S.mc.cells,
        S.mc.tris, S.mc.walks};
    add_counters(c, lane, A.counters);
    if (PATH && lane == 0 && A.slots != nullptr) {
      atomicAdd(A.slots, it_slots);
      atomicAdd(A.slots + 1, tri_slots);
    }
    if constexpr (GEO) add_prologue_count(S.pro_iters, lane, A.counters);
  }
}

// the residual kernel with the chord bank (or without a first scatter)
template <int EST, int RES, bool PRIMAL, bool COUNT, bool PATH, bool TGT>
__global__ void __launch_bounds__(WF_RES_THREADS, WF_RES_MIN_CTAS)
    res_kernel(const WfParams P, const __grid_constant__ ResArgs A) {
  res_cta_body<EST, RES, PRIMAL, COUNT, PATH, TGT, false>(P, A);
}

// the same with the geometric prologue in place of the chord bank
template <int EST, int RES, bool PRIMAL, bool COUNT, bool PATH, bool TGT>
__global__ void __launch_bounds__(WF_RES_THREADS, WF_RES_MIN_CTAS)
    res_prologue_kernel(const WfParams P, const __grid_constant__ ResArgs A) {
  res_cta_body<EST, RES, PRIMAL, COUNT, PATH, TGT, true>(P, A);
}

// The walk pass: persistent warps walk records [0, n) in the z-slices
// [zlo, zhi) of the grid (a slab: the wrapper runs one pass a slab, so
// that the dose grid's part the atomics reach fits L2). A warp's threads
// without a walk take the next records of the warp's chunk (claimed from
// *next, WF_WALK_CHUNK at a time, with one atomic), in lane order; a
// record whose segment misses the grid or the slab is passed over. A walk
// that reaches the slab from outside steps there without deposits: the
// same arithmetic, so each deposit is made by one slab's pass, as in one
// walk. COUNT: the walking threads' steps (counters[0]), the steps and
// deposits in the slab, and the warps' lane slots (32 for each step of
// the warp's loop). TWO: a two-channel film, each record's channel in
// the sign of its maxt (PathSink)
template <bool COUNT, bool TWO>
__global__ void __launch_bounds__(WF_WALK_THREADS, WF_WALK_MIN_CTAS)
    walk_kernel(const WfParams P, const float4* __restrict__ recs, unsigned n,
                unsigned* __restrict__ next, int zlo, int zhi,
                float* __restrict__ acc,
                unsigned long long* __restrict__ counters) {
  constexpr unsigned FULL = 0xffffffffu;
  Grid G;
  G.init(P);
  Sink<true, COUNT, TWO> S{acc, nullptr, nullptr, nullptr, -1, 0.0f,
                           0,   0,       0,       0};
  S.two = TWO;
  int chan = 0;
  const float st = P.sigma_t;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  DdaWalk w;
  float base = 0.0f;
  bool busy = false, drained = false;
  unsigned cur = 0, end = 0;  // the warp's chunk, the same on every lane
  unsigned long long slots = 0, walking = 0;
  for (;;) {
    while (!drained) {
      const unsigned need = __ballot_sync(FULL, !busy);
      if (need == 0u) break;
      if (cur >= end) {
        unsigned b = 0;
        if (lane == 0) b = atomicAdd(next, (unsigned)WF_WALK_CHUNK);
        b = __shfl_sync(FULL, b, 0);
        if (b >= n) {
          drained = true;
          break;
        }
        cur = b;
        end = n - b < (unsigned)WF_WALK_CHUNK ? n : b + WF_WALK_CHUNK;
      }
      const unsigned rank = __popc(need & below);
      if (!busy && rank < end - cur) {
        const unsigned r = cur + rank;
        const float4 a = __ldg(recs + 2 * r), c = __ldg(recs + 2 * r + 1);
        if (TWO) chan = c.z < 0.0f ? 1 : 0;
        busy = w.init(P, G, V3{a.x, a.y, a.z}, V3{a.w, c.x, c.y},
                      TWO ? fabsf(c.z) : c.z) &&
               w.meets(zlo, zhi);
        base = c.w;
      }
      const unsigned took = (unsigned)__popc(need);
      cur = end - cur < took ? end : cur + took;
    }
    const unsigned active = __ballot_sync(FULL, busy);
    if (active == 0u) break;
    if (COUNT && lane == 0) {
      slots += 32;
      walking += __popc(active);
    }
    if (TWO) S.chan = chan;
    if (busy) busy = w.step<true>(P, G, S, base, st, zlo, zhi);
  }
  if (COUNT) {
    unsigned long long c[5] = {walking, S.steps, 0, S.n_global, slots};
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      for (int off = 16; off > 0; off >>= 1)
        c[k] += __shfl_down_sync(FULL, c[k], off);
      if (lane == 0) atomicAdd(counters + k, c[k]);
    }
  }
}

// The chord table from the chord bank, one entry a thread
__global__ void chord_table_kernel(const float* __restrict__ bank, int n,
                                   float st, float4* __restrict__ tab) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) chord_entry(bank + 12 * i, st, tab + 4 * i);
}

using ResFn = void (*)(const WfParams, const ResArgs);

// The instantiation for P (scattering and transmission only) by
// estimator, residual mode and whether the scene keeps the target: the
// forward's single pass (ratio, delta), its path pass (PATH: dda) or the
// adjoint (every estimator); GEO: the first-scatter modes' prologue
// instantiation; nullptr for a P the kind does not run
template <bool PRIMAL, bool COUNT, bool PATH, bool TGT, bool GEO>
ResFn res_pick(const WfParams& P) {
  if (!P.has_scattering || !P.transmission_only) return nullptr;
  const int key = P.estimator * 4 + P.residual;
  if constexpr (GEO) {
    if (P.residual != FIRST_SCATTER && P.residual != FAST_RESIDUAL)
      return nullptr;
  }
#define WF_RES_CASE(E, R)                                          \
  case E * 4 + R:                                                  \
    if constexpr (GEO && R != SCAT_ONLY)                           \
      return res_prologue_kernel<E, R, PRIMAL, COUNT, PATH, TGT>;  \
    else                                                           \
      return res_kernel<E, R, PRIMAL, COUNT, PATH, TGT>;
  if constexpr (PATH) {
    switch (key) {
      WF_RES_CASE(DDA, SCAT_ONLY)
      WF_RES_CASE(DDA, FIRST_SCATTER)
      default:
        return nullptr;
    }
  } else {
    switch (key) {
      WF_RES_CASE(RATIO, SCAT_ONLY)
      WF_RES_CASE(RATIO, FIRST_SCATTER)
      WF_RES_CASE(DELTA, SCAT_ONLY)
      WF_RES_CASE(DELTA, FIRST_SCATTER)
      WF_RES_CASE(DELTA, FAST_RESIDUAL)
      default:
        break;
    }
    if constexpr (!PRIMAL) {
      switch (key) {
        WF_RES_CASE(DDA, SCAT_ONLY)
        WF_RES_CASE(DDA, FIRST_SCATTER)
        default:
          break;
      }
    }
    return nullptr;
  }
#undef WF_RES_CASE
}

template <bool PRIMAL, bool PATH, bool GEO>
ResFn res_pick_geo(const WfParams& P, bool count) {
  if (P.target)
    return count ? res_pick<PRIMAL, true, PATH, true, GEO>(P)
                 : res_pick<PRIMAL, false, PATH, true, GEO>(P);
  return count ? res_pick<PRIMAL, true, PATH, false, GEO>(P)
               : res_pick<PRIMAL, false, PATH, false, GEO>(P);
}

// the instantiation of a launch of P (count: the counting one; geo: the
// prologue's, for a first-scatter mode without a chord bank)
template <bool PRIMAL, bool PATH>
ResFn res_pick_for(const WfParams& P, bool count, bool geo) {
  return geo ? res_pick_geo<PRIMAL, PATH, true>(P, count)
             : res_pick_geo<PRIMAL, PATH, false>(P, count);
}

// Launch CTAs [A.c0, c1) of the launch order (the adjoint and the single
// pass: all of them). A first-scatter mode without a chord bank (chords
// null) runs the prologue's instantiation
template <bool PRIMAL, bool PATH>
int res_launch(const WfParams* p, const ResArgs& A, int c1, void* stream) {
  WfParams P = *p;
  P.tile_n = 0;
  if (P.n_active <= 0 || c1 <= A.c0) return 0;
  const bool fs = P.residual == FIRST_SCATTER || P.residual == FAST_RESIDUAL;
  if (P.n_surf > WF_MAX_SURF || P.n_groups <= 0 || P.group <= 0 ||
      P.group > WF_RES_MAX_GROUP || A.c0 < 0 || c1 > P.resy * P.n_groups ||
      (!P.identity && (A.order == nullptr || A.starts == nullptr)) ||
      (PATH && (A.recs == nullptr || A.n_recs == nullptr)) ||
      (P.target && A.tris == nullptr) ||
      (P.target == 2 && fs && A.mask == nullptr))
    return (int)cudaErrorInvalidValue;
  ResFn k = res_pick_for<PRIMAL, PATH>(P, A.counters != nullptr,
                                       fs && A.chords == nullptr);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  k<<<(unsigned)(c1 - A.c0), WF_RES_THREADS, 0, (cudaStream_t)stream>>>(P, A);
  return (int)cudaGetLastError();
}

using WalkFn = void (*)(const WfParams, const float4*, unsigned, unsigned*,
                        int, int, float*, unsigned long long*);

// the walk pass's instantiation: counting, two channels
inline WalkFn walk_pick(bool count, bool two) {
  if (two) return count ? walk_kernel<true, true> : walk_kernel<false, true>;
  return count ? walk_kernel<true, false> : walk_kernel<false, false>;
}

// CTAs of the walk pass: as many as the SMs hold at once
inline cudaError_t walk_grid(WalkFn k, int& ctas, int& per_sm) {
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, (const void*)k, WF_WALK_THREADS, 0);
  ctas = sms * per_sm;
  return e;
}

inline int walk_launch(const WfParams* p, const float4* recs, unsigned n,
                       unsigned* next, int zlo, int zhi, float* acc,
                       unsigned long long* counters, void* stream) {
  if (n == 0) return 0;
  if (recs == nullptr || next == nullptr || acc == nullptr)
    return (int)cudaErrorInvalidValue;
  const WalkFn k = walk_pick(counters != nullptr, p->target == 2);
  int ctas, per_sm;
  cudaError_t e = walk_grid(k, ctas, per_sm);
  if (e != cudaSuccess) return (int)e;
  k<<<ctas, WF_WALK_THREADS, 0, (cudaStream_t)stream>>>(*p, recs, n, next,
                                                          zlo, zhi, acc,
                                                          counters);
  return (int)cudaGetLastError();
}

inline void shape_out(int threads, int ctas, const cudaFuncAttributes& fa,
                      int per_sm, int* out) {
  const int v[8] = {threads, ctas, 0, (int)fa.sharedSizeBytes, fa.numRegs,
                    (int)fa.localSizeBytes, per_sm, 0};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

// The launch shape of P's per-lane instantiation (flags: bit 0 the
// counting one, bit 1 the prologue's), 8 ints as wf::info
template <bool PRIMAL, bool PATH>
int res_info(const WfParams* p, int flags, int* out) {
  ResFn k = res_pick_for<PRIMAL, PATH>(*p, (flags & 1) != 0,
                                       (flags & 2) != 0);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  int per_sm = 0;
  cudaError_t e = cudaFuncGetAttributes(&fa, (const void*)k);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k,
                                                      WF_RES_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  shape_out(WF_RES_THREADS, p->resy * p->n_groups, fa, per_sm, out);
  return 0;
}

inline int walk_info(int count, int two, int* out) {
  cudaFuncAttributes fa;
  int ctas, per_sm;
  const WalkFn k = walk_pick(count != 0, two != 0);
  cudaError_t e = cudaFuncGetAttributes(&fa, (const void*)k);
  if (e == cudaSuccess) e = walk_grid(k, ctas, per_sm);
  if (e != cudaSuccess) return (int)e;
  shape_out(WF_WALK_THREADS, ctas, fa, per_sm, out);
  return 0;
}
#endif  // __CUDACC__

}  // namespace wf
