// The target forms of the wavefront pair on the H100: the loop kernels'
// instantiations for a scene that keeps the target (a surface-aware
// film's two channels, or the final render of a surface-aware scene),
// behind wf_target.cu.
//
// Replaces drtvam_tpu/ops/march.py:913 trace_wavefront with the target
// mesh in its scene (intersect_scene's MESH branch :151-190, the
// two-channel deposits :556-565 and :1092-1093; XLA, no Pallas kernel on
// this path).
//
// What held the one-pass forms back (wf_kernel with TGT, 1024 threads, the
// banks in global memory; measured on an H100, PERF.md section 6): the
// two-channel home-slice tile takes 228 KB of the SM's 256 KB, so the
// grid walk's chain of dependent loads (cell start, triangle id, the
// triangle's rows) and the lane loop's spills find almost no L1 (the tile
// off: 660 -> 520 ms). Not the spills themselves: built at 512 threads
// the lane loop keeps its state in 117 registers and runs slower (797 ms),
// with half the warps to hide the loads. The design separates the mesh
// from the tile:
//   * the adjoint (no tile) runs WF_TGT_THREADS threads a CTA with the
//     banks staged in its shared memory (wf_mesh.cuh stage_banks): the
//     walk's loads run at shared memory's latency, L1 keeps the rest of
//     the SM for dL's gathers and the spills. A gather: bitwise its plain
//     version and lane order;
//   * the dda forward runs in two passes (as the dda residual does,
//     wf_residual.cuh): a path pass (tgt_path_kernel) at the adjoint's
//     launch shape, no tile, which traces the lanes through the surfaces
//     and the target and records each in-medium segment (o, d, maxt with
//     the lane's channel in its sign, the weighted base; PathSink's
//     32-byte record) into its unit's region of a record buffer; then a
//     walk pass (tgt_walk_kernel), one CTA of 1024 threads per unit, which
//     walks the unit's records into the home-slice tile of the DMD row
//     that made them (DdaWalk::step, dda_segment's own, with wf_kernel's
//     tile) and flushes it. A warp walks 32 neighbouring records at a
//     time, the segments of neighbouring lanes, whose deposits meet
//     neighbouring voxels as in the one-pass kernel (measured faster than
//     refilling each thread from a chunk of records as the residual's
//     walk pass does: its deposits scatter over the tile). A unit is a range of one launch-order CTA's
//     tasks (a DMD row and angle group: the tile keeps its meaning), at
//     most ops/render.py TGT_UNIT_LANES lanes, so that a render at high
//     spp still gives the card many units. A segment past its unit's
//     region is walked at once by the path pass, its deposits global
//     atomics, so no batch fails and the wrapper never waits on the card
//     between batches. Every deposit is the one-pass kernel's value; only
//     the order of the float atomics changes. The wrapper (ops/render.py
//     tgt_forward) sizes the regions from the records each unit made in
//     the last launch, and runs the passes in batches of units whose
//     regions fit its buffer.
//   * the ratio forward runs in the same two passes: its path pass
//     (tgt_ratio_path_kernel) records each in-medium segment as the dda's
//     does, and beside it the lane's random stream at the segment's start
//     (TgtArgs keys: (lane, counter), 8 bytes a record, so 40 a segment),
//     then advances the stream by the free flights the tracking draws
//     (ratio_skip: its draws without their deposits), so that the next
//     bounce draws what the one-pass kernel draws; its walk pass
//     (tgt_ratio_walk_kernel) replays each record's tracking from its
//     stream (ratio_segment's own loop) into the home-slice tile. A
//     segment past its unit's region is tracked at once by the path pass,
//     its deposits global atomics;
//   * the delta forward makes one deposit a bounce, at the sampled
//     interaction point, so its cost is the lanes' paths through the
//     meshes: one pass (tgt_delta_kernel) at the path pass's launch shape
//     and units (tgt_path_cta, its sink the plain Sink), the banks staged,
//     no tile, each deposit a global atomic. (The other way, the deposits
//     as (voxel, value) records added by a second pass through the tile,
//     costs at least the lanes traced without deposits: 0.35 ms less of
//     22.77 on cell (d)'s loop inputs, PERF.md section 6.)
// Scenes whose banks do not fit a CTA's shared memory keep the one-pass
// kernel (wf_kernel with TGT, wf_fwd.cu) for every estimator.
//
// Bound on the H100: the dda walk's voxel steps (~20 float32 operations
// each, two expf), ratio tracking's steps (a hash, a log1pf, an expf and
// the voxel's index), delta's one deposit a bounce, and the target's grid
// walks (~20 operations a cell, ~40 a triangle test; cell (b) tests ~29
// triangles a bounce, 13 G a launch); the records are 32 bytes a segment
// (the ratio's 40), written and read once.
#pragma once

#include "wf_trace.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
#endif

// Launch shapes, chosen on an H100 (tools/wf_variants.py target: 512
// threads without spills, 768 and 1024 with them; 1024 the fastest loop
// step)
#ifndef WF_TGT_THREADS
#define WF_TGT_THREADS 1024
#endif
#ifndef WF_TGT_MIN_CTAS
#define WF_TGT_MIN_CTAS 1
#endif
#ifndef WF_TGT_WALK_THREADS
#define WF_TGT_WALK_THREADS 1024
#endif

namespace wf {

// What the split forward's passes take beside WfParams (mirror of
// ops/render.py TgtArgs: the pointers, then 4-byte fields, then keys). A
// batch is the units [u0, u1) of units (3 ints each: the launch-order
// CTA, its first task and its task end); unit u0 + k writes its records
// at [region[k], region[k + 1]) of recs (records of 8 floats) and their
// count into counts[k] (zeroed by the wrapper, counting those past the
// region too, which the path pass walks into acc); a ratio record r's
// stream at keys[r] (the dda's and the delta form take none)
struct TgtArgs {
  float4* recs;
  const unsigned* region;
  unsigned* counts;
  const int* units;
  float* acc;
  int u0, u1;
  uint2* keys;
};

// ratio tracking's draws on a segment of length maxt without its
// deposits: rng advanced as ratio_segment advances it (one draw a step,
// the terminating one included)
__device__ __forceinline__ void ratio_skip(const WfParams& P, Rng& rng,
                                           float maxt) {
  const float M = P.majorant;
  float t = 0.0f;
  for (int i = 0; i < RATIO_MAX_STEPS; ++i) {
    const float u = rng.next1();
    t = t + free_flight(u, M);
    if (!(t < maxt)) break;
  }
}

// The path pass's sink: the target kept (TGT), its banks staged; a dda
// or ratio segment becomes one record (PathSink's layout; a ratio
// record's stream in keys) in the unit's region of cap records from lo,
// or past it is walked or tracked at once into the accumulator (every
// deposit a global atomic; the sink's tile is none); n_made the unit's
// record counter (shared memory on the card)
template <bool COUNT_>
struct TgtPathSink : Sink<true, COUNT_, true, true> {
  static constexpr bool RECORDS = true, RATIO_RECORDS = true;
  float4* recs;
  unsigned lo, cap;
  unsigned* n_made;
  uint2* keys;

  // the unit's next record: one atomic for the threads of the warp that
  // record together
  __device__ __forceinline__ unsigned claim() {
#ifdef __CUDACC__
    namespace cg = cooperative_groups;
    cg::coalesced_group g = cg::coalesced_threads();
    unsigned r0 = 0;
    if (g.thread_rank() == 0) r0 = atomicAdd(n_made, g.size());
    return g.shfl(r0, 0) + g.thread_rank();
#else
    return (*n_made)++;
#endif
  }
  __device__ __forceinline__ void put(unsigned r, const V3& o, const V3& d,
                                      float maxt, float base) {
    float4* dst = recs + 2 * (size_t)(lo + r);
    dst[0] = make_float4(o.x, o.y, o.z, d.x);
    dst[1] = make_float4(d.y, d.z, this->two && this->chan != 0 ? -maxt
                                                                : maxt,
                         base);
  }

  __device__ __forceinline__ void record(const WfParams& P, const Grid& G,
                                         const V3& o, const V3& d, float maxt,
                                         float base, float st) {
    const unsigned r = claim();
    if (r < cap) {
      put(r, o, d, maxt, base);
    } else {
      dda_walk(P, G, *this, o, d, maxt, base, st);
    }
  }

  // a ratio segment: recorded with the lane's stream at its start, the
  // stream then advanced past the tracking's draws; past the region
  // tracked at once, as the one-pass kernel tracks it (this sink as the
  // plain Sink it derives from: no tile, every deposit global)
  __device__ __forceinline__ void ratio_record(const WfParams& P,
                                               const Grid& G, Rng& rng,
                                               const V3& o, const V3& d,
                                               float maxt, float base,
                                               float st) {
    const unsigned r = claim();
    if (r < cap) {
      put(r, o, d, maxt, base);
      keys[lo + r] = make_uint2(rng.lane, rng.ctr);
      ratio_skip(P, rng, maxt);
    } else {
      ratio_segment(P, G, static_cast<Sink<true, COUNT_, true, true>&>(*this),
                    rng, o, d, maxt, base, st);
    }
  }
};

// the path sink of unit u0 + k of batch A, its banks B
template <bool COUNT>
__device__ __forceinline__ TgtPathSink<COUNT> tgt_path_sink(
    const WfParams& P, const WfMesh* M, const MeshBanks& B,
    const TgtArgs& A, int k, unsigned* n_made) {
  TgtPathSink<COUNT> S{
      {A.acc, nullptr, nullptr, nullptr, -1, 0.0f, 0, 0, 0, 0},
      A.recs,
      A.region[k],
      A.region[k + 1] - A.region[k],
      n_made,
      A.keys};
  S.two = P.target == 2;
  S.mesh = M;
  S.banks = B;
  return S;
}

// unit u's launch-order CTA c and its task range [t0, t1)
__device__ __forceinline__ void tgt_unit(const TgtArgs& A, int u, int& c,
                                         int& t0, int& t1) {
  c = A.units[3 * u];
  t0 = A.units[3 * u + 1];
  t1 = A.units[3 * u + 2];
}

// the records unit u0 + k of batch A holds: [lo, lo + n) of A.recs
__device__ __forceinline__ void tgt_walk_range(const TgtArgs& A, int k,
                                               unsigned& lo, unsigned& n) {
  lo = A.region[k];
  const unsigned cap = A.region[k + 1] - lo;
  n = A.counts[k] < cap ? A.counts[k] : cap;
}

// Record r of recs (a unit's, its streams keys) walked into S: a dda
// record by dda_segment's walk, a ratio record by ratio_segment's
// tracking from the stream it recorded. TWO: a two-channel film, the
// record's channel in the sign of its maxt
template <int EST, bool TWO, class SinkT>
__device__ __forceinline__ void tgt_walk_record(
    const WfParams& P, const Grid& G, SinkT& S,
    const float4* __restrict__ recs, const uint2* __restrict__ keys,
    unsigned r) {
  const float4 a = __ldg(recs + 2 * r), b = __ldg(recs + 2 * r + 1);
  if (TWO) S.chan = b.z < 0.0f ? 1 : 0;
  const V3 o{a.x, a.y, a.z}, d{a.w, b.x, b.y};
  const float maxt = TWO ? fabsf(b.z) : b.z;
  if constexpr (EST == RATIO) {
    const uint2 key = keys[r];
    Rng rng{P.seed + 0x9E3779B9u, key.x, key.y};
    ratio_segment(P, G, S, rng, o, d, maxt, b.w, P.sigma_t);
  } else {
    dda_walk(P, G, S, o, d, maxt, b.w, P.sigma_t);
  }
}

// The sink of unit u0 + k of batch A for estimator EST: the path pass's
// (TgtPathSink); the delta form's the plain Sink (the target kept, its
// banks staged, no tile: every deposit a global atomic into acc)
template <int EST, bool COUNT>
__device__ __forceinline__ auto tgt_cta_sink(const WfParams& P,
                                             const WfMesh* M,
                                             const MeshBanks& B,
                                             const TgtArgs& A, int k,
                                             unsigned* n_made) {
  if constexpr (EST == DELTA) {
    Sink<true, COUNT, true, true> S{
        A.acc, nullptr, nullptr, nullptr, -1, 0.0f, 0, 0, 0, 0};
    S.two = P.target == 2;
    S.mesh = M;
    S.banks = B;
    return S;
  } else {
    return tgt_path_sink<COUNT>(P, M, B, A, k, n_made);
  }
}

#ifdef __CUDACC__

// The path pass of estimator EST (DDA, RATIO) and the delta form (DELTA):
// one CTA of WF_TGT_THREADS threads per unit u0 + k of the batch (its
// CTA's DMD row and angle group, tasks [t0, t1) of wf_kernel's order), the
// banks staged first; each lane traced as wf_kernel's forward traces it,
// its dda or ratio segments recorded (TgtPathSink), or its delta deposits
// (one at most a bounce) global atomics. COUNT: the bounce iterations, the
// target's grid cells, triangles and walks, and the steps and global
// deposits (the path pass: of the segments walked at once); the delta
// form also the lane slots
template <int EST, bool SCAT, bool TONLY, bool COUNT>
__device__ __forceinline__ void tgt_path_cta(
    const WfParams& P, const WfMesh& M, const float4* __restrict__ tris,
    const float* __restrict__ in, const int* __restrict__ active_pixels,
    const int* __restrict__ order, const int* __restrict__ starts,
    const TgtArgs& A, unsigned long long* __restrict__ counters) {
  constexpr bool RECORDS = EST != DELTA;
  extern __shared__ float4 path_smem[];
  __shared__ unsigned next_task, n_made;
  const int k = blockIdx.x;
  int c, t0, t1, lo, hi, py;
  tgt_unit(A, A.u0 + k, c, t0, t1);
  block_range(P, starts, c, lo, hi, py);
  Grid G;
  G.init(P);
  const MeshBanks B =
      stage_banks({tris, M.cell_start, M.tri_ids}, M.n_rows, M.n_cell_start,
                  M.n_tri_ids, path_smem, threadIdx.x, WF_TGT_THREADS);
  auto S = tgt_cta_sink<EST, COUNT>(P, &M, B, A, k, &n_made);
  if (threadIdx.x == 0) {
    next_task = (unsigned)t0;
    if (RECORDS) n_made = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (;;) {
    unsigned t = 0;
    if (lane == 0) t = atomicAdd(&next_task, 1u);
    t = __shfl_sync(0xffffffffu, t, 0);
    if (t >= (unsigned)t1) break;
    if constexpr (RECORDS)
      trace_task<EST, SCAT, TONLY>(P, G, order, lo, hi, (int)t, lane, in,
                                   active_pixels, nullptr, S);
    else
      S.template task<EST, SCAT, TONLY>(P, G, order, lo, hi, (int)t, lane,
                                        in, active_pixels, nullptr);
  }
  if constexpr (RECORDS) {
    __syncthreads();
    if (threadIdx.x == 0) A.counts[k] = n_made;
  }
  if (COUNT) {
    unsigned long long c8[WF_N_COUNTERS] = {
        S.iters, S.steps, 0, S.n_global, S.slots, S.mc.cells, S.mc.tris,
        S.mc.walks};
    add_counters(c8, lane, counters);
  }
}

template <bool SCAT, bool TONLY, bool COUNT>
__global__ void __launch_bounds__(WF_TGT_THREADS, WF_TGT_MIN_CTAS)
    tgt_path_kernel(const WfParams P, const __grid_constant__ WfMesh M,
                    const float4* __restrict__ tris,
                    const float* __restrict__ in,
                    const int* __restrict__ active_pixels,
                    const int* __restrict__ order,
                    const int* __restrict__ starts,
                    const __grid_constant__ TgtArgs A,
                    unsigned long long* __restrict__ counters) {
  tgt_path_cta<DDA, SCAT, TONLY, COUNT>(P, M, tris, in, active_pixels, order,
                                        starts, A, counters);
}

// the ratio forward's path pass: its segments recorded with their streams
template <bool SCAT, bool TONLY, bool COUNT>
__global__ void __launch_bounds__(WF_TGT_THREADS, WF_TGT_MIN_CTAS)
    tgt_ratio_path_kernel(const WfParams P, const __grid_constant__ WfMesh M,
                          const float4* __restrict__ tris,
                          const float* __restrict__ in,
                          const int* __restrict__ active_pixels,
                          const int* __restrict__ order,
                          const int* __restrict__ starts,
                          const __grid_constant__ TgtArgs A,
                          unsigned long long* __restrict__ counters) {
  tgt_path_cta<RATIO, SCAT, TONLY, COUNT>(P, M, tris, in, active_pixels,
                                          order, starts, A, counters);
}

// The walk pass of estimator EST (DDA, RATIO): CTA k walks the records of
// unit u0 + k into the home-slice tile of its CTA's DMD row (wf_kernel's
// tile: zeroed, the walks' deposits added in shared memory, flushed with
// one global atomic per nonzero value), a thread every
// WF_TGT_WALK_THREADS-th record (tgt_walk_record). TWO: a two-channel
// film, each record's channel in the sign of its maxt. COUNT: the steps,
// the tile and global deposits and the lane slots
template <int EST, bool COUNT, bool TWO>
__device__ __forceinline__ void tgt_walk_cta(
    const WfParams& P, const TgtArgs& A, const int4* __restrict__ rows,
    unsigned long long* __restrict__ counters) {
  extern __shared__ int4 smem[];
  unsigned lo, n;
  tgt_walk_range(A, blockIdx.x, lo, n);
  if (n == 0) return;
  int c, t0, t1;
  tgt_unit(A, A.u0 + (int)blockIdx.x, c, t0, t1);
  Grid G;
  G.init(P);
  int4* srows = smem;
  float* tile = reinterpret_cast<float*>(smem + G.res[1]);
  const int home = P.tile_n > 0 ? home_slice(P, G, c / P.n_groups) : -1;
  Sink<true, COUNT, true> S{A.acc, nullptr, tile, srows, home, 0.0f,
                            0,     0,       0,    0};
  S.two = TWO;
  const int ch = TWO ? 2 : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int n_warps = WF_TGT_WALK_THREADS / 32;
  if (home >= 0)
    tile_zero<true>(P, G, rows, srows, tile, ch, warp, lane, n_warps);
  __syncthreads();
  // round i: thread t walks record i WF_TGT_WALK_THREADS + t, so that a
  // warp walks 32 neighbouring records (the segments of neighbouring
  // lanes) together
  const float4* __restrict__ recs = A.recs + 2 * (size_t)lo;
  const uint2* __restrict__ keys = EST == RATIO ? A.keys + lo : nullptr;
  unsigned long long slots = 0;
  for (unsigned r0 = 0; r0 < n; r0 += WF_TGT_WALK_THREADS) {
    const unsigned r = r0 + threadIdx.x;
    const unsigned long long s0 = S.steps;
    if (r < n) tgt_walk_record<EST, TWO>(P, G, S, recs, keys, r);
    if (COUNT) {
      // a warp spends 32 lane slots on each step of its longest walk
      unsigned long long d = S.steps - s0;
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, d, off);
        d = o > d ? o : d;
      }
      if (lane == 0) slots += 32 * d;
    }
  }
  if (home >= 0) {
    __syncthreads();
    tile_flush<true>(G, srows, tile, home, ch, A.acc, warp, lane, n_warps);
  }
  if (COUNT) {
    unsigned long long c8[WF_N_COUNTERS] = {0,     S.steps, S.n_tile,
                                            S.n_global, slots, 0, 0, 0};
    add_counters(c8, lane, counters);
  }
}

template <bool COUNT, bool TWO>
__global__ void __launch_bounds__(WF_TGT_WALK_THREADS, 1)
    tgt_walk_kernel(const WfParams P, const __grid_constant__ TgtArgs A,
                    const int4* __restrict__ rows,
                    unsigned long long* __restrict__ counters) {
  tgt_walk_cta<DDA, COUNT, TWO>(P, A, rows, counters);
}

// the ratio forward's walk pass: each record's tracking replayed
template <bool COUNT, bool TWO>
__global__ void __launch_bounds__(WF_TGT_WALK_THREADS, 1)
    tgt_ratio_walk_kernel(const WfParams P, const __grid_constant__ TgtArgs A,
                          const int4* __restrict__ rows,
                          unsigned long long* __restrict__ counters) {
  tgt_walk_cta<RATIO, COUNT, TWO>(P, A, rows, counters);
}

// the delta form: the lanes traced, their deposits global atomics
template <bool SCAT, bool TONLY, bool COUNT>
__global__ void __launch_bounds__(WF_TGT_THREADS, WF_TGT_MIN_CTAS)
    tgt_delta_kernel(const WfParams P, const __grid_constant__ WfMesh M,
                     const float4* __restrict__ tris,
                     const float* __restrict__ in,
                     const int* __restrict__ active_pixels,
                     const int* __restrict__ order,
                     const int* __restrict__ starts,
                     const __grid_constant__ TgtArgs A,
                     unsigned long long* __restrict__ counters) {
  tgt_path_cta<DELTA, SCAT, TONLY, COUNT>(P, M, tris, in, active_pixels,
                                          order, starts, A, counters);
}

// The staged adjoint: wf_kernel's adjoint at WF_TGT_THREADS threads a CTA
// with the banks staged in its shared memory, by estimator, scattering
// and transmission_only
template <bool COUNT>
KernelFn tgt_bwd_pick(const WfParams& P) {
  const int key = P.estimator * 4 + (P.has_scattering ? 2 : 0) +
                  (P.transmission_only ? 1 : 0);
#define WF_TGT_CASE(E, SC, TO)              \
  case E * 4 + (SC ? 2 : 0) + (TO ? 1 : 0): \
    return wf_kernel<E, SC, TO, ANALOG, false, COUNT, true, WF_TGT_THREADS, \
                     WF_TGT_MIN_CTAS, true>;
  switch (key) {
    WF_TGT_CASE(DDA, false, false)
    WF_TGT_CASE(DDA, false, true)
    WF_TGT_CASE(DDA, true, false)
    WF_TGT_CASE(DDA, true, true)
    WF_TGT_CASE(RATIO, false, false)
    WF_TGT_CASE(RATIO, false, true)
    WF_TGT_CASE(RATIO, true, false)
    WF_TGT_CASE(RATIO, true, true)
    WF_TGT_CASE(DELTA, false, false)
    WF_TGT_CASE(DELTA, false, true)
    WF_TGT_CASE(DELTA, true, false)
    WF_TGT_CASE(DELTA, true, true)
    default:
      return nullptr;
  }
#undef WF_TGT_CASE
}

using PathFn = void (*)(const WfParams, const WfMesh, const float4*,
                        const float*, const int*, const int*, const int*,
                        const TgtArgs, unsigned long long*);
using TgtWalkFn = void (*)(const WfParams, const TgtArgs, const int4*,
                           unsigned long long*);

// the path pass of P's estimator (dda, ratio), by scattering and
// transmission_only; the delta form (pass 3 of tgt_info) by the same
template <bool COUNT>
PathFn tgt_path_pick(const WfParams& P) {
#define WF_TGT_PICK(K)                                           \
  if (P.has_scattering)                                          \
    return P.transmission_only ? K<true, true, COUNT>            \
                               : K<true, false, COUNT>;          \
  return P.transmission_only ? K<false, true, COUNT>             \
                             : K<false, false, COUNT>;
  if (P.estimator == DDA) {
    WF_TGT_PICK(tgt_path_kernel)
  }
  if (P.estimator == RATIO) {
    WF_TGT_PICK(tgt_ratio_path_kernel)
  }
  return nullptr;
}

template <bool COUNT>
PathFn tgt_delta_pick(const WfParams& P) {
  if (P.estimator != DELTA) return nullptr;
  WF_TGT_PICK(tgt_delta_kernel)
#undef WF_TGT_PICK
}

// the walk pass of estimator est (dda, ratio): counting, two channels
inline TgtWalkFn tgt_walk_pick(int est, bool count, bool two) {
  if (est == RATIO) {
    if (two)
      return count ? tgt_ratio_walk_kernel<true, true>
                   : tgt_ratio_walk_kernel<false, true>;
    return count ? tgt_ratio_walk_kernel<true, false>
                 : tgt_ratio_walk_kernel<false, false>;
  }
  if (two)
    return count ? tgt_walk_kernel<true, true> : tgt_walk_kernel<false, true>;
  return count ? tgt_walk_kernel<true, false> : tgt_walk_kernel<false, false>;
}

// whether P's target forms run here: the scene keeps the target and its
// banks fit a staged CTA (the staged adjoint's instantiation decides; the
// path pass's static shared memory is the same few bytes)
inline cudaError_t tgt_fits(const WfParams& P, const WfMesh& M, bool& fits) {
  fits = false;
  if (!P.target || P.residual != ANALOG) return cudaSuccess;
  const KernelFn k = tgt_bwd_pick<false>(P);
  if (k == nullptr) return cudaErrorInvalidValue;
  size_t smem;
  return stage_shape((const void*)k, M, WF_TGT_MIN_CTAS, smem, fits);
}

inline bool tgt_args_ok(const WfParams& P, const WfMesh* M,
                        const float4* tris, const int* order,
                        const int* starts) {
  return P.n_surf <= WF_MAX_SURF && P.n_groups > 0 && P.group > 0 &&
         P.target != 0 && P.residual == ANALOG && M != nullptr &&
         tris != nullptr &&
         (P.identity || (order != nullptr && starts != nullptr));
}

// The staged adjoint over every CTA of the launch order
inline int tgt_bwd_launch(const WfParams* p, const WfMesh* M,
                          const float4* tris, const float* dL,
                          const int* active_pixels, const int* order,
                          const int* starts, float* grad,
                          unsigned long long* counters, void* stream) {
  WfParams P = *p;
  P.tile_n = 0;
  if (P.n_active <= 0) return 0;
  if (!tgt_args_ok(P, M, tris, order, starts))
    return (int)cudaErrorInvalidValue;
  const KernelFn k = counters != nullptr ? tgt_bwd_pick<true>(P)
                                         : tgt_bwd_pick<false>(P);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  size_t smem;
  bool fits;
  cudaError_t e =
      stage_shape((const void*)k, *M, WF_TGT_MIN_CTAS, smem, fits);
  if (e != cudaSuccess) return (int)e;
  if (!fits) return (int)cudaErrorInvalidConfiguration;
  k<<<(unsigned)P.resy * P.n_groups, WF_TGT_THREADS, smem,
      (cudaStream_t)stream>>>(P, *M, tris, dL, active_pixels, order, starts,
                              nullptr, grad, counters);
  return (int)cudaGetLastError();
}

// The path pass over the batch's units [A.u0, A.u1) (delta: the delta
// form, which takes the units and the accumulator alone)
inline int tgt_path_launch(const WfParams* p, const WfMesh* M,
                           const float4* tris, const float* data,
                           const int* active_pixels, const int* order,
                           const int* starts, const TgtArgs* A,
                           unsigned long long* counters, void* stream,
                           bool delta = false) {
  const WfParams& P = *p;
  if (P.n_active <= 0 || A == nullptr || A->u1 <= A->u0) return 0;
  if (!tgt_args_ok(P, M, tris, order, starts) || A->u0 < 0 ||
      A->units == nullptr || A->acc == nullptr ||
      (!delta && (A->recs == nullptr || A->region == nullptr ||
                  A->counts == nullptr)) ||
      (!delta && P.estimator == RATIO && A->keys == nullptr))
    return (int)cudaErrorInvalidValue;
  const PathFn k = delta ? (counters != nullptr ? tgt_delta_pick<true>(P)
                                                : tgt_delta_pick<false>(P))
                         : (counters != nullptr ? tgt_path_pick<true>(P)
                                                : tgt_path_pick<false>(P));
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  size_t smem;
  bool fits;
  cudaError_t e =
      stage_shape((const void*)k, *M, WF_TGT_MIN_CTAS, smem, fits);
  if (e != cudaSuccess) return (int)e;
  if (!fits) return (int)cudaErrorInvalidConfiguration;
  k<<<(unsigned)(A->u1 - A->u0), WF_TGT_THREADS, smem,
      (cudaStream_t)stream>>>(P, *M, tris, data, active_pixels, order, starts,
                              *A, counters);
  return (int)cudaGetLastError();
}

// The walk pass over the batch's units
inline int tgt_walk_launch(const WfParams* p, const TgtArgs* A,
                           const int4* rows, unsigned long long* counters,
                           void* stream) {
  WfParams P = *p;
  if (A == nullptr || A->u1 <= A->u0) return 0;
  if (A->recs == nullptr || A->region == nullptr || A->counts == nullptr ||
      A->units == nullptr || A->acc == nullptr ||
      (P.tile_n > 0 && rows == nullptr) || !P.target ||
      (P.estimator != DDA && P.estimator != RATIO) ||
      (P.estimator == RATIO && A->keys == nullptr))
    return (int)cudaErrorInvalidValue;
  const TgtWalkFn k =
      tgt_walk_pick(P.estimator, counters != nullptr, P.target == 2);
  size_t smem;
  cudaError_t e = shape(k, P, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(unsigned)(A->u1 - A->u0), WF_TGT_WALK_THREADS, smem,
      (cudaStream_t)stream>>>(P, *A, rows, counters);
  return (int)cudaGetLastError();
}

// The launch shape of pass `pass` (0 the path pass, 1 the walk pass, 2
// the staged adjoint, 3 the delta form) for P (count: the counting
// instantiation), 8 ints as wf::info's (the path pass, the adjoint and
// the delta form: the staged banks' bytes as their dynamic shared memory,
// tile voxels 0)
inline int tgt_info(const WfParams* p, const WfMesh* M, int pass, int count,
                    int* out) {
  WfParams P = *p;
  const void* k = nullptr;
  int threads = WF_TGT_THREADS;
  size_t smem = 0;
  bool fits = true;
  cudaError_t e = cudaSuccess;
  if (pass == 1) {
    const TgtWalkFn w = tgt_walk_pick(P.estimator, count != 0, P.target == 2);
    k = (const void*)w;
    threads = WF_TGT_WALK_THREADS;
    e = shape(w, P, smem);
  } else {
    k = pass == 0   ? (const void*)(count ? tgt_path_pick<true>(P)
                                          : tgt_path_pick<false>(P))
        : pass == 3 ? (const void*)(count ? tgt_delta_pick<true>(P)
                                          : tgt_delta_pick<false>(P))
                    : (const void*)(count ? tgt_bwd_pick<true>(P)
                                          : tgt_bwd_pick<false>(P));
    if (k == nullptr) return (int)cudaErrorInvalidValue;
    e = stage_shape(k, *M, WF_TGT_MIN_CTAS, smem, fits);
    P.tile_n = 0;
  }
  cudaFuncAttributes fa;
  int per_sm = 0;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, k);
  if (e == cudaSuccess && !fits) e = cudaErrorInvalidConfiguration;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  const int v[8] = {threads, P.resy * P.n_groups, (int)smem,
                    (int)fa.sharedSizeBytes, fa.numRegs,
                    (int)fa.localSizeBytes, per_sm, P.tile_n};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
#endif  // __CUDACC__

}  // namespace wf
