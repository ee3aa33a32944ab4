// The DMD-pixel culling renders' kernel, behind wf_radon.cu and
// wf_corner.cu: the wavefront template's lane modes RADON and CORNER
// (wf_trace.cuh) with the target mesh (wf_mesh.cuh), one thread an active
// pixel.
//
// Replaces drtvam_tpu/ops/render.py:193 render_radon and :226
// render_corner (XLA: the march in its radon mode, march.py:917-923, and
// one intersect_scene, march.py:151-190; ray_triangles_grid,
// mesh_grid.py:117, inside both).
//
// Design for the H100. The renders' time is the lanes' triangle tests
// (the bench scene's radon render: ~200 a lane, ~29 a bounce iteration,
// against a bank of 792 triangles), each a chain of dependent loads (the
// cell's start, the triangle's id, its rows) and ~40 operations:
//   * persistent CTAs, as many as the SMs hold, whose warps take 32
//     neighbouring active pixels at a time from a counter (one global
//     atomic a task), so that each CTA stages the banks once;
//   * the banks staged in each CTA's shared memory by cp.async, the
//     triangles as 16-byte rows (cull_banks), when they fit the CTA's
//     share of the SM's shared memory at WF_CULL_MIN_CTAS CTAs an SM;
//     else the same kernel reads the global copies (a 100k-triangle mesh).
//     The choice is by size alone (cull_launch), and a caller may force
//     the global path (smem_limit 0);
//   * the angles' camera frames computed once a launch (cull_frames, with
//     a lane's own operations: the same bits) and read as three 16-byte
//     loads, with the lane's angle and pixel from its active index: the
//     lane's set-up keeps only what varies by lane;
//   * WF_CULL_MIN_CTAS bounds the registers so that the SM holds that
//     many CTAs.
// One thread sums its pixel's lanes in lane order and writes the pixel
// once: no atomics on the image, so it is bitwise reproducible.
#pragma once

#include "wf_trace.cuh"

// Launch shape (each entry point sets its own, wf_radon.cu, wf_corner.cu)
#ifndef WF_CULL_THREADS
#define WF_CULL_THREADS 256
#endif
#ifndef WF_CULL_MIN_CTAS
#define WF_CULL_MIN_CTAS 3
#endif
// the frame table, on (1) unless a measurement build turns it off
#ifndef WF_CULL_FRAMES
#define WF_CULL_FRAMES 1
#endif

namespace wf {

// What a culling launch takes beside WfParams and WfMesh (mirror of
// ops/render.py CullArgs: the 8-byte pointers, then 4-byte fields)
struct CullArgs {
  const int* active_pixels;  // (n_active,) flat DMD indices, or unused
  const float4* rows;        // the triangle rows (n_rows,): MeshBanks
  float4* frames;            // (n_patterns, 3) scratch: the angles' frames
  float* img;                // (n_patterns * resy * resx,) zeroed
  unsigned* next;            // the warps' task counter, zeroed
  unsigned long long* counters;  // CULL_COUNTERS, or null
  float dist, radius;        // the corner's distance and radius
  int n_rows, n_cell_start, n_tri_ids;  // the banks' lengths
  int smem_limit;            // bytes the staged banks may take at most
};

// the bytes the staged banks take: the rows, then the cell starts and the
// triangle ids
inline size_t stage_bytes(const CullArgs& A) {
  return bank_bytes(A.n_rows, A.n_cell_start, A.n_tri_ids);
}

// The banks a CTA's lanes read. STAGED: thread tid of n_threads copies its
// share of the rows, cell starts and triangle ids into smem (stage_bytes;
// wf_mesh.cuh stage_banks) and waits for its copies; the caller's barrier
// then publishes them. Else the global copies
template <bool STAGED>
__device__ __forceinline__ MeshBanks cull_banks(const WfMesh& M,
                                                const CullArgs& A,
                                                float4* smem, int tid,
                                                int n_threads) {
  if constexpr (!STAGED) {
    return {A.rows, M.cell_start, M.tri_ids};
  } else {
    return stage_banks({A.rows, M.cell_start, M.tri_ids}, A.n_rows,
                       A.n_cell_start, A.n_tri_ids, smem, tid, n_threads);
  }
}

// angle a's frame (angle_frame) as three 16-byte rows: origin and left.x;
// left.yz and up2.xy; up2.z and dirw
__device__ __forceinline__ void put_frame(float4* f, const Frame& F) {
  f[0] = make_float4(F.origin.x, F.origin.y, F.origin.z, F.left.x);
  f[1] = make_float4(F.left.y, F.left.z, F.up2.x, F.up2.y);
  f[2] = make_float4(F.up2.z, F.dirw.x, F.dirw.y, F.dirw.z);
}
__device__ __forceinline__ Frame get_frame(const float4* __restrict__ f) {
#ifdef __CUDA_ARCH__
  const float4 a = __ldg(f), b = __ldg(f + 1), c = __ldg(f + 2);
#else
  const float4 a = f[0], b = f[1], c = f[2];
#endif
  return {{a.x, a.y, a.z}, {a.w, b.x, b.y}, {b.z, b.w, c.x}, {c.y, c.z, c.w}};
}

// Task t's pixel for lane l: active index 32 t + l (none from n_active
// on), its spp lanes in the lane mode RES one after another, their values
// summed in lane order and written once, times the ray weight. frames:
// the frame table (null: each lane computes its frame). COUNT: the
// pixel's lanes that entered a mesh grid's box, into *boxed
template <int RES, bool TONLY, class SinkT>
__device__ __forceinline__ void cull_task(const WfParams& P, const Grid& G,
                                          const CullArgs& A,
                                          const float4* frames, SinkT& S,
                                          int t, int l,
                                          unsigned long long* boxed) {
  const int aidx = 32 * t + l;
  if (aidx >= P.n_active) return;
  const int idx = P.identity ? aidx : A.active_pixels[aidx];
  const int hw = P.resy * P.resx;
  LaneSetup su;
  su.emitter = idx / hw;
  const int pixel = idx - su.emitter * hw;
  su.py = pixel / P.resx;
  su.px = pixel - su.py * P.resx;
  Frame F;
  su.frame = nullptr;
  su.chord = nullptr;
  if (frames != nullptr) {
    F = get_frame(frames + 3 * su.emitter);
    su.frame = &F;
  }
  float sum = 0.0f;
  for (int k = 0; k < P.spp; ++k) {
    S.L = 0.0f;
    const unsigned long long w0 = S.mc.walks;
    trace_lane<DDA, false, TONLY, RES>(
        P, G, (uint32_t)aidx * (uint32_t)P.spp + (uint32_t)k, aidx,
        A.active_pixels, 1.0f, S, nullptr, &su);
    if (SinkT::COUNT) *boxed += S.mc.walks > w0 ? 1 : 0;
    sum = k == 0 ? S.L : sum + S.L;
  }
  A.img[idx] = sum * P.ray_w;
}

#ifdef __CUDACC__

// The frame table: angle a's frame for each a < n_patterns
__global__ void cull_frames(const WfParams P, float4* frames) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a < P.n_patterns) put_frame(frames + 3 * a, angle_frame(P, a));
}

// Persistent CTAs: each stages the banks (STAGED), then its warps take
// tasks of 32 active pixels from *A.next until none is left. COUNT:
// counters (CULL_COUNTERS) bounce iterations, grid cells, triangles
// tested, triangle slots (32 for each triangle test of a task's busiest
// lane: the tests' SIMT efficiency is triangles / slots), grid walks that
// entered a box, lanes with at least one such walk, and repeated tests
// (MeshCount)
template <int RES, bool TONLY, bool COUNT, bool STAGED>
__global__ void __launch_bounds__(WF_CULL_THREADS, WF_CULL_MIN_CTAS)
    cull_kernel(const WfParams P, const __grid_constant__ WfMesh M,
                const __grid_constant__ CullArgs A) {
  extern __shared__ float4 cull_smem[];
  const MeshBanks B =
      cull_banks<STAGED>(M, A, cull_smem, threadIdx.x, WF_CULL_THREADS);
  if (STAGED) __syncthreads();
  Grid G;
  G.init(P);
  MeshSink<COUNT, STAGED> S{&M, B, A.dist, A.radius, 0.0f, 0, {0, 0, 0, 0}};
  const float4* frames =
      (WF_CULL_FRAMES && !P.sample_time) ? A.frames : nullptr;
  const int lane = threadIdx.x & 31;
  const unsigned n_tasks = ((unsigned)P.n_active + 31u) / 32u;
  unsigned long long slots = 0, boxed = 0;
  for (;;) {
    unsigned t = 0;
    if (lane == 0) t = atomicAdd(A.next, 1u);
    t = __shfl_sync(0xffffffffu, t, 0);
    if (t >= n_tasks) break;
    const unsigned long long c0 = S.mc.tris;
    cull_task<RES, TONLY>(P, G, A, frames, S, (int)t, lane, &boxed);
    if (COUNT) {
      unsigned long long d = S.mc.tris - c0;
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, d, off);
        d = o > d ? o : d;
      }
      if (lane == 0) slots += 32 * d;
    }
  }
  if (COUNT) {
    unsigned long long c[7] = {S.iters,    S.mc.cells, S.mc.tris,
                               slots,      S.mc.walks, boxed,
                               S.mc.repeats};
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      for (int off = 16; off > 0; off >>= 1)
        c[k] += __shfl_down_sync(0xffffffffu, c[k], off);
      if (lane == 0) atomicAdd(A.counters + k, c[k]);
    }
  }
}

using CullFn = void (*)(const WfParams, const WfMesh, const CullArgs);

// RES's instantiation for P (the radon mode by transmission_only; the
// corner mode has one: its lanes end at their first hit), counting or
// not, staged or not
template <int RES, bool COUNT, bool STAGED>
CullFn cull_pick(const WfParams& P) {
  if constexpr (RES == CORNER) {
    return cull_kernel<RES, true, COUNT, STAGED>;
  } else {
    if (P.transmission_only) return cull_kernel<RES, true, COUNT, STAGED>;
    return cull_kernel<RES, false, COUNT, STAGED>;
  }
}

// The instantiation and the dynamic shared memory of a launch: staged
// when the banks fit A.smem_limit and the CTA's share of the SM's shared
// memory at WF_CULL_MIN_CTAS CTAs an SM; *ctas: the persistent CTAs (as
// many as the SMs hold, and no more than the tasks need)
template <int RES>
cudaError_t cull_shape(const WfParams& P, const CullArgs& A, bool count,
                       CullFn& k, size_t& smem, unsigned& ctas) {
  int dev, n_sm, per_sm_bytes, optin, reserved;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm_bytes,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (e != cudaSuccess) return e;
  size_t budget = (size_t)per_sm_bytes / WF_CULL_MIN_CTAS - (size_t)reserved;
  const size_t limit = A.smem_limit > 0 ? (size_t)A.smem_limit : 0;
  if (budget > (size_t)optin) budget = (size_t)optin;
  if (budget > limit) budget = limit;
  const bool staged = stage_bytes(A) <= budget;
  k = count ? (staged ? cull_pick<RES, true, true>(P)
                      : cull_pick<RES, true, false>(P))
            : (staged ? cull_pick<RES, false, true>(P)
                      : cull_pick<RES, false, false>(P));
  smem = staged ? stage_bytes(A) : 0;
  e = cudaFuncSetAttribute((const void*)k,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k,
                                                      WF_CULL_THREADS, smem);
  if (e != cudaSuccess) return e;
  const unsigned warps = ((unsigned)P.n_active + 31u) / 32u;
  const unsigned need = (warps + WF_CULL_THREADS / 32 - 1) /
                        (WF_CULL_THREADS / 32);
  ctas = (unsigned)(per_sm > 0 ? per_sm : 1) * (unsigned)n_sm;
  if (ctas > need) ctas = need;
  return cudaSuccess;
}

// One culling render: the frame table (without time sampling), then the
// persistent kernel
template <int RES>
int cull_launch(const WfParams* p, const WfMesh* m, const CullArgs* a,
                void* stream) {
  const WfParams& P = *p;
  if (P.n_active <= 0) return 0;
  if (P.n_surf > WF_MAX_SURF || P.spp <= 0 || m == nullptr || a == nullptr ||
      a->next == nullptr || (!P.sample_time && a->frames == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  CullFn k;
  size_t smem;
  unsigned ctas;
  cudaError_t e = cull_shape<RES>(P, *a, a->counters != nullptr, k, smem,
                                  ctas);
  if (e != cudaSuccess) return (int)e;
  if (!P.sample_time) {
    cull_frames<<<(unsigned)(P.n_patterns + 127) / 128, 128, 0, st>>>(
        P, a->frames);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  k<<<ctas, WF_CULL_THREADS, smem, st>>>(P, *m, *a);
  return (int)cudaGetLastError();
}

// The launch shape of P's instantiation (count: the counting one):
// {threads a CTA, CTAs, dynamic shared bytes a CTA (0: the global banks),
// static shared bytes, registers a thread, local (stack and spill) bytes
// a thread, CTAs an SM holds, 1 if staged}
template <int RES>
int cull_info(const WfParams* p, const CullArgs* a, int count, int* out) {
  CullFn k;
  size_t smem;
  unsigned ctas;
  cudaError_t e = cull_shape<RES>(*p, *a, count != 0, k, smem, ctas);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, (const void*)k);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k,
                                                      WF_CULL_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const int v[8] = {WF_CULL_THREADS, (int)ctas, (int)smem,
                    (int)fa.sharedSizeBytes, fa.numRegs,
                    (int)fa.localSizeBytes, per_sm, smem > 0 ? 1 : 0};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
#endif  // __CUDACC__

}  // namespace wf
