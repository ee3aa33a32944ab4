// The wavefront adjoint with the medium cotangents: the pattern gradient
// and d loss / d sigma_t, d loss / d sigma_s summed over every deposit
// of every lane (the reference's st_grad / ss_grad, volume.py:277-280,
// sensor.py:180-186).
//
// Replaces the `want_sigma` branches of drtvam_tpu/ops/march.py
// dda_segment (:586), ratio_segment (:747) and delta_segment (:865),
// summed by trace_wavefront (:913; XLA, no Pallas kernel). Each deposit
// c of a segment is re-expressed with (sigma_t, sigma_s) as leaves in the
// analytic transmittance, the albedo factor (st - ss) / st and the
// scattering power ss^n_scat, the sampling pdfs detached, and its
// partials times the gathered dL go to the lane's two sums, in the JAX
// package's formulas and operation order:
//   dda, per voxel step (E = exp(-st t), G = 1 - exp(-st dt)):
//     dst = -c (t_prev + t) + hist em E G (albedo / st)
//           + hist em E (1 - albedo) dt exp(-st dt),  dss = -hist em E G / st
//   ratio, per tracking step k (weight (st / M) (1 - st / M)^k):
//     dst = -c t_prev - c k / max(M - st, 1e-30) + hist em (1 - st/M)^k / M,
//     dss = -hist em (1 - st/M)^k / M
//   delta, at the event t_m:
//     dst = -c (t_prev + t_m) + hist em / st,  dss = -hist em / st
// and with scattering dss gains c n_scat / ss where ss > 0.
//
// The kernel is wf_kernel's adjoint (wf_trace.cuh: one 1024-thread CTA
// per (DMD row, angle group), warps taking 32 positions from a counter,
// each thread one pixel's spp lanes in lane order), its sink MedSink:
// the same gathers and the same pattern gradient, bitwise, plus the
// lane's history (hist em, t_prev, n_scat) and its two sums. A task's 32
// threads' sums go through a fixed shuffle tree to one float2 written at
// the task's index in the launch order (task_base: the tasks before the
// CTA), whatever warp took it; then one CTA sums the tasks in a fixed
// order (med_sum). So two launches give the same bits. The mesh-free
// form and the one-pass target form (the scene's meshes read from global
// memory) are instantiated; the staged target adjoint (wf_target.cuh) has
// no MED form.
//
// Bound on the H100: wf_bwd's (the voxel steps' float32 work and their
// gathers), plus the partials' float32 operations: 16 a dda step (MedSink
// dda and add), 3 more with scattering (the n_scat term).
#pragma once

#include "wf_trace.cuh"

namespace wf {

// The adjoint's sink with the medium cotangents: Sink's gathers, and per
// lane the history of the segment being deposited (hist em, t_prev, the
// lane's em), its scatter count nsc, and the thread's sums stg and ssg.
// init(P) takes the medium; data: the patterns (the emitted intensities)
template <bool TGT_>
struct MedSink : Sink<false, false, TGT_> {
  static constexpr bool MED = true;
  const float* data = nullptr;
  float st = 0.0f, M = 1.0f, sa = 0.0f, ss = 0.0f, al_st = 0.0f;
  bool scat = false;
  float hist_em = 0.0f, em = 0.0f, t_prev = 0.0f, nsc = 0.0f;
  float gd = 0.0f, stg = 0.0f, ssg = 0.0f;

  __device__ __forceinline__ void init(const WfParams& P) {
    st = P.sigma_t;
    M = P.majorant;
    sa = 1.0f - P.albedo;
    ss = P.albedo * P.sigma_t;
    al_st = P.albedo / P.sigma_t;
    scat = P.has_scattering != 0;
  }
  // a segment's history, before its deposits
  __device__ __forceinline__ void segment(float hist, float em_, float t) {
    hist_em = hist * em_;
    em = em_;
    t_prev = t;
  }
  // Sink's gather, the gathered value kept for the partials
  __device__ __forceinline__ void deposit(int, int flat, float val) {
    if (TGT_ && this->two) flat = 2 * flat + this->chan;
    gd = __ldg(this->dL + flat);
    this->g = this->g + val * gd;
  }
  // the partials of the last deposit (c_full its value with em), the
  // n_scat term added where ss > 0, times the gathered dL into the sums
  __device__ __forceinline__ void add(float dst, float dss, float c_full) {
    if (scat) dss = dss + (ss > 0.0f ? c_full * nsc / mx(ss, 1e-30f) : 0.0f);
    stg = stg + dst * gd;
    ssg = ssg + dss * gd;
  }
  __device__ __forceinline__ void dda(float E, float G, float dtc,
                                      float expdt, float t_at) {
    const float HG = hist_em * E * G;
    const float c_full = HG * sa;
    const float dst = -c_full * (t_prev + t_at) + HG * al_st +
                      hist_em * E * sa * dtc * expdt;
    add(dst, -HG / st, c_full);
  }
  __device__ __forceinline__ void ratio(float contrib, float ratio_k,
                                        float k_at) {
    const float H4 = hist_em * ratio_k / M;
    const float c_full = contrib * em;
    const float dst = -c_full * t_prev - c_full * k_at / mx(M - st, 1e-30f) +
                      H4;
    add(dst, -H4, c_full);
  }
  __device__ __forceinline__ void delta(float t_m) {
    const float c_full = hist_em * sa;
    const float H3 = hist_em / st;
    add(-c_full * (t_prev + t_m) + H3, -H3, c_full);
  }
};

// threads of the summing CTA (med_sum)
constexpr int WF_MED_SUM_THREADS = 1024;

#ifdef __CUDACC__

// One CTA per (DMD row, angle group) as wf_kernel's adjoint; grad
// (n_active,) the pattern gradient; partials[task_base[c] + t] the
// (stg, ssg) of CTA c's task t
template <int EST, bool SCAT, bool TONLY, bool TGT>
__global__ void __launch_bounds__(WF_THREADS, 1)
    med_kernel(const WfParams P, const __grid_constant__ WfMesh M,
               const float4* __restrict__ tris, const float* __restrict__ dL,
               const float* __restrict__ data,
               const int* __restrict__ active_pixels,
               const int* __restrict__ order, const int* __restrict__ starts,
               const int* __restrict__ task_base, float* __restrict__ grad,
               float2* __restrict__ partials) {
  __shared__ unsigned next_task;
  int lo, hi, py;
  block_range(P, starts, blockIdx.x, lo, hi, py);
  Grid G;
  G.init(P);
  MedSink<TGT> S{{nullptr, dL, nullptr, nullptr, -1, 0.0f, 0, 0, 0, 0}};
  S.data = data;
  S.init(P);
  if constexpr (TGT) {
    S.two = P.target == 2;
    S.mesh = &M;
    S.banks = {tris, M.cell_start, M.tri_ids};
  }
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) next_task = 0;
  __syncthreads();
  const unsigned n_tasks = (unsigned)task_count<false>(P, lo, hi);
  const int t0 = task_base[blockIdx.x];
  for (;;) {
    unsigned t = 0;
    if (lane == 0) t = atomicAdd(&next_task, 1u);
    t = __shfl_sync(0xffffffffu, t, 0);
    if (t >= n_tasks) break;
    S.stg = 0.0f;
    S.ssg = 0.0f;
    trace_task<EST, SCAT, TONLY>(P, G, order, lo, hi, (int)t, lane, dL,
                                 active_pixels, grad, S);
    float a = S.stg, b = S.ssg;
    for (int off = 16; off > 0; off >>= 1) {
      a = a + __shfl_down_sync(0xffffffffu, a, off);
      b = b + __shfl_down_sync(0xffffffffu, b, off);
    }
    if (lane == 0) partials[t0 + (int)t] = make_float2(a, b);
  }
}

// (stg, ssg) of n task partials: thread i sums partials i, i + 1024, ...
// in order, then a fixed tree over the threads
__global__ void __launch_bounds__(WF_MED_SUM_THREADS, 1)
    med_sum(const float2* __restrict__ partials, int n,
            float* __restrict__ sums) {
  __shared__ float2 s[WF_MED_SUM_THREADS];
  float a = 0.0f, b = 0.0f;
  for (int i = threadIdx.x; i < n; i += WF_MED_SUM_THREADS) {
    const float2 v = partials[i];
    a = a + v.x;
    b = b + v.y;
  }
  s[threadIdx.x] = make_float2(a, b);
  __syncthreads();
  for (int w = WF_MED_SUM_THREADS / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) {
      s[threadIdx.x].x = s[threadIdx.x].x + s[threadIdx.x + w].x;
      s[threadIdx.x].y = s[threadIdx.x].y + s[threadIdx.x + w].y;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sums[0] = s[0].x;
    sums[1] = s[0].y;
  }
}

using MedFn = void (*)(const WfParams, const WfMesh, const float4*,
                       const float*, const float*, const int*, const int*,
                       const int*, const int*, float*, float2*);

// P's instantiation by estimator, scattering, transmission_only and
// whether the scene has mesh surfaces; nullptr for a residual P
template <bool TGT>
MedFn med_pick_target(const WfParams& P) {
  const int key = P.estimator * 4 + (P.has_scattering ? 2 : 0) +
                  (P.transmission_only ? 1 : 0);
#define WF_CASE(E, SC, TO)                  \
  case E * 4 + (SC ? 2 : 0) + (TO ? 1 : 0): \
    return med_kernel<E, SC, TO, TGT>;
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

inline MedFn med_pick(const WfParams& P) {
  if (P.residual != ANALOG) return nullptr;
  return P.target ? med_pick_target<true>(P) : med_pick_target<false>(P);
}

inline int med_launch(const WfParams* p, const WfMesh* M, const float4* tris,
                      const float* dL, const float* data,
                      const int* active_pixels, const int* order,
                      const int* starts, const int* task_base, float* grad,
                      float2* partials, int n_tasks, float* sums,
                      void* stream) {
  WfParams P = *p;
  P.tile_n = 0;
  if (P.n_active <= 0) return 0;
  if (P.n_surf > WF_MAX_SURF || P.n_groups <= 0 || P.group <= 0 ||
      (!P.identity && (order == nullptr || starts == nullptr)) ||
      M == nullptr || (P.target && tris == nullptr) || task_base == nullptr ||
      n_tasks <= 0)
    return (int)cudaErrorInvalidValue;
  MedFn k = med_pick(P);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  k<<<(unsigned)P.resy * P.n_groups, WF_THREADS, 0, s>>>(
      P, *M, tris, dL, data, active_pixels, order, starts, task_base, grad,
      partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  med_sum<<<1, WF_MED_SUM_THREADS, 0, s>>>(partials, n_tasks, sums);
  return (int)cudaGetLastError();
}

// The launch shape of P's instantiation, as wf::info
inline int med_info(const WfParams* p, int* out) {
  WfParams P = *p;
  MedFn k = med_pick(P);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, (const void*)k);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, WF_THREADS,
                                                      0);
  if (e != cudaSuccess) return (int)e;
  const int v[8] = {WF_THREADS, P.resy * P.n_groups, 0,
                    (int)fa.sharedSizeBytes, fa.numRegs,
                    (int)fa.localSizeBytes, per_sm, 0};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
#endif  // __CUDACC__

}  // namespace wf
