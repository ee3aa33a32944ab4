// The wavefront adjoint's paths for the medium cotangents alone (wf_med.cu):
// d loss / d sigma_t and d loss / d sigma_s summed over every deposit of
// every lane (the reference's st_grad / ss_grad, volume.py:277-280,
// sensor.py:180-186), with no pattern gradient: the JAX package's
// optimize differentiates the medium alone (jax.grad(f, argnums=(0,
// 1))(st, al), drtvam_tpu/opt/optimize.py:453-468), as the port's
// optimize_medium does. A caller that differentiates the patterns too
// takes their gradient from wf_bwd (ops/render.py adjoint).
//
// Replaces the `want_sigma` branches of drtvam_tpu/ops/march.py
// dda_segment (:586), ratio_segment (:747) and delta_segment (:865),
// summed by trace_wavefront (:913; XLA, no Pallas kernel). Each deposit
// c of a segment is re-expressed with (sigma_t, sigma_s) as leaves in the
// analytic transmittance, the albedo factor (st - ss) / st and the
// scattering power ss^n_scat, the sampling pdfs detached, and its
// partials times the gathered dL go to the lane's two sums, in the JAX
// package's formulas and operation order, the divisions by the launch's
// constants taken as products with their reciprocals (MedArgs):
//   dda, per voxel step (E = exp(-st t), G = 1 - exp(-st dt)):
//     dst = -c (t_prev + t) + hist em E G (albedo / st)
//           + hist em E (1 - albedo) dt exp(-st dt),  dss = -hist em E G / st
//   ratio, per tracking step k (weight (st / M) (1 - st / M)^k):
//     dst = -c t_prev - c k / max(M - st, 1e-30) + hist em (1 - st/M)^k / M,
//     dss = -hist em (1 - st/M)^k / M
//   delta, at the event t_m:
//     dst = -c (t_prev + t_m) + hist em / st,  dss = -hist em / st
// and with scattering dss gains c n_scat / ss where ss > 0. The dda step
// carries E as a running product of exp(-st dt) from the walk's start
// (one expf a step less than the deposit's own).
//
// It runs wf_kernel's CTA (wf_trace.cuh wf_cta: one CTA per (DMD row,
// angle group), warps taking 32 positions from a counter) with the sink
// MedSink, which replaces the CTA's task hooks. Only the pixels whose
// emitted intensity em = data ray_w is not 0 are traced: every partial
// of such a pixel's deposits is 0 (each carries hist em), and each lane
// has its own random stream, so the others' values do not change. Each
// CTA first compacts its range (MedSink::begin: a block prefix sum in
// launch order) into its region of cidx, and its warps take 32 emitting
// pixels at a time, each thread one pixel's spp lanes in lane order. A
// task's 32 threads' sums go through a fixed shuffle tree to one float2
// written at the task's place in the launch order (task_base: the
// adjoint's tasks before the CTA; the compacted tasks take the first
// slots of the CTA's region, the rest are written 0), whatever warp took
// it; then one CTA sums the slots in a fixed order (med_sum). So two
// launches give the same bits. A mesh-free instantiation, a one-pass
// target one (the scene's mesh banks read from global memory) and a
// staged one (the banks in the CTA's shared memory, wf_mesh.cuh
// stage_banks, as wf_tgt_bwd reads them) for a scene whose banks fit a
// CTA.
//
// Bound on the H100: the emitting pixels' voxel steps at wf_bwd's float32
// work and gathers a step, plus the partials' (MedSink dda and add: 12
// operations a dda step, 3 more with scattering, the n_scat term).
#pragma once

#include "wf_trace.cuh"

// threads a CTA of the mesh-free and one-pass target forms: 768, up to
// 80 registers a thread. Measured on an H100 on the calibration cell's
// inputs (PERF.md section 6): 50.00 ms at 768 threads, 50.32 at 1024 (64
// registers, 48 bytes of spill), 54.18 at 512. At 768 the mesh-free
// forms spill nothing but the dda's with scattering (4 bytes); every
// target form, at 80 registers, spills: the dda's 112-148 bytes (cell
// (c)'s 136 one-pass, 112 staged), the ratio's and delta's 32-64
#ifndef WF_MED_THREADS
#define WF_MED_THREADS 768
#endif
// threads a CTA of the staged form (the banks in shared memory): the
// same 768. Measured on an H100 on a mesh vial's scene with an occlusion:
// 47.69 ms staged at 768 threads, 53.73 at 1024 (64 registers, 256 bytes
// of spill; wf_tgt_bwd's shape), 48.59 one-pass at 768
#ifndef WF_MED_STAGED_THREADS
#define WF_MED_STAGED_THREADS WF_MED_THREADS
#endif

namespace wf {

// What the medium adjoint takes beside wf_kernel's arguments, in the
// kernel's parameter space: the patterns; the adjoint's warp tasks
// before each CTA of the launch order (task_base, CTAs + 1) and their
// slots (partials); the compacted pixels (cidx, each CTA's at its
// range's first position) and each CTA's count of them; and the
// medium's launch constants, computed on the host (med_args)
struct MedArgs {
  const float* data;
  const int* task_base;
  float2* partials;
  int* cidx;
  int* count;
  float st, sa, al_st;
  // the reciprocals of sigma_t, the majorant, max(M - st, 1e-30) and
  // max(ss, 1e-30), and whether ss > 0 (the n_scat term)
  float inv_st, inv_M, inv_mst, inv_ss;
  int ss_pos;
};

inline MedArgs med_args(const WfParams& P, const float* data,
                        const int* task_base, float2* partials, int* cidx,
                        int* count) {
  MedArgs A;
  A.data = data;
  A.task_base = task_base;
  A.partials = partials;
  A.cidx = cidx;
  A.count = count;
  A.st = P.sigma_t;
  A.sa = 1.0f - P.albedo;
  A.al_st = P.albedo / P.sigma_t;
  // torch.clamp(., min=1e-30) as the plain version (host code: no mx)
  const float ss = P.albedo * P.sigma_t, mst = P.majorant - P.sigma_t;
  A.inv_st = 1.0f / P.sigma_t;
  A.inv_M = 1.0f / P.majorant;
  A.inv_mst = 1.0f / (mst > 1e-30f ? mst : 1e-30f);
  A.inv_ss = 1.0f / (ss > 1e-30f ? ss : 1e-30f);
  A.ss_pos = ss > 0.0f;
  return A;
}

// whether the pixel at sorted position j emits (its active index aidx):
// the medium adjoint traces it
__device__ __forceinline__ bool med_emits(const WfParams& P,
                                          const float* __restrict__ data,
                                          const int* order, int j,
                                          int& aidx) {
  aidx = lane_aidx(P, order, j);
  return __ldg(data + aidx) * P.ray_w != 0.0f;
}

// The medium adjoint's sink: Sink's gathers of dL, and per lane the
// history of the segment being deposited (hist em, t_prev, the lane's
// em), its scatter count nsc (SCAT), the dda walk's running E, and the
// thread's sums stg and ssg; A the launch's arguments (bind: a copy of
// the kernel's parameter, its constants read from parameter space, not
// held in registers), base the CTA's first task slot, n the CTA's
// emitting pixels
template <bool SCAT_, bool TGT_, bool STAGED_ = false>
struct MedSink : Sink<false, false, TGT_, STAGED_> {
  static constexpr bool MED = true;
  MedArgs A;
  int base = 0, n = 0;
  float hist_em = 0.0f, em = 0.0f, t_prev = 0.0f, nsc = 0.0f, E = 0.0f;
  float gd = 0.0f, stg = 0.0f, ssg = 0.0f;

  __device__ __forceinline__ void bind(const MedArgs& A_) { A = A_; }
  // a segment's history, before its deposits
  __device__ __forceinline__ void segment(float hist, float em_, float t) {
    hist_em = hist * em_;
    em = em_;
    t_prev = t;
  }
  // a dda walk from t: E = exp(-st t) at its first step
  __device__ __forceinline__ void walk(float st, float t) {
    E = expf(-st * t);
  }
  // the deposit's gathered dL, kept for the partials
  __device__ __forceinline__ void deposit(int, int flat, float) {
    if (TGT_ && this->two) flat = 2 * flat + this->chan;
    gd = __ldg(this->dL + flat);
  }
  // the partials of the last deposit (c_full its value with em), the
  // n_scat term added where ss > 0, times the gathered dL into the sums
  __device__ __forceinline__ void add(float dst, float dss, float c_full) {
    if constexpr (SCAT_) {
      if (A.ss_pos) dss = dss + c_full * nsc * A.inv_ss;
    }
    stg = stg + dst * gd;
    ssg = ssg + dss * gd;
  }
  // a dda step's partials; E advances to the next step's
  __device__ __forceinline__ void dda(float E_, float G, float dtc,
                                      float expdt, float t_at) {
    const float HG = hist_em * E_ * G;
    const float c_full = HG * A.sa;
    const float dst = -c_full * (t_prev + t_at) + HG * A.al_st +
                      hist_em * E_ * A.sa * dtc * expdt;
    add(dst, -HG * A.inv_st, c_full);
    E = E_ * expdt;
  }
  __device__ __forceinline__ void ratio(float contrib, float ratio_k,
                                        float k_at) {
    const float H4 = hist_em * ratio_k * A.inv_M;
    const float c_full = contrib * em;
    const float dst = -c_full * t_prev - c_full * k_at * A.inv_mst + H4;
    add(dst, -H4, c_full);
  }
  __device__ __forceinline__ void delta(float t_m) {
    const float c_full = hist_em * A.sa;
    const float H3 = hist_em * A.inv_st;
    add(-c_full * (t_prev + t_m) + H3, -H3, c_full);
  }

  // Task t's work for lane l, its sums into stg and ssg: the (32 t +
  // l)-th of the n emitting pixels of the CTA whose range starts at lo,
  // its spp lanes in lane order. Returns the pixel's active index, or -1
  template <int EST, bool SCAT, bool TONLY>
  __device__ __forceinline__ int trace(const WfParams& P, const Grid& G,
                                       int lo, int t, int l,
                                       const int* active_pixels) {
    stg = 0.0f;
    ssg = 0.0f;
    const int k = 32 * t + l;
    if (k >= n) return -1;
    const int aidx = A.cidx[lo + k];
    const float em_ = A.data[aidx] * P.ray_w;
    for (int j = 0; j < P.spp; ++j)
      trace_lane<EST, SCAT, TONLY>(
          P, G, (uint32_t)aidx * (uint32_t)P.spp + (uint32_t)j, aidx,
          active_pixels, em_, *this);
    return aidx;
  }

#ifdef __CUDACC__
  // The CTA's task hooks (Sink's, replaced). begin: compacts the CTA's
  // range [lo, hi), THREADS positions a round in launch order (a ballot
  // in each warp, the warps' counts scanned by warp 0), writing each
  // emitting pixel's active index at cidx[lo + its rank] and the count
  // to count[CTA]; a task for each 32 of them; the CTA's slots past its
  // tasks written 0
  template <int THREADS>
  __device__ __forceinline__ unsigned begin(const WfParams& P,
                                            const int* order, int lo,
                                            int hi) {
    base = A.task_base[blockIdx.x];
    const int slots = A.task_base[blockIdx.x + 1] - base;
    __shared__ int tot[32];
    constexpr int n_warps = THREADS / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int made = 0;
    for (int j0 = lo; j0 < hi; j0 += THREADS) {
      const int j = j0 + (int)threadIdx.x;
      int aidx = 0;
      const bool e = j < hi && med_emits(P, A.data, order, j, aidx);
      const unsigned b = __ballot_sync(0xffffffffu, e);
      if (lane == 0) tot[warp] = __popc(b);
      __syncthreads();
      if (warp == 0) {
        int v = lane < n_warps ? tot[lane] : 0;
        for (int off = 1; off < 32; off <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        if (lane < n_warps) tot[lane] = v;
      }
      __syncthreads();
      const int rank = made + (warp > 0 ? tot[warp - 1] : 0) +
                       __popc(b & ((1u << lane) - 1u));
      if (e) A.cidx[lo + rank] = aidx;
      made += tot[n_warps - 1];
      __syncthreads();
    }
    if (threadIdx.x == 0) A.count[blockIdx.x] = made;
    n = made;
    const int n_tasks = (made + 31) / 32;
    __syncthreads();
    for (int t = n_tasks + (int)threadIdx.x; t < slots; t += THREADS)
      A.partials[base + t] = make_float2(0.0f, 0.0f);
    return (unsigned)n_tasks;
  }
  // task: trace, then the task's 32 sums by a fixed shuffle tree into its
  // slot
  template <int EST, bool SCAT, bool TONLY>
  __device__ __forceinline__ void task(const WfParams& P, const Grid& G,
                                       const int*, int lo, int, int t,
                                       int l, const float*,
                                       const int* active_pixels, float*) {
    trace<EST, SCAT, TONLY>(P, G, lo, t, l, active_pixels);
    float a = stg, b = ssg;
    for (int off = 16; off > 0; off >>= 1) {
      a = a + __shfl_down_sync(0xffffffffu, a, off);
      b = b + __shfl_down_sync(0xffffffffu, b, off);
    }
    if (l == 0) A.partials[base + t] = make_float2(a, b);
  }
#endif  // __CUDACC__
};

// threads of the summing CTA (med_sum)
constexpr int WF_MED_SUM_THREADS = 1024;

#ifdef __CUDACC__

// One CTA per (DMD row, angle group) of wf_kernel's launch order (wf_cta)
// with the medium sink; dL the flat loss gradient
template <int EST, bool SCAT, bool TONLY, bool TGT, int THREADS,
          int MIN_CTAS, bool STAGED>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    med_kernel(const WfParams P, const __grid_constant__ WfMesh M,
               const float4* __restrict__ tris, const float* __restrict__ dL,
               const int* __restrict__ active_pixels,
               const int* __restrict__ order, const int* __restrict__ starts,
               const __grid_constant__ MedArgs A) {
  wf_cta<EST, SCAT, TONLY, false, false, TGT, THREADS, STAGED,
         MedSink<SCAT, TGT, STAGED>>(P, M, tris, dL, active_pixels, order,
                                     starts, nullptr, nullptr, nullptr, A);
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
                       const float*, const int*, const int*, const int*,
                       const MedArgs);

// the instantiation for P by estimator, scattering and transmission_only
// at one launch shape
template <bool TGT, int THREADS, int MIN_CTAS, bool STAGED>
MedFn med_pick_shape(const WfParams& P) {
  const int key = P.estimator * 4 + (P.has_scattering ? 2 : 0) +
                  (P.transmission_only ? 1 : 0);
#define WF_CASE(E, SC, TO)                                              \
  case E * 4 + (SC ? 2 : 0) + (TO ? 1 : 0):                             \
    return med_kernel<E, SC, TO, TGT, THREADS, MIN_CTAS, STAGED>;
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

// P's instantiation: staged (a scene with mesh surfaces whose banks fit,
// med_shape), one-pass target (mesh surfaces), mesh-free; nullptr for a
// residual P or staged without mesh surfaces
inline MedFn med_pick(const WfParams& P, bool staged) {
  if (P.residual != ANALOG || (staged && !P.target)) return nullptr;
  if (staged) return med_pick_shape<true, WF_MED_STAGED_THREADS, 1, true>(P);
  return P.target ? med_pick_shape<true, WF_MED_THREADS, 1, false>(P)
                  : med_pick_shape<false, WF_MED_THREADS, 1, false>(P);
}

// the launch shape of kernel k: threads, and the staged banks' dynamic
// shared memory with the kernel's limit raised to it (fits: they fit a
// CTA, wf_mesh.cuh stage_shape)
inline cudaError_t med_shape(MedFn k, bool staged, const WfMesh& M,
                             int& threads, size_t& smem, bool& fits) {
  threads = staged ? WF_MED_STAGED_THREADS : WF_MED_THREADS;
  smem = 0;
  fits = true;
  if (!staged) return cudaSuccess;
  return stage_shape((const void*)k, M, 1, smem, fits);
}

inline int med_launch(const WfParams* p, const WfMesh* M, const float4* tris,
                      const float* dL, const float* data,
                      const int* active_pixels, const int* order,
                      const int* starts, const int* task_base, int* cidx,
                      int* count, float2* partials, int n_tasks, float* sums,
                      int staged, void* stream) {
  WfParams P = *p;
  P.tile_n = 0;
  if (P.n_active <= 0) return 0;
  if (P.n_surf > WF_MAX_SURF || P.n_groups <= 0 || P.group <= 0 ||
      (!P.identity && (order == nullptr || starts == nullptr)) ||
      M == nullptr || (P.target && tris == nullptr) || task_base == nullptr ||
      n_tasks <= 0 || cidx == nullptr || count == nullptr)
    return (int)cudaErrorInvalidValue;
  const MedFn k = med_pick(P, staged != 0);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  int threads;
  size_t smem;
  bool fits;
  cudaError_t e = med_shape(k, staged != 0, *M, threads, smem, fits);
  if (e != cudaSuccess) return (int)e;
  if (!fits) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  k<<<(unsigned)P.resy * P.n_groups, threads, smem, s>>>(
      P, *M, tris, dL, active_pixels, order, starts,
      med_args(P, data, task_base, partials, cidx, count));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  med_sum<<<1, WF_MED_SUM_THREADS, 0, s>>>(partials, n_tasks, sums);
  return (int)cudaGetLastError();
}

// whether the staged instantiation for P fits the banks M into a CTA
inline int med_fits(const WfParams* p, const WfMesh* M, int* fits) {
  *fits = 0;
  if (!p->target || p->residual != ANALOG) return 0;
  const MedFn k = med_pick(*p, true);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  int threads;
  size_t smem;
  bool f;
  const cudaError_t e = med_shape(k, true, *M, threads, smem, f);
  *fits = f ? 1 : 0;
  return (int)e;
}

// The launch shape of P's instantiation (staged or not), as wf::info's 8
// ints (the staged banks' bytes as its dynamic shared memory, tile
// voxels 0)
inline int med_info(const WfParams* p, const WfMesh* M, int staged,
                    int* out) {
  WfParams P = *p;
  const MedFn k = med_pick(P, staged != 0);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  int threads;
  size_t smem;
  bool fits;
  cudaFuncAttributes fa;
  cudaError_t e = med_shape(k, staged != 0, *M, threads, smem, fits);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, (const void*)k);
  if (e == cudaSuccess && !fits) e = cudaErrorInvalidConfiguration;
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  const int v[8] = {threads, P.resy * P.n_groups, (int)smem,
                    (int)fa.sharedSizeBytes, fa.numRegs,
                    (int)fa.localSizeBytes, per_sm, 0};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
#endif  // __CUDACC__

}  // namespace wf
