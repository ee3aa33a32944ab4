"""The wavefront kernels' per-lane template (csrc/wf_trace.cuh) built
with the host compiler and held to the plain version, on the CPU: the
analog pair's instantiations and the residual pair's (the hybrid
engine's scattered-only, first-scatter and fast-residual modes), and the
target forms (csrc/wf_target.cuh, csrc/wf_res_target.cuh) in their
launch order, a warp's threads in turn.

Everything of the template above its `__global__` kernel is plain C++
once a few CUDA names are stubbed (below), so g++ builds it into a
library whose loop over pixels calls `trace_lane` exactly as the kernel
does, minus the threads: one check of the kernel source here, where
there is no nvcc. The card's chip_smoke.py phase 7 holds the real
kernels to the same plain version.

Tolerance: the paths must be the same paths, so the bounce iterations
and estimator steps counted by both are equal exactly. Values agree to
1e-4 of the max: glibc's expf / logf / powf / sinf / cosf against
torch's CPU ones differ by an ulp or two (on the card both use CUDA's,
and agree more closely); a ratio or delta deposit is a point, so there
up to 0.2 % of the nonzero values may be off by more."""
import ctypes
import ctypes.util
import dataclasses
import json
import shutil
import subprocess

import numpy as np
import pytest
import torch

from drtvam_tpu_torch.models.geometry import DIFFUSE
from drtvam_tpu_torch.models.scene import Scene
from drtvam_tpu_torch.native import CUDA_SRC_DIR
from drtvam_tpu_torch.ops import render as wf
from drtvam_tpu_torch.ops.hybrid import ScatteringEngine
from drtvam_tpu_torch.ops.march import scene_tensors
from drtvam_tpu_torch.ops.mesh import (make_box, make_box_tube,
                                       make_hollow_gear, save_ply)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the plain wavefront's many small ops gain
    nothing from more, and the suite runs several workers on one host,
    where spinning thread pools slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

STUB = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __forceinline__ inline
#define __restrict__
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
struct uint2 { unsigned x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline float atomicAdd(float* p, float v) { float o = *p; *p = o + v; return o; }
inline float __ldg(const float* p) { return *p; }
inline float4 __ldg(const float4* p) { return *p; }
inline int __ldg(const int* p) { return *p; }
using std::isfinite;
"""

HARNESS = r"""
#include <algorithm>
#include <vector>
#include "wf_residual.cuh"
#include "wf_target.cuh"
#include "wf_res_target.cuh"
#include "wf_med.cuh"
using namespace wf;
static std::vector<int> traced;
// the budget the staged banks must fit (bytes); the card's is a CTA's
// share of the SM's shared memory
static long long tgt_budget = 1LL << 30;

// the kernels' target arguments (TGT): the mesh, its triangle rows in
// global memory, the inside mask
struct Target {
  const WfMesh* M;
  const float4* tris;
  const unsigned char* mask;
};
template <class SinkT>
void set_target(SinkT& S, const WfParams& P, const Target& T) {
  if constexpr (SinkT::TGT) {
    S.two = P.target == 2;
    S.mesh = T.M;
    S.banks = {T.tris, T.M->cell_start, T.M->tri_ids};
    S.mask = T.mask;
  }
}

// the banks staged (stage_banks) into buf, standing for a CTA's shared
// memory
MeshBanks staged_banks(const Target& T, std::vector<float4>& buf) {
  const WfMesh& M = *T.M;
  buf.assign((bank_bytes(M.n_rows, M.n_cell_start, M.n_tri_ids) + 15) / 16,
             float4{0, 0, 0, 0});
  return stage_banks({T.tris, M.cell_start, M.tri_ids}, M.n_rows,
                     M.n_cell_start, M.n_tri_ids, buf.data(), 0, 1);
}

// a sink's counters as the kernels write them (wf_kernel: COUNTERS), when
// the call counts (c not null); GEO: the prologue's iterations after them
template <bool GEO = false, class SinkT>
void add_counts(const SinkT& S, unsigned long long slots,
                unsigned long long* c) {
  if (c == nullptr) return;
  const unsigned long long k[8] = {S.iters,    S.steps,   S.n_tile,
                                   S.n_global, slots,     S.mc.cells,
                                   S.mc.tris,  S.mc.walks};
  for (int i = 0; i < 8; ++i) c[i] += k[i];
  if (GEO) c[8] += S.pro_iters;
}

// the kernel's launch order on one thread: block by block, each block's
// range task by task (task_position); the forward's home-slice tile
// (a voxel's channels side by side) zeroed first and flushed last (the
// adjoint and the residual take none). STAGED: the banks staged, as the
// target forms' adjoint (wf_target.cuh) reads them
template <int EST, bool SCAT, bool TONLY, int RES, bool PRIMAL, bool TGT,
          bool STAGED = false>
void run_blocks(const WfParams& P, const Target& T, const float* in,
                const int* ap, const int* order, const int* starts,
                const int4* rows, const float* chords, float* out,
                unsigned long long* c) {
  Grid G;
  G.init(P);
  const int ch = P.target == 2 ? 2 : 1;
  std::vector<float> tile(ch * P.tile_n);
  Sink<PRIMAL, true, TGT, STAGED> S{out, in, tile.data(), rows, -1, 0.0f,
                                    0,   0,  0,           0};
  set_target(S, P, T);
  std::vector<float4> smem;
  if constexpr (STAGED) S.banks = staged_banks(T, smem);
  unsigned long long slots = 0;
  for (int b = 0; b < P.resy * P.n_groups; ++b) {
    int lo, hi, py;
    block_range(P, starts, b, lo, hi, py);
    S.home = P.tile_n > 0 ? home_slice(P, G, py) : -1;
    const int slice0 = S.home * G.res[0] * G.res[1];
    for (int y = 0; PRIMAL && S.home >= 0 && y < G.res[1]; ++y)
      for (int i = ch * (rows[y].z + rows[y].x);
           i < ch * (rows[y].z + rows[y].x + rows[y].y); ++i)
        tile[i] = 0.0f;
    for (int t = 0; t < task_count<PRIMAL>(P, lo, hi); ++t) {
      unsigned long long longest = 0;
      for (int l = 0; l < 32; ++l) {
        const unsigned long long s0 = S.steps;
        const int aidx = trace_task<EST, SCAT, TONLY>(
            P, G, order, lo, hi, t, l, in, ap, out, S);
        if (aidx >= 0) traced.push_back(aidx);
        if (S.steps - s0 > longest) longest = S.steps - s0;
      }
      slots += 32 * longest;
    }
    for (int y = 0; PRIMAL && S.home >= 0 && y < G.res[1]; ++y) {
      const int row0 = slice0 + y * G.res[0] + rows[y].x;
      for (int i = 0; i < ch * rows[y].y; ++i) {
        const float v = tile[ch * (rows[y].z + rows[y].x) + i];
        if (v != 0.0f) atomicAdd(out + ch * row0 + i, v);
      }
    }
  }
  add_counts(S, slots, c);
}

// lane order, no tile: active pixel 0, 1, 2, ..., each pixel's lanes
// in lane order on one thread (GEO: the first scatter from the prologue)
template <int EST, bool SCAT, bool TONLY, int RES, bool PRIMAL, bool TGT,
          bool GEO = false>
void run_lanes(const WfParams& P, const Target& T, const float* in,
               const int* ap, const int*, const int*, const int4*,
               const float* chords, float* out, unsigned long long* c) {
  Grid G;
  G.init(P);
  Sink<PRIMAL, true, TGT> S{out, in, nullptr, nullptr, -1, 0.0f,
                            0,   0,  0,       0};
  set_target(S, P, T);
  for (int aidx = 0; aidx < P.n_active; ++aidx) {
    const float em = PRIMAL ? in[aidx] * P.ray_w : 1.0f;
    if (em == 0.0f) continue;
    float gsum = 0.0f;
    for (int k = 0; k < P.spp; ++k) {
      S.g = 0.0f;
      trace_lane<EST, SCAT, TONLY, RES, GEO>(
          P, G, (uint32_t)aidx * (uint32_t)P.spp + (uint32_t)k, aidx, ap,
          em, S, chords);
      gsum = k == 0 ? S.g : gsum + S.g;
    }
    if (!PRIMAL) out[aidx] = gsum * P.ray_w;
  }
  add_counts<GEO>(S, 0, c);
}

template <bool PRIMAL, bool BLOCKS, bool TGT>
int dispatch_target(const WfParams* p, const Target& tg, const float* in,
                    const int* ap, const int* order, const int* starts,
                    const int4* rows, float* out, unsigned long long* c) {
  const int key = p->estimator * 4 + (p->has_scattering ? 2 : 0) +
                  (p->transmission_only ? 1 : 0);
#define C(E, S, T)                                                       \
  case E * 4 + (S ? 2 : 0) + (T ? 1 : 0):                                \
    (BLOCKS ? run_blocks<E, S, T, ANALOG, PRIMAL, TGT>                   \
            : run_lanes<E, S, T, ANALOG, PRIMAL, TGT>)(                  \
        *p, tg, in, ap, order, starts, rows, nullptr, out, c);           \
    break;
  switch (key) {
    C(0, 0, 0) C(0, 0, 1) C(0, 1, 0) C(0, 1, 1) C(1, 0, 0) C(1, 0, 1)
    C(1, 1, 0) C(1, 1, 1) C(2, 0, 0) C(2, 0, 1) C(2, 1, 0) C(2, 1, 1)
    default: return 1;
  }
#undef C
  return 0;
}

template <bool PRIMAL, bool BLOCKS>
int dispatch(const WfParams* p, const WfMesh* M, const float4* tris,
             const float* in, const int* ap, const int* order,
             const int* starts, const int4* rows, float* out,
             unsigned long long* c) {
  traced.clear();
  const Target tg{M, tris, nullptr};
  return p->target ? dispatch_target<PRIMAL, BLOCKS, true>(
                         p, tg, in, ap, order, starts, rows, out, c)
                   : dispatch_target<PRIMAL, BLOCKS, false>(
                         p, tg, in, ap, order, starts, rows, out, c);
}

// the residual kernels' launch order on one thread (res_kernel): CTAs
// [c0, c1), each CTA's angle frames first, then its tasks; pslots (the
// path pass): 32 slots for each bounce iteration and triangle test of a
// task's longest lane; GEO: the first scatter from the prologue
template <int EST, int RES, bool GEO, class SinkT>
void run_res_blocks(const WfParams& P, int c0, int c1, const float* in,
                    const int* ap, const int* order, const int* starts,
                    const float* chords, const float4* tab, float* out,
                    SinkT& S, unsigned long long& slots,
                    unsigned long long* pslots = nullptr) {
  Grid G;
  G.init(P);
  Frame frames[WF_RES_MAX_GROUP];
  for (int b = c0; b < c1; ++b) {
    const ResCta C = res_cta(P, starts, b);
    for (int i = 0; i < C.n_angles; ++i) frames[i] = angle_frame(P, C.a0 + i);
    for (int t = 0; t < task_count<SinkT::PRIMAL>(P, C.lo, C.hi); ++t) {
      unsigned long long longest = 0, most_iters = 0, most_tris = 0;
      for (int l = 0; l < 32; ++l) {
        const unsigned long long s0 = EST == DELTA ? S.iters : S.steps;
        const unsigned long long i0 = S.iters, t0 = S.mc.tris;
        const int aidx = res_task<EST, RES, GEO>(P, G, C, frames, t, l, in,
                                                 ap, order, chords, tab, out,
                                                 S);
        if (aidx >= 0) traced.push_back(aidx);
        const unsigned long long d = (EST == DELTA ? S.iters : S.steps) - s0;
        if (d > longest) longest = d;
        most_iters = std::max(most_iters, S.iters - i0);
        most_tris = std::max(most_tris, S.mc.tris - t0);
      }
      slots += 32 * longest;
      if (pslots != nullptr) {
        pslots[0] += 32 * most_iters;
        pslots[1] += 32 * most_tris;
      }
    }
  }
}

// the residual pair's instantiations (scattering, transmission only),
// by estimator and residual mode: the kernels' order with their tables
// (BLOCKS; tab null: each lane computes its chord entry), or lane order
// with every lane's set-up inline; GEO: a first-scatter mode without a
// chord bank (chords null), the kernels' prologue instantiations
template <bool PRIMAL, bool BLOCKS, bool TGT, bool GEO>
int res_dispatch_target(const WfParams* p, const Target& tg, const float* in,
                        const int* ap, const int* order, const int* starts,
                        const float* chords, const float4* tab, float* out,
                        unsigned long long* c) {
  Sink<PRIMAL, true, TGT> S{out, in, nullptr, nullptr, -1, 0.0f,
                            0,   0,  0,       0};
  set_target(S, *p, tg);
  unsigned long long slots = 0;
  const int n_ctas = p->resy * p->n_groups;
#define R(E, M)                                                            \
  case E * 4 + M:                                                          \
    if (BLOCKS)                                                            \
      run_res_blocks<E, M, GEO && M != SCAT_ONLY>(                         \
          *p, 0, n_ctas, in, ap, order, starts, chords, tab, out, S,       \
          slots);                                                          \
    else                                                                   \
      run_lanes<E, true, true, M, PRIMAL, TGT, GEO && M != SCAT_ONLY>(     \
          *p, tg, in, ap, order, starts, nullptr, chords, out, c);         \
    break;
  switch (p->estimator * 4 + p->residual) {
    R(DDA, SCAT_ONLY) R(DDA, FIRST_SCATTER) R(RATIO, SCAT_ONLY)
    R(RATIO, FIRST_SCATTER) R(DELTA, SCAT_ONLY) R(DELTA, FIRST_SCATTER)
    R(DELTA, FAST_RESIDUAL)
    default: return 1;
  }
#undef R
  if (BLOCKS) add_counts<GEO>(S, slots, c);
  return 0;
}
template <bool PRIMAL, bool BLOCKS, bool TGT>
int res_dispatch_geo(const WfParams* p, const Target& tg, const float* in,
                     const int* ap, const int* order, const int* starts,
                     const float* chords, const float4* tab, float* out,
                     unsigned long long* c) {
  const bool geo = chords == nullptr && (p->residual == FIRST_SCATTER ||
                                         p->residual == FAST_RESIDUAL);
  return geo ? res_dispatch_target<PRIMAL, BLOCKS, TGT, true>(
                   p, tg, in, ap, order, starts, chords, tab, out, c)
             : res_dispatch_target<PRIMAL, BLOCKS, TGT, false>(
                   p, tg, in, ap, order, starts, chords, tab, out, c);
}
#define RES_ENTRY(NAME, PRIMAL, BLOCKS)                                     \
  extern "C" int NAME(const WfParams* p, const WfMesh* M,                  \
                      const float4* tris, const unsigned char* mask,       \
                      const float* in, const int* ap, const int* order,    \
                      const int* starts, const float* chords,              \
                      const float4* tab, float* out,                       \
                      unsigned long long* c, void*) {                      \
    traced.clear();                                                        \
    const Target tg{M, tris, mask};                                        \
    return p->target ? res_dispatch_geo<PRIMAL, BLOCKS, true>(             \
                           p, tg, in, ap, order, starts, chords, tab, out, \
                           c)                                              \
                     : res_dispatch_geo<PRIMAL, BLOCKS, false>(            \
                           p, tg, in, ap, order, starts, chords, tab, out, \
                           c);                                             \
  }
RES_ENTRY(wf_res_fwd, true, true)
RES_ENTRY(wf_res_bwd, false, true)
RES_ENTRY(wf_res_fwd_lanes, true, false)
RES_ENTRY(wf_res_bwd_lanes, false, false)

// the dda forward's path pass over CTAs [c0, c1), as wf_res_path
template <bool TGT>
int path_target(const WfParams* p, const Target& tg, int c0, int c1,
                const float* in, const int* ap, const int* order,
                const int* starts, const float* chords, const float4* tab,
                float4* recs, unsigned* n_recs, unsigned cap,
                unsigned long long* c, unsigned long long* pslots) {
  PathSink<true, TGT> S{{nullptr, in, nullptr, nullptr, -1, 0.0f, 0, 0, 0, 0},
                        recs, n_recs, cap};
  set_target(S, *p, tg);
  unsigned long long slots = 0, ps[2] = {0, 0};
  const bool geo = chords == nullptr;
  if (p->residual == SCAT_ONLY)
    run_res_blocks<DDA, SCAT_ONLY, false>(*p, c0, c1, in, ap, order, starts,
                                          chords, tab, nullptr, S, slots, ps);
  else if (p->residual == FIRST_SCATTER && geo)
    run_res_blocks<DDA, FIRST_SCATTER, true>(*p, c0, c1, in, ap, order,
                                             starts, chords, tab, nullptr, S,
                                             slots, ps);
  else if (p->residual == FIRST_SCATTER)
    run_res_blocks<DDA, FIRST_SCATTER, false>(*p, c0, c1, in, ap, order,
                                              starts, chords, tab, nullptr, S,
                                              slots, ps);
  else
    return 1;
  if (c != nullptr) {
    c[0] += S.iters;
    c[5] += S.mc.cells;
    c[6] += S.mc.tris;
    c[7] += S.mc.walks;
    if (p->residual == FIRST_SCATTER && geo) c[8] += S.pro_iters;
  }
  if (pslots != nullptr) {
    pslots[0] += ps[0];
    pslots[1] += ps[1];
  }
  return 0;
}
extern "C" int wf_res_path(const WfParams* p, const WfMesh* M,
                           const float4* tris, const unsigned char* mask,
                           int c0, int c1, const float* in, const int* ap,
                           const int* order, const int* starts,
                           const float* chords, const float4* tab,
                           float4* recs, unsigned* n_recs, unsigned cap,
                           unsigned long long* c, unsigned long long* slots,
                           void*) {
  traced.clear();
  if (p->estimator != DDA) return 1;
  const Target tg{M, tris, mask};
  return p->target ? path_target<true>(p, tg, c0, c1, in, ap, order, starts,
                                       chords, tab, recs, n_recs, cap, c,
                                       slots)
                   : path_target<false>(p, tg, c0, c1, in, ap, order,
                                        starts, chords, tab, recs, n_recs,
                                        cap, c, slots);
}

// ---- the residual's target path pass (wf_res_target.cuh) ---------------

// res_tgt_path_kernel on one thread: CTA by CTA, its frames and banks
// (staged where they fit the smem limit and tgt_budget, as the launch
// picks) first, then rtp_warps warps of 32 threads in turns. A warp's
// turn: its threads without a lane take the next lanes of its chunk
// (rtp_chunk claimed from the CTA's counter at a time) in lane order,
// until each has one or the CTA's lanes run out, then each busy thread
// runs one bounce (res_path_turn: its ray's mesh walk tests each cell by
// 32 shares in turn, cell_nearest); 32 slots a turn, 32 for each round
// of 32 tests
static int rtp_warps = 3, rtp_chunk = WF_RTP_CHUNK;
extern "C" void set_res_tgt(int warps, int chunk) {
  rtp_warps = warps;
  rtp_chunk = chunk;
}
template <int RES, bool STAGED, bool GEO>
void rtp_ctas(const WfParams& P, const Target& T, int c0, int c1,
              const float* in, const int* ap, const int* order,
              const int* starts, const float* chords, const float4* tab,
              float4* recs, unsigned* n_recs, unsigned cap,
              unsigned long long* c, unsigned long long* slots) {
  Grid G;
  G.init(P);
  RtpSink<true, STAGED> S{
      {nullptr, in, nullptr, nullptr, -1, 0.0f, 0, 0, 0, 0},
      recs, n_recs, cap};
  set_target(S, P, T);
  std::vector<float4> smem;
  if constexpr (STAGED) S.banks = staged_banks(T, smem);
  Frame frames[WF_RES_MAX_GROUP];
  const unsigned FULL = 0xffffffffu, W = (unsigned)rtp_warps;
  const unsigned chunk = (unsigned)rtp_chunk;
  unsigned long long it_slots = 0, rounds = 0;
  struct Thread {
    LaneState L;
    bool busy;
  };
  for (int b = c0; b < c1; ++b) {
    const ResCta C = res_cta(P, starts, b);
    for (int i = 0; i < C.n_angles; ++i) frames[i] = angle_frame(P, C.a0 + i);
    const unsigned n_lanes = 32u * (unsigned)task_count<true>(P, C.lo, C.hi);
    unsigned next = 0;
    std::vector<Thread> th(32 * W);
    for (auto& t : th) t.busy = false;
    std::vector<unsigned> cur(W, 0), end(W, 0);
    std::vector<char> drained(W, 0), done(W, 0);
    for (unsigned live = W; live > 0;) {
      for (unsigned wi = 0; wi < W; ++wi) {
        if (done[wi]) continue;
        Thread* t = th.data() + 32 * wi;
        while (!drained[wi]) {
          unsigned need = 0;
          for (int l = 0; l < 32; ++l) need |= t[l].busy ? 0u : 1u << l;
          if (need == 0u) break;
          if (cur[wi] >= end[wi]) {
            const unsigned b0 = next;
            next += chunk;
            if (b0 >= n_lanes) {
              drained[wi] = 1;
              break;
            }
            cur[wi] = b0;
            end[wi] = n_lanes - b0 < chunk ? n_lanes : b0 + chunk;
          }
          unsigned rank = 0;
          for (int l = 0; l < 32; ++l) {
            if (!((need >> l) & 1u)) continue;
            if (rank < end[wi] - cur[wi])
              t[l].busy = res_path_start<RES, GEO>(P, G, C, frames,
                                                   cur[wi] + rank, in, ap,
                                                   order, chords, tab, S,
                                                   t[l].L);
            ++rank;
          }
          cur[wi] = end[wi] - cur[wi] < rank ? end[wi] : cur[wi] + rank;
        }
        bool any = false;
        for (int l = 0; l < 32; ++l) any = any || t[l].busy;
        if (!any) {
          done[wi] = 1;
          --live;
          continue;
        }
        for (int l = 0; l < 32; ++l)
          if (t[l].busy)
            t[l].busy = res_path_turn<RES>(P, G, *T.M, S, t[l].L, true, l,
                                           &rounds);
        it_slots += 32;
      }
    }
  }
  if (c != nullptr) {
    c[0] += S.iters;
    c[5] += S.mc.cells;
    c[6] += S.mc.tris;
    c[7] += S.mc.walks;
    if (GEO) c[8] += S.pro_iters;
  }
  if (slots != nullptr) {
    slots[0] += it_slots;
    slots[1] += 32 * rounds;
  }
}
extern "C" int wf_res_tgt_runs(const WfParams* p, int* runs) {
  *runs = p->target && p->estimator == DDA &&
          (p->residual == SCAT_ONLY || p->residual == FIRST_SCATTER);
  return 0;
}
extern "C" int wf_res_tgt_info(const WfParams*, const WfMesh*, int, int,
                               int*) {
  return 1;
}
extern "C" int wf_res_tgt_path(const WfParams* p, const WfMesh* M,
                               const float4* tris, const unsigned char* mask,
                               int c0, int c1, const float* in,
                               const int* ap, const int* order,
                               const int* starts, const float* chords,
                               const float4* tab, float4* recs,
                               unsigned* n_recs, unsigned cap,
                               unsigned long long* c,
                               unsigned long long* slots, int smem_limit,
                               void*) {
  traced.clear();
  int runs = 0;
  wf_res_tgt_runs(p, &runs);
  if (!runs) return 1;  // cudaErrorInvalidValue
  const long long bytes =
      (long long)bank_bytes(M->n_rows, M->n_cell_start, M->n_tri_ids);
  const bool staged = bytes <= smem_limit && bytes <= tgt_budget;
  const Target tg{M, tris, mask};
#define RTP(R, ST, GEO)                                                    \
  rtp_ctas<R, ST, GEO>(*p, tg, c0, c1, in, ap, order, starts, chords, tab, \
                       recs, n_recs, cap, c, slots)
  if (p->residual == FIRST_SCATTER && chords == nullptr) {
    if (staged) RTP(FIRST_SCATTER, true, true);
    else RTP(FIRST_SCATTER, false, true);
  } else if (p->residual == FIRST_SCATTER) {
    if (staged) RTP(FIRST_SCATTER, true, false);
    else RTP(FIRST_SCATTER, false, false);
  } else {
    if (staged) RTP(SCAT_ONLY, true, false);
    else RTP(SCAT_ONLY, false, false);
  }
#undef RTP
  return 0;
}

// the walk pass in z-slices [zlo, zhi) as wf_res_walk runs it: N_WARPS
// warps of 32 threads in turns, each warp's threads without a walk
// served in lane order from the warp's chunk of records (WF_WALK_CHUNK
// claimed from *next at a time), one step of every busy thread a turn;
// on a two-channel film a record's channel in the sign of its maxt
extern "C" int wf_res_walk(const WfParams* p, const float4* recs, unsigned n,
                           unsigned* next, int zlo, int zhi, float* acc,
                           unsigned long long* c, void*) {
  constexpr int N_WARPS = 3;
  const WfParams& P = *p;
  Grid G;
  G.init(P);
  const bool two = P.target == 2;
  Sink<true, true, true> S{acc, nullptr, nullptr, nullptr, -1, 0.0f,
                           0,   0,       0,       0};
  S.two = two;
  struct Thread {
    DdaWalk w;
    float base;
    int chan;
    bool busy;
  };
  std::vector<Thread> T(32 * N_WARPS);
  for (auto& t : T) t.busy = false;
  unsigned cur[N_WARPS] = {}, end[N_WARPS] = {};
  bool drained[N_WARPS] = {}, done[N_WARPS] = {};
  unsigned long long slots = 0, walking = 0;
  for (int live = N_WARPS; live > 0;) {
    for (int wi = 0; wi < N_WARPS; ++wi) {
      if (done[wi]) continue;
      Thread* th = T.data() + 32 * wi;
      while (!drained[wi]) {
        unsigned need = 0;
        for (int l = 0; l < 32; ++l) need |= th[l].busy ? 0u : 1u << l;
        if (need == 0u) break;
        if (cur[wi] >= end[wi]) {
          const unsigned b = *next;
          *next += WF_WALK_CHUNK;
          if (b >= n) {
            drained[wi] = true;
            break;
          }
          cur[wi] = b;
          end[wi] = n - b < (unsigned)WF_WALK_CHUNK ? n : b + WF_WALK_CHUNK;
        }
        unsigned rank = 0;
        for (int l = 0; l < 32; ++l) {
          if (th[l].busy) continue;
          if (rank < end[wi] - cur[wi]) {
            const unsigned r = cur[wi] + rank;
            const float4 a = recs[2 * r], b = recs[2 * r + 1];
            th[l].chan = two && b.z < 0.0f ? 1 : 0;
            th[l].busy = th[l].w.init(P, G, V3{a.x, a.y, a.z},
                                      V3{a.w, b.x, b.y},
                                      two ? std::fabs(b.z) : b.z) &&
                         th[l].w.meets(zlo, zhi);
            th[l].base = b.w;
          }
          ++rank;
        }
        cur[wi] = end[wi] - cur[wi] < rank ? end[wi] : cur[wi] + rank;
      }
      bool any = false;
      for (int l = 0; l < 32; ++l) any = any || th[l].busy;
      if (!any) {
        done[wi] = true;
        --live;
        continue;
      }
      slots += 32;
      for (int l = 0; l < 32; ++l)
        if (th[l].busy) {
          ++walking;
          S.chan = th[l].chan;
          th[l].busy = th[l].w.step<true>(P, G, S, th[l].base, P.sigma_t,
                                          zlo, zhi);
        }
    }
  }
  if (c != nullptr) {
    c[0] += walking;
    c[1] += S.steps;
    c[3] += S.n_global;
    c[4] += slots;
  }
  return 0;
}

// ---- the target forms (wf_target.cuh) ----------------------------------

extern "C" void set_tgt_budget(long long b) { tgt_budget = b; }
extern "C" int wf_tgt_fits(const WfParams* p, const WfMesh* M, int* fits) {
  *fits = p->target && p->residual == ANALOG &&
          (long long)bank_bytes(M->n_rows, M->n_cell_start, M->n_tri_ids) <=
              tgt_budget;
  return 0;
}
extern "C" int wf_tgt_info(const WfParams*, const WfMesh*, int, int, int*) {
  return 1;
}

// the staged adjoint in its launch order (block by block, task by task)
extern "C" int wf_tgt_bwd(const WfParams* p, const WfMesh* M,
                          const float4* tris, const float* dL, const int* ap,
                          const int* order, const int* starts, float* grad,
                          unsigned long long* c, void*) {
  traced.clear();
  const Target tg{M, tris, nullptr};
  const int key = p->estimator * 4 + (p->has_scattering ? 2 : 0) +
                  (p->transmission_only ? 1 : 0);
#define C(E, S, T)                                                       \
  case E * 4 + (S ? 2 : 0) + (T ? 1 : 0):                                \
    run_blocks<E, S, T, ANALOG, false, true, true>(                      \
        *p, tg, dL, ap, order, starts, nullptr, nullptr, grad, c);       \
    break;
  switch (key) {
    C(0, 0, 0) C(0, 0, 1) C(0, 1, 0) C(0, 1, 1) C(1, 0, 0) C(1, 0, 1)
    C(1, 1, 0) C(1, 1, 1) C(2, 0, 0) C(2, 0, 1) C(2, 1, 0) C(2, 1, 1)
    default: return 1;
  }
#undef C
  return 0;
}

// the path pass or the delta form over the batch's units, unit by unit,
// each unit's tasks in order (tgt_path_cta), the banks staged; the delta
// form's lane slots as the kernel counts them
template <int EST, bool SCAT, bool TONLY>
void tgt_path_units(const WfParams& P, const Target& T, const float* in,
                    const int* ap, const int* order, const int* starts,
                    const TgtArgs& A, unsigned long long* c) {
  Grid G;
  G.init(P);
  std::vector<float4> smem;
  const MeshBanks B = staged_banks(T, smem);
  for (int k = 0; k < A.u1 - A.u0; ++k) {
    int u, t0, t1, lo, hi, py;
    tgt_unit(A, A.u0 + k, u, t0, t1);
    block_range(P, starts, u, lo, hi, py);
    unsigned made = 0;
    auto S = tgt_cta_sink<EST, true>(P, T.M, B, A, k, &made);
    unsigned long long slots = 0;
    for (int t = t0; t < t1; ++t) {
      unsigned long long longest = 0;
      for (int l = 0; l < 32; ++l) {
        const unsigned long long s0 = S.steps;
        const int aidx = trace_task<EST, SCAT, TONLY>(P, G, order, lo, hi, t,
                                                      l, in, ap, nullptr, S);
        if (aidx >= 0) traced.push_back(aidx);
        longest = std::max(longest, S.steps - s0);
      }
      if (EST == DELTA) slots += 32 * longest;
    }
    if (EST != DELTA) A.counts[k] = made;
    if (c != nullptr) add_counts(S, slots, c);
  }
}
#define TGT_UNITS(E)                                                  \
  if (p->has_scattering)                                              \
    (p->transmission_only ? tgt_path_units<E, true, true>             \
                          : tgt_path_units<E, true, false>)(          \
        *p, tg, in, ap, order, starts, *A, c);                        \
  else                                                                \
    (p->transmission_only ? tgt_path_units<E, false, true>            \
                          : tgt_path_units<E, false, false>)(         \
        *p, tg, in, ap, order, starts, *A, c);
extern "C" int wf_tgt_path(const WfParams* p, const WfMesh* M,
                           const float4* tris, const float* in,
                           const int* ap, const int* order,
                           const int* starts, const TgtArgs* A,
                           unsigned long long* c, void*) {
  traced.clear();
  if (p->estimator == DELTA || !p->target ||
      (p->estimator == RATIO && A->keys == nullptr))
    return 1;
  const Target tg{M, tris, nullptr};
  if (p->estimator == RATIO) {
    TGT_UNITS(RATIO)
  } else {
    TGT_UNITS(DDA)
  }
  return 0;
}
extern "C" int wf_tgt_delta(const WfParams* p, const WfMesh* M,
                            const float4* tris, const float* in,
                            const int* ap, const int* order,
                            const int* starts, const TgtArgs* A,
                            unsigned long long* c, void*) {
  traced.clear();
  if (p->estimator != DELTA || !p->target) return 1;
  const Target tg{M, tris, nullptr};
  TGT_UNITS(DELTA)
  return 0;
}
#undef TGT_UNITS

// the walk pass unit by unit (tgt_walk_kernel, tgt_ratio_walk_kernel):
// the home-slice tile zeroed, the unit's records walked in order
// (tgt_walk_record), the tile flushed
extern "C" int wf_tgt_walk(const WfParams* p, const TgtArgs* A,
                           const int4* rows, unsigned long long* c, void*) {
  const WfParams& P = *p;
  if ((P.estimator != DDA && P.estimator != RATIO) ||
      (P.estimator == RATIO && A->keys == nullptr))
    return 1;
  Grid G;
  G.init(P);
  const bool two = P.target == 2;
  const int ch = two ? 2 : 1;
  std::vector<float> tile(ch * P.tile_n);
  for (int k = 0; k < A->u1 - A->u0; ++k) {
    unsigned lo, n;
    tgt_walk_range(*A, k, lo, n);
    if (n == 0) continue;
    int u, t0, t1;
    tgt_unit(*A, A->u0 + k, u, t0, t1);
    const int home = P.tile_n > 0 ? home_slice(P, G, u / P.n_groups) : -1;
    Sink<true, true, true> S{A->acc, nullptr, tile.data(), rows, home, 0.0f,
                             0,      0,       0,           0};
    S.two = two;
    for (int y = 0; home >= 0 && y < G.res[1]; ++y)
      for (int i = ch * (rows[y].z + rows[y].x);
           i < ch * (rows[y].z + rows[y].x + rows[y].y); ++i)
        tile[i] = 0.0f;
    const float4* recs = A->recs + 2 * (size_t)lo;
    const uint2* keys = A->keys == nullptr ? nullptr : A->keys + lo;
    for (unsigned r = 0; r < n; ++r) {
      if (P.estimator == RATIO) {
        if (two) tgt_walk_record<RATIO, true>(P, G, S, recs, keys, r);
        else tgt_walk_record<RATIO, false>(P, G, S, recs, keys, r);
      } else {
        if (two) tgt_walk_record<DDA, true>(P, G, S, recs, keys, r);
        else tgt_walk_record<DDA, false>(P, G, S, recs, keys, r);
      }
    }
    const int slice0 = home * G.res[0] * G.res[1];
    for (int y = 0; home >= 0 && y < G.res[1]; ++y) {
      const int row0 = slice0 + y * G.res[0] + rows[y].x;
      for (int i = 0; i < ch * rows[y].y; ++i) {
        const float v = tile[ch * (rows[y].z + rows[y].x) + i];
        if (v != 0.0f) atomicAdd(A->acc + ch * row0 + i, v);
      }
    }
    if (c != nullptr) add_counts(S, 0, c);
  }
  return 0;
}

// the chord table and the angle frames, by the kernels' own functions
extern "C" int wf_res_chords(const float* bank, int n, float st, float4* tab,
                             void*) {
  for (int i = 0; i < n; ++i) chord_entry(bank + 12 * i, st, tab + 4 * i);
  return 0;
}
extern "C" int res_frames(const WfParams* p, float* out) {
  for (int a = 0; a < p->n_patterns; ++a) {
    const Frame F = angle_frame(*p, a);
    std::memcpy(out + 12 * a, &F, sizeof(F));
  }
  return (int)sizeof(Frame);
}
#define ENTRY(NAME, PRIMAL, BLOCKS)                                          \
  extern "C" int NAME(const WfParams* p, const WfMesh* M,                  \
                      const float4* tris, const float* in, const int* ap,  \
                      const int* order, const int* starts,                 \
                      const int4* rows, float* out, unsigned long long* c, \
                      void*) {                                             \
    return dispatch<PRIMAL, BLOCKS>(p, M, tris, in, ap, order, starts,     \
                                    rows, out, c);                         \
  }
ENTRY(wf_fwd, true, true)
ENTRY(wf_bwd, false, true)
ENTRY(wf_fwd_lanes, true, false)
ENTRY(wf_bwd_lanes, false, false)
// the medium adjoint's launch order on one thread (wf_cta with a
// MedSink): block by block, the block's range compacted in order
// (med_emits) into cidx[lo ..] and count[b] (MedSink::begin); each
// task's 32 threads in turn (MedSink::trace), their sums through the
// kernel's shuffle tree (at offset 16, 8, .., 1 lane l adds lane l + off)
// into partials[task_base[b] + t], the block's slots past its tasks 0;
// then med_sum's order: 1024 strided sums, then the tree over them.
// STAGED: the banks staged, as the staged form reads them
template <int EST, bool SCAT, bool TONLY, bool TGT, bool STAGED>
void run_med(const WfParams& P, const Target& T, const float* dL,
             const float* data, const int* ap, const int* order,
             const int* starts, const int* base, int* cidx, int* count,
             float* part, int n_tasks, float* sums) {
  Grid G;
  G.init(P);
  MedSink<SCAT, TGT, STAGED> S{nullptr, dL, nullptr, nullptr, -1, 0.0f,
                               0,       0,  0,       0};
  S.bind(med_args(P, data, base, reinterpret_cast<float2*>(part), cidx,
                  count));
  set_target(S, P, T);
  std::vector<float4> smem;
  if constexpr (STAGED) S.banks = staged_banks(T, smem);
  for (int b = 0; b < P.resy * P.n_groups; ++b) {
    int lo, hi, py;
    block_range(P, starts, b, lo, hi, py);
    S.base = base[b];
    int made = 0;
    for (int j = lo; j < hi; ++j) {
      int aidx;
      if (med_emits(P, data, order, j, aidx)) cidx[lo + made++] = aidx;
    }
    count[b] = S.n = made;
    const int n_t = (made + 31) / 32;
    for (int t = 0; t < n_t; ++t) {
      float a[32], c[32];
      for (int l = 0; l < 32; ++l) {
        const int aidx =
            S.template trace<EST, SCAT, TONLY>(P, G, lo, t, l, ap);
        if (aidx >= 0) traced.push_back(aidx);
        a[l] = S.stg;
        c[l] = S.ssg;
      }
      for (int off = 16; off > 0; off >>= 1)
        for (int l = 0; l < off; ++l) {
          a[l] = a[l] + a[l + off];
          c[l] = c[l] + c[l + off];
        }
      part[2 * (base[b] + t)] = a[0];
      part[2 * (base[b] + t) + 1] = c[0];
    }
    for (int t = n_t; t < base[b + 1] - base[b]; ++t)
      part[2 * (base[b] + t)] = part[2 * (base[b] + t) + 1] = 0.0f;
  }
  std::vector<float> sa(WF_MED_SUM_THREADS), sb(WF_MED_SUM_THREADS);
  for (int i = 0; i < WF_MED_SUM_THREADS; ++i) {
    float x = 0.0f, y = 0.0f;
    for (int j = i; j < n_tasks; j += WF_MED_SUM_THREADS) {
      x = x + part[2 * j];
      y = y + part[2 * j + 1];
    }
    sa[i] = x;
    sb[i] = y;
  }
  for (int w = WF_MED_SUM_THREADS / 2; w > 0; w >>= 1)
    for (int i = 0; i < w; ++i) {
      sa[i] = sa[i] + sa[i + w];
      sb[i] = sb[i] + sb[i + w];
    }
  sums[0] = sa[0];
  sums[1] = sb[0];
}
template <bool TGT, bool STAGED>
int med_target(const WfParams* p, const Target& tg, const float* dL,
               const float* data, const int* ap, const int* order,
               const int* starts, const int* base, int* cidx, int* count,
               float* part, int n_tasks, float* sums) {
  const int key = p->estimator * 4 + (p->has_scattering ? 2 : 0) +
                  (p->transmission_only ? 1 : 0);
#define C(E, S, T)                                                      \
  case E * 4 + (S ? 2 : 0) + (T ? 1 : 0):                               \
    run_med<E, S, T, TGT, STAGED>(*p, tg, dL, data, ap, order, starts,  \
                                  base, cidx, count, part, n_tasks,     \
                                  sums);                                \
    break;
  switch (key) {
    C(0, 0, 0) C(0, 0, 1) C(0, 1, 0) C(0, 1, 1) C(1, 0, 0) C(1, 0, 1)
    C(1, 1, 0) C(1, 1, 1) C(2, 0, 0) C(2, 0, 1) C(2, 1, 0) C(2, 1, 1)
    default: return 1;
  }
#undef C
  return 0;
}
// wf_med.cu's entry point
extern "C" int wf_med(const WfParams* p, const WfMesh* M, const float4* tris,
                      const float* dL, const float* data, const int* ap,
                      const int* order, const int* starts, const int* base,
                      int* cidx, int* count, float* part, int n_tasks,
                      float* sums, int staged, void*) {
  traced.clear();
  if (p->residual != ANALOG || cidx == nullptr || count == nullptr ||
      (staged && !p->target))
    return 1;
  const Target tg{M, tris, nullptr};
  if (staged)
    return med_target<true, true>(p, tg, dL, data, ap, order, starts, base,
                                  cidx, count, part, n_tasks, sums);
  return p->target
             ? med_target<true, false>(p, tg, dL, data, ap, order, starts,
                                       base, cidx, count, part, n_tasks,
                                       sums)
             : med_target<false, false>(p, tg, dL, data, ap, order, starts,
                                        base, cidx, count, part, n_tasks,
                                        sums);
}
extern "C" int wf_med_fits(const WfParams* p, const WfMesh* M, int* fits) {
  return wf_tgt_fits(p, M, fits);
}
extern "C" int wf_med_info(const WfParams*, const WfMesh*, int, int*) {
  return 1;
}

// the active indices the last call traced, in its order
extern "C" int wf_traced(int* out) {
  for (size_t i = 0; i < traced.size(); ++i) out[i] = traced[i];
  return (int)traced.size();
}
"""


@pytest.fixture(scope="module")
def template_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx is not None, "the port's host code is built with g++"
    work = tmp_path_factory.mktemp("wf_template")
    (work / "stub").mkdir()
    (work / "stub" / "cuda_runtime.h").write_text(STUB)
    (work / "harness.cpp").write_text(HARNESS)
    lib = work / "libwf_template.so"
    # IEEE float32 op by op, as nvcc --fmad=false
    build = subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off",
                            "-shared", "-fPIC", "-I", str(work / "stub"),
                            "-I", CUDA_SRC_DIR, str(work / "harness.cpp"),
                            "-o", str(lib)], capture_output=True, text=True)
    assert build.returncode == 0, build.stderr
    lib = ctypes.CDLL(str(lib))
    for name in wf.KERNELS + wf.RES_KERNELS + (wf.TGT_LIB, wf.RES_TGT_LIB,
                                                wf.MED_LIB):
        wf._setup(lib, name)
    lib.set_tgt_budget.argtypes = [ctypes.c_longlong]
    lib.set_tgt_budget.restype = None
    lib.set_res_tgt.argtypes = [ctypes.c_int] * 2
    lib.set_res_tgt.restype = None
    for name in ("wf_fwd", "wf_bwd", "wf_res_fwd", "wf_res_bwd"):
        fn = getattr(lib, name + "_lanes")
        fn.argtypes, fn.restype = wf._ARGS[name], ctypes.c_int
    for name, args in (("wf_traced", [ctypes.c_void_p]),
                       ("res_frames", [ctypes.POINTER(wf.WfParams),
                                       ctypes.c_void_p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    path = work / "t.ply"
    save_ply(make_box((0.5, 0.5, 0.5)), str(path))
    # the meshes of the scenes whose meshes are not the target (_scene):
    # a cuvette's walls, an occlusion box and a hollow gear (960
    # triangles: walked through its grid)
    for name, mesh in (
            ("cuv_outer.ply", make_box_tube(8.0, 7.8, -10.0, 10.0)),
            ("cuv_inner.ply", make_box_tube(7.3, 7.1, -10.0, 10.0)),
            ("occ.ply", make_box((2.5, 1.5, 2.0), center=(-2.0, 1.0, 0.0))),
            ("gear.ply", make_hollow_gear(r_out=3.0, r_root=2.4, r_hole=1.0,
                                          half_height=2.0, segments=120))):
        save_ply(mesh, str(work / name))
    return lib, str(path)


# occlusions of _scene's vials (the meshes of template_lib's directory)
OCCLUSIONS = {
    "black": ("occ.ply", None),
    "null": ("occ.ply", {"type": "null"}),
    "dielectric": ("occ.ply", {"type": "dielectric", "int_ior": 1.52,
                               "ext_ior": 1.4849}),
    "reflective": ("occ.ply", {"type": "diffuse", "reflectance": 0.6}),
    "gear": ("gear.ply", {"type": "diffuse", "reflectance": 0.6}),
}


def _scene(path, estimator, albedo, projector, vial, tonly, diffuse=False,
           n_patterns=6, store="identity", sample_time=True, target=None):
    """store: "identity", "crop" (a cropped DMD window) or "subset" (a
    numpy-seeded random half of the pixels, in random order). target:
    None (no target in the scene), "kept" (the target mesh kept, one
    channel: a surface-aware scene's final render) or "surface_aware" (a
    two-channel film; the inside mask in arr["inside_mask"]). vial: a
    vial's name ("custom": the cuvette's mesh walls), with "+" and an
    OCCLUSIONS key for an occlusion in it."""
    vial, _, occ = vial.partition("+")
    meshes = path.rsplit("/", 1)[0]
    med = {"ior": 1.4849, "extinction": 0.1, "albedo": albedo,
           "phase": {"type": "rayleigh"}}
    vials = {"cylindrical": {"type": "cylindrical", "r_ext": 8.385,
                             "r_int": 7.665, "height": 20.0, "ior": 1.514,
                             "medium": med},
             "square": {"type": "square", "w_int": 12.0, "w_ext": 14.0,
                        "ior": 1.24, "medium": med},
             "index_matched": {"type": "index_matched", "r": 7.665,
                               "medium": med},
             "double_cylindrical": {
                 "type": "double_cylindrical", "r_ext_outer": 8.3,
                 "r_int_outer": 7.9, "r_ext_inner": 3.0, "r_int_inner": 2.6,
                 "ior_outer": 1.54, "ior_inner": 1.52,
                 "ior_inside_inner": 1.40, "medium": med},
             "custom": {"type": "custom",
                        "filename_vial_outer": f"{meshes}/cuv_outer.ply",
                        "filename_vial_inner": f"{meshes}/cuv_inner.ply",
                        "ior": 1.514, "medium": med}}
    if occ:
        name, bsdf = OCCLUSIONS[occ]
        vials[vial]["occlusions"] = [dict(
            {"filename": f"{meshes}/{name}"},
            **({} if bsdf is None else {"bsdf": bsdf}))]
    proj = {"type": projector, "n_patterns": n_patterns, "resx": 16,
            "resy": 12, "pixel_size": 16.77 / 16, "motion": "circular",
            "distance": 25.0}
    if projector == "telecentric":
        proj.update(aperture_radius=0.3, focus_distance=20.0)
    elif projector == "lens":
        del proj["pixel_size"]
        proj.update(fov=30.0, aperture_radius=0.3, focus_distance=25.0,
                    motion={"type": "circular", "clockwise": True})
    if store == "crop":
        proj.update(cropx=11, cropy=9, crop_offset_x=3, crop_offset_y=2)
    cfg = {"vial": vials[vial], "projector": proj,
           "sensor": {"type": estimator, "scalex": 16.77, "scaley": 16.77,
                      "scalez": 16.77, "majorant": 10.0,
                      "film": {"type": "vfilm", "resx": 20, "resy": 20,
                               "resz": 20}},
           "target": {"filename": path, "size": 4.0}, "output": "."}
    if target == "surface_aware":
        cfg["final_sensor"] = json.loads(json.dumps(cfg["sensor"]))
        cfg["sensor"]["film"]["surface_aware"] = True
    scene = Scene(cfg)
    if store == "subset":
        n = n_patterns * 16 * 12
        pick = np.random.default_rng(11).permutation(n)[:n // 2]
        scene.projector.set_active(pick.astype(np.int32),
                                   np.ones(pick.size, np.float32))
    static, arr = scene.build(mode="volume", include_target=target is not None,
                              max_depth=8, rr_depth=3,
                              transmission_only=tonly,
                              sample_time=sample_time)
    if target == "surface_aware":
        arr["inside_mask"] = scene.sensor.discretize(scene.target_bank())
    if diffuse:
        # the inner vial's outer wall made diffuse (reflectance 0.6): the
        # occlusions' BSDF, which no analytic vial has
        surfaces = list(static.surfaces)
        surfaces[2] = dataclasses.replace(surfaces[2], bsdf=DIFFUSE)
        static = dataclasses.replace(static, surfaces=tuple(surfaces))
        arr = dict(arr, surf_refl=np.asarray([0.0, 0.0, 0.6, 0.0],
                                             np.float32))
    return static, arr


# (estimator, albedo, projector, vial, transmission_only)
CASES = [("dda", 0.0, "collimated", "cylindrical", True),
         ("ratio", 0.5, "telecentric", "square", False),
         ("delta", 0.5, "lens", "cylindrical", True),
         ("dda", 0.5, "collimated", "double_cylindrical", False),
         ("ratio", 0.0, "lens", "double_cylindrical", True),
         ("dda", 0.0, "collimated", "double_cylindrical", False, True)]


def _run(lib, name, static, at, x, n_out, seed, spp):
    P = wf.make_params(static, at, seed, spp)
    order, starts, rows, P.tile_n = wf._launch_layout(static, at)
    M, tris, _ = wf._target_args(name, static, at, P)
    out = torch.zeros(n_out)
    counters = (ctypes.c_ulonglong * len(wf.COUNTERS))()
    assert getattr(lib, name)(ctypes.byref(P), ctypes.byref(M),
                              wf._ptr(tris), x.data_ptr(),
                              at["active_pixels"].data_ptr(),
                              wf._ptr(order), wf._ptr(starts),
                              rows.data_ptr(), out.data_ptr(),
                              ctypes.addressof(counters), None) == 0
    return out, dict(zip(wf.COUNTERS, counters))


def _traced(lib, n):
    buf = torch.empty(n, dtype=torch.int32)
    assert lib.wf_traced(buf.data_ptr()) == n
    return buf.to(torch.int64)


def _close(out, ref, point, channels=1):
    """Values to 1e-4 of the max, per channel of a two-channel dose."""
    for c in range(channels):
        o, f = out.reshape(-1, channels)[:, c], ref.reshape(-1, channels)[:, c]
        scale = float(f.abs().max())
        assert scale > 0.0
        off = int(((o - f).abs() > 1e-4 * scale).sum())
        assert off <= (2e-3 * int((f != 0).sum()) if point else 0), off


def _deposits_add_up(stats, estimator):
    """Every dda or delta step is one deposit, into the tile or to
    global memory; a ratio-tracking step past the segment's end or
    outside the film deposits nothing."""
    deposits = stats["tile_deposits"] + stats["global_deposits"]
    if estimator == "ratio":
        assert 0 < deposits <= stats["steps"]
    else:
        assert deposits == stats["steps"]


@pytest.mark.parametrize("case", CASES)
def test_template_traces_the_plain_versions_paths(case, template_lib):
    lib, path = template_lib
    static, arr = _scene(path, *case)
    at = scene_tensors(arr, "cpu")
    rng = np.random.default_rng(4)
    data = torch.from_numpy(rng.uniform(0.5, 1.5, static.projector.n_active)
                            .astype(np.float32))
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, static.sensor.n_cells)
                          .astype(np.float32))
    seed, spp = 9, 3
    ref_stats, ref_g_stats = {}, {}
    dose_ref = wf._forward(static, at, data, seed, spp, wf.DEFAULT_CHUNK,
                           ref_stats)
    grad_ref = wf._adjoint(static, at, seed, spp, wf.DEFAULT_CHUNK, dL,
                           ref_g_stats)
    dose, stats = _run(lib, "wf_fwd", static, at, data,
                       static.sensor.n_cells, seed, spp)
    grad, g_stats = _run(lib, "wf_bwd", static, at, dL,
                         static.projector.n_active, seed, spp)
    for ours, ref in ((stats, ref_stats), (g_stats, ref_g_stats)):
        assert {k: ours[k] for k in ref} == ref
        _deposits_add_up(ours, static.sensor.estimator)
        assert ours["lane_slots"] >= ours["steps"]
    assert g_stats["tile_deposits"] == 0  # the adjoint gathers from dL
    if case[2] == "collimated" and static.sensor.estimator == "dda":
        assert stats["tile_deposits"] > 0
    point = static.sensor.estimator in ("ratio", "delta")
    _close(dose, dose_ref, point)
    _close(grad, grad_ref, point)


# the block order against lane order: the bench-like collimated dda
# scene, and every estimator, on the three pattern stores and with more
# than one angle group (30 angles: 2 groups of 15)
ORDER_CASES = [(CASES[0], 6, "identity"), (CASES[0], 30, "identity"),
               (CASES[0], 30, "crop"), (CASES[0], 30, "subset"),
               (CASES[1], 6, "subset"), (CASES[2], 6, "identity"),
               (CASES[3], 30, "identity"), (CASES[5], 6, "crop")]


@pytest.mark.parametrize("case,n_patterns,store", ORDER_CASES)
def test_block_order_changes_no_value(case, n_patterns, store,
                                      template_lib):
    """Traced block by block through the forward's home-slice tile, the
    adjoint is bitwise equal to lane order and the forward agrees to
    1e-4 of the max (its sums regroup); the same paths, step for step,
    in the order block_order gives."""
    lib, path = template_lib
    static, arr = _scene(path, *case, n_patterns=n_patterns, store=store)
    at = scene_tensors(arr, "cpu")
    n = static.projector.n_active
    assert static.projector.identity == (store == "identity")
    rng = np.random.default_rng(6)
    data = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, static.sensor.n_cells)
                          .astype(np.float32))
    seed, spp, n_cells = 3, 2, static.sensor.n_cells
    dose, stats = _run(lib, "wf_fwd", static, at, data, n_cells, seed, spp)
    lanes = _traced(lib, n * spp)  # the forward: one lane a thread
    dose_l, stats_l = _run(lib, "wf_fwd_lanes", static, at, data, n_cells,
                           seed, spp)
    grad, g_stats = _run(lib, "wf_bwd", static, at, dL, n, seed, spp)
    order = _traced(lib, n)  # the adjoint: one pixel a thread
    grad_l, g_stats_l = _run(lib, "wf_bwd_lanes", static, at, dL, n, seed,
                             spp)
    # the adjoint traced block_order's pixels in its order; the forward
    # each of their spp lanes once, block by block
    ref, starts = wf.block_order(static, at)
    assert torch.equal(order, ref)
    for b in range(len(starts) - 1):
        lo, hi = int(starts[b]), int(starts[b + 1])
        assert torch.equal(torch.sort(lanes[lo * spp:hi * spp]).values,
                           torch.sort(ref[lo:hi].repeat(spp)).values)
    assert torch.equal(grad, grad_l)
    _close(dose, dose_l, False)
    for ours, lanes in ((stats, stats_l), (g_stats, g_stats_l)):
        assert ours["iterations"] == lanes["iterations"]
        assert ours["steps"] == lanes["steps"]
        _deposits_add_up(ours, static.sensor.estimator)
    if case[2] == "collimated":
        assert stats["tile_deposits"] > 0
    if case == CASES[0]:  # horizontal rays only: most stay in the slice
        assert stats["tile_deposits"] > stats["global_deposits"]


# the residual pair: (estimator, residual mode, vial, projector). The
# scenes' rr_depth 3 makes Russian roulette fire in the fast loop
RES_CASES = [("dda", "first_scatter", "cylindrical", "collimated"),
             ("ratio", "first_scatter", "square", "collimated"),
             ("delta", "fast_residual", "cylindrical", "collimated"),
             ("delta", "fast_residual", "square", "collimated"),
             ("delta", "first_scatter", "index_matched", "collimated"),
             ("dda", "scattered_only", "cylindrical", "collimated"),
             ("delta", "scattered_only", "index_matched", "collimated")]


def _residual(path, estimator, mode, vial, projector, **scene):
    """The hybrid engine's residual static and tensors on a small
    scattering scene: its chord bank, its mode (and with
    target="surface_aware" the inside mask)."""
    static, arr = _scene(path, estimator, 0.5, projector, vial, True,
                         **scene)
    eng = ScatteringEngine(static, arr, "cpu",
                           first_scatter=mode != "scattered_only",
                           inside_mask=arr.pop("inside_mask", None))
    st = dataclasses.replace(eng.static_s,
                             fast_residual=mode == "fast_residual")
    assert wf.make_params(st, eng.arr, 0, 1).residual == \
        ("scattered_only", "first_scatter", "fast_residual").index(mode) + 1
    return st, eng.arr


def _run_res(lib, name, static, at, x, n_out, seed, spp):
    """One of the harness's residual passes: the kernels' order with the
    chord table, or lane order ("_lanes") with every set-up inline; a
    first-scatter static without the chord bank runs the prologue, and
    counts its iterations after the COUNTERS."""
    P, order, starts, bank = wf._family_params(name.replace("_lanes", ""),
                                               static, at, seed, spp)
    M, tris, mask = wf._target_args(name, static, at, P)
    tab = None if name.endswith("_lanes") else wf._res_chords(
        _libs(lib), at, bank, P)
    out = torch.zeros(n_out)
    keys = wf.COUNTERS + ((wf.PROLOGUE_COUNTER,) if wf._prologue(P, bank)
                          else ())
    counters = (ctypes.c_ulonglong * len(keys))()
    assert getattr(lib, name)(ctypes.byref(P), ctypes.byref(M),
                              wf._ptr(tris), wf._ptr(mask), x.data_ptr(),
                              at["active_pixels"].data_ptr(),
                              wf._ptr(order), wf._ptr(starts), wf._ptr(bank),
                              wf._ptr(tab), out.data_ptr(),
                              ctypes.addressof(counters), None) == 0
    return out, dict(zip(keys, counters))


def _libs(lib):
    """The harness library in the place of the card's kernel libraries."""
    return {name: lib for name in wf.RES_KERNELS + (wf.TGT_LIB,
                                                   wf.RES_TGT_LIB)}


@pytest.mark.parametrize("case", RES_CASES)
def test_residual_template_traces_the_plain_residual(case, template_lib):
    """The residual pair's template in its launch order against the
    plain residual: the same bounce iterations and deposits, values to
    1e-4 of the max (a delta deposit is a point), every deposit to
    global memory; the adjoint bitwise equal to lane order."""
    lib, path = template_lib
    static, at = _residual(path, *case)
    rng = np.random.default_rng(8)
    n, n_cells = static.projector.n_active, static.sensor.n_cells
    data = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, n_cells).astype(np.float32))
    seed, spp = 5, 3
    ref_stats, ref_g_stats = {}, {}
    dose_ref = wf._forward(static, at, data, seed, spp, wf.DEFAULT_CHUNK,
                           ref_stats)
    grad_ref = wf._adjoint(static, at, seed, spp, wf.DEFAULT_CHUNK, dL,
                           ref_g_stats)
    dose, stats = _run_res(lib, "wf_res_fwd", static, at, data, n_cells,
                           seed, spp)
    grad, g_stats = _run_res(lib, "wf_res_bwd", static, at, dL, n, seed,
                             spp)
    grad_l, _ = _run_res(lib, "wf_res_bwd_lanes", static, at, dL, n, seed,
                         spp)
    for ours, ref in ((stats, ref_stats), (g_stats, ref_g_stats)):
        assert ref["steps"] > 0
        assert {k: ours[k] for k in ref} == ref
        assert ours["tile_deposits"] == 0
        _deposits_add_up(ours, static.sensor.estimator)
    point = static.sensor.estimator in ("ratio", "delta")
    _close(dose, dose_ref, point)
    _close(grad, grad_ref, point)
    assert torch.equal(grad, grad_l)


# the dda residual forward in two passes (the path pass's records, then
# the walk pass with its refill loop), through the wrapper's batching
# (ops/render.py res_forward): the dda cases of RES_CASES and two more,
# one without time sampling (the CTAs' frame tables)
SPLIT_CASES = [RES_CASES[0], RES_CASES[5],
               ("dda", "first_scatter", "square", "collimated"),
               ("dda", "scattered_only", "index_matched", "collimated")]


@pytest.mark.parametrize("case,sample_time", [(c, True) for c in SPLIT_CASES]
                         + [(SPLIT_CASES[0], False)])
def test_split_dda_residual_traces_the_plain_residual(case, sample_time,
                                                       template_lib):
    """Path pass + walk pass against the plain residual: the same bounce
    iterations and voxel steps exactly, every step one global deposit,
    values to 1e-4 of the max; the walk's lane slots cover its steps."""
    lib, path = template_lib
    static, at = _residual(path, *case, sample_time=sample_time)
    rng = np.random.default_rng(12)
    data = torch.from_numpy(rng.uniform(
        0.5, 1.5, static.projector.n_active).astype(np.float32))
    seed, spp = 5, 3
    ref_stats, stats = {}, {}
    ref = wf._forward(static, at, data, seed, spp, wf.DEFAULT_CHUNK,
                      ref_stats)
    dose = wf.res_forward(_libs(lib), static, at, data, seed, spp, stats)
    assert ref_stats["steps"] > 0
    assert {k: stats[k] for k in ref_stats} == ref_stats
    assert stats["global_deposits"] == stats["steps"]
    assert stats["tile_deposits"] == 0
    assert stats["steps"] <= stats["lane_slots"]
    assert 0 < stats["records"] <= stats["iterations"]
    _close(dose, ref, False)


@pytest.mark.parametrize("case", [SPLIT_CASES[0], SPLIT_CASES[1]])
def test_split_batches_change_no_step(case, template_lib, monkeypatch):
    """Batches of 1, 2 and all the CTAs (each a DMD row's angle group):
    the same steps and iterations, one batch a CTA at 1, values to 1e-4
    of the max; the walk in 1, 2 (shipped) and 3 z-slabs: the same
    steps; a buffer too small for a batch's records makes the wrapper
    run it again in smaller parts, with the same steps."""
    lib, path = template_lib
    static, at = _residual(path, *case, n_patterns=30)
    n_ctas = static.projector.resy * wf.angle_groups(30)[0]
    assert n_ctas > 2
    rng = np.random.default_rng(13)
    data = torch.from_numpy(rng.uniform(
        0.5, 1.5, static.projector.n_active).astype(np.float32))
    seed, spp = 2, 2
    # a buffer for 4 records a lane: room for all the CTAs in one batch
    cap = 4 * static.projector.n_active * spp
    at["_wf_res_split"] = (cap, torch.empty(cap * 8),
                           torch.zeros(2, dtype=torch.int32))
    runs = {}
    for batch in (1, 2, n_ctas):
        stats = {}
        runs[batch] = (wf.res_forward(_libs(lib), static, at, data, seed,
                                      spp, stats, batch_ctas=batch), stats)
    assert runs[1][1]["batches"] == n_ctas
    assert runs[2][1]["batches"] == -(-n_ctas // 2)
    assert runs[n_ctas][1]["batches"] == 1
    dose_all, all_stats = runs[n_ctas]
    for batch in (1, 2):
        dose, stats = runs[batch]
        for k in ("iterations", "steps", "global_deposits", "records"):
            assert stats[k] == all_stats[k], (batch, k)
        _close(dose, dose_all, False)
    # the walk in 1 and 3 z-slabs: the same steps
    for slabs in (1, 3):
        monkeypatch.setattr(wf, "WALK_SLABS", slabs)
        stats = {}
        dose = wf.res_forward(_libs(lib), static, at, data, seed, spp, stats)
        assert stats["steps"] == all_stats["steps"], slabs
        assert stats["walk_steps"] >= stats["steps"]
        _close(dose, dose_all, False)
    # a buffer of a tenth of the records: batches split until they fit
    monkeypatch.setattr(wf, "SPLIT_MAX_RECORDS", all_stats["records"] // 10)
    del at["_wf_res_split"]
    stats = {}
    dose = wf.res_forward(_libs(lib), static, at, data, seed, spp, stats)
    assert stats["batches"] >= 10
    assert {k: stats[k] for k in ("iterations", "steps")} == \
        {k: all_stats[k] for k in ("iterations", "steps")}
    _close(dose, dose_all, False)


def test_split_buffer_halves_hold_the_same_records(template_lib):
    """The record buffer's halves, which the card's overlapped batches
    take in turn: a path pass into half 0 or 1 makes the records it makes
    into the whole buffer, at that half's place and with that half's
    counters; the walk of a half's records, claimed with its counter,
    gives the whole buffer's dose bit for bit."""
    lib, path = template_lib
    static, at = _residual(path, *SPLIT_CASES[0])
    rng = np.random.default_rng(14)
    data = torch.from_numpy(rng.uniform(
        0.5, 1.5, static.projector.n_active).astype(np.float32))
    seed, spp = 3, 2
    n_ctas = len(wf._lanes_before(static, at, spp)) - 1
    cap = 8 * static.projector.n_active * spp
    buf = torch.empty(cap * 8)
    at["_wf_res_split"] = (cap, buf, torch.zeros(2, dtype=torch.int32))
    libs = _libs(lib)
    whole = wf.res_path(libs, static, at, data, seed, spp, 0, n_ctas).clone()
    ref = torch.zeros(static.sensor.n_cells)
    wf.res_walk(libs, static, at, whole, ref, seed, spp)
    assert whole.shape[0] > 0
    for half in (0, 1):
        recs = wf.res_path(libs, static, at, data, seed, spp, 0, n_ctas,
                           half=half)
        assert torch.equal(recs, whole)
        assert recs.data_ptr() == buf.data_ptr() + 4 * 8 * half * (cap // 2)
        assert int(at["_wf_res_halves"][half, 0]) == whole.shape[0]
        acc = torch.zeros(static.sensor.n_cells)
        wf.res_walk(libs, static, at, recs, acc, seed, spp, half=half)
        assert torch.equal(acc, ref)


def _libm():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("cosf", "sinf", "expf"):
        getattr(libm, name).argtypes = [ctypes.c_float]
        getattr(libm, name).restype = ctypes.c_float
    return libm


def test_res_tables_equal_the_inline_computation(template_lib):
    """The CTAs' frame table (angle_frame) and the chord table
    (chord_entry), made by the template's own functions, equal bit for
    bit what a lane computes inline: sample_rays' look-at at time a / A
    and _sample_first_scatter's masses and exp(-st L_k), evaluated here
    float32 operation by float32 operation (numpy) with the C library's
    cosf, sinf and expf, which the host build calls. The plain version
    of the table (ops/render.py _chord_table, torch's exp) agrees to an
    ulp or two."""
    lib, path = template_lib
    static, at = _residual(path, "delta", "fast_residual", "cylindrical",
                           "collimated", sample_time=False)
    P = wf.make_params(static, at, 0, 1)
    A = P.n_patterns
    got = np.zeros((A, 12), np.float32)
    assert lib.res_frames(ctypes.byref(P), got.ctypes.data) == 48
    libm, f = _libm(), np.float32
    want = np.zeros_like(got)
    for a in range(A):
        alpha = f(2.0 * np.pi) * (f(a) / f(A))
        if P.clockwise:
            alpha = -alpha
        md = f(P.motion_distance)
        o = np.array([md * f(libm.cosf(alpha)), md * f(libm.sinf(alpha)),
                      md * f(0.0)], np.float32)
        norm = lambda v: np.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
        dirw = -o / norm(o)
        left = np.array([f(0) * dirw[2] - f(1) * dirw[1],
                         f(1) * dirw[0] - f(0) * dirw[2],
                         f(0) * dirw[1] - f(0) * dirw[0]], np.float32)
        left = left / norm(left)
        up2 = np.array([dirw[1] * left[2] - dirw[2] * left[1],
                        dirw[2] * left[0] - dirw[0] * left[2],
                        dirw[0] * left[1] - dirw[1] * left[0]], np.float32)
        want[a] = np.concatenate([o, left, up2, dirw])
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))

    # the inner vial splits a chord in two segments
    bank = _residual(path, "dda", "first_scatter", "double_cylindrical",
                     "collimated")[1]["chord_pack"]
    n = bank.shape[0]
    tab = torch.empty((n, 16))
    assert lib.wf_res_chords(bank.data_ptr(), n, P.sigma_t, tab.data_ptr(),
                             None) == 0
    b, st = bank.numpy(), f(P.sigma_t)
    e0 = np.array([libm.expf(-st * L) for L in b[:, 8]], np.float32)
    e1 = np.array([libm.expf(-st * L) for L in b[:, 9]], np.float32)
    m0 = b[:, 10] * (f(1) - e0)
    m1 = b[:, 11] * e0 * (f(1) - e1)
    want = np.stack([m0, m1, m0 + m1, np.zeros_like(m0), b[:, 8], b[:, 9],
                     e0, e1, b[:, 0], b[:, 1], b[:, 4], b[:, 5], b[:, 2],
                     b[:, 3], b[:, 6], b[:, 7]], 1)
    assert (b[:, 10] > 0).any() and (b[:, 9] > 0).any()
    assert np.array_equal(tab.numpy().view(np.uint32), want.view(np.uint32))
    plain = wf._chord_table(bank, P.sigma_t)
    assert torch.allclose(plain, tab, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("vial", ["cylindrical", "square"])
def test_fast_loop_adjoint_with_tables_is_lane_order(vial, template_lib):
    """The delta fast loop's adjoint in the kernels' order with the
    frame and chord tables and the indices from the launch order equals,
    bit for bit, the lane-order trace that computes every lane's set-up
    inline; the forward the same paths, step for step."""
    lib, path = template_lib
    static, at = _residual(path, "delta", "fast_residual", vial,
                           "collimated", sample_time=False)
    assert not static.sample_time
    rng = np.random.default_rng(14)
    n, n_cells = static.projector.n_active, static.sensor.n_cells
    data = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, n_cells).astype(np.float32))
    seed, spp = 8, 3
    grad, g_stats = _run_res(lib, "wf_res_bwd", static, at, dL, n, seed, spp)
    grad_l, g_stats_l = _run_res(lib, "wf_res_bwd_lanes", static, at, dL, n,
                                 seed, spp)
    assert g_stats["steps"] > 0
    assert torch.equal(grad, grad_l)
    dose, stats = _run_res(lib, "wf_res_fwd", static, at, data, n_cells,
                           seed, spp)
    dose_l, stats_l = _run_res(lib, "wf_res_fwd_lanes", static, at, data,
                               n_cells, seed, spp)
    for ours, lanes in ((stats, stats_l), (g_stats, g_stats_l)):
        assert ours["iterations"] == lanes["iterations"]
        assert ours["steps"] == lanes["steps"]
        # a delta lane's slots are counted on its events
        assert ours["iterations"] <= ours["lane_slots"]
    _close(dose, dose_l, False)


def test_walk_pass_equals_its_plain_version(template_lib):
    """The walk pass (its refill loop, warps in turns, the shipped
    z-slabs) on the path pass's records against its plain version
    (ops/render.py _walk: march.dda_segment on the same records): the
    same voxel steps, values to 1e-4 of the max."""
    lib, path = template_lib
    static, at = _residual(path, *SPLIT_CASES[0])
    rng = np.random.default_rng(15)
    data = torch.from_numpy(rng.uniform(
        0.5, 1.5, static.projector.n_active).astype(np.float32))
    cap = 4 * static.projector.n_active * 2
    at["_wf_res_split"] = (cap, torch.empty(cap * 8),
                           torch.zeros(2, dtype=torch.int32))
    n_ctas = static.projector.resy * wf.angle_groups(6)[0]
    recs = wf.res_path(_libs(lib), static, at, data, 4, 2, 0, n_ctas).clone()
    assert recs.shape[0] > 0
    acc = torch.zeros(static.sensor.n_cells)
    stats, ref_stats = {}, {}
    wf.res_walk(_libs(lib), static, at, recs, acc, 4, 2, stats)
    ref = wf._walk(static, at, recs, stats=ref_stats)
    assert stats["steps"] == ref_stats["steps"] > 0
    assert stats["global_deposits"] == stats["steps"]
    _close(acc, ref, False)


# the target kept: (estimator, albedo, projector, vial, transmission
# only, target). A two-channel film deposits by the lane's inside flag,
# flipped at the target mesh's crossings; a one-channel render keeping
# the target (a surface-aware scene's final render) splits its segments
# there
TARGET_CASES = [("dda", 0.0, "collimated", "cylindrical", True,
                 "surface_aware"),
                ("delta", 0.5, "collimated", "square", True,
                 "surface_aware"),
                ("ratio", 0.5, "telecentric", "cylindrical", False,
                 "surface_aware"),
                ("dda", 0.5, "collimated", "cylindrical", True, "kept")]
# scenes whose meshes are not the target: a custom vial (its inner wall
# the medium's, the tile laid out from its triangles), occlusions with
# each BSDF (the medium on their outside; a reflective one without
# transmission_only reflects, a grid-walked gear among them), and an
# occlusion beside a surface-aware target (the inside flag flipped at the
# target only). They run the target instantiations: target mode 1 without
# a target, 2 with the two-channel film
MESH_CASES = [("dda", 0.0, "collimated", "custom", True, None),
              ("dda", 0.5, "collimated", "custom+black", True, None),
              ("ratio", 0.5, "collimated", "cylindrical+reflective", False,
               None),
              ("delta", 0.5, "telecentric", "square+dielectric", True,
               None),
              ("dda", 0.0, "collimated", "custom+null", True,
               "surface_aware"),
              ("dda", 0.0, "collimated", "cylindrical+gear", False, None)]


@pytest.mark.parametrize("case", TARGET_CASES + MESH_CASES)
def test_target_template_traces_the_plain_versions_paths(case,
                                                         template_lib):
    """The analog pair's target instantiations in the kernels' order
    (the forward's two-channel tile) against the plain version: the same
    bounce iterations, steps and mesh work, values to 1e-4 of each
    channel's max; the adjoint bitwise equal to lane order. On the mesh
    scenes too (MESH_CASES)."""
    lib, path = template_lib
    *scene, target = case
    static, arr = _scene(path, *scene, target=target)
    arr.pop("inside_mask", None)
    at = scene_tensors(arr, "cpu")
    ch = static.sensor.channels
    assert ch == (2 if target == "surface_aware" else 1)
    assert wf.make_params(static, at, 0, 1).target == ch
    rng = np.random.default_rng(16)
    data = torch.from_numpy(rng.uniform(0.5, 1.5, static.projector.n_active)
                            .astype(np.float32))
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, static.sensor.n_cells)
                          .astype(np.float32))
    seed, spp = 4, 2
    ref_stats, ref_g_stats = {}, {}
    dose_ref = wf._forward(static, at, data, seed, spp, wf.DEFAULT_CHUNK,
                           ref_stats)
    grad_ref = wf._adjoint(static, at, seed, spp, wf.DEFAULT_CHUNK, dL,
                           ref_g_stats)
    dose, stats = _run(lib, "wf_fwd", static, at, data,
                       static.sensor.n_cells, seed, spp)
    grad, g_stats = _run(lib, "wf_bwd", static, at, dL,
                         static.projector.n_active, seed, spp)
    grad_l, _ = _run(lib, "wf_bwd_lanes", static, at, dL,
                     static.projector.n_active, seed, spp)
    for ours, ref in ((stats, ref_stats), (g_stats, ref_g_stats)):
        assert {k: ours[k] for k in ref} == ref
        _deposits_add_up(ours, static.sensor.estimator)
    if case[2] == "collimated" and static.sensor.estimator == "dda":
        assert stats["tile_deposits"] > 0
    point = static.sensor.estimator in ("ratio", "delta")
    _close(dose, dose_ref, point, ch)
    _close(grad, grad_ref, point)
    assert torch.equal(grad, grad_l)
    if ch == 2:
        # both channels hold dose: the inside one from the crossings
        assert (dose.reshape(-1, 2).sum(0) > 0).all()


def test_two_channel_tile_keeps_the_widest_rows():
    """On a two-channel film the home-slice tile holds two floats a voxel,
    and the kernel keeps the rows that end within the voxels its shared
    memory holds (csrc/wf_trace.cuh shape()): the rows are laid out
    widest first, so that any such cut keeps the widest rows; a
    one-channel film lays its rows out in order."""
    import types
    from drtvam_tpu_torch.models.geometry import CYLINDER
    from drtvam_tpu_torch.models.sensor import SensorStatic
    st = types.SimpleNamespace(
        sensor=SensorStatic("dda", (256, 256, 8), True),
        surfaces=(types.SimpleNamespace(kind=CYLINDER, medium_side=1),))
    arr = {"bbox_min": torch.full((3,), -5.0), "bbox_max": torch.full((3,),
                                                                      5.0),
           "surf_params": torch.tensor([[4.75, -10.0, 10.0]])}
    rows2, n2 = wf.tile_rows(st, arr)
    st1 = types.SimpleNamespace(sensor=SensorStatic("dda", (256, 256, 8),
                                                    False),
                                surfaces=st.surfaces)
    rows1, n1 = wf.tile_rows(st1, arr)
    assert n2 == n1 and torch.equal(rows2[:, :2], rows1[:, :2])
    off1 = rows1[:, 2] + rows1[:, 0]
    assert torch.equal(off1, torch.cumsum(rows1[:, 1], 0) - rows1[:, 1])
    end = rows2[:, 2] + rows2[:, 0] + rows2[:, 1]
    for fit in (n1 // 4, n1 // 2, 3 * n1 // 4, n1):
        kept = (end <= fit) & (rows2[:, 1] > 0)
        assert int(rows2[kept, 1].sum()) <= fit
        # the kept rows are the widest: a band about the centre
        y = torch.nonzero(kept).squeeze(1)
        assert int(y.max() - y.min()) + 1 == int(kept.sum())
        if not kept.all():
            assert int(rows1[~kept, 1].max()) <= int(rows1[kept, 1].min())
    assert bool(((end <= n1) | (rows2[:, 1] == 0)).all())


# the residual pair with the target: (estimator, mode, vial, target)
TARGET_RES_CASES = [("dda", "first_scatter", "cylindrical", "surface_aware"),
                    ("ratio", "first_scatter", "square", "surface_aware"),
                    ("delta", "fast_residual", "cylindrical",
                     "surface_aware"),
                    ("delta", "fast_residual", "square", "surface_aware"),
                    ("delta", "first_scatter", "cylindrical",
                     "surface_aware"),
                    ("dda", "first_scatter", "cylindrical", "kept")]


@pytest.mark.parametrize("case", TARGET_RES_CASES)
def test_target_residual_template_traces_the_plain_residual(case,
                                                            template_lib):
    """The residual pair's target instantiations (the first scatter's
    channel from the inside mask, the fast residual's at each event, the
    general loop's flipped at the crossings) against the plain residual:
    the same iterations and steps, values to 1e-4 of each channel's max,
    the adjoint bitwise equal to lane order; the dda forward through its
    path and walk passes (the records' channels in their sign)."""
    lib, path = template_lib
    est, mode, vial, target = case
    static, at = _residual(path, est, mode, vial, "collimated",
                           target=target)
    ch = static.sensor.channels
    rng = np.random.default_rng(17)
    n, n_cells = static.projector.n_active, static.sensor.n_cells
    data = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, n_cells).astype(np.float32))
    seed, spp = 6, 3
    ref_stats, ref_g_stats, stats = {}, {}, {}
    dose_ref = wf._forward(static, at, data, seed, spp, wf.DEFAULT_CHUNK,
                           ref_stats)
    grad_ref = wf._adjoint(static, at, seed, spp, wf.DEFAULT_CHUNK, dL,
                           ref_g_stats)
    if est == "dda":
        dose = wf.res_forward(_libs(lib), static, at, data, seed, spp, stats)
    else:
        dose, stats = _run_res(lib, "wf_res_fwd", static, at, data, n_cells,
                               seed, spp)
    grad, g_stats = _run_res(lib, "wf_res_bwd", static, at, dL, n, seed,
                             spp)
    grad_l, _ = _run_res(lib, "wf_res_bwd_lanes", static, at, dL, n, seed,
                         spp)
    for ours, ref in ((stats, ref_stats), (g_stats, ref_g_stats)):
        assert ref["steps"] > 0
        assert {k: ours[k] for k in ref} == ref
    point = est in ("ratio", "delta")
    _close(dose, dose_ref, point, ch)
    _close(grad, grad_ref, point)
    assert torch.equal(grad, grad_l)
    if ch == 2:
        assert (dose.reshape(-1, 2).sum(0) > 0).all()


# the residual pair without a chord bank (the geometric prologue: each
# lane marches to its chord): (estimator, mode, vial, projector, target).
# A telecentric projector's chords leave the horizontal plane; a mesh
# vial's and an occlusion's only a march finds. No case keeps the target
# beside an occlusion: _scene's occlusions share the target's z = +-2
# planes, where a scattered ray's nearest face is a tie of two surfaces
# that an ulp of glibc's sinf / cosf against torch's decides
PROLOGUE_CASES = [
    ("dda", "first_scatter", "cylindrical", "collimated", None),
    ("ratio", "first_scatter", "square", "collimated", None),
    ("delta", "fast_residual", "cylindrical", "collimated", None),
    ("delta", "first_scatter", "double_cylindrical", "collimated", None),
    ("delta", "fast_residual", "square", "telecentric", None),
    ("dda", "first_scatter", "cylindrical", "collimated", "surface_aware"),
    ("delta", "fast_residual", "square", "collimated", "surface_aware"),
    ("dda", "first_scatter", "cylindrical", "collimated", "kept"),
    ("dda", "first_scatter", "custom+null", "collimated", None),
    ("delta", "first_scatter", "custom", "collimated", "surface_aware"),
    ("ratio", "first_scatter", "square+dielectric", "telecentric", None),
]


def _prologue_residual(path, est, mode, vial, projector, target):
    """A first-scatter residual static on _scene's scattering scene, its
    tensors without a chord bank (a two-channel film: the inside mask as
    bytes, as ops/hybrid.py gives it)."""
    static, arr = _scene(path, est, 0.5, projector, vial, True,
                         target=target)
    mask = arr.pop("inside_mask", None)
    st = dataclasses.replace(static, scattered_only=True, first_scatter=True,
                             fast_residual=mode == "fast_residual")
    at = scene_tensors(arr, "cpu")
    if mask is not None:
        at["inside_mask"] = torch.from_numpy(
            (np.asarray(mask, np.float32) > 0.5).reshape(-1)
            .astype(np.uint8))
    assert wf.make_params(st, at, 0, 1).residual == \
        ("first_scatter", "fast_residual").index(mode) + 2
    return st, at


@pytest.mark.parametrize("case", PROLOGUE_CASES)
def test_prologue_template_traces_the_plain_residual(case, template_lib):
    """The residual pair's prologue instantiations (a null chord bank) in
    their launch order against the plain residual: the same prologue and
    bounce iterations, steps and mesh work, values to 1e-4 of each
    channel's max (a ratio or delta deposit is a point); the adjoint
    bitwise equal to lane order; the dda forward through its path and
    walk passes (with the target kept, the target path pass)."""
    lib, path = template_lib
    est = case[0]
    static, at = _prologue_residual(path, *case)
    assert "chord_pack" not in at
    ch = static.sensor.channels
    rng = np.random.default_rng(19)
    n, n_cells = static.projector.n_active, static.sensor.n_cells
    data = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, n_cells).astype(np.float32))
    seed, spp = 6, 3
    ref_stats, ref_g_stats, stats = {}, {}, {}
    dose_ref = wf._forward(static, at, data, seed, spp, wf.DEFAULT_CHUNK,
                           ref_stats)
    grad_ref = wf._adjoint(static, at, seed, spp, wf.DEFAULT_CHUNK, dL,
                           ref_g_stats)
    if est == "dda":
        dose = wf.res_forward(_libs(lib), static, at, data, seed, spp, stats)
    else:
        dose, stats = _run_res(lib, "wf_res_fwd", static, at, data, n_cells,
                               seed, spp)
    grad, g_stats = _run_res(lib, "wf_res_bwd", static, at, dL, n, seed,
                             spp)
    grad_l, l_stats = _run_res(lib, "wf_res_bwd_lanes", static, at, dL, n,
                               seed, spp)
    for ours, ref in ((stats, ref_stats), (g_stats, ref_g_stats),
                      (l_stats, ref_g_stats)):
        assert ref["steps"] > 0 and ref["prologue_iters"] >= n * spp
        assert {k: ours[k] for k in ref} == ref
    point = est in ("ratio", "delta")
    _close(dose, dose_ref, point, ch)
    _close(grad, grad_ref, point)
    assert torch.equal(grad, grad_l)
    if ch == 2:
        assert (dose.reshape(-1, 2).sum(0) > 0).all()


@pytest.mark.parametrize("case", [RES_CASES[0], RES_CASES[2],
                                  TARGET_RES_CASES[0]])
def test_null_bank_selects_the_prologue(case, template_lib):
    """The same static with and without its chord bank: with it, the
    bank's instantiations (no prologue iteration counted, the plain
    version's chord-bank adjoint); without it, the prologue's (its
    iterations counted, the plain prologue's adjoint): two realizations
    of one expectation, not the same bits."""
    lib, path = template_lib
    est, mode, vial = case[:3]
    kw = {"target": case[3]} if case in TARGET_RES_CASES else {}
    static, at = _residual(path, est, mode, vial, "collimated", **kw)
    bare = {k: v for k, v in at.items() if k != "chord_pack"}
    rng = np.random.default_rng(21)
    n, n_cells = static.projector.n_active, static.sensor.n_cells
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, n_cells).astype(np.float32))
    seed, spp = 4, 2
    grads = []
    for arr in (at, bare):
        ref_stats = {}
        ref = wf._adjoint(static, arr, seed, spp, wf.DEFAULT_CHUNK, dL,
                          ref_stats)
        grad, stats = _run_res(lib, "wf_res_bwd", static, arr, dL, n, seed,
                               spp)
        assert ("prologue_iters" in stats) == \
            ("prologue_iters" in ref_stats) == (arr is bare)
        assert {k: stats[k] for k in ref_stats} == ref_stats
        _close(grad, ref, est != "dda")
        grads.append(grad)
    assert not torch.equal(grads[0], grads[1])
    np.testing.assert_allclose(float(grads[1].sum()), float(grads[0].sum()),
                               rtol=0.05)


# --------------------------------------------------------------------------
# the analog pair's target forms (csrc/wf_target.cuh): the staged adjoint,
# the dda forward's path and walk passes


def _target_scene(path, case, **kw):
    *scene, target = case
    static, arr = _scene(path, *scene, target=target, **kw)
    arr.pop("inside_mask", None)
    return static, scene_tensors(arr, "cpu")


def _inputs(static, seed):
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.uniform(0.5, 1.5, static.projector.n_active)
                            .astype(np.float32))
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, static.sensor.n_cells)
                          .astype(np.float32))
    return data, dL


@pytest.fixture(scope="module")
def gear_path(tmp_path_factory):
    """A target of 480 triangles: past GRID_MIN_TRIS, so the kernels and
    the plain version walk its grid."""
    from drtvam_tpu_torch.ops.mesh import make_box_with_hole
    path = tmp_path_factory.mktemp("gear") / "box_hole.ply"
    save_ply(make_box_with_hole((1.0, 1.0, 0.5), 0.3, segments=48),
             str(path))
    return str(path)


@pytest.mark.parametrize("case", TARGET_CASES + MESH_CASES)
def test_staged_target_adjoint_equals_global_banks(case, template_lib):
    """The target forms' adjoint (the banks staged, as wf_tgt_bwd reads
    them) equals the global-bank adjoint and lane order bit for bit, with
    the same counters (the target's cells, triangles and walks too), and
    the plain version's steps."""
    lib, path = template_lib
    static, at = _target_scene(path, case)
    _, dL = _inputs(static, 18)
    seed, spp, n = 4, 2, static.projector.n_active
    assert wf.tgt_route(_libs(lib), "wf_bwd", static, at)
    ref_stats = {}
    wf._adjoint(static, at, seed, spp, wf.DEFAULT_CHUNK, dL, ref_stats)
    stats = {}
    staged = wf.tgt_adjoint(_libs(lib), static, at, dL, seed, spp, stats)
    glob, g_stats = _run(lib, "wf_bwd", static, at, dL, n, seed, spp)
    lanes, _ = _run(lib, "wf_bwd_lanes", static, at, dL, n, seed, spp)
    assert torch.equal(staged, glob) and torch.equal(staged, lanes)
    assert stats == g_stats
    assert {k: stats[k] for k in ref_stats} == ref_stats
    assert stats["triangles"] > 0


def _split(lib, static, at, data, seed, spp):
    stats = {}
    dose = wf.tgt_forward(_libs(lib), static, at, data, seed, spp, stats)
    return dose, stats


DDA_TARGET_CASES = [c for c in TARGET_CASES + MESH_CASES if c[0] == "dda"]


@pytest.mark.parametrize("case", DDA_TARGET_CASES)
def test_split_target_forward_equals_one_pass(case, template_lib):
    """The dda forward's target form, path pass then walk pass through the
    wrapper's batching, against the one-pass forward (the same launch
    order and tile): the same bounce iterations, steps and mesh work,
    values to 1e-4 of each channel's max with none off; every step a
    deposit; the records the path pass made, walked by the plain walk
    (ops/render.py _walk: each record's channel from the sign of its
    maxt), give the plain forward's dose in each channel: the records
    carry the one-pass lanes' inside flags."""
    lib, path = template_lib
    static, at = _target_scene(path, case)
    data, _ = _inputs(static, 19)
    seed, spp = 4, 2
    ch = static.sensor.channels
    assert wf.tgt_route(_libs(lib), "wf_fwd", static, at)
    one, one_stats = _run(lib, "wf_fwd", static, at, data,
                          static.sensor.n_cells, seed, spp)
    ref_stats = {}
    ref = wf._forward(static, at, data, seed, spp, wf.DEFAULT_CHUNK,
                      ref_stats)
    dose, stats = _split(lib, static, at, data, seed, spp)
    for k in ("iterations", "steps") + wf.MESH_COUNTERS:
        assert stats[k] == one_stats[k], k
    assert {k: stats[k] for k in ref_stats} == ref_stats
    _deposits_add_up(stats, "dda")
    assert stats["tile_deposits"] > 0
    assert 0 < stats["records"] <= stats["iterations"]
    _close(dose, one, False, ch)
    _close(dose, ref, False, ch)
    # the records of one batch with room for all of them, walked plainly
    units, lanes = wf.tgt_units(static, at, spp)
    cap = 4 * int(lanes.sum())
    recs = torch.zeros(cap * 8)
    region = torch.tensor([0] + [cap] * units.shape[0], dtype=torch.int32)
    region[1:] = torch.arange(1, units.shape[0] + 1) * (cap // units.shape[0])
    cnt = torch.zeros(units.shape[0], dtype=torch.int32)
    acc = torch.zeros(static.sensor.n_cells)
    P, order, starts, _ = wf._family_params("wf_fwd", static, at, seed, spp)
    M, tris, _ = wf._target_args("wf_fwd", static, at, P)
    A = wf.TgtArgs(recs.data_ptr(), region.data_ptr(), cnt.data_ptr(),
                   units.data_ptr(), acc.data_ptr(), 0, units.shape[0])
    assert lib.wf_tgt_path(ctypes.byref(P), ctypes.byref(M), wf._ptr(tris),
                           data.data_ptr(), at["active_pixels"].data_ptr(),
                           wf._ptr(order), wf._ptr(starts), ctypes.byref(A),
                           None, None) == 0
    assert not bool(acc.any())  # every segment recorded
    per = cap // units.shape[0]
    rec = torch.cat([recs.view(-1, 8)[k * per:k * per + int(cnt[k])]
                     for k in range(units.shape[0])])
    assert rec.shape[0] == stats["records"]
    if ch == 2:
        assert bool((rec[:, 6] < 0).any()) and bool((rec[:, 6] > 0).any())
    _close(wf._walk(static, at, rec), ref, False, ch)


@pytest.mark.parametrize("lever", ["walked_at_once", "batches", "units"])
def test_split_target_forward_levers_change_no_step(lever, template_lib,
                                                    monkeypatch):
    """Regions too small for their records (the path pass walks the rest
    at once, every deposit global), a buffer of a few units' regions (many
    batches) and units of 64 lanes (each CTA's tasks cut in parts, each
    with its own tile): the same iterations and steps as the shipped
    sizes, values to 1e-4 of each channel's max; the estimate from the
    first launch sizes the next one's regions, which then hold every
    record."""
    lib, path = template_lib
    static, at = _target_scene(path, TARGET_CASES[0], n_patterns=30)
    data, _ = _inputs(static, 20)
    seed, spp = 5, 2
    base, base_stats = _split(lib, static, at, data, seed, spp)
    assert base_stats["batches"] == 1
    at.pop("_wf_tgt_est")
    if lever == "walked_at_once":
        monkeypatch.setattr(wf, "TGT_GUESS", 0.0)
        monkeypatch.setattr(wf, "TGT_SLACK", 0)
    elif lever == "batches":
        monkeypatch.setattr(wf, "TGT_MAX_RECORDS", 200)
    else:
        monkeypatch.setattr(wf, "TGT_UNIT_LANES", 64)
        at.pop("_wf_tgt_units")
    dose, stats = _split(lib, static, at, data, seed, spp)
    for k in ("iterations", "steps", "records"):
        assert stats[k] == base_stats[k], k
    _close(dose, base, False, 2)
    if lever == "walked_at_once":
        assert stats["records_walked_at_once"] == stats["records"]
        assert stats["tile_deposits"] == 0
        monkeypatch.setattr(wf, "TGT_SLACK", 32)
        again, again_stats = _split(lib, static, at, data, seed, spp)
        assert again_stats["records_walked_at_once"] == 0
        _close(again, base, False, 2)
    elif lever == "batches":
        assert stats["batches"] > 3
    else:
        assert wf.tgt_units(static, at, spp)[0].shape[0] > \
            static.projector.resy * wf.angle_groups(30)[0]


# the ratio and delta cases of TARGET_CASES and MESH_CASES (one and two
# channels, with and without transmission_only): their forwards' target
# forms, the ratio's path and walk passes and the delta's one pass
POINT_TARGET_CASES = [c for c in TARGET_CASES + MESH_CASES if c[0] != "dda"]


def _ratio_records(lib, static, at, data, seed, spp):
    """The ratio path pass over every unit in one batch with room for all
    its records: (records (n, 8), keys (n, 2) int64: each record's lane
    and stream counter), unit by unit; the accumulator stays 0 (no
    segment tracked at once)."""
    units, lanes = wf.tgt_units(static, at, spp)
    cap = 16 * lanes + 64
    start = np.concatenate([[0], np.cumsum(cap)]).astype(np.int32)
    n = int(start[-1])
    recs = torch.zeros(n * 8)
    keys = torch.zeros(n * 2, dtype=torch.int32)
    region = torch.from_numpy(start)
    cnt = torch.zeros(units.shape[0], dtype=torch.int32)
    acc = torch.zeros(static.sensor.n_cells)
    P, order, starts, _ = wf._family_params("wf_fwd", static, at, seed, spp)
    M, tris, _ = wf._target_args("wf_fwd", static, at, P)
    A = wf.TgtArgs(recs.data_ptr(), region.data_ptr(), cnt.data_ptr(),
                   units.data_ptr(), acc.data_ptr(), 0, units.shape[0],
                   keys.data_ptr())
    assert lib.wf_tgt_path(ctypes.byref(P), ctypes.byref(M), wf._ptr(tris),
                           data.data_ptr(), at["active_pixels"].data_ptr(),
                           wf._ptr(order), wf._ptr(starts), ctypes.byref(A),
                           None, None) == 0
    assert not bool(acc.any()) and bool((cnt.numpy() <= cap).all())
    idx = torch.cat([torch.arange(int(s0), int(s0) + int(m))
                     for s0, m in zip(start[:-1], cnt.tolist())])
    key = keys.view(-1, 2)[idx].to(torch.int64) & 0xFFFFFFFF
    return recs.view(-1, 8)[idx], key


@pytest.mark.parametrize("case", POINT_TARGET_CASES)
def test_point_target_forward_equals_one_pass(case, template_lib):
    """The ratio and delta forwards' target forms through the wrapper
    (tgt_forward: the ratio's path and walk passes, batched; the delta's
    one pass over the units) against the one-pass forward (the same
    launch order) and the plain version: the same bounce iterations,
    steps and mesh work, every delta step a global deposit; doses to 1e-4
    of each channel's max with none off. The ratio's records, each
    walked by the plain ratio tracking (ops/render.py _walk) from the
    stream it recorded, give the plain forward's dose in each channel:
    the records carry the one-pass lanes' segments, inside flags and
    random streams."""
    lib, path = template_lib
    static, at = _target_scene(path, case)
    est, ch = case[0], static.sensor.channels
    data, _ = _inputs(static, 22)
    seed, spp = 4, 2
    assert wf.tgt_route(_libs(lib), "wf_fwd", static, at)
    one, one_stats = _run(lib, "wf_fwd", static, at, data,
                          static.sensor.n_cells, seed, spp)
    ref_stats = {}
    ref = wf._forward(static, at, data, seed, spp, wf.DEFAULT_CHUNK,
                      ref_stats)
    dose, stats = _split(lib, static, at, data, seed, spp)
    for k in ("iterations", "steps") + wf.MESH_COUNTERS:
        assert stats[k] == one_stats[k], k
    assert {k: stats[k] for k in ref_stats} == ref_stats
    assert stats["steps"] > 0 and stats["triangles"] > 0
    _deposits_add_up(stats, est)
    _close(dose, one, False, ch)
    _close(dose, ref, False, ch)
    if est == "delta":
        assert stats["global_deposits"] == stats["steps"]
        assert "records" not in stats
        return
    assert 0 < stats["records"] <= stats["iterations"]
    recs, keys = _ratio_records(lib, static, at, data, seed, spp)
    assert recs.shape[0] == stats["records"]
    if ch == 2:
        assert bool((recs[:, 6] < 0).any()) and bool((recs[:, 6] > 0).any())
    walked = {}
    _close(wf._walk(static, at, recs, walked, keys=keys, seed=seed), ref,
           False, ch)
    assert walked["steps"] == stats["steps"]


# (estimator, lever): the ratio form's batches, units and regions that
# overflow; the delta form's units (it takes no records)
POINT_LEVERS = [("ratio", "walked_at_once"), ("ratio", "batches"),
                ("ratio", "units"), ("delta", "units")]


@pytest.mark.parametrize("est,lever", POINT_LEVERS)
def test_point_target_forward_levers_change_no_step(est, lever, template_lib,
                                                    monkeypatch):
    """As test_split_target_forward_levers_change_no_step for the ratio
    and delta forms on TARGET_CASES' two-channel scenes at 30 angles:
    regions too small for their records (the path pass tracks the rest
    at once, every deposit global; the next launch's regions, sized from
    the first's records, hold them all), a buffer of a few units' regions
    (many batches) and units of 64 lanes: the same iterations and steps
    as the shipped sizes, values to 1e-4 of each channel's max."""
    lib, path = template_lib
    case = next(c for c in TARGET_CASES if c[0] == est)
    static, at = _target_scene(path, case, n_patterns=30)
    data, _ = _inputs(static, 23)
    seed, spp = 5, 2
    base, base_stats = _split(lib, static, at, data, seed, spp)
    if est == "ratio":
        assert base_stats["batches"] == 1
        at.pop("_wf_tgt_est")
    if lever == "walked_at_once":
        monkeypatch.setattr(wf, "TGT_GUESS", 0.0)
        monkeypatch.setattr(wf, "TGT_SLACK", 0)
    elif lever == "batches":
        monkeypatch.setattr(wf, "TGT_MAX_RECORDS", 200)
    else:
        monkeypatch.setattr(wf, "TGT_UNIT_LANES", 64)
        at.pop("_wf_tgt_units")
    dose, stats = _split(lib, static, at, data, seed, spp)
    for k in ("iterations", "steps") + wf.MESH_COUNTERS + (
            ("records",) if est == "ratio" else ()):
        assert stats[k] == base_stats[k], k
    _close(dose, base, False, 2)
    if lever == "walked_at_once":
        assert stats["records_walked_at_once"] == stats["records"]
        assert stats["tile_deposits"] == 0
        monkeypatch.setattr(wf, "TGT_SLACK", 32)
        again, again_stats = _split(lib, static, at, data, seed, spp)
        assert again_stats["records_walked_at_once"] == 0
        assert again_stats["tile_deposits"] > 0
        _close(again, base, False, 2)
    elif lever == "batches":
        assert stats["batches"] > 3
    else:
        assert wf.tgt_units(static, at, spp)[0].shape[0] > \
            static.projector.resy * wf.angle_groups(30)[0]


@pytest.mark.parametrize("form", ["wf_fwd", "wf_bwd"])
def test_target_mesh_counts_equal_the_plain_grid_walk(form, template_lib,
                                                      gear_path):
    """On a target walked through its grid, the target forms count the
    plain version's grid walks, cells and triangle tests
    (ray_triangles_grid over the lanes that intersect), as do the
    one-pass kernels; a budget too small for the banks routes the scene
    to the one-pass kernels."""
    lib, _ = template_lib
    static, at = _target_scene(gear_path, TARGET_CASES[0])
    assert any(s.grid is not None for s in static.surfaces)
    data, dL = _inputs(static, 21)
    seed, spp = 3, 2
    ref_stats = {}
    if form == "wf_fwd":
        wf._forward(static, at, data, seed, spp, wf.DEFAULT_CHUNK, ref_stats)
        _, stats = _split(lib, static, at, data, seed, spp)
        _, one = _run(lib, "wf_fwd", static, at, data, static.sensor.n_cells,
                      seed, spp)
    else:
        wf._adjoint(static, at, seed, spp, wf.DEFAULT_CHUNK, dL, ref_stats)
        stats = {}
        wf.tgt_adjoint(_libs(lib), static, at, dL, seed, spp, stats)
        _, one = _run(lib, "wf_bwd", static, at, dL, static.projector.n_active,
                      seed, spp)
    assert ref_stats["cells"] > ref_stats["walks"] > 0
    for k in ("iterations", "steps") + wf.MESH_COUNTERS:
        assert stats[k] == ref_stats[k] == one[k], k
    try:
        lib.set_tgt_budget(0)
        assert not wf.tgt_route(_libs(lib), form, static, at)
    finally:
        lib.set_tgt_budget(1 << 30)


# --------------------------------------------------------------------------
# the residual pair's target path pass (csrc/wf_res_target.cuh): the dda
# residual forward's path pass with the target kept, its threads refilled
# lane by lane, the banks staged


def _sorted_rows(recs):
    """The records (n, 8) as int32 bit patterns, sorted row by row: the
    record set, compared bitwise whatever the order the pass made it in."""
    bits = recs.numpy().view(np.int32)
    return bits[np.lexsort(bits.T[::-1])]


def _path_records(lib, static, at, data, seed, spp, form, monkeypatch):
    """The path pass over every CTA in one batch, through the wrapper
    (ops/render.py res_path): form "target" (res_tgt_route must take the
    scene) or "one_pass" (the route forced off: wf_res_path). Returns
    (sorted record bits, stats)."""
    libs = _libs(lib)
    n_ctas = static.projector.resy * wf.angle_groups(
        static.projector.n_patterns)[0]
    cap = 16 * static.projector.n_active * spp
    at["_wf_res_split"] = (cap, torch.empty(cap * 8),
                           torch.zeros(2, dtype=torch.int32))
    with monkeypatch.context() as m:
        if form == "one_pass":
            m.setattr(wf, "res_tgt_route", lambda *a: False)
        else:
            assert wf.res_tgt_route(libs, static, at)
        stats = {}
        recs = wf.res_path(libs, static, at, data, seed, spp, 0, n_ctas,
                           stats)
    assert recs is not None and recs.shape[0] == stats["records"] > 0
    return _sorted_rows(recs.clone()), stats


# (estimator, mode, vial, target) of the dda residual with the target
RES_TARGET_CASES = [("dda", "first_scatter", "cylindrical", "surface_aware"),
                    ("dda", "first_scatter", "square", "kept"),
                    ("dda", "scattered_only", "square", "surface_aware")]


@pytest.mark.parametrize("case", RES_TARGET_CASES)
def test_residual_target_path_records_equal_one_pass(case, template_lib,
                                                     monkeypatch):
    """The target form's path pass (threads refilled lane by lane, the
    banks staged) makes the one-pass instantiation's records: the sorted
    record sets equal bit for bit, with the banks staged and read from
    global memory (a staging limit of 0 bytes), the same bounce
    iterations and mesh work; on a two-channel film both channels' signs
    occur. Each SIMT slot count covers its work."""
    lib, path = template_lib
    est, mode, vial, target = case
    static, at = _residual(path, est, mode, vial, "collimated", target=target,
                           n_patterns=8)
    data, _ = _inputs(static, 22)
    seed, spp = 7, 3
    one, one_stats = _path_records(lib, static, at, data, seed, spp,
                                   "one_pass", monkeypatch)
    new, stats = _path_records(lib, static, at, data, seed, spp, "target",
                               monkeypatch)
    with monkeypatch.context() as m:
        m.setattr(wf, "RES_TGT_SMEM_LIMIT", 0)
        glob, g_stats = _path_records(lib, static, at, data, seed, spp,
                                      "target", monkeypatch)
    assert np.array_equal(new, one) and np.array_equal(glob, one)
    for k in ("iterations", "records") + wf.MESH_COUNTERS:
        assert stats[k] == one_stats[k] == g_stats[k], k
    assert stats["triangles"] > 0
    for s in (stats, one_stats):
        assert s["iterations"] <= s["iteration_slots"]
        assert s["triangles"] <= s["triangle_slots"]
    if static.sensor.channels == 2:
        maxt = new[:, 6].view(np.float32)
        assert (maxt < 0).any() and (maxt > 0).any()


@pytest.mark.parametrize("lever", ["global_warps5", "chunk1", "chunk64",
                                   "warps1", "warps5", "batches"])
def test_residual_target_path_levers_change_no_record(lever, template_lib,
                                                      monkeypatch):
    """Lanes claimed one at a time or 64 at a time, one warp or five in
    turns a CTA, five warps with the banks in global memory (a CTA's
    share of 0 bytes): the same record set bit for bit and the same
    counts; batches of one CTA through the wrapper (ops/render.py
    res_forward): the same iterations, steps and records, the dose to
    1e-4 of the max."""
    lib, path = template_lib
    static, at = _residual(path, "dda", "first_scatter", "square",
                           "collimated", target="surface_aware",
                           n_patterns=8)
    data, _ = _inputs(static, 23)
    seed, spp = 2, 2
    if lever == "batches":
        base_stats, stats = {}, {}
        base = wf.res_forward(_libs(lib), static, at, data, seed, spp,
                              base_stats)
        dose = wf.res_forward(_libs(lib), static, at, data, seed, spp, stats,
                              batch_ctas=1)
        assert stats["batches"] == static.projector.resy * wf.angle_groups(
            8)[0] > base_stats["batches"]
        for k in ("iterations", "steps", "records") + wf.MESH_COUNTERS:
            assert stats[k] == base_stats[k], k
        _close(dose, base, False, 2)
        return
    base, base_stats = _path_records(lib, static, at, data, seed, spp,
                                     "target", monkeypatch)
    warps, chunk, budget = {"global_warps5": (5, 32, 0),
                            "chunk1": (3, 1, 1 << 30),
                            "chunk64": (3, 64, 1 << 30),
                            "warps1": (1, 32, 1 << 30),
                            "warps5": (5, 32, 1 << 30)}[lever]
    try:
        lib.set_res_tgt(warps, chunk)
        lib.set_tgt_budget(budget)
        recs, stats = _path_records(lib, static, at, data, seed, spp,
                                    "target", monkeypatch)
    finally:
        lib.set_res_tgt(3, 32)
        lib.set_tgt_budget(1 << 30)
    assert np.array_equal(recs, base)
    for k in ("iterations", "records") + wf.MESH_COUNTERS:
        assert stats[k] == base_stats[k], k


def test_residual_target_mesh_counts_equal_the_plain_grid_walk(template_lib,
                                                               gear_path,
                                                               monkeypatch):
    """On a target walked through its grid (480 triangles), the
    residual's target form counts the plain version's bounce iterations,
    grid walks, cells and triangle tests, with its banks staged and, on a
    budget too small for them, read from global memory (the scene stays
    on the form's route), as does the one-pass instantiation; the dose of
    its records to 1e-4 of the plain's."""
    lib, _ = template_lib
    static, at = _residual(gear_path, "dda", "first_scatter", "cylindrical",
                           "collimated", target="kept")
    assert any(s.grid is not None for s in static.surfaces)
    data, _ = _inputs(static, 24)
    seed, spp = 3, 2
    ref_stats, stats = {}, {}
    ref = wf._forward(static, at, data, seed, spp, wf.DEFAULT_CHUNK,
                      ref_stats)
    assert wf.res_tgt_route(_libs(lib), static, at)
    dose = wf.res_forward(_libs(lib), static, at, data, seed, spp, stats)
    assert ref_stats["cells"] > ref_stats["walks"] > 0
    for k in ("iterations", "steps") + wf.MESH_COUNTERS:
        assert stats[k] == ref_stats[k], k
    _close(dose, ref, False)
    glob_stats, one_stats = {}, {}
    try:
        lib.set_tgt_budget(0)
        assert wf.res_tgt_route(_libs(lib), static, at)
        wf.res_forward(_libs(lib), static, at, data, seed, spp, glob_stats)
    finally:
        lib.set_tgt_budget(1 << 30)
    with monkeypatch.context() as m:
        m.setattr(wf, "res_tgt_route", lambda *a: False)
        wf.res_forward(_libs(lib), static, at, data, seed, spp, one_stats)
    for k in ("iterations", "steps") + wf.MESH_COUNTERS:
        assert glob_stats[k] == one_stats[k] == ref_stats[k], k


# the medium adjoint (csrc/wf_med.cuh): dda, ratio and delta, with and
# without scattering, reflecting and not, and scenes with mesh surfaces
# (one-pass target form): a custom vial with an occlusion, a reflective
# occlusion, a surface-aware target (two channels)
MED_CASES = [("dda", 0.0, "collimated", "cylindrical", True, None),
             ("dda", 0.5, "collimated", "double_cylindrical", False, None),
             ("ratio", 0.0, "lens", "double_cylindrical", True, None),
             ("ratio", 0.5, "telecentric", "square", False, None),
             ("delta", 0.5, "lens", "cylindrical", True, None),
             ("delta", 0.5, "collimated", "square", False, None),
             ("dda", 0.5, "collimated", "custom+black", True, None),
             ("ratio", 0.5, "collimated", "cylindrical+reflective", False,
              None),
             ("dda", 0.0, "collimated", "cylindrical", True, "surface_aware")]


@pytest.mark.parametrize("case", MED_CASES)
def test_medium_template_traces_the_plain_cotangents(case, template_lib):
    """The medium adjoint's instantiations in the kernel's launch order
    (its compaction, its shuffle tree and its fixed-order sum), on
    patterns with no zero: every pixel traced, each CTA's count its
    pixels; (stg, ssg) within 1e-4 relative of the plain version's
    (glibc's expf / logf against torch's; the sums regroup; the dda's E a
    running product), the pattern gradient a caller differentiating both
    gets (wf_bwd's: the one-pass target form on the mesh scenes) close to
    the plain medium adjoint's, and the task partials and sums bitwise on
    two runs."""
    lib, path = template_lib
    *scene, target = case
    static, arr = _scene(path, *scene, target=target)
    arr.pop("inside_mask", None)
    static = dataclasses.replace(static, medium_grads=True)
    at = scene_tensors(arr, "cpu")
    assert wf.make_params(static, at, 0, 1).target == int(
        "+" in case[3] or target is not None) * static.sensor.channels
    rng = np.random.default_rng(21)
    n = static.projector.n_active
    data = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, static.sensor.n_cells)
                          .astype(np.float32))
    seed, spp = 5, 2
    pg_ref, stg_ref, ssg_ref = wf._adjoint(static, at, seed, spp,
                                           wf.DEFAULT_CHUNK, dL, data=data)
    libs = {wf.MED_LIB: lib}
    stg, ssg, part, count = wf.med_adjoint(libs, static, at, dL, data, seed,
                                           spp, partials=True)
    base, n_tasks = wf.med_tasks(static, at)
    assert part.shape[0] == n_tasks
    starts = wf.block_order(static, at)[1]
    assert torch.equal(count.long(), starts[1:] - starts[:-1])
    assert int(((count.long() + 31) // 32).sum()) == n_tasks
    for ours, ref in ((stg, stg_ref), (ssg, ssg_ref)):
        assert float(ref) != 0.0
        assert abs(float(ours) - float(ref)) <= 1e-4 * abs(float(ref)), \
            (float(ours), float(ref))
    grad, _ = _run(lib, "wf_bwd", static, at, dL, n, seed, spp)
    point = static.sensor.estimator in ("ratio", "delta")
    _close(grad, pg_ref, point)
    stg2, ssg2, part2, count2 = wf.med_adjoint(libs, static, at, dL, data,
                                               seed, spp, partials=True)
    assert torch.equal(part, part2) and torch.equal(count, count2)
    assert torch.equal(torch.stack([stg, ssg]), torch.stack([stg2, ssg2]))


def _med_scene(path, case):
    *scene, target = case
    static, arr = _scene(path, *scene, target=target)
    arr.pop("inside_mask", None)
    return dataclasses.replace(static, medium_grads=True), \
        scene_tensors(arr, "cpu")


def _dark_patterns(static, seed, share=0.4):
    """Patterns in [0.5, 1.5) with about `share` of them exactly 0, and
    the loss gradient."""
    rng = np.random.default_rng(seed)
    n = static.projector.n_active
    data = rng.uniform(0.5, 1.5, n).astype(np.float32)
    data[rng.uniform(0.0, 1.0, n) < share] = 0.0
    dL = rng.uniform(0.0, 1.0, static.sensor.n_cells).astype(np.float32)
    return torch.from_numpy(data), torch.from_numpy(dL)


def _emitting(static, at, data, seed, spp):
    """Each launch-order CTA's emitting pixels (em = data ray_w != 0), by
    active index in launch order."""
    order, starts = (t.numpy() for t in wf.block_order(static, at))
    em = data.numpy() * np.float32(wf.make_params(static, at, seed,
                                                  spp).ray_w)
    return [order[a:b][em[order[a:b]] != 0.0]
            for a, b in zip(starts[:-1], starts[1:])]


@pytest.mark.parametrize("case", MED_CASES)
def test_medium_only_template_traces_the_emitting_pixels(case, template_lib):
    """The medium adjoint (each CTA's emitting pixels compacted, 32 a
    task) in the kernel's launch order, on patterns with 40 % exact zeros:
    (stg, ssg) within 1e-4 relative of the plain version's (the sums
    regroup; the dda's E a running product); each CTA's count its
    emitting pixels, its tasks the count rounded up by warp and its later
    slots 0; exactly the emitting pixels traced, in launch order; the
    slots and sums bitwise on two runs."""
    lib, path = template_lib
    static, at = _med_scene(path, case)
    data, dL = _dark_patterns(static, 23)
    assert float((data == 0).float().mean()) >= 0.3
    seed, spp = 5, 2
    _, stg_ref, ssg_ref = wf._adjoint(static, at, seed, spp,
                                      wf.DEFAULT_CHUNK, dL, data=data)
    libs = {wf.MED_LIB: lib}
    runs = [wf.med_adjoint(libs, static, at, dL, data, seed, spp,
                           partials=True) for _ in range(2)]
    buf = torch.empty(static.projector.n_active, dtype=torch.int32)
    traced = buf[:lib.wf_traced(buf.data_ptr())].numpy()
    stg, ssg, part, count = runs[0]
    for ours, ref in ((stg, stg_ref), (ssg, ssg_ref)):
        assert float(ref) != 0.0
        assert abs(float(ours) - float(ref)) <= 1e-4 * abs(float(ref)), \
            (float(ours), float(ref))
    emit = _emitting(static, at, data, seed, spp)
    assert count.tolist() == [len(e) for e in emit]
    assert np.array_equal(traced, np.concatenate(emit))
    base = wf.med_tasks(static, at)[0].numpy()
    tasks = [(len(e) + 31) // 32 for e in emit]
    for b, t in enumerate(tasks):
        assert not part[base[b] + t:base[b + 1]].any()
    assert sum(tasks) < base[-1]
    assert torch.equal(part, runs[1][2]) and torch.equal(count, runs[1][3])
    assert torch.equal(torch.stack([stg, ssg]),
                       torch.stack([runs[1][0], runs[1][1]]))


@pytest.mark.parametrize("share", [0.0, 0.4])
@pytest.mark.parametrize("case", MESH_CASES)
def test_staged_medium_adjoint_equals_one_pass(case, share, template_lib,
                                               monkeypatch):
    """The medium adjoint's staged form (the banks staged, as wf_tgt_bwd
    reads them) on the mesh scenes, on patterns with no zero and with 40 %
    zeros: the route takes it; (stg, ssg) within 1e-4 of the plain
    version's and bitwise the one-pass target form's, which traces the
    same pixels in the same order."""
    lib, path = template_lib
    static, at = _med_scene(path, case)
    data, dL = _dark_patterns(static, 29, share)
    seed, spp = 4, 2
    libs = {wf.MED_LIB: lib}
    assert wf.med_route(libs, static, at)
    n0 = wf.form_launches[f"{wf.MED_LIB}:staged"]
    stg, ssg = wf.med_adjoint(libs, static, at, dL, data, seed, spp)
    assert wf.form_launches[f"{wf.MED_LIB}:staged"] == n0 + 1
    with monkeypatch.context() as m:
        m.setattr(wf, "med_route", lambda *a: False)
        stg1, ssg1 = wf.med_adjoint(libs, static, at, dL, data, seed, spp)
    _, stg_ref, ssg_ref = wf._adjoint(static, at, seed, spp,
                                      wf.DEFAULT_CHUNK, dL, data=data)
    for ours, ref in ((stg, stg_ref), (ssg, ssg_ref)):
        assert float(ref) != 0.0
        assert abs(float(ours) - float(ref)) <= 1e-4 * abs(float(ref)), \
            (float(ours), float(ref))
    assert torch.equal(torch.stack([stg, ssg]), torch.stack([stg1, ssg1]))


# a block of the store with a non-zero first active index (the sharded
# render's rank, drtvam_tpu_torch/parallel/shard.py): the analog pair on
# the bench-like dda scene and a ratio scene with reflections, the
# residual pair on the dda first scatter and the delta fast loop (12
# angles), the target forms (split forward, staged adjoint) on a
# two-channel film at 30 angles (2 groups of 15), so that a block of 10
# leaves CTAs empty (tgt_units skips them)
BLOCK_CASES = [("analog", CASES[0]), ("analog", CASES[1]),
               ("residual", RES_CASES[0]), ("residual", RES_CASES[2]),
               ("target", TARGET_CASES[0])]


@pytest.mark.parametrize("family,case", BLOCK_CASES)
def test_pixel_blocks_keep_their_lanes(family, case, template_lib):
    """The store cut into 3 blocks (pixel_block: the later two start at a
    non-zero active index), each run in the kernels' launch order over
    its pixels: the gradient of a block is the full launch's on its
    pixels bitwise and 0 elsewhere, the blocks' bounce iterations and
    steps add up to the full launch's, and their doses sum to its dose
    within 1e-6 of the max (the deposits regroup); the dda residual
    through its path and walk passes too, and the target forms through
    their wrappers' batching (tgt_forward, tgt_adjoint)."""
    from drtvam_tpu_torch.parallel.shard import block_range, pixel_block
    lib, path = template_lib
    if family == "analog":
        static, arr = _scene(path, *case, n_patterns=12)
        at = scene_tensors(arr, "cpu")
        fwd, bwd = (lambda *a: _run(lib, "wf_fwd", *a),
                    lambda *a: _run(lib, "wf_bwd", *a))
    elif family == "residual":
        static, at = _residual(path, *case, n_patterns=12)
        fwd, bwd = (lambda *a: _run_res(lib, "wf_res_fwd", *a),
                    lambda *a: _run_res(lib, "wf_res_bwd", *a))
    else:
        static, at = _target_scene(path, case, n_patterns=30)

        def fwd(st, at, x, n_out, seed, spp):
            assert wf.tgt_route(_libs(lib), "wf_fwd", st, at)
            return _split(lib, st, at, x, seed, spp)

        def bwd(st, at, x, n_out, seed, spp):
            stats = {}
            return wf.tgt_adjoint(_libs(lib), st, at, x, seed, spp,
                                  stats), stats
    n, n_cells = static.projector.n_active, static.sensor.n_cells
    rng = np.random.default_rng(21)
    data = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    dL = torch.from_numpy(rng.uniform(0.0, 1.0, n_cells).astype(np.float32))
    seed, spp = 7, 2
    dose, stats = fwd(static, at, data, n_cells, seed, spp)
    grad, g_stats = bwd(static, at, dL, n, seed, spp)
    split = family == "residual" and static.sensor.estimator == "dda"
    if split:
        split_stats = {}
        split_dose = wf.res_forward(_libs(lib), static, at, data, seed, spp,
                                    split_stats)
    total = torch.zeros(n_cells)
    total_split = torch.zeros(n_cells)
    counts = {"fwd": {}, "bwd": {}, "split": {}}
    for r in range(3):
        lo, hi = block_range(n, 3, r)
        st = pixel_block(static, lo, hi)
        assert wf.pixel_range(st) == (lo, hi) and (lo > 0) == (r > 0)
        d, s = fwd(st, at, data, n_cells, seed, spp)
        g, gs = bwd(st, at, dL, n, seed, spp)
        assert torch.equal(g[lo:hi], grad[lo:hi])
        assert not g[:lo].any() and not g[hi:].any()
        total += d
        for key, c in (("fwd", s), ("bwd", gs)):
            for k in ("iterations", "steps"):
                counts[key][k] = counts[key].get(k, 0) + c[k]
        if split:
            total_split += wf.res_forward(_libs(lib), st, at, data, seed,
                                          spp, counts["split"])
    for key, ref in (("fwd", stats), ("bwd", g_stats)) + (
            (("split", split_stats),) if split else ()):
        assert ref["steps"] > 0
        assert all(counts[key][k] == ref[k] for k in ("iterations", "steps"))
    for out, ref in ((total, dose),) + (((total_split, split_dose),)
                                        if split else ()):
        scale = float(ref.abs().max())
        assert scale > 0.0
        assert float((out - ref).abs().max()) <= 1e-6 * scale
