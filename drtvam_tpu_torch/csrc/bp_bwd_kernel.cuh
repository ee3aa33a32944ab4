// The gather backprojection adjoint, shared by bp_bwd and bp_bwd_band,
// and by their bf16 operand forms bp_bwd_bf16 and bp_bwd_band_bf16:
//
//   Pzbar[a, z, i] = sum_j dL[z, j] * B_a[i, j],
//
// walking per angle a list of the voxels that carry a kept tap. The
// lists are built once per engine from the fields (ops/backproject.py
// voxel_lists): taps in [0, U) for bp_bwd, taps in the voxel's band for
// bp_bwd_band. A dropped tap has weight 0 in its entry, and a voxel with
// no kept tap has no entry, so the kernel computes whichever function
// its lists describe.
//
// Design:
// - Per angle, the voxels are grouped by i0 = floor(u) and ordered by
//   raster voxel index inside a group: entries (j, i0, w0, w1), with
//   group g = i0 + 1 in 0..U starting at ptr[a * (U + 1) + g].
// - dL is re-laid out once per call to dLt (Y*X, Zp), z innermost, so a
//   voxel's z-line is contiguous: a warp reads it as four values per
//   lane (128 z-rows: 512 bytes in float32, coalesced). The bf16 form
//   rounds dL to bfloat16 in that pass (256-byte lines, 8 bytes a lane)
//   and rounds each entry's two weights as it loads them.
// - A warp owns (angle, a run of RUN columns, 128 z-rows) and walks the
//   voxels of groups c0 - 1 .. c1 - 1 in order. Each voxel has taps on
//   the two adjacent columns i0 and i0 + 1, so its dL line is read once
//   and feeds two register accumulators; when the group advances, the
//   finished column goes to a warp-private tile in shared memory. No
//   atomics; only the voxels of a run's boundary group are read twice.
// - The grid runs all (angle, run) warps of one z-chunk first, so the
//   warps in flight share one 128-row slab of dLt (YX x 512 bytes) in L2.
// - The tile is written out row by row, consecutive lanes on
//   consecutive columns. Every output element is written once, in a
//   fixed order: the result is bitwise reproducible from run to run, and
//   the output needs no zeroing. The sums are float32 in both forms.
#pragma once

#include "backproject_common.cuh"

// Internal linkage: every source that includes this header is built
// into a shared library of its own.
namespace {

using namespace bp;

constexpr int BWD_WARPS = 8;
constexpr int RUN = 16;     // columns per warp
constexpr int ZW = 128;     // z-rows per warp: one float4 per lane
constexpr int TS = ZW + 4;  // floats between two columns of a warp's tile
constexpr int BATCH = 8;    // dL lines in flight per warp
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float4 fma4(float w, float4 d, float4 acc) {
  acc.x += w * d.x;
  acc.y += w * d.y;
  acc.z += w * d.z;
  acc.w += w * d.w;
  return acc;
}

template <class T>
__global__ void __launch_bounds__(BWD_WARPS * 32)
bwd_kernel(const T* __restrict__ dLt, const int4* __restrict__ ent,
           const int* __restrict__ ptr, float* __restrict__ out, int A,
           int Zf, int Zp, int U, int runs) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * BWD_WARPS + warp;
  if (gw >= A * runs) return;  // no block-wide barrier below
  const int a = gw / runs, c0 = (gw % runs) * RUN, c1 = min(c0 + RUN, U);
  const int zb = blockIdx.y * ZW, z = zb + lane * 4;
  const bool zon = z < Zp;
  float* tile = reinterpret_cast<float*>(smem) + warp * RUN * TS;
  const int* p = ptr + (size_t)a * (U + 1);
  // groups c0 .. c1 hold the voxels with i0 in [c0 - 1, c1 - 1]
  const int e_beg = p[c0], e_end = p[c1 + 1];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 acc0 = zero, acc1 = zero;  // columns cur and cur + 1
  int cur = c0 - 1;

  for (int base = e_beg; base < e_end; base += 32) {
    const int k = base + lane;
    int4 mine = k < e_end ? ent[k] : make_int4(0, 0, 0, 0);
    mine.z = __float_as_int(Operand<T>::weight(__int_as_float(mine.z)));
    mine.w = __float_as_int(Operand<T>::weight(__int_as_float(mine.w)));
    const int cnt = min(32, e_end - base);
    for (int t0 = 0; t0 < cnt; t0 += BATCH) {
      float4 d[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int jj = __shfl_sync(FULL, mine.x, t0 + b);
        d[b] = (zon && t0 + b < cnt)
                   ? Operand<T>::load4(dLt + (size_t)jj * Zp + z)
                   : zero;
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int i0 = __shfl_sync(FULL, mine.y, t0 + b);
        const float w0 = __int_as_float(__shfl_sync(FULL, mine.z, t0 + b));
        const float w1 = __int_as_float(__shfl_sync(FULL, mine.w, t0 + b));
        if (t0 + b < cnt) {
          while (cur < i0) {  // column cur is complete
            if (cur >= c0)
              *reinterpret_cast<float4*>(tile + (cur - c0) * TS + lane * 4) =
                  acc0;
            acc0 = acc1;
            acc1 = zero;
            ++cur;
          }
          acc0 = fma4(w0, d[b], acc0);
          acc1 = fma4(w1, d[b], acc1);
        }
      }
    }
  }
  while (cur < c1) {
    if (cur >= c0)
      *reinterpret_cast<float4*>(tile + (cur - c0) * TS + lane * 4) = acc0;
    acc0 = acc1;
    acc1 = zero;
    ++cur;
  }
  __syncwarp();
  const int nc = c1 - c0, nz = min(ZW, Zf - zb);
  float* o = out + ((size_t)a * Zf + zb) * U + c0;
  for (int idx = lane; idx < nz * nc; idx += 32) {
    const int zz = idx / nc, c = idx - zz * nc;
    o[(size_t)zz * U + c] = tile[c * TS + zz];
  }
}

// dL (Zf, YX) float32 raster; ptr (A * (U + 1) + 1) int32 and ent
// (nnz, 4) int32 the voxel lists; dLt (YX, Zp) scratch of the operand
// type T, Zp = Zf rounded up to 4; out (A, Zf, U) float32, every element
// written. All contiguous, on the device. Returns the CUDA error code of
// the launches.
template <class T>
int bwd_run(const float* dL, const int* ptr, const int* ent, T* dLt,
            float* out, int A, int Zf, int U, int YX, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int Zp = (Zf + 3) / 4 * 4;
  cudaError_t e = transpose<T>(dL, dLt, 1, Zf, Zp, YX, s);
  if (e != cudaSuccess) return (int)e;
  const int smem = BWD_WARPS * RUN * TS * (int)sizeof(float);
  e = cudaFuncSetAttribute(bwd_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int runs = (U + RUN - 1) / RUN;
  const dim3 grid((A * runs + BWD_WARPS - 1) / BWD_WARPS, (Zp + ZW - 1) / ZW);
  bwd_kernel<T><<<grid, BWD_WARPS * 32, smem, s>>>(
      dLt, reinterpret_cast<const int4*>(ent), ptr, out, A, Zf, Zp, U, runs);
  return (int)cudaGetLastError();
}

}  // namespace
