// Dense ballistic backprojection, forward.
//
// Replaces drtvam_tpu/ops/backproject.py:_fwd_pallas (kernel body
// _make_fwd_kernel): dose(Zf, YX) = sum_a sum_taps W * Pz[a, z, tap].
//
// Operands at the bench scene: Pz 164 MB and the packed (W, u) fields
// 210 MB, against 2 FMAs per (angle, voxel, z). Measured on the H100 the
// kernel is bound by the shared-memory tap reads and the per-angle
// staging of Pz (PERF.md), not by HBM.
// Design: a block owns 512 voxels x a z-chunk and loops over the angles.
// It stages the slab Pz[a, z-chunk, 0:U] in shared memory once per
// angle, reads each voxel's (W, u) once per angle, and accumulates in
// registers; no atomics, and each output element is written once. Pz
// is re-read once per 512-voxel tile (from L2 mostly), the fields once
// per z-chunk.
#include "backproject_common.cuh"

namespace {

using namespace bp;
constexpr int VPT = 2;  // voxels per thread
constexpr int TV = THREADS * VPT;

template <int ZC>
__global__ void __launch_bounds__(THREADS)
bp_fwd_kernel(const float* __restrict__ Pz, const float* __restrict__ F,
              float* __restrict__ out, int A, int Zf, int U, int YX) {
  extern __shared__ float slab[];  // ZC x U
  const int j_base = blockIdx.x * TV + threadIdx.x;
  const int z0 = blockIdx.y * ZC;
  const int zn = min(ZC, Zf - z0);
  float acc[VPT][ZC];
#pragma unroll
  for (int v = 0; v < VPT; ++v)
#pragma unroll
    for (int z = 0; z < ZC; ++z) acc[v][z] = 0.0f;

  for (int a = 0; a < A; ++a) {
    const float* src = Pz + ((size_t)a * Zf + z0) * U;
    __syncthreads();  // the previous angle's slab is consumed
    for (int k = threadIdx.x; k < ZC * U; k += THREADS)
      slab[k] = k < zn * U ? src[k] : 0.0f;
    __syncthreads();
    const float* Wa = F + (size_t)a * 2 * YX;
    const float* ua = Wa + YX;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int j = j_base + v * THREADS;
      if (j < YX) {
        const Taps t = make_taps(Wa[j], ua[j], 0, U);
        if (t.w0 != 0.0f || t.w1 != 0.0f) {
#pragma unroll
          for (int z = 0; z < ZC; ++z)
            acc[v][z] += t.w0 * slab[z * U + t.c0] +
                         t.w1 * slab[z * U + t.c1];
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int j = j_base + v * THREADS;
    if (j < YX) {
#pragma unroll
      for (int z = 0; z < ZC; ++z)
        if (z < zn) out[(size_t)(z0 + z) * YX + j] = acc[v][z];
    }
  }
}

template <int ZC>
int launch(const float* Pz, const float* F, float* out, int A, int Zf,
           int U, int YX, cudaStream_t stream) {
  const int smem = ZC * U * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bp_fwd_kernel<ZC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((YX + TV - 1) / TV, (Zf + ZC - 1) / ZC);
  bp_fwd_kernel<ZC><<<grid, THREADS, smem, stream>>>(Pz, F, out, A, Zf, U,
                                                      YX);
  return (int)cudaGetLastError();
}

}  // namespace

// Pz (A, Zf, U), F (A, 2, YX) packed fields, out (Zf, YX); all float32,
// contiguous, on the device. Returns the CUDA error code of the launch.
extern "C" int bp_fwd(const float* Pz, const float* F, float* out, int A,
                      int Zf, int U, int YX, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (bp::dense_z_chunk(U)) {
    case 32: return launch<32>(Pz, F, out, A, Zf, U, YX, s);
    case 16: return launch<16>(Pz, F, out, A, Zf, U, YX, s);
    case 8: return launch<8>(Pz, F, out, A, Zf, U, YX, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
