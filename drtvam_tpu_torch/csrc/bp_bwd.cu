// Dense ballistic backprojection, adjoint.
//
// Replaces drtvam_tpu/ops/backproject.py:_bwd_pallas (kernel body
// _make_bwd_kernel): Pzbar[a, z, i] = sum_j dL[z, j] * B_a[i, j], the
// exact transpose of bp_fwd.
//
// Bound on the H100: bytes and shared-memory atomics. dL (67 MB at the
// bench scene) is re-read once per angle; each (angle, voxel, z) issues
// two shared atomics. Design: a block owns (angle, z-chunk) and sweeps
// every voxel of the film, scattering its two taps into a ZC x U
// accumulator in shared memory with shared atomicAdd; then it writes
// its rows of the output once, plainly. The atomics sum in a
// run-dependent order, so results agree with the plain version to f32
// round-off, not bitwise.
#include "backproject_common.cuh"

namespace {

using namespace bp;

template <int ZC>
__global__ void __launch_bounds__(THREADS)
bp_bwd_kernel(const float* __restrict__ dL, const float* __restrict__ F,
              float* __restrict__ out, int Zf, int U, int YX) {
  extern __shared__ float acc[];  // ZC x U
  const int a = blockIdx.x;
  const int z0 = blockIdx.y * ZC;
  const int zn = min(ZC, Zf - z0);
  for (int k = threadIdx.x; k < ZC * U; k += THREADS) acc[k] = 0.0f;
  __syncthreads();
  const float* Wa = F + (size_t)a * 2 * YX;
  const float* ua = Wa + YX;
  const float* dz = dL + (size_t)z0 * YX;
  for (int j = threadIdx.x; j < YX; j += THREADS) {
    const Taps t = make_taps(Wa[j], ua[j], 0, U);
    if (t.w0 == 0.0f && t.w1 == 0.0f) continue;
#pragma unroll
    for (int z = 0; z < ZC; ++z) {
      if (z < zn) {
        const float g = dz[(size_t)z * YX + j];
        if (t.w0 != 0.0f) atomicAdd(&acc[z * U + t.c0], t.w0 * g);
        if (t.w1 != 0.0f) atomicAdd(&acc[z * U + t.c1], t.w1 * g);
      }
    }
  }
  __syncthreads();
  float* o = out + ((size_t)a * Zf + z0) * U;
  for (int k = threadIdx.x; k < zn * U; k += THREADS) o[k] = acc[k];
}

template <int ZC>
int launch(const float* dL, const float* F, float* out, int A, int Zf,
           int U, int YX, cudaStream_t stream) {
  const int smem = ZC * U * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bp_bwd_kernel<ZC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(A, (Zf + ZC - 1) / ZC);
  bp_bwd_kernel<ZC><<<grid, THREADS, smem, stream>>>(dL, F, out, Zf, U, YX);
  return (int)cudaGetLastError();
}

}  // namespace

// dL (Zf, YX), F (A, 2, YX) packed fields, out (A, Zf, U), every element
// written; all float32, contiguous, on the device.
extern "C" int bp_bwd(const float* dL, const float* F, float* out, int A,
                      int Zf, int U, int YX, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (bp::dense_z_chunk(U)) {
    case 32: return launch<32>(dL, F, out, A, Zf, U, YX, s);
    case 16: return launch<16>(dL, F, out, A, Zf, U, YX, s);
    case 8: return launch<8>(dL, F, out, A, Zf, U, YX, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
