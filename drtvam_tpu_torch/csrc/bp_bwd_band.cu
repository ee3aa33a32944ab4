// Banded ballistic backprojection, adjoint.
//
// Replaces drtvam_tpu/ops/backproject.py:_bwd_banded (kernel body
// _make_bwd_banded_kernel): the exact transpose of bp_fwd_band, each
// (angle, 32 x 64 film block) adding into Pzbar[a, :, u0 : u0 + 256].
//
// Bound on the H100: bytes (dL, 67 MB at the bench scene, re-read once
// per angle) and atomics. Design: a block owns (angle, film block,
// z-chunk of 32 rows). It scatters each voxel's two taps into a 32 x 256
// band accumulator in shared memory (shared atomicAdd), then adds the
// nonzero part of its band into the output with global atomicAdd,
// because the bands of one angle's film blocks overlap. The output must
// be zeroed by the caller. Atomics sum in a run-dependent order, so
// results agree with the plain version to f32 round-off, not bitwise.
#include "backproject_common.cuh"

namespace {

using namespace bp;
constexpr int ZC = 32;

__global__ void __launch_bounds__(THREADS)
bp_bwd_band_kernel(const float* __restrict__ dL, const float* __restrict__ F,
                   const int* __restrict__ u0, float* __restrict__ out,
                   int Zf, int U, int Y, int X) {
  __shared__ float acc[ZC * BANDW];
  const int ntx = X / BX;
  const int T = (Y / BY) * ntx;
  const int a = blockIdx.x / T;
  const int t = blockIdx.x % T;
  const int z0 = blockIdx.y * ZC;
  const int zn = min(ZC, Zf - z0);
  const size_t L = (size_t)T * TILE_B;
  const size_t YX = (size_t)Y * X;
  for (int k = threadIdx.x; k < ZC * BANDW; k += THREADS) acc[k] = 0.0f;
  __syncthreads();

  const int b = u0[(size_t)a * T + t];
  const int n = min(BANDW, U - b);
  const float* Wa = F + (size_t)a * 2 * L + (size_t)t * TILE_B;
  const float* ua = Wa + L;
  const int row0 = (t / ntx) * BY, col0 = (t % ntx) * BX;
  const float* dz = dL + (size_t)z0 * YX;
  for (int e = threadIdx.x; e < TILE_B; e += THREADS) {
    const Taps tp = make_taps(Wa[e], ua[e], b, n);
    if (tp.w0 == 0.0f && tp.w1 == 0.0f) continue;
    const size_t p = (size_t)(row0 + e / BX) * X + col0 + e % BX;
#pragma unroll
    for (int z = 0; z < ZC; ++z) {
      if (z < zn) {
        const float g = dz[(size_t)z * YX + p];
        if (tp.w0 != 0.0f) atomicAdd(&acc[z * BANDW + tp.c0], tp.w0 * g);
        if (tp.w1 != 0.0f) atomicAdd(&acc[z * BANDW + tp.c1], tp.w1 * g);
      }
    }
  }
  __syncthreads();
  float* o = out + ((size_t)a * Zf + z0) * U + b;
  for (int k = threadIdx.x; k < ZC * BANDW; k += THREADS) {
    const int z = k / BANDW, c = k % BANDW;
    const float v = acc[k];
    if (z < zn && c < n && v != 0.0f) atomicAdd(&o[(size_t)z * U + c], v);
  }
}

}  // namespace

// dL (Zf, Y * X) raster; F (A, 2, T * 2048) block-major packed fields;
// u0 (A, T) int32; out (A, Zf, U) zero-initialized. Y % 32 == 0,
// X % 64 == 0.
extern "C" int bp_bwd_band(const float* dL, const float* F, const int* u0,
                           float* out, int A, int Zf, int U, int Y, int X,
                           void* stream) {
  const int T = (Y / bp::BY) * (X / bp::BX);
  const dim3 grid(A * T, (Zf + ZC - 1) / ZC);
  bp_bwd_band_kernel<<<grid, bp::THREADS, 0, (cudaStream_t)stream>>>(
      dL, F, u0, out, Zf, U, Y, X);
  return (int)cudaGetLastError();
}
