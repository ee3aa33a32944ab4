// Banded ballistic backprojection, forward.
//
// Replaces drtvam_tpu/ops/backproject.py:_fwd_banded (kernel body
// _make_fwd_banded_kernel). Same forward as bp_fwd, with the film tiled
// into 32 x 64 blocks: each (angle, block) only touches the 256 DMD
// columns from its band start u0[a, block] (a multiple of 128, see
// pack_fields_banded), so each block stages 256 columns of Pz instead
// of all U.
//
// Operands and bound as bp_fwd (Pz 164 MB, fields 210 MB at the bench
// scene; shared-memory tap reads and Pz staging on the H100). Design: a
// block owns a quarter of one 32 x 64 film block (512
// voxels) x 32 z-rows and loops over the angles, staging the band
// Pz[a, z-chunk, u0 : u0 + 256] (32 KB) in shared memory and
// accumulating in registers; no atomics, each output element written
// once, directly at its raster position (the JAX version un-permutes
// the block-major result in a separate pass).
#include "backproject_common.cuh"

namespace {

using namespace bp;
constexpr int ZC = 32;
constexpr int VPT = 2;
constexpr int PARTS = TILE_B / (THREADS * VPT);  // blocks per film block

__global__ void __launch_bounds__(THREADS)
bp_fwd_band_kernel(const float* __restrict__ Pz, const float* __restrict__ F,
                   const int* __restrict__ u0, float* __restrict__ out,
                   int A, int Zf, int U, int Y, int X) {
  __shared__ float slab[ZC * BANDW];
  const int ntx = X / BX;
  const int T = (Y / BY) * ntx;
  const int t = blockIdx.x / PARTS;
  const int e_base = (blockIdx.x % PARTS) * THREADS * VPT + threadIdx.x;
  const int z0 = blockIdx.y * ZC;
  const int zn = min(ZC, Zf - z0);
  const size_t L = (size_t)T * TILE_B;  // field length of one angle
  float acc[VPT][ZC];
#pragma unroll
  for (int v = 0; v < VPT; ++v)
#pragma unroll
    for (int z = 0; z < ZC; ++z) acc[v][z] = 0.0f;

  for (int a = 0; a < A; ++a) {
    const int b = u0[(size_t)a * T + t];
    const int n = min(BANDW, U - b);  // band columns inside [0, U)
    const float* src = Pz + ((size_t)a * Zf + z0) * U + b;
    __syncthreads();
    for (int k = threadIdx.x; k < ZC * BANDW; k += THREADS) {
      const int z = k / BANDW, c = k % BANDW;
      slab[k] = (z < zn && c < n) ? src[(size_t)z * U + c] : 0.0f;
    }
    __syncthreads();
    const float* Wa = F + (size_t)a * 2 * L + (size_t)t * TILE_B;
    const float* ua = Wa + L;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const int e = e_base + v * THREADS;
      const Taps tp = make_taps(Wa[e], ua[e], b, n);
      if (tp.w0 != 0.0f || tp.w1 != 0.0f) {
#pragma unroll
        for (int z = 0; z < ZC; ++z)
          acc[v][z] += tp.w0 * slab[z * BANDW + tp.c0] +
                       tp.w1 * slab[z * BANDW + tp.c1];
      }
    }
  }
  const int row0 = (t / ntx) * BY, col0 = (t % ntx) * BX;
  const size_t YX = (size_t)Y * X;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int e = e_base + v * THREADS;
    const size_t p = (size_t)(row0 + e / BX) * X + col0 + e % BX;
#pragma unroll
    for (int z = 0; z < ZC; ++z)
      if (z < zn) out[(size_t)(z0 + z) * YX + p] = acc[v][z];
  }
}

}  // namespace

// Pz (A, Zf, U); F (A, 2, T * 2048) block-major packed fields; u0 (A, T)
// int32 band starts; out (Zf, Y * X) raster. Y % 32 == 0, X % 64 == 0.
extern "C" int bp_fwd_band(const float* Pz, const float* F, const int* u0,
                           float* out, int A, int Zf, int U, int Y, int X,
                           void* stream) {
  const int T = (Y / bp::BY) * (X / bp::BX);
  const dim3 grid(T * PARTS, (Zf + ZC - 1) / ZC);
  bp_fwd_band_kernel<<<grid, bp::THREADS, 0, (cudaStream_t)stream>>>(
      Pz, F, u0, out, A, Zf, U, Y, X);
  return (int)cudaGetLastError();
}
