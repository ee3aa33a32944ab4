// The windowed backprojection forward, shared by bp_fwd (raster fields)
// and bp_fwd_band (block-major fields):
//
//   dose(Zf, Y*X) = sum_a sum_taps W * Pz[a, z, tap],
//
// where a voxel's taps count only inside its (angle, 32x32 film tile)'s
// column window win[a, tile] = [lo, hi]. The window is computed when the
// fields are packed (ops/backproject.py tile_windows) from the taps the
// function keeps: those in [0, U) for bp_fwd, those in the voxel's band
// for bp_fwd_band. So the window holds exactly the kept taps, and
// make_taps with the window as its range drops exactly the others.
//
// Design:
// - A block owns a compact 32x32 film tile x ZC z-rows and loops over
//   the angles. At one angle a tile's taps fall in a narrow column
//   window; only that window of Pz is staged, not all U columns.
// - The window is staged z-innermost (column stride ZC + 4 floats), so
//   one 16-byte shared load gives a tap four z-rows, and the 8 lanes of
//   a load phase (8 neighbouring voxels) hit distinct banks.
// - Staging is double-buffered with cp.async: angle a+1's window is in
//   flight while angle a is summed, and angle a+1's fields are loaded
//   into registers meanwhile. The staging order puts 8 columns x
//   4 z-rows on a warp, so the global reads fill 32-byte sectors and
//   the shared writes are conflict-free.
// - The grid runs the tiles of one z-chunk first, so the blocks in
//   flight share one z-slab of Pz (A x ZC x U floats) in L2.
// - The sums stay in registers and each output element is written once,
//   in a fixed order: no atomics, bitwise reproducible.
//
// The template is parametrised only on how a voxel's fields are
// addressed: Fields::index(y, x, X) is voxel (y, x)'s position in one
// angle's row F[a, 0 | 1, :]. The dose is always written in raster order.
#pragma once

#include "backproject_common.cuh"

// Internal linkage: every source that includes this header is built
// into a shared library of its own.
namespace {

using namespace bp;

constexpr int FT = 32;              // film tile edge (FT x FT voxels)
constexpr int FWD_THREADS = 512;
constexpr int ROWS = FWD_THREADS / 32;      // tile rows per pass
constexpr int VPT = FT * FT / FWD_THREADS;  // voxels per thread

// floats between two staged columns: ZC z-rows plus 4 of padding, which
// keeps 16-byte alignment and spreads neighbouring columns over banks
template <int ZC>
constexpr int kColStride = ZC >= 8 ? ZC + 4 : ZC;

// Issue the copies of Pz[a, z0:z0+zn, lo:lo+n] into buf[c * S + z].
template <int ZC>
__device__ __forceinline__ void stage(float* buf, const float* Pz, int a,
                                      int z0, int zn, int Zf, int U, int lo,
                                      int n) {
  constexpr int S = kColStride<ZC>;
  constexpr int ZQ = ZC / 4;  // groups of 4 z-rows
  const int items = ((n + 7) / 8) * ZQ * 32;
  const float* src = Pz + ((size_t)a * Zf + z0) * U + lo;
  for (int idx = threadIdx.x; idx < items; idx += FWD_THREADS) {
    const int l = idx & 31, blk = idx >> 5;
    const int c = (blk / ZQ) * 8 + (l & 7);
    const int z = (blk % ZQ) * 4 + (l >> 3);
    if (c < n && z < zn) cp_async4(buf + c * S + z, src + (size_t)z * U + c);
  }
}

template <int ZC, class Fields>
__global__ void __launch_bounds__(FWD_THREADS, 1)
fwd_kernel(const float* __restrict__ Pz, const float* __restrict__ F,
           const int2* __restrict__ win, float* __restrict__ out, int A,
           int Zf, int U, int Y, int X, int maxw) {
  constexpr int S = kColStride<ZC>;
  extern __shared__ float4 smem[];
  float* const buf0 = reinterpret_cast<float*>(smem);
  float* const buf1 = buf0 + (size_t)maxw * S;
  const int T = gridDim.x, tile = blockIdx.x;
  const int tiles_x = (X + FT - 1) / FT;
  const int y0 = (tile / tiles_x) * FT, x0 = (tile % tiles_x) * FT;
  const int z0 = blockIdx.y * ZC, zn = min(ZC, Zf - z0);
  const int YX = Y * X;
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;

  int j[VPT], fj[VPT];  // raster index; position in the fields
  bool on[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int y = y0 + row + v * ROWS, x = x0 + lane;
    on[v] = y < Y && x < X;
    j[v] = on[v] ? y * X + x : 0;
    fj[v] = on[v] ? Fields::index(y, x, X) : 0;
  }
  float acc[VPT][ZC];
#pragma unroll
  for (int v = 0; v < VPT; ++v)
#pragma unroll
    for (int z = 0; z < ZC; ++z) acc[v][z] = 0.0f;

  // Prefetch: angle a + 1's window is staged and its fields are loaded
  // into registers while angle a is summed; angle a + 2's window bounds
  // are loaded one step earlier still, since the staging needs them.
  const float* Wa = F;  // fields of the next angle: F[a + 1, 0 | 1, :]
  const int2* w_tile = win + tile;  // win[a * T + tile] = (lo, hi)
  int2 cur = w_tile[0];
  int2 nxt = A > 1 ? w_tile[T] : make_int2(0, -1);
  stage<ZC>(buf0, Pz, 0, z0, zn, Zf, U, cur.x, cur.y - cur.x + 1);
  cp_async_commit();
  float Wv[VPT], uv[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    Wv[v] = on[v] ? F[fj[v]] : 0.0f;
    uv[v] = on[v] ? F[YX + fj[v]] : -2.0f;
  }
  for (int a = 0; a < A; ++a) {
    int2 nxt2 = make_int2(0, -1);
    float Wn[VPT], un[VPT];
    if (a + 1 < A) {
      stage<ZC>((a & 1) ? buf0 : buf1, Pz, a + 1, z0, zn, Zf, U, nxt.x,
                nxt.y - nxt.x + 1);
      if (a + 2 < A) nxt2 = w_tile[(size_t)(a + 2) * T];
      Wa = F + (size_t)(a + 1) * 2 * YX;
    }
    cp_async_commit();  // possibly empty: keeps one group per angle
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      const bool ld = on[v] && a + 1 < A;
      Wn[v] = ld ? Wa[fj[v]] : 0.0f;
      un[v] = ld ? Wa[YX + fj[v]] : -2.0f;
    }
    cp_async_wait<1>();  // this angle's window has landed
    __syncthreads();
    const int n = cur.y - cur.x + 1;
    if (n > 0) {
      const float* buf = (a & 1) ? buf1 : buf0;
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        // the window holds every kept tap of the tile, so a tap outside
        // it is one the function drops: make_taps gives it weight 0
        const Taps t = make_taps(Wv[v], uv[v], cur.x, n);
        if (t.w0 != 0.0f || t.w1 != 0.0f) {
          const float4* p0 = reinterpret_cast<const float4*>(buf + t.c0 * S);
          const float4* p1 = reinterpret_cast<const float4*>(buf + t.c1 * S);
#pragma unroll
          for (int q = 0; q < ZC / 4; ++q) {
            const float4 g0 = p0[q], g1 = p1[q];
            acc[v][4 * q + 0] += t.w0 * g0.x + t.w1 * g1.x;
            acc[v][4 * q + 1] += t.w0 * g0.y + t.w1 * g1.y;
            acc[v][4 * q + 2] += t.w0 * g0.z + t.w1 * g1.z;
            acc[v][4 * q + 3] += t.w0 * g0.w + t.w1 * g1.w;
          }
        }
      }
    }
    __syncthreads();  // buffer a & 1 is refilled with angle a + 2 next
    cur = nxt;
    nxt = nxt2;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      Wv[v] = Wn[v];
      uv[v] = un[v];
    }
  }
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    if (on[v]) {
#pragma unroll
      for (int z = 0; z < ZC; ++z)
        if (z < zn) out[(size_t)(z0 + z) * YX + j[v]] = acc[v][z];
    }
  }
}

template <int ZC, class Fields>
int fwd_launch(const float* Pz, const float* F, const int2* win, float* out,
               int A, int Zf, int U, int Y, int X, int maxw,
               cudaStream_t stream) {
  const int smem = 2 * maxw * kColStride<ZC> * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fwd_kernel<ZC, Fields>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((Y + FT - 1) / FT) * ((X + FT - 1) / FT),
                  (Zf + ZC - 1) / ZC);
  fwd_kernel<ZC, Fields><<<grid, FWD_THREADS, smem, stream>>>(
      Pz, F, win, out, A, Zf, U, Y, X, maxw);
  return (int)cudaGetLastError();
}

// the largest z-chunk whose two window buffers fit in shared memory
int fwd_z_chunk(int maxw) {
  const long cap = 227L * 1024;
  if (2L * maxw * kColStride<32> * 4 <= cap) return 32;
  if (2L * maxw * kColStride<16> * 4 <= cap) return 16;
  if (2L * maxw * kColStride<8> * 4 <= cap) return 8;
  if (2L * maxw * kColStride<4> * 4 <= cap) return 4;
  return 0;
}

// Pz (A, Zf, U); F (A, 2, Y*X) packed fields, addressed by Fields; win
// (A, T, 2) int32 per-(angle, 32x32 tile) column windows [lo, hi]
// (lo > hi: no taps), T = ceil(Y/32) * ceil(X/32), maxw the widest
// window; out (Zf, Y*X) raster, every element written. All contiguous,
// on the device. Returns the CUDA error code of the launch.
template <class Fields>
int fwd_run(const float* Pz, const float* F, const int* win, float* out,
            int A, int Zf, int U, int Y, int X, int maxw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int2* w = reinterpret_cast<const int2*>(win);
  if (maxw < 1) maxw = 1;
  switch (fwd_z_chunk(maxw)) {
    case 32: return fwd_launch<32, Fields>(Pz, F, w, out, A, Zf, U, Y, X,
                                           maxw, s);
    case 16: return fwd_launch<16, Fields>(Pz, F, w, out, A, Zf, U, Y, X,
                                           maxw, s);
    case 8: return fwd_launch<8, Fields>(Pz, F, w, out, A, Zf, U, Y, X,
                                         maxw, s);
    case 4: return fwd_launch<4, Fields>(Pz, F, w, out, A, Zf, U, Y, X,
                                         maxw, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
