// The windowed backprojection forward, shared by bp_fwd (raster fields)
// and bp_fwd_band (block-major fields), and by their bf16 operand forms
// bp_fwd_bf16 and bp_fwd_band_bf16:
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
// - The window is staged z-innermost (column stride ZC plus padding),
//   so one 16-byte shared load gives a tap four float32 z-rows (eight
//   bfloat16 ones), and the 8 lanes of a load phase (8 neighbouring
//   voxels) hit distinct banks.
// - Staging is double-buffered with cp.async: angle a+1's window is in
//   flight while angle a is summed, and angle a+1's fields are loaded
//   into registers meanwhile. float32 Pz (A, Zf, U) is staged in 4-byte
//   copies, 8 columns x 4 z-rows a warp, so the global reads fill
//   32-byte sectors and the shared writes are conflict-free. The bf16
//   form first rounds Pz into a copy laid out (A, U, Zp), z innermost
//   (transpose, backproject_common.cuh), and stages 16-byte copies of
//   its z-lines.
// - The grid runs the tiles of one z-chunk first, so the blocks in
//   flight share one z-slab of Pz in L2.
// - The sums stay in float32 registers and each output element is
//   written once, in a fixed order: no atomics, bitwise reproducible.
//
// The template is parametrised on the operand type T (float or
// __nv_bfloat16) and on how a voxel's fields are addressed:
// Fields::index(y, x, X) is voxel (y, x)'s position in one angle's row
// F[a, 0 | 1, :]. The dose is always written in raster order.
#pragma once

#include <type_traits>

#include "backproject_common.cuh"

// Internal linkage: every source that includes this header is built
// into a shared library of its own.
namespace {

using namespace bp;

constexpr int FT = 32;              // film tile edge (FT x FT voxels)
constexpr int FWD_THREADS = 512;
constexpr int ROWS = FWD_THREADS / 32;      // tile rows per pass
constexpr int VPT = FT * FT / FWD_THREADS;  // voxels per thread

// values between two staged columns: ZC z-rows plus 16 bytes of padding,
// which keeps 16-byte alignment and spreads neighbouring columns over
// banks
template <class T, int ZC>
constexpr int kColStride =
    ZC >= 2 * Operand<T>::kVec ? ZC + Operand<T>::kVec : ZC;

// Issue the copies of Pz[a, z0:z0+zn, lo:lo+n] into buf[c * S + z];
// float32 Pz is (A, Zp, U) with Zp = Zf.
template <int ZC>
__device__ __forceinline__ void stage(float* buf, const float* Pz, int a,
                                      int z0, int zn, int Zp, int U, int lo,
                                      int n) {
  constexpr int S = kColStride<float, ZC>;
  constexpr int ZQ = ZC / 4;  // groups of 4 z-rows
  const int items = ((n + 7) / 8) * ZQ * 32;
  const float* src = Pz + ((size_t)a * Zp + z0) * U + lo;
  for (int idx = threadIdx.x; idx < items; idx += FWD_THREADS) {
    const int l = idx & 31, blk = idx >> 5;
    const int c = (blk / ZQ) * 8 + (l & 7);
    const int z = (blk % ZQ) * 4 + (l >> 3);
    if (c < n && z < zn) cp_async4(buf + c * S + z, src + (size_t)z * U + c);
  }
}

// The same from the bf16 copy Pt (A, U, Zp), Zp a multiple of 8: each
// column's z-rows z0 .. z0 + zn are one run of 16-byte pieces.
template <int ZC>
__device__ __forceinline__ void stage(__nv_bfloat16* buf,
                                      const __nv_bfloat16* Pt, int a, int z0,
                                      int zn, int Zp, int U, int lo, int n) {
  constexpr int S = kColStride<__nv_bfloat16, ZC>;
  constexpr int ZQ = ZC / 8;  // 16-byte pieces of a staged column
  const int zq = (zn + 7) / 8;
  const __nv_bfloat16* src = Pt + ((size_t)a * U + lo) * Zp + z0;
  for (int idx = threadIdx.x; idx < n * ZQ; idx += FWD_THREADS) {
    const int c = idx / ZQ, q = idx - c * ZQ;
    if (q < zq) cp_async16(buf + c * S + q * 8, src + (size_t)c * Zp + q * 8);
  }
}

template <class T, int ZC, class Fields>
__global__ void __launch_bounds__(FWD_THREADS, 1)
fwd_kernel(const T* __restrict__ Pz, const float* __restrict__ F,
           const int2* __restrict__ win, float* __restrict__ out, int A,
           int Zf, int Zp, int U, int Y, int X, int maxw) {
  constexpr int S = kColStride<T, ZC>;
  constexpr int V = Operand<T>::kVec;
  static_assert(ZC % V == 0, "a z-chunk is whole 16-byte loads");
  extern __shared__ float4 smem[];
  T* const buf0 = reinterpret_cast<T*>(smem);
  T* const buf1 = buf0 + (size_t)maxw * S;
  const int ntiles = gridDim.x, tile = blockIdx.x;
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
  const int2* w_tile = win + tile;  // win[a * ntiles + tile] = (lo, hi)
  int2 cur = w_tile[0];
  int2 nxt = A > 1 ? w_tile[ntiles] : make_int2(0, -1);
  stage<ZC>(buf0, Pz, 0, z0, zn, Zp, U, cur.x, cur.y - cur.x + 1);
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
      stage<ZC>((a & 1) ? buf0 : buf1, Pz, a + 1, z0, zn, Zp, U, nxt.x,
                nxt.y - nxt.x + 1);
      if (a + 2 < A) nxt2 = w_tile[(size_t)(a + 2) * ntiles];
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
      const T* buf = (a & 1) ? buf1 : buf0;
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        // the window holds every kept tap of the tile, so a tap outside
        // it is one the function drops: make_taps gives it weight 0
        const Taps t = make_taps(Wv[v], uv[v], cur.x, n);
        const float w0 = Operand<T>::weight(t.w0);
        const float w1 = Operand<T>::weight(t.w1);
        if (w0 != 0.0f || w1 != 0.0f) {
          const T* p0 = buf + t.c0 * S;
          const T* p1 = buf + t.c1 * S;
#pragma unroll
          for (int q = 0; q < ZC / V; ++q) {
            float g0[V], g1[V];
            Operand<T>::load16(p0 + q * V, g0);
            Operand<T>::load16(p1 + q * V, g1);
#pragma unroll
            for (int k = 0; k < V; ++k)
              acc[v][V * q + k] += w0 * g0[k] + w1 * g1[k];
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

template <class T, int ZC, class Fields>
int fwd_launch(const T* P, const float* F, const int2* win, float* out,
               int A, int Zf, int Zp, int U, int Y, int X, int maxw,
               cudaStream_t stream) {
  const int smem = 2 * maxw * kColStride<T, ZC> * (int)sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      fwd_kernel<T, ZC, Fields>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((Y + FT - 1) / FT) * ((X + FT - 1) / FT),
                  (Zf + ZC - 1) / ZC);
  fwd_kernel<T, ZC, Fields><<<grid, FWD_THREADS, smem, stream>>>(
      P, F, win, out, A, Zf, Zp, U, Y, X, maxw);
  return (int)cudaGetLastError();
}

// the largest z-chunk whose two window buffers fit in shared memory
// (at least one 16-byte load of z-rows)
template <class T>
int fwd_z_chunk(int maxw) {
  const long cap = 227L * 1024;
  for (int zc = 32; zc >= Operand<T>::kVec; zc /= 2) {
    const long S = zc >= 2 * Operand<T>::kVec ? zc + Operand<T>::kVec : zc;
    if (2L * maxw * S * (long)sizeof(T) <= cap) return zc;
  }
  return 0;
}

// Pz (A, Zf, U) float32; F (A, 2, Y*X) packed fields, addressed by
// Fields; win (A, NT, 2) int32 per-(angle, 32x32 tile) column windows
// [lo, hi] (lo > hi: no taps), NT = ceil(Y/32) * ceil(X/32), maxw the
// widest window; out (Zf, Y*X) raster, every element written. With
// T = __nv_bfloat16, Pt is scratch (A, U, Zp), Zp = Zf rounded up to 8,
// into which Pz is first rounded; with T = float it is unused. All
// contiguous, on the device. Returns the CUDA error code of the launches.
template <class T, class Fields>
int fwd_run(const float* Pz, const float* F, const int* win, T* Pt,
            float* out, int A, int Zf, int U, int Y, int X, int maxw,
            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int2* w = reinterpret_cast<const int2*>(win);
  if (maxw < 1) maxw = 1;
  const T* P;
  int Zp;
  if constexpr (std::is_same_v<T, float>) {
    P = Pz;
    Zp = Zf;
  } else {
    Zp = (Zf + 7) / 8 * 8;
    const cudaError_t e = transpose<T>(Pz, Pt, A, Zf, Zp, U, s);
    if (e != cudaSuccess) return (int)e;
    P = Pt;
  }
  switch (fwd_z_chunk<T>(maxw)) {
    case 32: return fwd_launch<T, 32, Fields>(P, F, w, out, A, Zf, Zp, U, Y,
                                              X, maxw, s);
    case 16: return fwd_launch<T, 16, Fields>(P, F, w, out, A, Zf, Zp, U, Y,
                                              X, maxw, s);
    case 8: return fwd_launch<T, 8, Fields>(P, F, w, out, A, Zf, Zp, U, Y, X,
                                            maxw, s);
    case 4:
      if constexpr (std::is_same_v<T, float>)
        return fwd_launch<T, 4, Fields>(P, F, w, out, A, Zf, Zp, U, Y, X,
                                        maxw, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

// voxel (y, x)'s position in raster fields (bp_fwd, bp_fwd_bf16)
struct RasterFields {
  __device__ static int index(int y, int x, int X) { return y * X + x; }
};

constexpr int BY = 32, BX = 64;  // film block of the banded layout

// voxel (y, x)'s position in block-major fields (bp_fwd_band,
// bp_fwd_band_bf16): block (y / BY, x / BX) row-major, then
// (y % BY, x % BX) row-major inside it
struct BlockMajorFields {
  __device__ static int index(int y, int x, int X) {
    return ((y / BY) * (X / BX) + x / BX) * (BY * BX) + (y % BY) * BX +
           x % BX;
  }
};

}  // namespace
