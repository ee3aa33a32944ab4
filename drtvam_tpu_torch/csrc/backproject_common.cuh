// Shared pieces of the four ballistic backprojection kernels.
//
// Forward:  dose(Zf, YX)    = sum_a Pz_a(Zf, U) @ B_a(U, YX)
// Adjoint:  Pzbar_a(Zf, U)  = dL(Zf, YX) @ B_a^T
// B_a[i, j] = W_aj * max(0, 1 - |u_aj - i|) has two nonzeros per column
// j: the linear-interpolation taps at i0 = floor(u_aj) and i0 + 1. On
// the TPU B is built densely in VMEM and contracted on the MXU, because
// gathers are slow there; here each kernel applies the two taps
// directly. A dense B on wgmma would do U/2 times the useful work, so
// the kernels stay on FMAs and spend their design on memory traffic.
//
// Two kernel templates serve the eight entry points: the windowed
// forward (bp_fwd_kernel.cuh) and the gather adjoint
// (bp_bwd_kernel.cuh). The banded pair differs from the dense one only
// in which taps count, and that is fixed by the layout the engine builds
// (column windows, voxel lists), not by the kernels. Both templates take
// the type of the streamed operand (Pz or dL) as a parameter: float, or
// __nv_bfloat16 for the bf16 operand form (the JAX package's bf16=True
// kernels). The bf16 form rounds the operand and each tap weight to
// bfloat16 and accumulates in float32, as the MXU does there.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bp {

// float32 -> bfloat16 -> float32, rounding to nearest even: the rounding
// of torch's and the JAX package's casts.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the two bfloat16 halves of a 32-bit word as float32 (element 0 is the
// low half)
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// How a kernel reads its streamed operand of type T: kVec values per
// 16-byte load (load16), four values per lane of a warp's z-line
// (load4, read-only cache), the tap weight as it multiplies (weight:
// rounded to bfloat16 in the bf16 form), and the store from float32
// (store: rounded to nearest even in the bf16 form).
template <class T>
struct Operand;

template <>
struct Operand<float> {
  static constexpr int kVec = 4;
  __device__ static float weight(float w) { return w; }
  __device__ static float store(float x) { return x; }
  __device__ static void load16(const float* p, float (&v)[4]) {
    const float4 g = *reinterpret_cast<const float4*>(p);
    v[0] = g.x;
    v[1] = g.y;
    v[2] = g.z;
    v[3] = g.w;
  }
  __device__ static float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
};

template <>
struct Operand<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float weight(float w) { return bf16_round(w); }
  __device__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ static void load16(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 g = *reinterpret_cast<const uint4*>(p);
    v[0] = bf16_lo(g.x);
    v[1] = bf16_hi(g.x);
    v[2] = bf16_lo(g.y);
    v[3] = bf16_hi(g.y);
    v[4] = bf16_lo(g.z);
    v[5] = bf16_hi(g.z);
    v[6] = bf16_lo(g.w);
    v[7] = bf16_hi(g.w);
  }
  __device__ static float4 load4(const __nv_bfloat16* p) {
    const uint2 g = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(bf16_lo(g.x), bf16_hi(g.x), bf16_lo(g.y),
                       bf16_hi(g.y));
  }
};

struct Taps {
  int c0, c1;    // tap columns relative to the column base
  float w0, w1;  // tap weights, 0 for a tap outside [base, base + n)
};

// The two taps of one field cell (W, u). A tap is kept only if its
// column i lies in [base, base + n); a dropped tap gets weight 0 and
// relative column 0, so it contributes exactly nothing. Empty cells and
// padding carry W = 0 and u = -2: both taps fall outside any range.
// The weights are the plain version's W * (1 - f) and W * f, each
// operation rounded on its own (no contraction), so that the bf16 form
// rounds the same float32 weight as the plain version does.
__device__ __forceinline__ Taps make_taps(float W, float u, int base,
                                          int n) {
  const float fl = floorf(u);
  const int i0 = (int)fl - base;
  const float f = __fsub_rn(u, fl);
  const bool ok0 = i0 >= 0 && i0 < n;
  const bool ok1 = i0 + 1 >= 0 && i0 + 1 < n;
  Taps t;
  t.c0 = ok0 ? i0 : 0;
  t.w0 = ok0 ? __fmul_rn(W, __fsub_rn(1.0f, f)) : 0.0f;
  t.c1 = ok1 ? i0 + 1 : 0;
  t.w1 = ok1 ? __fmul_rn(W, f) : 0.0f;
  return t;
}

// src (B, R, C) float32 -> dst (B, C, Rp) of type T, R innermost, rows
// R..Rp written as 0; T = __nv_bfloat16 rounds to nearest even. One
// 32 x 32 tile per block of 32 x 8 threads, grid (C/32, Rp/32, B).
template <class T>
__global__ void transpose_kernel(const float* __restrict__ src,
                                 T* __restrict__ dst, int R, int Rp, int C) {
  __shared__ float t[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const float* s = src + (size_t)blockIdx.z * R * C;
  T* d = dst + (size_t)blockIdx.z * C * Rp;
  for (int k = threadIdx.y; k < 32; k += 8) {
    const int r = r0 + k, c = c0 + threadIdx.x;
    t[k][threadIdx.x] = (r < R && c < C) ? s[(size_t)r * C + c] : 0.0f;
  }
  __syncthreads();
  for (int k = threadIdx.y; k < 32; k += 8) {
    const int c = c0 + k, r = r0 + threadIdx.x;
    if (c < C && r < Rp)
      d[(size_t)c * Rp + r] = Operand<T>::store(t[threadIdx.x][k]);
  }
}

template <class T>
cudaError_t transpose(const float* src, T* dst, int B, int R, int Rp, int C,
                      cudaStream_t s) {
  transpose_kernel<T><<<dim3((C + 31) / 32, (Rp + 31) / 32, B), dim3(32, 8),
                        0, s>>>(src, dst, R, Rp, C);
  return cudaGetLastError();
}

// Asynchronous 4-byte copy global -> shared (cp.async, Ampere and
// later), and its group commit / wait.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Asynchronous 16-byte copy global -> shared; both addresses 16-byte
// aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace bp
