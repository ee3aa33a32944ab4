// The card's rate of float atomic adds into a float32 grid (the dda
// walk's deposits): each thread makes `per_thread` reductions
// (red.global.add.f32: an atomicAdd whose result is unused) at
//   kind 0: uniformly scattered voxels of a res^3 grid (a hash each), or
//   kind 1: the voxels along a straight line from a random voxel in a
//           random direction, one voxel length a step (wrapping at the
//           faces): the walk's address stream.
// Built and timed by tools/atomic_rate.py.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7feb352du;
  h ^= h >> 15;
  h *= 0x846ca68bu;
  h ^= h >> 16;
  return h;
}
__device__ __forceinline__ float unit(uint32_t h) {
  return (float)(h >> 8) * (1.0f / 16777216.0f);
}

__global__ void adds(int kind, float* __restrict__ grid, int res,
                     int per_thread, uint32_t seed) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t h = mix(i * 0x9E3779B9u + seed);
  const uint32_t mask = (uint32_t)res - 1u;  // res a power of two
  if (kind == 0) {
    for (int k = 0; k < per_thread; ++k) {
      h = mix(h + 0x632BE5ABu);
      atomicAdd(grid + (h & (uint32_t)(res * res * res - 1)), 1.0f);
    }
    return;
  }
  float p[3], d[3], n2 = 0.0f;
  for (int k = 0; k < 3; ++k) {
    h = mix(h + 0x632BE5ABu);
    p[k] = unit(h) * (float)res;
    h = mix(h + 0x632BE5ABu);
    d[k] = 2.0f * unit(h) - 1.0f;
    n2 += d[k] * d[k];
  }
  const float inv = rsqrtf(n2 > 1e-12f ? n2 : 1.0f);
  for (int s = 0; s < per_thread; ++s) {
    uint32_t v[3];
    for (int k = 0; k < 3; ++k)
      v[k] = (uint32_t)(int)floorf(p[k] + (float)s * d[k] * inv) & mask;
    atomicAdd(grid + v[0] + (size_t)res * (v[1] + (size_t)res * v[2]), 1.0f);
  }
}

// threads of 256 a block; returns cudaGetLastError()
extern "C" int atomic_adds(int kind, float* grid, int res, int threads,
                           int per_thread, unsigned seed, void* stream) {
  adds<<<(threads + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      kind, grid, res, per_thread, seed);
  return (int)cudaGetLastError();
}
