// The ballistic engine's z-resample: one weighted gather along the middle
// axis, the forward and its adjoint alike.
//
//   out[a, j, u] = sum_k w[j, k] * x[a, idx[j, k], u]
//
// for j over the output rows. The forward resamples the patterns' DMD
// rows onto the film's z-rows with the (Zf, K) tables; the adjoint
// gathers them back with the (R, K) tables of the transposed matrix, so
// it needs no atomics. Replaces no TPU kernel: the JAX package leaves
// the resample to XLA (drtvam_tpu/ops/ballistic.py _tap_contract), and
// the port's plain version (ops/ballistic.py BallisticEngine._tap_contract)
// runs it as K index_selects, multiplies and adds over full-size
// temporaries.
//
// Bound on the H100: bytes. Each input element is read once and each
// output element written once: at the bench shapes (400 angles, 400 DMD
// rows, 256 film rows, 400 columns) 256 MB + 164 MB a direction, 0.125 ms
// at 3.35 TB/s. Two flops a tap are nothing beside that.
//
// Design. Threads run along u, so every access is coalesced: 16-byte
// loads and stores where U % 4 == 0 and both pointers are 16-byte
// aligned, one float a thread otherwise. A CTA owns one angle and kRows
// output rows, their taps staged in shared memory; each thread issues
// all K loads of its element before it sums them. Consecutive CTAs share
// an angle, so the source rows that neighbouring output rows share (and
// row 0, which the zero-weight padding taps read) come from L2: one
// angle's input is 640 KB, and the device memory sees it about once.
//
// Arithmetic: every tap in table order, the zero-weight padding taps too,
// each product and each sum rounded on its own (__fmul_rn, __fadd_rn, no
// FMA contraction): ((x0 w0 + x1 w1) + x2 w2) + x3 w3, the order in which
// the plain version adds its terms. The result is bitwise the plain
// version's.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;     // output rows a CTA
constexpr int kTaps = 4;      // K: BallisticEngine._MAX_TAPS

// V floats a thread: a 16-byte vector (V = 4) or one float (V = 1).
template <int V>
struct Lanes;

template <>
struct Lanes<4> {
  using T = float4;
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static T mul(T x, float w) {
    return make_float4(__fmul_rn(x.x, w), __fmul_rn(x.y, w),
                       __fmul_rn(x.z, w), __fmul_rn(x.w, w));
  }
  __device__ static T add(T a, T b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
  __device__ static void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Lanes<1> {
  using T = float;
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static T mul(T x, float w) { return __fmul_rn(x, w); }
  __device__ static T add(T a, T b) { return __fadd_rn(a, b); }
  __device__ static void store(float* p, T v) { *p = v; }
};

// x (A, n_in, U), idx / w (n_out, K), out (A, n_out, U); block b covers
// angle b / blocks_per_angle and output rows kRows * (b % blocks_per_angle)
// onwards.
template <int V>
__global__ void __launch_bounds__(kThreads)
    zres_gather_kernel(const float* __restrict__ x,
                       const long long* __restrict__ idx,
                       const float* __restrict__ w, float* __restrict__ out,
                       int n_in, int n_out, int U, int blocks_per_angle) {
  using L = Lanes<V>;
  __shared__ int s_row[kRows * kTaps];
  __shared__ float s_w[kRows * kTaps];
  const int a = blockIdx.x / blocks_per_angle;
  const int j0 = (blockIdx.x - a * blocks_per_angle) * kRows;
  const int rows = min(kRows, n_out - j0);
  for (int t = threadIdx.x; t < rows * kTaps; t += kThreads) {
    s_row[t] = static_cast<int>(idx[static_cast<int64_t>(j0) * kTaps + t]);
    s_w[t] = w[static_cast<int64_t>(j0) * kTaps + t];
  }
  __syncthreads();
  const int Uv = U / V;
  const float* xa = x + static_cast<int64_t>(a) * n_in * U;
  float* oa = out + (static_cast<int64_t>(a) * n_out + j0) * U;
  for (int e = threadIdx.x; e < rows * Uv; e += kThreads) {
    const int r = e / Uv;
    const int c = (e - r * Uv) * V;
    const int* tr = s_row + r * kTaps;
    const float* tw = s_w + r * kTaps;
    typename L::T v[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
      v[k] = L::load(xa + static_cast<int64_t>(tr[k]) * U + c);
    typename L::T acc = L::mul(v[0], tw[0]);
#pragma unroll
    for (int k = 1; k < kTaps; ++k)
      acc = L::add(acc, L::mul(v[k], tw[k]));
    L::store(oa + static_cast<int64_t>(r) * U + c, acc);
  }
}

}  // namespace

// x (A, n_in, U) float32, idx (n_out, K) int64 rows of x in [0, n_in),
// w (n_out, K) float32, K = kTaps, out (A, n_out, U) float32; all
// contiguous on one device. Returns the cudaError_t of the launch (0:
// launched, or nothing to do).
extern "C" int zres_gather(const float* x, const long long* idx,
                           const float* w, float* out, int A, int n_in,
                           int n_out, int U, int K, void* stream) {
  if (A <= 0 || n_out <= 0 || U <= 0) return 0;
  if (K != kTaps || n_in <= 0) return cudaErrorInvalidValue;
  const int blocks_per_angle = (n_out + kRows - 1) / kRows;
  if (static_cast<int64_t>(blocks_per_angle) * A > INT_MAX)
    return cudaErrorInvalidValue;
  const dim3 grid(blocks_per_angle * A);
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = U % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    zres_gather_kernel<4><<<grid, kThreads, 0, s>>>(x, idx, w, out, n_in,
                                                     n_out, U,
                                                     blocks_per_angle);
  else
    zres_gather_kernel<1><<<grid, kThreads, 0, s>>>(x, idx, w, out, n_in,
                                                     n_out, U,
                                                     blocks_per_angle);
  return static_cast<int>(cudaGetLastError());
}
