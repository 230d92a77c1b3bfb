// K3: fused jet RMSNorm, (n+1, B, W) stack + (W,) gain -> (n+1, B, W).
//
// Replaces kernels/jet_attention.py::jet_rms_norm_pallas (body
// rms_norm_jet_body) of the JAX package.  Per row of W features:
//   ms_m  = mean_w sum_{i+j=m} x_i x_j              (+ eps on ms_0)
//   inv_0 = 1 / sqrt(ms_0)
//   inv_m = sum_{j=1..m} (0.5 j - m) ms_j inv_{m-j} / (m ms_0)   (Miller, r = -1/2)
//   out_m = gamma * sum_{j=0..m} x_{m-j} inv_j
// One warp owns one row; its lanes stride over W, so any W works and the
// ragged edge is a bounds check.  Each lane accumulates its columns' n+1
// mean-square partials in registers, warp shuffles reduce them, every lane
// then runs the scalar rsqrt recurrence redundantly (it is n^2/2 flops),
// and a second pass over the row (an L1 hit: the warp just read it)
// writes the normalized product times the gain with one store per
// coefficient.  f32 accumulates in f32, f64 in f64.
//
// Bound on the H100: bytes.  The row moves 2 (n+1) W words for a few
// (n+1)^2 flops per word, far below the card's f64 balance point.  At the
// cross-512 serving shape, (5, 16384, 32) f64, that is 2 x 21.0 MB, 12.5 us
// at 3.35 TB/s.  What this simple design leaves for later: 16-byte vector
// loads, several rows per warp when W is small (at W = 32 each lane holds
// one column), and fusing the norm into the dense kernel that follows it.
#include "act_jet.cuh"  // jetk::DType, JETK_FOR_EACH_N1

namespace {

using namespace jetk;

constexpr int kWarps = 8;  // rows per block

__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int N1>
__global__ void __launch_bounds__(kWarps * 32)
    jet_rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                        T* __restrict__ out, int64_t bsz, int width, T eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= bsz) return;  // the whole warp leaves: the shuffles below stay full
  const int64_t plane = bsz * width;
  const T* xr = x + row * width;

  T ms[N1];
#pragma unroll
  for (int m = 0; m < N1; ++m) ms[m] = T(0);
  for (int w = lane; w < width; w += 32) {
    T c[N1];
#pragma unroll
    for (int k = 0; k < N1; ++k) c[k] = xr[k * plane + w];
#pragma unroll
    for (int m = 0; m < N1; ++m) {
#pragma unroll
      for (int i = 0; i <= m; ++i) ms[m] += c[i] * c[m - i];
    }
  }
#pragma unroll
  for (int m = 0; m < N1; ++m) ms[m] = warp_sum(ms[m]) / T(width);
  ms[0] += eps;

  T inv[N1];
  inv[0] = T(1) / dev_sqrt(ms[0]);
#pragma unroll
  for (int m = 1; m < N1; ++m) {
    T acc = T(0);
#pragma unroll
    for (int j = 1; j <= m; ++j) acc += (T(0.5) * T(j) - T(m)) * ms[j] * inv[m - j];
    inv[m] = acc / (T(m) * ms[0]);
  }

  T* outr = out + row * width;
  for (int w = lane; w < width; w += 32) {
    T c[N1];
#pragma unroll
    for (int k = 0; k < N1; ++k) c[k] = xr[k * plane + w];
    const T g = gamma[w];
#pragma unroll
    for (int m = 0; m < N1; ++m) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j <= m; ++j) acc += c[m - j] * inv[j];
      outr[m * plane + w] = acc * g;
    }
  }
}

template <typename T, int N1>
cudaError_t launch(const void* x, const void* gamma, void* out, int64_t bsz, int width,
                   double eps, cudaStream_t stream) {
  const int64_t blocks = (bsz + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  jet_rms_norm_kernel<T, N1><<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<T*>(out), bsz,
      width, static_cast<T>(eps));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n1(int n1, const void* x, const void* gamma, void* out, int64_t bsz,
                        int width, double eps, cudaStream_t stream) {
  switch (n1) {
#define JETK_CASE(N) \
  case N:            \
    return launch<T, N>(x, gamma, out, bsz, width, eps, stream);
    JETK_FOR_EACH_N1(JETK_CASE)
#undef JETK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for an argument the kernel does not take, or
// cudaSuccess for an empty input.  The caller makes the tensors' device
// current.
extern "C" int jet_rms_norm_launch(const void* x, const void* gamma, void* out, int64_t bsz,
                                   int width, int n1, int dtype, double eps, void* stream) {
  if (bsz < 0 || width < 1) return cudaErrorInvalidValue;
  if (bsz == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_n1<float>(n1, x, gamma, out, bsz, width, eps, s);
  if (dtype == kF64) return dispatch_n1<double>(n1, x, gamma, out, bsz, width, eps, s);
  return cudaErrorInvalidValue;
}
