// K2: standalone activation jet, (n+1, B, W) -> (n+1, B, W).
//
// Replaces kernels/tanh_jet.py::act_jet_pallas (body act_jet_body) of the
// JAX package.  One thread per (b, w) element loads its n+1 coefficients
// (coefficient plane k is contiguous, so a warp's loads are coalesced),
// runs the shared epilogue of act_jet.cuh in registers, and stores n+1
// results.  The ragged edge is masked; nothing is padded or copied.
//
// Bound on the H100: bytes at order 4 (the element moves 2 (n+1) words
// against ~60 f64 operations and a tanh), the FP64 pipe toward order 8.
// The epilogue's terms are straight-line code (see act_jet.cuh), so the
// thread runs no table load and no data-dependent loop.  What this design
// leaves for later: vectorized 16-byte loads, several elements per thread,
// and fusing into whatever produced the input.
#include "act_jet.cuh"

namespace {

using namespace jetk;

template <typename T, int N1, int ACT>
__global__ void act_jet_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n_elem) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_elem) return;
  T z[N1];
#pragma unroll
  for (int k = 0; k < N1; ++k) z[k] = x[k * n_elem + i];
  act_jet_epilogue<T, N1, ACT>(z);
#pragma unroll
  for (int k = 0; k < N1; ++k) out[k * n_elem + i] = z[k];
}

constexpr int kThreads = 256;

template <typename T, int N1, int ACT>
cudaError_t launch(const void* x, void* out, int64_t n_elem, cudaStream_t stream) {
  const int64_t blocks = (n_elem + kThreads - 1) / kThreads;
  act_jet_kernel<T, N1, ACT><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n_elem);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t dispatch_n1(int n1, const void* x, void* out, int64_t n_elem, cudaStream_t stream) {
  switch (n1) {
#define JETK_CASE(N) \
  case N:            \
    return launch<T, N, ACT>(x, out, n_elem, stream);
    JETK_FOR_EACH_N1(JETK_CASE)
#undef JETK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_act(int act, int n1, const void* x, void* out, int64_t n_elem,
                         cudaStream_t stream) {
  switch (act) {
    case kTanh:
      return dispatch_n1<T, kTanh>(n1, x, out, n_elem, stream);
    case kSigmoid:
      return dispatch_n1<T, kSigmoid>(n1, x, out, n_elem, stream);
    case kSin:
      return dispatch_n1<T, kSin>(n1, x, out, n_elem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for an argument the kernel does not take, or
// cudaSuccess for an empty input.  The caller makes the tensors' device
// current.
extern "C" int act_jet_launch(const void* x, void* out, int64_t n_elem, int n1, int act,
                              int dtype, void* stream) {
  if (n_elem < 0 || (n_elem + kThreads - 1) / kThreads > 0x7fffffff) return cudaErrorInvalidValue;
  if (n_elem == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_act<float>(act, n1, x, out, n_elem, s);
  if (dtype == kF64) return dispatch_act<double>(act, n1, x, out, n_elem, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* jetk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
