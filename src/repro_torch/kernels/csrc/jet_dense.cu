// K1: fused n-TangentProp dense layer,
//   (n+1, B, Din) x (Din, Dout) + bias on c_0 -> activation jet (n+1, B, Dout).
//
// Replaces kernels/jet_dense.py::jet_dense_pallas (body _kernel) of the JAX
// package.  One thread per (b, o) output column holds all n+1 accumulators
// in registers across the whole K loop, so the coefficient axis is never
// split (order k of the activation jet mixes every lower order), adds the
// bias to acc[0] only, runs the shared Faa di Bruno epilogue of act_jet.cuh
// (or none, for the linear readout) and stores once.  f32 accumulates in
// f32 and f64 in f64, with plain FMAs: no tensor cores, so no TF32.
//
// Threads of a warp share b and walk consecutive o, so each weight load is
// coalesced and each input load is a broadcast; for Dout < 32 the block
// packs several rows b per warp instead.  The weight matrix of this model
// (at most 32 x 32) stays in L1.
//
// Bound on the H100: bytes, at the serving shapes.  A hidden layer of the
// 512-row cross request (16 directions, n = 4) reads and writes a
// (5, 8192, 32) f64 stack, about 21 MB, against ~84 MFLOP of GEMM: the
// GEMM's arithmetic intensity (~4 flop/byte) sits far below the card's f64
// balance point.  What this simple design leaves for later: DMMA / wgmma
// tiles for wide layers, TMA-staged input tiles in shared memory, several
// outputs per thread, and one launch for the whole layer stack.
#include "act_jet.cuh"

namespace {

using namespace jetk;

template <typename T, int N1, int ACT>
__global__ void jet_dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                 const T* __restrict__ bias, T* __restrict__ out, int64_t bsz,
                                 int din, int dout, Tables<T> tab) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  const int o = blockIdx.y * blockDim.x + threadIdx.x;
  if (b >= bsz || o >= dout) return;
  const int64_t plane_in = bsz * din, plane_out = bsz * dout;
  const T* xr = x + b * din;
  T acc[N1];
#pragma unroll
  for (int k = 0; k < N1; ++k) acc[k] = T(0);
  for (int i = 0; i < din; ++i) {
    const T wi = w[static_cast<int64_t>(i) * dout + o];
#pragma unroll
    for (int k = 0; k < N1; ++k) acc[k] += xr[k * plane_in + i] * wi;
  }
  acc[0] += bias[o];
  act_jet_epilogue<T, N1, ACT>(acc, tab);
  T* outr = out + b * dout + o;
#pragma unroll
  for (int k = 0; k < N1; ++k) outr[k * plane_out] = acc[k];
}

constexpr int kThreads = 256;

template <typename T, int N1, int ACT>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int64_t bsz,
                   int din, int dout, const Tables<T>& tab, cudaStream_t stream) {
  int tx = 1;
  while (tx < dout && tx < 32) tx *= 2;
  const int ty = kThreads / tx;
  const int64_t gx = (bsz + ty - 1) / ty;
  const int gy = (dout + tx - 1) / tx;
  if (gx > 0x7fffffff || gy > 65535) return cudaErrorInvalidValue;
  jet_dense_kernel<T, N1, ACT>
      <<<dim3(static_cast<unsigned>(gx), gy), dim3(tx, ty), 0, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
          static_cast<T*>(out), bsz, din, dout, tab);
  return cudaGetLastError();
}

template <typename T, int ACT>
cudaError_t dispatch_n1(int n1, const void* x, const void* w, const void* bias, void* out,
                        int64_t bsz, int din, int dout, const Tables<T>& tab,
                        cudaStream_t stream) {
  switch (n1) {
#define JETK_CASE(N) \
  case N:            \
    return launch<T, N, ACT>(x, w, bias, out, bsz, din, dout, tab, stream);
    JETK_FOR_EACH_N1(JETK_CASE)
#undef JETK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_act(int act, int n1, const void* x, const void* w, const void* bias,
                         void* out, int64_t bsz, int din, int dout, const Tables<T>& tab,
                         cudaStream_t stream) {
  switch (act) {
    case kNone:
      return dispatch_n1<T, kNone>(n1, x, w, bias, out, bsz, din, dout, tab, stream);
    case kTanh:
      return dispatch_n1<T, kTanh>(n1, x, w, bias, out, bsz, din, dout, tab, stream);
    case kSigmoid:
      return dispatch_n1<T, kSigmoid>(n1, x, w, bias, out, bsz, din, dout, tab, stream);
    case kSin:
      return dispatch_n1<T, kSin>(n1, x, w, bias, out, bsz, din, dout, tab, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for an argument the kernel does not take, or
// cudaSuccess for an empty input.  The caller makes the tensors' device
// current.
extern "C" int jet_dense_launch(const void* x, const void* w, const void* bias, void* out,
                                int64_t bsz, int din, int dout, int n1, int act, int dtype,
                                const void* starts, const void* terms, const void* coef,
                                const void* poly, void* stream) {
  if (bsz < 0 || din < 1 || dout < 1) return cudaErrorInvalidValue;
  if (bsz == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_act<float>(act, n1, x, w, bias, out, bsz, din, dout,
                               make_tables<float>(starts, terms, coef, poly), s);
  if (dtype == kF64)
    return dispatch_act<double>(act, n1, x, w, bias, out, bsz, din, dout,
                                make_tables<double>(starts, terms, coef, poly), s);
  return cudaErrorInvalidValue;
}
