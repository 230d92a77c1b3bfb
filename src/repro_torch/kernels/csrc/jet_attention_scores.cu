// K5: fused jet attention scores.  Q/K coefficient stacks (n+1, B, T, D) ->
// the softmaxed score jet (n+1, B, Tq, Tk), one launch.
//
// Replaces kernels/jet_attention.py::jet_attention_scores_pallas (body
// attention_scores_jet_body) of the JAX package.  The TPU kernel holds a
// block of whole (T, D) stacks in VMEM and runs the Cauchy terms on the MXU;
// here one block owns kWarps queries of one batch row b, one warp per query,
// and the lanes stride over the keys:
//
//   s_m   = scale sum_{i+j=m} q_i . k_j                   (lane = key)
//   e_0   = exp(s_0 - max_keys s_0)
//   e_m   = (1/m) sum_{j=1..m} j s_j e_{m-j}
//   tot_m = sum_keys e_m                                  (warp shuffles)
//   p_0   = e_0 / tot_0
//   p_m   = (e_m - sum_{j=1..m} tot_j p_{m-j}) / tot_0
//
// The softmax needs the whole row twice: e_0 needs the row max of s_0 before
// any exp, and every p_m needs the totals over all keys.  A row of N1 T
// values does not fit in registers at long T (the memory comparison runs T
// up to 1024), so the block walks the keys three times and recomputes rather
// than stores: pass 1 takes the max of s_0 (D FMAs per key), pass 2 the
// scores, the e-jet and the lane's partial totals, pass 3 the scores and
// e-jet again and the p-jet, which it writes once, one coalesced store per
// coefficient.  Keys come in tiles of 32 (one per lane), copied from device
// memory into shared memory by the whole block with contiguous loads and
// read there by all kWarps queries; a tile row is padded to D+1 words so
// the lanes' strided reads hit distinct banks.  The query's N1 x D
// coefficients sit in the warp's own slice of shared memory.  There is no
// padding of the data: the key tile and the query count are bounds checks,
// so T = 1 and D = 1 work as any other shape.  f32 accumulates in f32, f64
// in f64.
//
// Bound on the H100: bytes.  The output is N1 B T^2 words against 2 N1 B T D
// of input; at (3, 4, 1024, 8) f64 that is 100.7 MB written, 30 us at
// 3.35 TB/s, against 0.48 GFLOP of Cauchy terms and recurrences.  The
// recompute costs this design 2.5x the Cauchy FLOPs.  Measured, it is bound
// by latency, not by either: each block waits on a tile load and two block
// syncs 3 T / 32 times in a row (96 at T = 1024).  What it leaves for
// later: wider or double-buffered tiles, several queries per warp at short
// T (at T = 2, 30 of 32 lanes idle) and DMMA tiles for the score
// contraction.
#include "act_jet.cuh"  // jetk::DType, JETK_FOR_EACH_N1

namespace {

using namespace jetk;

constexpr int kWarps = 8;  // queries of one batch row per block
constexpr int kTile = 32;  // keys per shared-memory tile: one per lane

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ T dev_max(T a, T b) {
  return a > b ? a : b;
}

template <typename T>
__device__ __forceinline__ T lowest();
template <>
__device__ __forceinline__ float lowest<float>() {
  return -3.402823466e38f;
}
template <>
__device__ __forceinline__ double lowest<double>() {
  return -1.7976931348623157e308;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = dev_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// s[m] = scale sum_{i+j=m} qs_i . kr_j for one key; qs is the query's
// [N1][d] and kr the key's row of the shared tile, coefficients kstride
// apart.
template <typename T, int N1>
__device__ __forceinline__ void scores(const T* qs, const T* kr, int kstride, int d, T scale,
                                       T (&s)[N1]) {
#pragma unroll
  for (int m = 0; m < N1; ++m) s[m] = T(0);
  for (int dd = 0; dd < d; ++dd) {
    T qc[N1], kc[N1];
#pragma unroll
    for (int i = 0; i < N1; ++i) {
      qc[i] = qs[i * d + dd];
      kc[i] = kr[i * kstride + dd];
    }
#pragma unroll
    for (int m = 0; m < N1; ++m) {
#pragma unroll
      for (int i = 0; i <= m; ++i) s[m] += qc[i] * kc[m - i];
    }
  }
#pragma unroll
  for (int m = 0; m < N1; ++m) s[m] *= scale;
}

// e-jet of exp(s - shift) by the power-series recurrence.
template <typename T, int N1>
__device__ __forceinline__ void exp_jet(const T (&s)[N1], T shift, T (&e)[N1]) {
  e[0] = dev_exp(s[0] - shift);
#pragma unroll
  for (int m = 1; m < N1; ++m) {
    T r = T(0);
#pragma unroll
    for (int j = 1; j <= m; ++j) r += T(j) * s[j] * e[m - j];
    e[m] = r / T(m);
  }
}

// Copy keys j0 .. j0+31 (fewer at the ragged end) of coefficients
// 0 .. n_coeffs-1 of one batch row into the tile ks[i][key][dp]; each
// coefficient's keys are contiguous in device memory.  Called by the whole
// block; the syncs fence the previous tile's readers and this tile's writers.
template <typename T>
__device__ __forceinline__ void stage(T* ks, const T* __restrict__ kb, int64_t plane, int t,
                                      int d, int dp, int j0, int n_coeffs) {
  __syncthreads();
  const int per = min(kTile, t - j0) * d;
  for (int idx = threadIdx.x; idx < n_coeffs * per; idx += kWarps * 32) {
    const int i = idx / per, r = idx - i * per;  // r = key * d + dd within the tile
    const int key = r / d, dd = r - key * d;
    ks[(i * kTile + key) * dp + dd] = kb[i * plane + static_cast<int64_t>(j0) * d + r];
  }
  __syncthreads();
}

template <typename T, int N1>
__global__ void __launch_bounds__(kWarps * 32)
    jet_attention_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                T* __restrict__ out, int64_t bsz, int t, int d, T scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q_blocks = (t + kWarps - 1) / kWarps;
  const int64_t b = blockIdx.x / q_blocks;
  const int qi = static_cast<int>(blockIdx.x % q_blocks) * kWarps + warp;
  // a warp past the last query still stages tiles and meets every sync
  const bool active = qi < t;
  const int dp = d + 1;                       // padded tile row
  const int kstride = kTile * dp;             // one coefficient of the tile
  const int64_t plane = bsz * t * d;          // one coefficient of q or k
  const int64_t out_plane = bsz * t * static_cast<int64_t>(t);
  const int64_t row = b * t + qi;
  T* ks = reinterpret_cast<T*>(smem_raw);                      // [N1][kTile][dp]
  T* qs = ks + N1 * kstride + static_cast<int64_t>(warp) * N1 * d;  // [N1][d]
  if (active) {
    for (int idx = lane; idx < N1 * d; idx += 32) {
      const int i = idx / d, dd = idx - i * d;
      qs[idx] = q[i * plane + row * d + dd];
    }
  }
  __syncwarp();
  const T* kb = k + b * t * d;  // batch row b's keys, coefficient 0

  // pass 1: the row max of s_0
  T mx = lowest<T>();
  for (int j0 = 0; j0 < t; j0 += kTile) {
    stage(ks, kb, plane, t, d, dp, j0, 1);
    if (active && j0 + lane < t) {
      const T* kr = ks + lane * dp;
      T acc = T(0);
      for (int dd = 0; dd < d; ++dd) acc += qs[dd] * kr[dd];
      mx = dev_max(mx, acc * scale);
    }
  }
  mx = warp_max(mx);

  // pass 2: the totals of the e-jet over all keys
  T tot[N1];
#pragma unroll
  for (int m = 0; m < N1; ++m) tot[m] = T(0);
  for (int j0 = 0; j0 < t; j0 += kTile) {
    stage(ks, kb, plane, t, d, dp, j0, N1);
    if (active && j0 + lane < t) {
      T s[N1], e[N1];
      scores<T, N1>(qs, ks + lane * dp, kstride, d, scale, s);
      exp_jet<T, N1>(s, mx, e);
#pragma unroll
      for (int m = 0; m < N1; ++m) tot[m] += e[m];
    }
  }
#pragma unroll
  for (int m = 0; m < N1; ++m) tot[m] = warp_sum(tot[m]);

  // pass 3: the probability jet, written once
  T* outr = out + row * t;
  for (int j0 = 0; j0 < t; j0 += kTile) {
    stage(ks, kb, plane, t, d, dp, j0, N1);
    const int j = j0 + lane;
    if (active && j < t) {
      T s[N1], e[N1], p[N1];
      scores<T, N1>(qs, ks + lane * dp, kstride, d, scale, s);
      exp_jet<T, N1>(s, mx, e);
      p[0] = e[0] / tot[0];
#pragma unroll
      for (int m = 1; m < N1; ++m) {
        T r = e[m];
#pragma unroll
        for (int i = 1; i <= m; ++i) r -= tot[i] * p[m - i];
        p[m] = r / tot[0];
      }
#pragma unroll
      for (int m = 0; m < N1; ++m) outr[m * out_plane + j] = p[m];
    }
  }
}

template <typename T, int N1>
cudaError_t launch(const void* q, const void* k, void* out, int64_t bsz, int t, int d,
                   double scale, cudaStream_t stream) {
  const int64_t blocks = bsz * ((t + kWarps - 1) / kWarps);
  const size_t smem =
      sizeof(T) * static_cast<size_t>(N1) * (static_cast<size_t>(kTile) * (d + 1) + kWarps * d);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = jet_attention_scores_kernel<T, N1>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<T*>(out), bsz, t, d,
      static_cast<T>(scale));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n1(int n1, const void* q, const void* k, void* out, int64_t bsz, int t,
                        int d, double scale, cudaStream_t stream) {
  switch (n1) {
#define JETK_CASE(N) \
  case N:            \
    return launch<T, N>(q, k, out, bsz, t, d, scale, stream);
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
extern "C" int jet_attention_scores_launch(const void* q, const void* k, void* out,
                                           int64_t bsz, int t, int d, int n1, int dtype,
                                           double scale, void* stream) {
  if (bsz < 0 || t < 1 || d < 1) return cudaErrorInvalidValue;
  if (bsz == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_n1<float>(n1, q, k, out, bsz, t, d, scale, s);
  if (dtype == kF64) return dispatch_n1<double>(n1, q, k, out, bsz, t, d, scale, s);
  return cudaErrorInvalidValue;
}
