// K1: fused n-TangentProp dense layer,
//   (n+1, B, Din) x (Din, Dout) + bias on c_0 -> activation jet (n+1, B, Dout).
//
// Replaces kernels/jet_dense.py::jet_dense_pallas (body _kernel) of the JAX
// package: z = x @ w over the stacked coefficients, the bias on c_0 only,
// the Faa di Bruno activation jet (or none, for the linear readout), one
// store.  f32 accumulates in f32 and f64 in f64, with plain FMAs: no tensor
// cores, so no TF32.
//
// Bound on the H100: bytes, at the serving shapes.  A hidden layer of the
// 512-row cross request (16 directions, n = 4) reads and writes a
// (5, 8192, 32) f64 stack, 21 MB, against ~84 MFLOP of GEMM and ~30 MFLOP
// of epilogue, 6.3 us at 3.35 TB/s; but the f64 FMAs alone take ~2.5 us of
// the FP64 pipe, so loads, GEMM and epilogue must overlap.  The first
// version ran one thread per output column: each thread walked the K loop
// alone, every x value it loaded (an 8-byte broadcast) fed N1 FMAs of one
// column and every w value one row, and the epilogue read its terms from a
// device table.  This design:
//
// * Tiles.  A block owns rg batch rows x cg * TN output columns, all N1
//   coefficient planes.  It stages x[:, rows, k0:k0+kc] (zero-padded to a
//   row pitch ldx whose 16-byte groups are odd, so the 4 rows a warp reads
//   hit distinct banks) and w[k0:k0+kc, cols] in shared memory with
//   cp.async copies, 16 bytes a lane when the rows allow, coalesced along
//   the contiguous axis; the masked edge is zero-filled by the copy itself
//   (src-size 0).
// * Register tiles.  Thread (tx, ty) accumulates row ty, columns
//   tx + j cg (j < TN), all planes: acc[N1][TN].  Each x value (a 16-byte
//   vector load of VEC k-steps, broadcast across the warp's column groups)
//   feeds TN FMAs and each w value N1.  TN = 4 (2 at N1 > 5) when the rows
//   fill the card; TN = 1 at small B, where parallelism, not reuse, is
//   short: there the block shrinks (rg down to one warp) until the grid
//   covers the 132 SMs twice.
// * Straight-line epilogue (act_jet.cuh): the partition terms and Horner
//   rows are generated code per N1, read from no table.  Stores are
//   coalesced: lane tx writes column tx + j cg.
//
// What still bounds it: at the served shape the whole layer is one wave of
// blocks, so an SM loads all its tiles, then multiplies, then stores, and
// the three phases add instead of overlapping (chip_smoke.py times the same
// launch without the epilogue, and a plain copy of the stack, beside it).
// A persistent grid that prefetches the next tile was tried and lost: two
// blocks an SM were too few to hide the GEMM's latency.
// What it leaves for later: f64 DMMA (mma.sync m8n8k4) to shorten the GEMM
// phase, warp-specialized loading, and one launch for the whole layer
// stack.
#include <algorithm>

#include "act_jet.cuh"
#include "cp_async.cuh"

namespace {

using namespace jetk;

constexpr int kThreads = 256;       // largest block
constexpr int kMaxKc = 32;          // k-chunk staged at a time
constexpr int kMaxRows = 32;        // rows of a tile
constexpr int kWideMinRows = 4224;  // 132 SMs x 32 rows: B from which TN > 1 pays
constexpr int kSms = 132;

template <typename T>
// T per 16 bytes
__host__ __device__ constexpr int vec_of() { return 16 / static_cast<int>(sizeof(T)); }

template <int N1>
constexpr int wide_tn() { return N1 <= 5 ? 4 : 2; }

__device__ __forceinline__ void ld16(const double* p, double* v) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}
__device__ __forceinline__ void ld16(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

template <typename T, int N1, int ACT, int TN>
__global__ void __launch_bounds__(kThreads)
    jet_dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias, T* __restrict__ out, int64_t bsz, int din,
                     int dout, int kc, int ldx) {
  constexpr int VEC = vec_of<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cg = blockDim.x, rg = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * cg + tx, nthreads = cg * rg;
  const int warp = tid >> 5, lane = tid & 31, nwarps = (nthreads + 31) >> 5;
  const int cb = cg * TN;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * rg;
  const int o0 = blockIdx.y * cb;
  const int rows = bsz - b0 < rg ? static_cast<int>(bsz - b0) : rg;
  const int64_t plane_in = bsz * din;
  const bool vec_rows = din % VEC == 0 && aligned_16(x);   // ldx and kc are multiples of VEC
  T* xs = reinterpret_cast<T*>(smem_raw);   // [N1][rg][ldx]
  T* ws = xs + N1 * rg * ldx;               // [kc][cb]

  T acc[N1][TN];
#pragma unroll
  for (int p = 0; p < N1; ++p)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[p][j] = T(0);

  for (int k0 = 0; k0 < din; k0 += kc) {
    const int kn = min(kc, din - k0);
    // x rows (plane p, row r): kn contiguous words, zero-padded to ldx; in
    // 16-byte pieces when every row starts on a 16-byte boundary
    for (int pr = warp; pr < N1 * rg; pr += nwarps) {
      const int p = pr / rg, r = pr - p * rg;
      const bool row_ok = r < rows;
      const T* src = x + p * plane_in + (b0 + (row_ok ? r : 0)) * din + k0;
      if (vec_rows) {
        for (int i = lane * VEC; i < ldx; i += 32 * VEC)
          cp_async_16(xs + pr * ldx + i, row_ok && i < kn ? src + i : x, row_ok && i < kn);
      } else {
        for (int i = lane; i < ldx; i += 32)
          cp_async_elem(xs + pr * ldx + i, row_ok && i < kn ? src + i : x, row_ok && i < kn);
      }
    }
    // w rows k0 + i: cb columns from o0, zero past dout and past kn
    for (int idx = tid; idx < kc * cb; idx += nthreads) {
      const int i = idx / cb, c = idx - i * cb;
      const bool ok = i < kn && o0 + c < dout;
      cp_async_elem(ws + idx, ok ? w + static_cast<int64_t>(k0 + i) * dout + o0 + c : w, ok);
    }
    cp_async_wait_all();
    __syncthreads();

    const T* xr = xs + ty * ldx;
    const int kv = (kn + VEC - 1) / VEC * VEC;   // padding is zero on both sides
    for (int i = 0; i < kv; i += VEC) {
      T xv[N1][VEC];
#pragma unroll
      for (int p = 0; p < N1; ++p) ld16(xr + p * rg * ldx + i, xv[p]);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        T wv[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) wv[j] = ws[(i + v) * cb + tx + j * cg];
#pragma unroll
        for (int p = 0; p < N1; ++p)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[p][j] += xv[p][v] * wv[j];
      }
    }
    __syncthreads();   // the next chunk overwrites xs and ws
  }

  if (ty >= rows) return;
  const int64_t plane_out = bsz * dout;
  T* outr = out + (b0 + ty) * dout;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int o = o0 + tx + j * cg;
    if (o < dout) {
      T z[N1];
#pragma unroll
      for (int p = 0; p < N1; ++p) z[p] = acc[p][j];
      z[0] += bias[o];
      act_jet_epilogue<T, N1, ACT>(z);
#pragma unroll
      for (int p = 0; p < N1; ++p) outr[p * plane_out + o] = z[p];
    }
  }
}

int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

template <typename T, int N1, int ACT, int TN>
cudaError_t launch_tiled(const void* x, const void* w, const void* bias, void* out,
                         int64_t bsz, int din, int dout, cudaStream_t stream) {
  constexpr int VEC = vec_of<T>();
  const int cg = std::min(32 / TN, pow2_ceil((dout + TN - 1) / TN));
  const int64_t col_tiles = (dout + cg * TN - 1) / (cg * TN);
  int rg = std::min(kMaxRows, kThreads / cg);
  while (rg * cg > 32 && rg > 1 && (bsz + rg - 1) / rg * col_tiles < 2 * kSms) rg /= 2;
  const int kc = std::min(kMaxKc, (din + VEC - 1) / VEC * VEC);
  const int ldx = (kc / VEC) % 2 == 0 ? kc + VEC : kc;   // odd 16-byte groups per row
  const size_t smem = sizeof(T) * (static_cast<size_t>(N1) * rg * ldx + kc * cg * TN);
  const int64_t gx = (bsz + rg - 1) / rg;
  if (gx > 0x7fffffff || col_tiles > 65535) return cudaErrorInvalidValue;
  auto kernel = jet_dense_kernel<T, N1, ACT, TN>;
  if (smem > 48 * 1024) {   // opt in; a refusal is returned and cleared
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
  }
  kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(col_tiles)), dim3(cg, rg),
           smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                           static_cast<const T*>(bias), static_cast<T*>(out), bsz, din, dout,
                           kc, ldx);
  return cudaGetLastError();
}

// TN > 1 once the rows fill the card with tiles of 32: column reuse pays;
// below that every thread of a narrow tile is worth more than reuse.
template <typename T, int N1, int ACT>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int64_t bsz,
                   int din, int dout, cudaStream_t stream) {
  if (bsz >= kWideMinRows && dout > 32 / wide_tn<N1>())
    return launch_tiled<T, N1, ACT, wide_tn<N1>()>(x, w, bias, out, bsz, din, dout, stream);
  return launch_tiled<T, N1, ACT, 1>(x, w, bias, out, bsz, din, dout, stream);
}

template <typename T, int ACT>
cudaError_t dispatch_n1(int n1, const void* x, const void* w, const void* bias, void* out,
                        int64_t bsz, int din, int dout, cudaStream_t stream) {
  switch (n1) {
#define JETK_CASE(N) \
  case N:            \
    return launch<T, N, ACT>(x, w, bias, out, bsz, din, dout, stream);
    JETK_FOR_EACH_N1(JETK_CASE)
#undef JETK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_act(int act, int n1, const void* x, const void* w, const void* bias,
                         void* out, int64_t bsz, int din, int dout, cudaStream_t stream) {
  switch (act) {
    case kNone:
      return dispatch_n1<T, kNone>(n1, x, w, bias, out, bsz, din, dout, stream);
    case kTanh:
      return dispatch_n1<T, kTanh>(n1, x, w, bias, out, bsz, din, dout, stream);
    case kSigmoid:
      return dispatch_n1<T, kSigmoid>(n1, x, w, bias, out, bsz, din, dout, stream);
    case kSin:
      return dispatch_n1<T, kSin>(n1, x, w, bias, out, bsz, din, dout, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for an argument the kernel does not take, or
// cudaSuccess for an empty input.  x, w, bias and out must be 16-byte
// aligned (PyTorch's allocations are).  The caller makes the tensors'
// device current.
extern "C" int jet_dense_launch(const void* x, const void* w, const void* bias, void* out,
                                int64_t bsz, int din, int dout, int n1, int act, int dtype,
                                void* stream) {
  if (bsz < 0 || din < 1 || dout < 1) return cudaErrorInvalidValue;
  if (bsz == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_act<float>(act, n1, x, w, bias, out, bsz, din, dout, s);
  if (dtype == kF64) return dispatch_act<double>(act, n1, x, w, bias, out, bsz, din, dout, s);
  return cudaErrorInvalidValue;
}
