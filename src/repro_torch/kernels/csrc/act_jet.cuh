// The Faa di Bruno activation-jet epilogue shared by the two kernels of the
// dense path: act_jet.cu (standalone, replaces the reference's
// kernels/tanh_jet.py::act_jet_pallas) and jet_dense.cu (the fused layer,
// replaces kernels/jet_dense.py::jet_dense_pallas, whose Pallas body runs
// the same act_jet_body as its epilogue).
//
// One thread owns all N1 = n+1 Taylor coefficients of one element in
// registers.  Given the pre-activation stack z[0..n] it computes
//   F_m = sigma^(m)(z_0) / m!          (tanh/sigmoid: Horner in u = tanh;
//                                       sin: the sin/cos phase cycle)
//   out_k = sum_{p in P(k)} C_p F_|p| prod_j z_j^{p_j}
// and writes the result back into z.
//
// What bounds it on the H100: in f64 the card's FP64 pipe (64 lanes an SM),
// not bytes, once the terms are straight-line code: the element moves
// 2 (n+1) words and does ~60 (order 4) to ~400 (order 8) dependent f64
// operations plus one tanh.  The first version read the partition terms,
// their coefficients and the Horner rows from a device buffer, term by
// term, and raised each z_j to its power with a data-dependent loop: a
// chain of dependent loads and branches that nothing overlapped (K2 at
// 52% of its byte bound).  Now the terms and rows are code generated from
// kernels/bell_tables.py into fdb_tables.cuh, instantiated per N1 (the
// launchers' template parameter): no load, no branch on data, every
// register array indexed by constants.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "fdb_tables.cuh"

namespace jetk {

enum Act : int { kNone = 0, kTanh = 1, kSigmoid = 2, kSin = 3 };
enum DType : int { kF32 = 0, kF64 = 1 };

__host__ __device__ constexpr double factorial(int m) {
  return m <= 1 ? 1.0 : m * factorial(m - 1);
}

__device__ __forceinline__ float dev_tanh(float x) { return tanhf(x); }
__device__ __forceinline__ double dev_tanh(double x) { return tanh(x); }
__device__ __forceinline__ float dev_sin(float x) { return sinf(x); }
__device__ __forceinline__ double dev_sin(double x) { return sin(x); }
__device__ __forceinline__ float dev_cos(float x) { return cosf(x); }
__device__ __forceinline__ double dev_cos(double x) { return cos(x); }

// F_m = sigma^(m)(z0) / m! for m = 0..N1-1.
template <typename T, int N1, int ACT>
__device__ __forceinline__ void taylor_stack(T z0, T (&f)[N1]) {
  if constexpr (ACT == kSin) {
    const T s = dev_sin(z0), c = dev_cos(z0);
#pragma unroll
    for (int m = 0; m < N1; ++m) {
      const T v = (m % 4 == 0) ? s : (m % 4 == 1) ? c : (m % 4 == 2) ? -s : -c;
      f[m] = v * T(1.0 / factorial(m));
    }
  } else if constexpr (ACT == kTanh) {
    fdb::tanh_rows<T, N1>(dev_tanh(z0), f);
  } else {
    fdb::sigmoid_rows<T, N1>(T(0.5) * (dev_tanh(T(0.5) * z0) + T(1)), f);
  }
}

// z <- sigma(z) as a jet; a no-op for ACT == kNone (the linear readout).
template <typename T, int N1, int ACT>
__device__ __forceinline__ void act_jet_epilogue(T (&z)[N1]) {
  if constexpr (ACT != kNone) {
    T f[N1], out[N1];
    taylor_stack<T, N1, ACT>(z[0], f);
    fdb::faa_di_bruno<T, N1>(f, z, out);
#pragma unroll
    for (int k = 0; k < N1; ++k) z[k] = out[k];
  }
}

}  // namespace jetk

// Expands F(n1) for every templated coefficient count (1 .. fdb::kMaxOrder
// + 1), for the launchers' switch over the template parameter N1; other
// counts (and bfloat16) run the run-time-order kernels of jet_runtime.cu.
#define JETK_FOR_EACH_N1(F) F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9)
