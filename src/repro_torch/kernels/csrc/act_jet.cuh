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
// and writes the result back into z.  The partition terms and the Horner
// rows are read from a small device buffer that the Python wrapper packs
// from kernels/bell_tables.py (see tanh_jet.py::device_tables), so the
// tables are data, not code: one build covers every order up to the
// template limit kMaxN1 - 1 = 8.  Register arrays are indexed only with
// compile-time indices (the F_m lookup is a select chain), so nothing
// spills to local memory for lack of a static index.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace jetk {

constexpr int kMaxN1 = 9;            // coefficients 0..8: orders up to 8
constexpr int kPolyW = kMaxN1 + 1;   // P_8 has degree 9

enum Act : int { kNone = 0, kTanh = 1, kSigmoid = 2, kSin = 3 };
enum DType : int { kF32 = 0, kF64 = 1 };

// Layout written by tanh_jet.py::device_tables.
template <typename T>
struct Tables {
  const int32_t* starts;  // [kMaxN1]: order k's terms are starts[k-1] .. starts[k]-1
  const int32_t* terms;   // [n_terms][2]: (|p|, exponents p_1..p_8 in 4-bit fields, p_1 lowest)
  const T* coef;          // [n_terms]: C_p = |p|! / prod_j p_j!
  const T* poly;          // [2][kMaxN1][kPolyW]: tanh rows, then sigmoid rows (low -> high)
};

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
__device__ __forceinline__ void taylor_stack(T z0, T (&f)[N1], const Tables<T>& tab) {
  if constexpr (ACT == kSin) {
    const T s = dev_sin(z0), c = dev_cos(z0);
#pragma unroll
    for (int m = 0; m < N1; ++m) {
      const T v = (m % 4 == 0) ? s : (m % 4 == 1) ? c : (m % 4 == 2) ? -s : -c;
      f[m] = v * T(1.0 / factorial(m));
    }
  } else {
    const T u = (ACT == kTanh) ? dev_tanh(z0)
                               : T(0.5) * (dev_tanh(T(0.5) * z0) + T(1));
    const T* rows = tab.poly + (ACT == kTanh ? 0 : kMaxN1 * kPolyW);
#pragma unroll
    for (int m = 0; m < N1; ++m) {
      const T* row = rows + m * kPolyW;  // degree m + 1
      T acc = row[m + 1];
#pragma unroll
      for (int i = m; i >= 0; --i) acc = acc * u + row[i];
      f[m] = acc;
    }
  }
}

// f[m] with a runtime m, without indexing a register array dynamically.
template <typename T, int N1>
__device__ __forceinline__ T pick(const T (&f)[N1], int m) {
  T r = f[0];
#pragma unroll
  for (int i = 1; i < N1; ++i) r = (m == i) ? f[i] : r;
  return r;
}

// z <- sigma(z) as a jet; a no-op for ACT == kNone (the linear readout).
template <typename T, int N1, int ACT>
__device__ __forceinline__ void act_jet_epilogue(T (&z)[N1], const Tables<T>& tab) {
  if constexpr (ACT != kNone) {
    T f[N1];
    taylor_stack<T, N1, ACT>(z[0], f, tab);
    T out[N1];
    out[0] = f[0];
#pragma unroll
    for (int k = 1; k < N1; ++k) {
      T acc = T(0);
      const int t_end = tab.starts[k];
      for (int t = tab.starts[k - 1]; t < t_end; ++t) {
        const int m = tab.terms[2 * t];
        const uint32_t packed = static_cast<uint32_t>(tab.terms[2 * t + 1]);
        T prod = pick(f, m) * tab.coef[t];
#pragma unroll
        for (int j = 1; j < N1; ++j) {
          for (uint32_t e = (packed >> (4 * (j - 1))) & 0xFu; e > 0; --e) prod *= z[j];
        }
        acc += prod;
      }
      out[k] = acc;
    }
#pragma unroll
    for (int k = 0; k < N1; ++k) z[k] = out[k];
  }
}

template <typename T>
inline Tables<T> make_tables(const void* starts, const void* terms, const void* coef,
                             const void* poly) {
  return Tables<T>{static_cast<const int32_t*>(starts), static_cast<const int32_t*>(terms),
                   static_cast<const T*>(coef), static_cast<const T*>(poly)};
}

}  // namespace jetk

// Expands F(n1) for every supported coefficient count, for the launchers'
// switch over the template parameter N1.
#define JETK_FOR_EACH_N1(F) F(1) F(2) F(3) F(4) F(5) F(6) F(7) F(8) F(9)
