// Generated by `python -m repro_torch.kernels.bell_tables` from
// kernels/bell_tables.py (fdb_terms, tanh_poly_rows, sigmoid_poly_rows),
// orders 1..8.  Do not edit: tests/test_torch_tables.py holds it equal
// to the generator and decodes it back to the tables.
//
// fdb_order_k(f, z) = sum_{p in P(k)} C_p F_|p| prod_j z_j^{p_j}, one term
// per line in fdb_terms order; tanh_row_m(u) / sigmoid_row_m(u) = F_m by
// Horner's rule in u.  Every index is a constant, so once inlined the
// arrays f and z stay in registers.  Each product and sum is rounded on
// its own, in the order ref.py's separate PyTorch ops round them (no
// FMA contraction): at order 8 the sigmoid rows cancel enough that
// contracting them moves the result by more than 1e-12 of its size.
#pragma once

namespace jetk {
namespace fdb {

constexpr int kMaxOrder = 8;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

// order 1: 1 term
template <typename T>
__device__ __forceinline__ T fdb_order_1(const T* f, const T* z) {
  T acc = mul(f[1], z[1]);
  return acc;
}

// order 2: 2 terms
template <typename T>
__device__ __forceinline__ T fdb_order_2(const T* f, const T* z) {
  T acc = mul(f[1], z[2]);
  acc = add(acc, mul(mul(f[2], z[1]), z[1]));
  return acc;
}

// order 3: 3 terms
template <typename T>
__device__ __forceinline__ T fdb_order_3(const T* f, const T* z) {
  T acc = mul(f[1], z[3]);
  acc = add(acc, mul(mul(mul(f[2], T(2.0)), z[1]), z[2]));
  acc = add(acc, mul(mul(mul(f[3], z[1]), z[1]), z[1]));
  return acc;
}

// order 4: 5 terms
template <typename T>
__device__ __forceinline__ T fdb_order_4(const T* f, const T* z) {
  T acc = mul(f[1], z[4]);
  acc = add(acc, mul(mul(mul(f[2], T(2.0)), z[1]), z[3]));
  acc = add(acc, mul(mul(f[2], z[2]), z[2]));
  acc = add(acc, mul(mul(mul(mul(f[3], T(3.0)), z[1]), z[1]), z[2]));
  acc = add(acc, mul(mul(mul(mul(f[4], z[1]), z[1]), z[1]), z[1]));
  return acc;
}

// order 5: 7 terms
template <typename T>
__device__ __forceinline__ T fdb_order_5(const T* f, const T* z) {
  T acc = mul(f[1], z[5]);
  acc = add(acc, mul(mul(mul(f[2], T(2.0)), z[1]), z[4]));
  acc = add(acc, mul(mul(mul(f[2], T(2.0)), z[2]), z[3]));
  acc = add(acc, mul(mul(mul(mul(f[3], T(3.0)), z[1]), z[2]), z[2]));
  acc = add(acc, mul(mul(mul(mul(f[3], T(3.0)), z[1]), z[1]), z[3]));
  acc = add(acc, mul(mul(mul(mul(mul(f[4], T(4.0)), z[1]), z[1]), z[1]), z[2]));
  acc = add(acc, mul(mul(mul(mul(mul(f[5], z[1]), z[1]), z[1]), z[1]), z[1]));
  return acc;
}

// order 6: 11 terms
template <typename T>
__device__ __forceinline__ T fdb_order_6(const T* f, const T* z) {
  T acc = mul(f[1], z[6]);
  acc = add(acc, mul(mul(mul(f[2], T(2.0)), z[1]), z[5]));
  acc = add(acc, mul(mul(mul(f[2], T(2.0)), z[2]), z[4]));
  acc = add(acc, mul(mul(f[2], z[3]), z[3]));
  acc = add(acc, mul(mul(mul(mul(f[3], T(6.0)), z[1]), z[2]), z[3]));
  acc = add(acc, mul(mul(mul(mul(f[3], T(3.0)), z[1]), z[1]), z[4]));
  acc = add(acc, mul(mul(mul(f[3], z[2]), z[2]), z[2]));
  acc = add(acc, mul(mul(mul(mul(mul(f[4], T(6.0)), z[1]), z[1]), z[2]), z[2]));
  acc = add(acc, mul(mul(mul(mul(mul(f[4], T(4.0)), z[1]), z[1]), z[1]), z[3]));
  acc = add(acc, mul(mul(mul(mul(mul(mul(f[5], T(5.0)), z[1]), z[1]), z[1]), z[1]), z[2]));
  acc = add(acc, mul(mul(mul(mul(mul(mul(f[6], z[1]), z[1]), z[1]), z[1]), z[1]), z[1]));
  return acc;
}

// order 7: 15 terms
template <typename T>
__device__ __forceinline__ T fdb_order_7(const T* f, const T* z) {
  T acc = mul(f[1], z[7]);
  acc = add(acc, mul(mul(mul(f[2], T(2.0)), z[1]), z[6]));
  acc = add(acc, mul(mul(mul(f[2], T(2.0)), z[2]), z[5]));
  acc = add(acc, mul(mul(mul(f[2], T(2.0)), z[3]), z[4]));
  acc = add(acc, mul(mul(mul(mul(f[3], T(6.0)), z[1]), z[2]), z[4]));
  acc = add(acc, mul(mul(mul(mul(f[3], T(3.0)), z[1]), z[3]), z[3]));
  acc = add(acc, mul(mul(mul(mul(f[3], T(3.0)), z[1]), z[1]), z[5]));
  acc = add(acc, mul(mul(mul(mul(f[3], T(3.0)), z[2]), z[2]), z[3]));
  acc = add(acc, mul(mul(mul(mul(mul(f[4], T(4.0)), z[1]), z[2]), z[2]), z[2]));
  acc = add(acc, mul(mul(mul(mul(mul(f[4], T(12.0)), z[1]), z[1]), z[2]), z[3]));
  acc = add(acc, mul(mul(mul(mul(mul(f[4], T(4.0)), z[1]), z[1]), z[1]), z[4]));
  acc = add(acc, mul(mul(mul(mul(mul(mul(f[5], T(10.0)), z[1]), z[1]), z[1]), z[2]), z[2]));
  acc = add(acc, mul(mul(mul(mul(mul(mul(f[5], T(5.0)), z[1]), z[1]), z[1]), z[1]), z[3]));
  acc = add(acc, mul(mul(mul(mul(mul(mul(mul(f[6], T(6.0)), z[1]), z[1]), z[1]), z[1]), z[1]), z[2]));
  acc = add(acc, mul(mul(mul(mul(mul(mul(mul(f[7], z[1]), z[1]), z[1]), z[1]), z[1]), z[1]), z[1]));
  return acc;
}

// order 8: 22 terms
template <typename T>
__device__ __forceinline__ T fdb_order_8(const T* f, const T* z) {
  T acc = mul(f[1], z[8]);
  acc = add(acc, mul(mul(mul(f[2], T(2.0)), z[1]), z[7]));
  acc = add(acc, mul(mul(mul(f[2], T(2.0)), z[2]), z[6]));
  acc = add(acc, mul(mul(mul(f[2], T(2.0)), z[3]), z[5]));
  acc = add(acc, mul(mul(f[2], z[4]), z[4]));
  acc = add(acc, mul(mul(mul(mul(f[3], T(6.0)), z[1]), z[2]), z[5]));
  acc = add(acc, mul(mul(mul(mul(f[3], T(6.0)), z[1]), z[3]), z[4]));
  acc = add(acc, mul(mul(mul(mul(f[3], T(3.0)), z[1]), z[1]), z[6]));
  acc = add(acc, mul(mul(mul(mul(f[3], T(3.0)), z[2]), z[3]), z[3]));
  acc = add(acc, mul(mul(mul(mul(f[3], T(3.0)), z[2]), z[2]), z[4]));
  acc = add(acc, mul(mul(mul(mul(mul(f[4], T(12.0)), z[1]), z[2]), z[2]), z[3]));
  acc = add(acc, mul(mul(mul(mul(mul(f[4], T(12.0)), z[1]), z[1]), z[2]), z[4]));
  acc = add(acc, mul(mul(mul(mul(mul(f[4], T(6.0)), z[1]), z[1]), z[3]), z[3]));
  acc = add(acc, mul(mul(mul(mul(mul(f[4], T(4.0)), z[1]), z[1]), z[1]), z[5]));
  acc = add(acc, mul(mul(mul(mul(f[4], z[2]), z[2]), z[2]), z[2]));
  acc = add(acc, mul(mul(mul(mul(mul(mul(f[5], T(10.0)), z[1]), z[1]), z[2]), z[2]), z[2]));
  acc = add(acc, mul(mul(mul(mul(mul(mul(f[5], T(20.0)), z[1]), z[1]), z[1]), z[2]), z[3]));
  acc = add(acc, mul(mul(mul(mul(mul(mul(f[5], T(5.0)), z[1]), z[1]), z[1]), z[1]), z[4]));
  acc = add(acc, mul(mul(mul(mul(mul(mul(mul(f[6], T(15.0)), z[1]), z[1]), z[1]), z[1]), z[2]), z[2]));
  acc = add(acc, mul(mul(mul(mul(mul(mul(mul(f[6], T(6.0)), z[1]), z[1]), z[1]), z[1]), z[1]), z[3]));
  acc = add(acc, mul(mul(mul(mul(mul(mul(mul(mul(f[7], T(7.0)), z[1]), z[1]), z[1]), z[1]), z[1]), z[1]), z[2]));
  acc = add(acc, mul(mul(mul(mul(mul(mul(mul(mul(f[8], z[1]), z[1]), z[1]), z[1]), z[1]), z[1]), z[1]), z[1]));
  return acc;
}

template <typename T>
__device__ __forceinline__ T tanh_row_0(T u) {
  return add(mul(T(1.0), u), T(0.0));
}

template <typename T>
__device__ __forceinline__ T tanh_row_1(T u) {
  return add(mul(add(mul(T(-1.0), u), T(0.0)), u), T(1.0));
}

template <typename T>
__device__ __forceinline__ T tanh_row_2(T u) {
  return add(mul(add(mul(add(mul(T(1.0), u), T(0.0)), u), T(-1.0)), u), T(0.0));
}

template <typename T>
__device__ __forceinline__ T tanh_row_3(T u) {
  return add(mul(add(mul(add(mul(add(mul(T(-1.0), u), T(0.0)), u), T(1.3333333333333333)), u), T(0.0)), u), T(-0.3333333333333333));
}

template <typename T>
__device__ __forceinline__ T tanh_row_4(T u) {
  return add(mul(add(mul(add(mul(add(mul(add(mul(T(1.0), u), T(0.0)), u), T(-1.6666666666666665)), u), T(0.0)), u), T(0.6666666666666666)), u), T(0.0));
}

template <typename T>
__device__ __forceinline__ T tanh_row_5(T u) {
  return add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(T(-1.0), u), T(0.0)), u), T(2.0)), u), T(0.0)), u), T(-1.1333333333333333)), u), T(0.0)), u), T(0.13333333333333333));
}

template <typename T>
__device__ __forceinline__ T tanh_row_6(T u) {
  return add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(T(1.0), u), T(0.0)), u), T(-2.3333333333333335)), u), T(0.0)), u), T(1.7111111111111112)), u), T(0.0)), u), T(-0.37777777777777777)), u), T(0.0));
}

template <typename T>
__device__ __forceinline__ T tanh_row_7(T u) {
  return add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(T(-1.0), u), T(0.0)), u), T(2.6666666666666665)), u), T(0.0)), u), T(-2.4)), u), T(0.0)), u), T(0.7873015873015873)), u), T(0.0)), u), T(-0.05396825396825397));
}

template <typename T>
__device__ __forceinline__ T tanh_row_8(T u) {
  return add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(T(1.0), u), T(0.0)), u), T(-3.0)), u), T(0.0)), u), T(3.2)), u), T(0.0)), u), T(-1.3968253968253967)), u), T(0.0)), u), T(0.19682539682539682)), u), T(0.0));
}

template <typename T>
__device__ __forceinline__ T sigmoid_row_0(T u) {
  return add(mul(T(1.0), u), T(0.0));
}

template <typename T>
__device__ __forceinline__ T sigmoid_row_1(T u) {
  return add(mul(add(mul(T(-1.0), u), T(1.0)), u), T(0.0));
}

template <typename T>
__device__ __forceinline__ T sigmoid_row_2(T u) {
  return add(mul(add(mul(add(mul(T(1.0), u), T(-1.5)), u), T(0.5)), u), T(0.0));
}

template <typename T>
__device__ __forceinline__ T sigmoid_row_3(T u) {
  return add(mul(add(mul(add(mul(add(mul(T(-1.0), u), T(2.0)), u), T(-1.1666666666666665)), u), T(0.16666666666666666)), u), T(0.0));
}

template <typename T>
__device__ __forceinline__ T sigmoid_row_4(T u) {
  return add(mul(add(mul(add(mul(add(mul(add(mul(T(1.0), u), T(-2.5)), u), T(2.083333333333333)), u), T(-0.625)), u), T(0.041666666666666664)), u), T(0.0));
}

template <typename T>
__device__ __forceinline__ T sigmoid_row_5(T u) {
  return add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(T(-1.0), u), T(3.0)), u), T(-3.25)), u), T(1.5)), u), T(-0.2583333333333333)), u), T(0.008333333333333333)), u), T(0.0));
}

template <typename T>
__device__ __forceinline__ T sigmoid_row_6(T u) {
  return add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(T(1.0), u), T(-3.5)), u), T(4.666666666666667)), u), T(-2.916666666666667)), u), T(0.8361111111111111)), u), T(-0.08750000000000001)), u), T(0.001388888888888889)), u), T(0.0));
}

template <typename T>
__device__ __forceinline__ T sigmoid_row_7(T u) {
  return add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(T(-1.0), u), T(4.0)), u), T(-6.333333333333333)), u), T(5.0)), u), T(-2.025)), u), T(0.38333333333333336)), u), T(-0.0251984126984127)), u), T(0.0001984126984126984)), u), T(0.0));
}

template <typename T>
__device__ __forceinline__ T sigmoid_row_8(T u) {
  return add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(add(mul(T(1.0), u), T(-4.5)), u), T(8.25)), u), T(-7.875)), u), T(4.1375)), u), T(-1.15625)), u), T(0.15004960317460317)), u), T(-0.006324404761904762)), u), T(2.48015873015873e-05)), u), T(0.0));
}

// out[k] for k < N1; out[0] = F_0
template <typename T, int N1>
__device__ __forceinline__ void faa_di_bruno(const T* f, const T* z, T* out) {
  out[0] = f[0];
  if constexpr (N1 > 1) out[1] = fdb_order_1(f, z);
  if constexpr (N1 > 2) out[2] = fdb_order_2(f, z);
  if constexpr (N1 > 3) out[3] = fdb_order_3(f, z);
  if constexpr (N1 > 4) out[4] = fdb_order_4(f, z);
  if constexpr (N1 > 5) out[5] = fdb_order_5(f, z);
  if constexpr (N1 > 6) out[6] = fdb_order_6(f, z);
  if constexpr (N1 > 7) out[7] = fdb_order_7(f, z);
  if constexpr (N1 > 8) out[8] = fdb_order_8(f, z);
}

// f[m] = tanh^(m)(z_0) / m! for m < N1, from u
template <typename T, int N1>
__device__ __forceinline__ void tanh_rows(T u, T* f) {
  f[0] = tanh_row_0(u);
  if constexpr (N1 > 1) f[1] = tanh_row_1(u);
  if constexpr (N1 > 2) f[2] = tanh_row_2(u);
  if constexpr (N1 > 3) f[3] = tanh_row_3(u);
  if constexpr (N1 > 4) f[4] = tanh_row_4(u);
  if constexpr (N1 > 5) f[5] = tanh_row_5(u);
  if constexpr (N1 > 6) f[6] = tanh_row_6(u);
  if constexpr (N1 > 7) f[7] = tanh_row_7(u);
  if constexpr (N1 > 8) f[8] = tanh_row_8(u);
}

// f[m] = sigmoid^(m)(z_0) / m! for m < N1, from u
template <typename T, int N1>
__device__ __forceinline__ void sigmoid_rows(T u, T* f) {
  f[0] = sigmoid_row_0(u);
  if constexpr (N1 > 1) f[1] = sigmoid_row_1(u);
  if constexpr (N1 > 2) f[2] = sigmoid_row_2(u);
  if constexpr (N1 > 3) f[3] = sigmoid_row_3(u);
  if constexpr (N1 > 4) f[4] = sigmoid_row_4(u);
  if constexpr (N1 > 5) f[5] = sigmoid_row_5(u);
  if constexpr (N1 > 6) f[6] = sigmoid_row_6(u);
  if constexpr (N1 > 7) f[7] = sigmoid_row_7(u);
  if constexpr (N1 > 8) f[8] = sigmoid_row_8(u);
}

}  // namespace fdb
}  // namespace jetk
