// Run-time-order kernels: K1-K5 for any coefficient count N1 = n+1, and for
// bfloat16 stacks at every order.
//
// The templated kernels (act_jet.cu, jet_dense.cu, jet_rms_norm.cu,
// jet_flash_attention.cu, jet_attention_scores.cu) keep each element's N1
// coefficients in registers, one instantiation per N1 <= 9 and per float /
// double, and the dense path reads its Faa di Bruno terms as generated
// straight-line code (fdb_tables.cuh).  They replace the JAX package's
// kernels/jet_dense.py::jet_dense_pallas, kernels/tanh_jet.py::act_jet_pallas
// and kernels/jet_attention.py::{jet_rms_norm_pallas,
// jet_flash_attention_pallas, jet_attention_scores_pallas} up to order 8;
// the Pallas kernels take the stack depth from the input's shape, so these
// kernels replace the same functions at every other order and dtype.  What
// they do instead of the templates:
//
// * N1 is a run-time argument, so every per-element jet lives in shared
//   memory; the wrappers size blocks so that the working set fits
//   (jet_attention.py / tanh_jet.py mirror each formula) and refuse, naming
//   the bytes, only where the smallest block does not.
// * bfloat16 is loaded into float, computed on the float path (FMAs; no
//   tensor cores) and rounded to bfloat16 once, on the store: the
//   reference's promote_types(dtype, float32).
//
// K1 and K2, the dense path (the Burgers k = 4 net trains at N1 = 11 and
// the DenseMLP serves grid(10) through them).  Their epilogue is the Faa di
// Bruno sum out_k = sum_{p in P(k)} C_p F_|p| prod_j z_j^{p_j}: p(k) terms
// of order k, sum_k p(k) in all (138 at order 10, 914 at 16), each a chain
// of products, every order independent of the others.  Walked by one thread
// an element, as one chain of table loads, that chain is the kernel's time
// wherever the elements do not fill the card (the Burgers layers: 12288
// elements).  This design:
//
// * Spread over (element, output order).  bell_tables.order_slots packs the
//   orders into slots of at most p(n) terms (first-fit decreasing: 4 slots
//   at orders 9-16), and a warp takes one slot for 32 lanes x kLane<T>
//   elements: the critical path falls from sum_k p(k) terms to p(n) (138 ->
//   42 at order 10, 914 -> 231 at order 16).  Each order's terms are still
//   summed one by one from zero in ref.py's order, each product multiplied
//   left to right, so K1 and K2 equal their plain versions bit for bit at
//   f32 and f64.  Orders are stored straight out.
// * A flat schedule.  A term is one 16-byte record (its part count m, the
//   counts of the parts 1..4, its first four larger parts), at an address
//   that follows from the term's index: no load waits for another record,
//   and the coefficients the term multiplies wait for its record alone.
//   The table is staged once per block by cp.async where it fits beside
//   the tile (24 KB at order 16), else read from device memory.
// * Registers where the data allow.  The parts 1..4 make up 80-90% of all
//   factors at orders 10-16; a lane keeps z_1..z_4 of its elements in
//   registers and multiplies by them as often as the record counts, with
//   no load.  A lane takes kLane<T> neighbouring elements (32 bytes: 4
//   doubles, 8 floats), so every table load, loop step and vector load of
//   F_m serves that many products, and their chains run side by side.
// * The Taylor stack F once per element: the primal (tanh, sigmoid; sin's
//   whole stack) a thread an element, then the Horner rows a thread an
//   (m, kLane elements), into shared memory.
// * K1's GEMM part tiled: a block's tile is rows x up to 32 output
//   columns, all N1 planes; x's rows (plane, batch row) and w staged by
//   cp.async (kc input columns at a time) in F's room, a thread keeping one
//   column of kRowTile rows in registers, each an FMA chain in input order
//   from zero, as the plain version's GEMM at these shapes.
// * A persistent grid: as many blocks as the SMs hold, walking the tiles,
//   so each block stages the table once.  Small inputs shrink the tile
//   until the grid covers the SMs twice (the Burgers layers: one row of 24
//   columns a block).
//
// K3-K5: K3 a warp per row (lanes over W, warp sums of the
// mean-square jet, lane 0 runs the rsqrt recurrence); K4 a warp per
// (row, query), lanes over the head dims in steps of 32 (any Dh), per head
// two passes over the kept keys (the max of s_0, then the e-jets, totals
// and value contraction with that max: no rescaling), the jet division,
// and the head's share of the projection accumulated in shared memory;
// K5 a warp per (row, query), lanes over keys, three passes (max, totals,
// probabilities), recomputing the score jet in each from one read of the
// key (its coefficients dim by dim).  Dot products use
// explicit fused multiply-adds so that every pass computes bit-identical
// scores.
//
// Bound on the H100: the same as the templated kernels' (bytes; FP64
// operations for K1/K2 at high orders).  K1/K2's walk is bounded by the
// instructions around its products (a term's loads and loop steps) and
// their latency, not by the FP64 pipe; PERF.md has their times against the
// bound.  K3-K5 are simple kernels that are right, not fast: K4 and K5
// re-read keys and values per query from L2 and reduce each score
// coefficient across the warp.
#include <cuda_bf16.h>

#include <algorithm>
#include <type_traits>

#include "act_jet.cuh"  // jetk::Act, jetk::DType, fdb::mul / fdb::add, dev_tanh / sin / cos
#include "cp_async.cuh"

namespace {

using namespace jetk;

constexpr int kBF16 = 2;             // DTYPE_CODES[torch.bfloat16]
constexpr int kSmemLimit = 232448;   // shared memory a block can use on Hopper
constexpr int kMaxWarps = 8;         // warps of a K3/K4/K5 block, at most
constexpr double kMaskNeg = -1e30;
enum Mask : int { kMaskNone = 0, kMaskCausal = 1, kMaskLocal = 2 };
// positions of bell_tables.runtime_table's header
enum Table : int { kOrder = 0, kSlots = 1, kSlotStart = 2, kSlotOrders = 3, kOrderRecords = 4,
                   kRecords = 5, kTanhRows = 6, kSigmoidRows = 7, kInvFact = 8 };

// storage type S, computed in Compute<S>::T
template <typename S>
struct Compute {
  using T = S;
};
template <>
struct Compute<__nv_bfloat16> {
  using T = float;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ double ld(const double* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(double* p, double v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// ---------------------------------------------------------------------------
// K2 and K1: the dense epilogue spread over (element, output order)
// ---------------------------------------------------------------------------

constexpr int kDenseMaxWarps = 8;    // warps of a K1/K2 block, at most (tanh_jet._DENSE_WARPS)
constexpr int kDenseCols = 32;       // K1: output columns of a tile, at most
constexpr int kRowTile = 8;          // K1: (plane, row) pairs a GEMM thread keeps in registers
constexpr int kMaxKc = 32;           // K1: input columns staged at a time, at most

// 16 bytes of T, one vector load.
template <typename T>
struct alignas(16) Lane16 {
  T v[16 / sizeof(T)];
};

// Bytes of `words` compute-type words, rounded up to 16 (the table follows).
__host__ __device__ __forceinline__ int64_t tile_bytes(int64_t words, int item) {
  return (words * item + 15) / 16 * 16;
}
// Words of a K1/K2 tile (tanh_jet.dense_smem): the stacks z and F, n1 words
// an element of epad; K1's GEMM staging shares F's room.
__host__ __device__ __forceinline__ int64_t dense_words(int n1, int epad, int64_t stage) {
  const int64_t stacks = static_cast<int64_t>(n1) * epad;
  return stacks + (stage > stacks ? stage : stacks);
}
// K1's GEMM staging: x rows (plane, row) padded to kRowTile, kc words
// each, then kc rows of w.
__host__ __device__ __forceinline__ int64_t stage_words(int n1, int rows, int kc, int cols) {
  const int64_t nqp = (static_cast<int64_t>(n1) * rows + kRowTile - 1) / kRowTile * kRowTile;
  return (nqp + cols) * kc;
}

// Where element e of a tile goes in an output plane.  K2: a run of
// elements from base.
struct ElemRun {
  int64_t base, count;
  __device__ bool valid(int e) const { return base + e < count; }
  __device__ int64_t at(int e) const { return base + e; }
};
// K1: element e = r * cols + c of a tile of rows x cols from (b0, o0) of
// the (B, Dout) plane.
struct ElemTile {
  int64_t b0, bsz;
  int o0, cols, dout;
  __device__ bool valid(int e) const { return b0 + e / cols < bsz && o0 + e % cols < dout; }
  __device__ int64_t at(int e) const { return (b0 + e / cols) * dout + o0 + e % cols; }
};

// One element of a stack into a shared tile: by cp.async where the storage
// type is the compute type (zero-filled when !ok; `any` is a valid address),
// else loaded and widened (bfloat16).
template <typename S, typename T>
__device__ __forceinline__ void stage_elem(T* dst, const S* src, const S* any, bool ok) {
  if constexpr (std::is_same<S, T>::value) {
    cp_async_elem(dst, ok ? src : any, ok);
  } else {
    *dst = ok ? ld(src) : T(0);
  }
}

// The table into shared memory by 16-byte cp.async copies (runtime_table
// pads both arrays to whole pieces); the caller's next wait covers them.
__device__ __forceinline__ void stage_table(int* ts, const int* tab, int n_ints, double* rs,
                                            const double* re, int n_reals) {
  for (int i = 4 * threadIdx.x; i < n_ints; i += 4 * blockDim.x) cp_async_16(ts + i, tab + i, true);
  for (int i = 2 * threadIdx.x; i < n_reals; i += 2 * blockDim.x) cp_async_16(rs + i, re + i, true);
}

// Horner row m of a Taylor stack (rows bound each row in re, low -> high) at u.
template <typename T>
__device__ __forceinline__ T horner(const int* rows, const double* re, int m, T u) {
  const int lo = rows[m], hi = rows[m + 1];
  T acc = T(re[hi - 1]);
  for (int i = hi - 2; i >= lo; --i) acc = fdb::add(fdb::mul(acc, u), T(re[i]));
  return acc;
}

// kLane<T> neighbouring elements of a tile, which one lane of the epilogue
// takes (tanh_jet.lane_elems): each table load, loop step and vector load
// from shared memory serves kLane products, and the lane's kLane chains of
// products run side by side.  32 bytes of compute type: 4 doubles, 8 floats.
template <typename T>
constexpr int kLane = 32 / static_cast<int>(sizeof(T));

template <typename T>
struct alignas(16) Lane {
  T v[kLane<T>];
};
template <typename T>
__device__ __forceinline__ Lane<T> ldl(const T* p) {
  return *reinterpret_cast<const Lane<T>*>(p);
}
template <typename T>
__device__ __forceinline__ void mul_lane(Lane<T>& p, const Lane<T>& x) {
#pragma unroll
  for (int i = 0; i < kLane<T>; ++i) p.v[i] = fdb::mul(p.v[i], x.v[i]);
}
template <typename T>
__device__ __forceinline__ void add_lane(Lane<T>& acc, const Lane<T>& x) {
#pragma unroll
  for (int i = 0; i < kLane<T>; ++i) acc.v[i] = fdb::add(acc.v[i], x.v[i]);
}
// p <- p * x, `count` times (a count the warp shares)
template <typename T>
__device__ __forceinline__ void mul_lane_pow(Lane<T>& p, const Lane<T>& x, unsigned count) {
#pragma unroll 2
  for (; count > 0; --count) mul_lane(p, x);
}

// A lane's z_1 .. z_4, kept in registers.
template <typename T>
struct Low {
  Lane<T> z1, z2, z3, z4;
};

// Output order k of a lane's elements (z, f their stacks, `stride` apart;
// low their z_1..z_4): the order's terms r, each C_r F_m z_1^e_1 ..
// z_4^e_4 z_j1 .. z_jh multiplied left to right, summed one by one from
// zero in ref.py's order.  A term's record is one 16-byte load, (m, e_1..e_4,
// h + 256 start, j_1..j_4) packed 8 bits a field, at an address that follows
// from r alone; the loads of F_m and z_j1..z_j4 wait for the record and
// nothing else (parts past the fourth larger one, from order 25, are listed
// at start).
template <typename T>
__device__ __forceinline__ Lane<T> order_sum(int k, const int* tab, const double* re, const T* z,
                                             const T* f, int stride, const Low<T>& low) {
  const int* first = tab + tab[kOrderRecords];
  const int4* records = reinterpret_cast<const int4*>(tab + tab[kRecords]);
  Lane<T> acc;
#pragma unroll
  for (int i = 0; i < kLane<T>; ++i) acc.v[i] = T(0);
  for (int r = first[k - 1]; r < first[k]; ++r) {
    const int4 rec = records[r];
    const T c = T(re[r]);
    Lane<T> prod = ldl(f + rec.x * stride);
#pragma unroll
    for (int i = 0; i < kLane<T>; ++i) prod.v[i] = fdb::mul(prod.v[i], c);
    const unsigned e = static_cast<unsigned>(rec.y), j = static_cast<unsigned>(rec.w);
    mul_lane_pow(prod, low.z1, e & 255u);
    mul_lane_pow(prod, low.z2, (e >> 8) & 255u);
    mul_lane_pow(prod, low.z3, (e >> 16) & 255u);
    mul_lane_pow(prod, low.z4, e >> 24);
    const int h = rec.z & 255;
    if (h > 0) {
      mul_lane(prod, ldl(z + (j & 255u) * stride));
      if (h > 1) {
        mul_lane(prod, ldl(z + ((j >> 8) & 255u) * stride));
        if (h > 2) {
          mul_lane(prod, ldl(z + ((j >> 16) & 255u) * stride));
          if (h > 3) {
            mul_lane(prod, ldl(z + (j >> 24) * stride));
            for (int i = rec.z >> 8; i < (rec.z >> 8) + h - 4; ++i)
              mul_lane(prod, ldl(z + tab[i] * stride));
          }
        }
      }
    }
    add_lane(acc, prod);
  }
  return acc;
}

// The activation jet of a tile's `elems` elements whose stacks are in z
// ([coefficient][epad], epad a multiple of 32), stored to out (planes `plane`
// apart, element e at map.at(e)); f is the Taylor stack's room.  Three
// phases, each closed by __syncthreads(): (1) a thread an element: the
// primal u into f[0] (tanh, sigmoid; for sin the whole stack) and out_0;
// (2) a thread an (m, kLane elements): Horner row m at u into f[m]; (3) a
// warp a (group of 32 kLane elements, slot of the table's schedule): each
// output order of the slot, stored straight out.  Orders read z and F
// only, so none waits for another, and the longest slot sums p(n) terms.
template <typename S, typename T, typename Map>
__device__ __forceinline__ void dense_epilogue(int act, int n1, int elems, int epad,
                                               const int* tab, const double* re, const T* z,
                                               T* f, S* out, int64_t plane, Map map) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int* rows = tab + tab[act == kTanh ? kTanhRows : kSigmoidRows];
  for (int e = tid; e < elems; e += nthreads) {
    const T z0 = z[e];
    if (act == kSin) {
      const T s = dev_sin(z0), c = dev_cos(z0);
      const double* inv = re + tab[kInvFact];
      for (int m = 0; m < n1; ++m) {
        const T v = (m % 4 == 0) ? s : (m % 4 == 1) ? c : (m % 4 == 2) ? -s : -c;
        f[m * epad + e] = fdb::mul(v, T(inv[m]));
      }
      if (map.valid(e)) st(out + map.at(e), f[e]);
    } else {
      const T u = act == kTanh ? dev_tanh(z0) : T(0.5) * (dev_tanh(T(0.5) * z0) + T(1));
      f[e] = u;
      if (map.valid(e)) st(out + map.at(e), horner(rows, re, 0, u));
    }
  }
  __syncthreads();
  if (act != kSin) {
    const int chunks = epad / kLane<T>;
    for (int i = tid; i < (n1 - 1) * chunks; i += nthreads) {
      const int m = 1 + i / chunks, e = (i - (m - 1) * chunks) * kLane<T>;
      if (e >= elems) continue;
      const Lane<T> u = ldl(f + e);
      const int lo = rows[m], hi = rows[m + 1];
      Lane<T> acc;
#pragma unroll
      for (int j = 0; j < kLane<T>; ++j) acc.v[j] = T(re[hi - 1]);
      for (int h = hi - 2; h >= lo; --h) {
        const T c = T(re[h]);
#pragma unroll
        for (int j = 0; j < kLane<T>; ++j) acc.v[j] = fdb::add(fdb::mul(acc.v[j], u.v[j]), c);
      }
      *reinterpret_cast<Lane<T>*>(f + m * epad + e) = acc;
    }
    __syncthreads();
  }
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int slots = tab[kSlots], groups = (elems + 32 * kLane<T> - 1) / (32 * kLane<T>);
  const int* slot_start = tab + tab[kSlotStart];
  const int* slot_orders = tab + tab[kSlotOrders];
  for (int it = warp; it < groups * slots; it += nwarps) {
    const int g = it / slots, s = it - g * slots, e0 = (g * 32 + lane) * kLane<T>;
    if (e0 >= elems) continue;
    int64_t at[kLane<T>];
    unsigned ok = 0;
#pragma unroll
    for (int i = 0; i < kLane<T>; ++i) {
      ok |= (e0 + i < elems && map.valid(e0 + i)) ? 1u << i : 0u;
      at[i] = map.at(e0 + i);
    }
    const T* ze = z + e0;
    Lane<T> zero;
#pragma unroll
    for (int i = 0; i < kLane<T>; ++i) zero.v[i] = T(0);
    const Low<T> low{n1 > 1 ? ldl(ze + epad) : zero, n1 > 2 ? ldl(ze + 2 * epad) : zero,
                     n1 > 3 ? ldl(ze + 3 * epad) : zero, n1 > 4 ? ldl(ze + 4 * epad) : zero};
    for (int i = slot_start[s]; i < slot_start[s + 1]; ++i) {
      const int k = slot_orders[i];
      const Lane<T> v = order_sum(k, tab, re, ze, f + e0, epad, low);
#pragma unroll
      for (int j = 0; j < kLane<T>; ++j)
        if (ok & (1u << j)) st(out + k * plane + at[j], v.v[j]);
    }
  }
}

// K2: a persistent grid; a block walks tiles of 32 * units elements, its
// warps one per (group of 64, slot).
template <typename S, bool STAGED>
__global__ void __launch_bounds__(kDenseMaxWarps * 32, 3)
    act_jet_rt_kernel(const S* __restrict__ x, S* __restrict__ out, int64_t n_elem, int n1,
                      int act, const int* __restrict__ tab_g, const double* __restrict__ re_g,
                      int n_ints, int n_reals, int units) {
  using T = typename Compute<S>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int epad = 32 * units;
  T* z = reinterpret_cast<T*>(smem_raw);
  T* f = z + n1 * epad;
  const int* tab = tab_g;
  const double* re = re_g;
  if constexpr (STAGED) {
    int* ts = reinterpret_cast<int*>(smem_raw + tile_bytes(dense_words(n1, epad, 0), sizeof(T)));
    double* rs = reinterpret_cast<double*>(ts + n_ints);
    stage_table(ts, tab_g, n_ints, rs, re_g, n_reals);
    tab = ts;
    re = rs;
  }
  const int64_t tiles = (n_elem + epad - 1) / epad;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t base = t * epad;
    const int elems = static_cast<int>(n_elem - base < epad ? n_elem - base : epad);
#pragma unroll 8
    for (int i = threadIdx.x; i < n1 * epad; i += blockDim.x) {
      const int p = i / epad, e = i - p * epad;
      stage_elem(z + i, x + p * n_elem + base + e, x, e < elems);
    }
    cp_async_wait_all();
    __syncthreads();
    dense_epilogue<S, T>(act, n1, elems, epad, tab, re, z, f, out, n_elem, ElemRun{base, n_elem});
    __syncthreads();   // the next tile overwrites z and f
  }
}

// K1: a persistent grid over tiles of rows x cols outputs.  The GEMM part:
// kc input columns at a time, x's rows (plane p, batch row r) as rows
// q = p * rows + r, a warp a row, and w's rows staged by cp.async in F's
// room; a thread keeps one output column of kRowTile rows q in registers,
// each a chain of FMAs in input order from zero (as the templated K1 and
// the plain version's GEMM), the bias on c_0 after it, and reads x 16 bytes
// at a time (the warp's lanes share the address).  The pre-activations go
// to z, then the epilogue as K2's.  Without an activation they go straight
// out.
template <typename S, bool STAGED>
__global__ void __launch_bounds__(kDenseMaxWarps * 32, 3)
    jet_dense_rt_kernel(const S* __restrict__ x, const S* __restrict__ w,
                        const S* __restrict__ bias, S* __restrict__ out, int64_t bsz, int din,
                        int dout, int n1, int act, const int* __restrict__ tab_g,
                        const double* __restrict__ re_g, int n_ints, int n_reals, int rows,
                        int kc) {
  using T = typename Compute<S>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cols = min(dout, kDenseCols), elems = rows * cols, epad = (elems + 31) / 32 * 32;
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int nq = n1 * rows, nqp = (nq + kRowTile - 1) / kRowTile * kRowTile;
  T* z = reinterpret_cast<T*>(smem_raw);
  T* f = z + n1 * epad;
  T* xs = f;                 // the staging shares F's room: [nqp][kc], then [kc][cols]
  T* ws = xs + nqp * kc;
  const int* tab = tab_g;
  const double* re = re_g;
  if constexpr (STAGED) {
    int* ts = reinterpret_cast<int*>(
        smem_raw + tile_bytes(dense_words(n1, epad, stage_words(n1, rows, kc, cols)), sizeof(T)));
    double* rs = reinterpret_cast<double*>(ts + n_ints);
    stage_table(ts, tab_g, n_ints, rs, re_g, n_reals);
    tab = ts;
    re = rs;
  }
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int col_tiles = (dout + cols - 1) / cols;
  const int64_t tiles = (bsz + rows - 1) / rows * col_tiles;
  const int64_t plane_in = bsz * din, plane_out = bsz * dout;
  const int items = nqp / kRowTile * cols, rounds = (items + nthreads - 1) / nthreads;
  const bool one_chunk = din <= kc;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t b0 = t / col_tiles * rows;
    const int o0 = static_cast<int>(t % col_tiles) * cols;
    const int nrows = static_cast<int>(bsz - b0 < rows ? bsz - b0 : rows);
    for (int round = 0; round < rounds; ++round) {
      const int item = round * nthreads + tid;
      const bool active = item < items;
      const int c = item % cols, q0 = item / cols * kRowTile;
      T acc[kRowTile];
#pragma unroll
      for (int j = 0; j < kRowTile; ++j) acc[j] = T(0);
      for (int k0 = 0; k0 < din; k0 += kc) {
        const int kn = min(kc, din - k0);
        if (round == 0 || !one_chunk) {
          if (lane < kc) {
#pragma unroll 4
            for (int q = warp; q < nqp; q += nwarps) {
              const int p = q / rows, r = q - p * rows;
              const bool ok = q < nq && r < nrows && lane < kn;
              stage_elem(xs + q * kc + lane, x + p * plane_in + (b0 + r) * din + k0 + lane, x,
                         ok);
            }
          }
          for (int k = warp; k < kc; k += nwarps)
            for (int cc = lane; cc < cols; cc += 32)
              stage_elem(ws + k * cols + cc, w + static_cast<int64_t>(k0 + k) * dout + o0 + cc,
                         w, k < kn && o0 + cc < dout);
          cp_async_wait_all();
          __syncthreads();
        }
        if (active) {
          const T* xq = xs + q0 * kc;
          int k = 0;
          if (kc % VEC == 0) {
            for (; k + VEC <= kn; k += VEC) {
              T xv[kRowTile][VEC];
#pragma unroll
              for (int j = 0; j < kRowTile; ++j)
                *reinterpret_cast<Lane16<T>*>(xv[j]) =
                    *reinterpret_cast<const Lane16<T>*>(xq + j * kc + k);
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                const T wv = ws[(k + v) * cols + c];
#pragma unroll
                for (int j = 0; j < kRowTile; ++j) acc[j] = fmadd(xv[j][v], wv, acc[j]);
              }
            }
          }
          for (; k < kn; ++k) {
            const T wv = ws[k * cols + c];
#pragma unroll
            for (int j = 0; j < kRowTile; ++j) acc[j] = fmadd(xq[j * kc + k], wv, acc[j]);
          }
        }
        if (!one_chunk) __syncthreads();   // the next chunk overwrites xs and ws
      }
      if (active) {
#pragma unroll
        for (int j = 0; j < kRowTile; ++j) {
          const int q = q0 + j, p = q / rows, r = q - p * rows;
          if (q < nq) {
            T v = acc[j];
            if (p == 0 && o0 + c < dout) v += ld(bias + o0 + c);
            if (act != kNone) {
              z[p * epad + r * cols + c] = v;
            } else if (r < nrows && o0 + c < dout) {
              st(out + p * plane_out + (b0 + r) * dout + o0 + c, v);
            }
          }
        }
      }
    }
    __syncthreads();   // z complete; the staging's room is F's again
    if (act != kNone) {
      dense_epilogue<S, T>(act, n1, elems, epad, tab, re, z, f, out, plane_out,
                           ElemTile{b0, bsz, o0, cols, dout});
      __syncthreads();   // the next tile overwrites z and f
    }
  }
}

// ---------------------------------------------------------------------------
// K3: a warp per row; the row's mean-square and rsqrt jets in shared memory
// ---------------------------------------------------------------------------

template <typename S>
__global__ void jet_rms_norm_rt_kernel(const S* __restrict__ x, const S* __restrict__ gamma,
                                       S* __restrict__ out, int64_t bsz, int width, int n1,
                                       typename Compute<S>::T eps) {
  using T = typename Compute<S>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  T* ms = reinterpret_cast<T*>(smem_raw) + warp * 2 * n1;
  T* inv = ms + n1;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * nw + warp;
  if (row >= bsz) return;   // the whole warp leaves: the shuffles below stay full
  const int64_t plane = bsz * width;
  const S* xr = x + row * width;
  for (int m = 0; m < n1; ++m) {
    T part = T(0);
    for (int w = lane; w < width; w += 32)
      for (int i = 0; i <= m; ++i)
        part = fmadd(ld(xr + i * plane + w), ld(xr + (m - i) * plane + w), part);
    part = warp_sum(part) / T(width);
    if (lane == 0) ms[m] = m == 0 ? part + eps : part;
  }
  __syncwarp();
  if (lane == 0) {
    inv[0] = T(1) / dev_sqrt(ms[0]);
    for (int m = 1; m < n1; ++m) {
      T acc = T(0);
      for (int j = 1; j <= m; ++j) acc += (T(0.5) * T(j) - T(m)) * ms[j] * inv[m - j];
      inv[m] = acc / (T(m) * ms[0]);
    }
  }
  __syncwarp();
  S* outr = out + row * width;
  for (int w = lane; w < width; w += 32) {
    const T g = ld(gamma + w);
    for (int m = 0; m < n1; ++m) {
      T acc = T(0);
      for (int j = 0; j <= m; ++j) acc = fmadd(ld(xr + (m - j) * plane + w), inv[j], acc);
      st(outr + m * plane + w, acc * g);
    }
  }
}

// ---------------------------------------------------------------------------
// K4: a warp per (row, query), lanes over the head dims
// ---------------------------------------------------------------------------

__device__ __forceinline__ int keep_lo(int qi, int mask, int window) {
  return mask == kMaskLocal ? max(0, qi - window + 1) : 0;
}
__device__ __forceinline__ int keep_hi(int qi, int t, int mask) {
  return mask == kMaskNone ? t : qi + 1;
}

// scale sum_{i <= m} q_i . k_{m-i} for the key row kr (a plane apart per
// coefficient), the query in shared memory; the same bits in every pass
template <typename S, typename T>
__device__ __forceinline__ T flash_score(const T* qs, const S* kr, int64_t plane, int dh, int m,
                                         int lane, T scale) {
  T part = T(0);
  for (int d = lane; d < dh; d += 32)
    for (int i = 0; i <= m; ++i) part = fmadd(qs[i * dh + d], ld(kr + (m - i) * plane + d), part);
  return warp_sum(part) * scale;
}

__host__ __device__ inline int64_t flash_words(int n1, int dh, int dm) {
  return 2LL * n1 * dh + static_cast<int64_t>(n1) * dm + 3LL * n1;
}

template <typename S>
__global__ void jet_flash_attention_rt_kernel(const S* __restrict__ q, const S* __restrict__ k,
                                              const S* __restrict__ v, const S* __restrict__ wo,
                                              S* __restrict__ out, int64_t bsz, int heads, int t,
                                              int dh, int dm, int n1, typename Compute<S>::T scale,
                                              int mask, int window) {
  using T = typename Compute<S>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  T* qs = reinterpret_cast<T*>(smem_raw) + warp * flash_words(n1, dh, dm);  // [n1][dh]
  T* as = qs + n1 * dh;                                                    // [n1][dh]
  T* rs = as + n1 * dh;                                                    // [n1][dm]
  T* sc = rs + n1 * dm;
  T* ec = sc + n1;
  T* tot = ec + n1;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * nw + warp;
  if (item >= bsz * t) return;   // warp-uniform
  const int64_t b = item / t;
  const int qi = static_cast<int>(item - b * t);
  const int64_t seg = static_cast<int64_t>(t) * dh;
  const int64_t plane = bsz * heads * seg;
  const int lo = keep_lo(qi, mask, window), hi = keep_hi(qi, t, mask);
  for (int idx = lane; idx < n1 * dm; idx += 32) rs[idx] = T(0);

  for (int h = 0; h < heads; ++h) {
    const int64_t head = (b * heads + h) * seg;
    for (int idx = lane; idx < n1 * dh; idx += 32) {
      const int i = idx / dh, d = idx - i * dh;
      qs[idx] = ld(q + i * plane + head + static_cast<int64_t>(qi) * dh + d);
      as[idx] = T(0);
    }
    if (lane == 0)
      for (int m = 0; m < n1; ++m) tot[m] = T(0);
    __syncwarp();
    T mx = T(kMaskNeg);
    for (int j = lo; j < hi; ++j) {
      const T s0 = flash_score(qs, k + head + static_cast<int64_t>(j) * dh, plane, dh, 0, lane, scale);
      mx = s0 > mx ? s0 : mx;
    }
    for (int j = lo; j < hi; ++j) {
      const S* kr = k + head + static_cast<int64_t>(j) * dh;
      for (int m = 0; m < n1; ++m) {
        const T s = flash_score(qs, kr, plane, dh, m, lane, scale);
        if (lane == 0) sc[m] = s;
      }
      if (lane == 0) {
        ec[0] = dev_exp(sc[0] - mx);
        tot[0] += ec[0];
        for (int m = 1; m < n1; ++m) {
          T acc = T(0);
          for (int jj = 1; jj <= m; ++jj) acc += T(jj) * sc[jj] * ec[m - jj];
          ec[m] = acc / T(m);
          tot[m] += ec[m];
        }
      }
      __syncwarp();
      const S* vr = v + head + static_cast<int64_t>(j) * dh;
      for (int d = lane; d < dh; d += 32)
        for (int m = 0; m < n1; ++m) {
          T acc = as[m * dh + d];
          for (int i = 0; i <= m; ++i) acc = fmadd(ec[i], ld(vr + (m - i) * plane + d), acc);
          as[m * dh + d] = acc;
        }
      __syncwarp();   // sc and ec are rewritten for the next key
    }
    // o = a / tot as jets, over a in place (o_m needs a_m and o_{<m})
    const T inv0 = T(1) / (tot[0] > T(1e-37) ? tot[0] : T(1e-37));
    for (int d = lane; d < dh; d += 32)
      for (int m = 0; m < n1; ++m) {
        T r = as[m * dh + d];
        for (int j = 1; j <= m; ++j) r -= tot[j] * as[(m - j) * dh + d];
        as[m * dh + d] = r * inv0;
      }
    __syncwarp();
    for (int n = lane; n < dm; n += 32)
      for (int m = 0; m < n1; ++m) {
        T acc = rs[m * dm + n];
        for (int d = 0; d < dh; ++d)
          acc = fmadd(as[m * dh + d], ld(wo + (static_cast<int64_t>(h) * dh + d) * dm + n), acc);
        rs[m * dm + n] = acc;
      }
    __syncwarp();   // qs, as and tot are rewritten for the next head
  }
  const int64_t out_plane = bsz * t * dm;
  S* outr = out + item * dm;
  for (int n = lane; n < dm; n += 32)
    for (int m = 0; m < n1; ++m) st(outr + m * out_plane + n, rs[m * dm + n]);
}

// ---------------------------------------------------------------------------
// K5: a warp per (row, query), lanes over keys
// ---------------------------------------------------------------------------

__host__ __device__ inline int64_t scores_words(int n1, int d) { return static_cast<int64_t>(n1) * d + 65LL * n1; }

// the score jet s[m * 32] (m < n1) of the key row kr against the query in
// shared memory, then its e-jet e[m * 32] for the row max mx.  The key is
// read once: dim by dim, its n1 coefficients of that dim go to e (free
// until the e-jet is computed) and feed every (m, i) product.  s_0 takes
// the same fused multiply-adds in the same order as pass 1's.
template <typename S, typename T>
__device__ __forceinline__ void scores_e_jet(const T* qs, const S* kr, int64_t plane, int d,
                                             int n1, T scale, T mx, T* s, T* e) {
  for (int m = 0; m < n1; ++m) s[m * 32] = T(0);
  for (int dd = 0; dd < d; ++dd) {
    for (int c = 0; c < n1; ++c) e[c * 32] = ld(kr + c * plane + dd);
    for (int m = 0; m < n1; ++m) {
      T acc = s[m * 32];
      for (int i = 0; i <= m; ++i) acc = fmadd(qs[i * d + dd], e[(m - i) * 32], acc);
      s[m * 32] = acc;
    }
  }
  for (int m = 0; m < n1; ++m) s[m * 32] *= scale;
  e[0] = dev_exp(s[0] - mx);
  for (int m = 1; m < n1; ++m) {
    T acc = T(0);
    for (int j = 1; j <= m; ++j) acc += T(j) * s[j * 32] * e[(m - j) * 32];
    e[m * 32] = acc / T(m);
  }
}

template <typename S>
__global__ void jet_attention_scores_rt_kernel(const S* __restrict__ q, const S* __restrict__ k,
                                               S* __restrict__ out, int64_t bsz, int t, int d,
                                               int n1, typename Compute<S>::T scale) {
  using T = typename Compute<S>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  T* qs = reinterpret_cast<T*>(smem_raw) + warp * scores_words(n1, d);  // [n1][d]
  T* s = qs + n1 * d + lane;                                           // [n1][32]
  T* e = s + 32 * n1;                                                  // [n1][32]
  T* tot = qs + n1 * d + 64 * n1;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * nw + warp;
  if (item >= bsz * t) return;   // warp-uniform
  const int64_t b = item / t;
  const int64_t plane = bsz * t * d;
  const S* krow = k + b * t * d;
  for (int idx = lane; idx < n1 * d; idx += 32) {
    const int i = idx / d, dd = idx - i * d;
    qs[idx] = ld(q + i * plane + item * d + dd);
  }
  if (lane == 0)
    for (int m = 0; m < n1; ++m) tot[m] = T(0);
  __syncwarp();
  // pass 1: the row max of s_0
  T mx = T(kMaskNeg);
  for (int j = lane; j < t; j += 32) {
    T dot = T(0);
    for (int dd = 0; dd < d; ++dd) dot = fmadd(qs[dd], ld(krow + static_cast<int64_t>(j) * d + dd), dot);
    const T s0 = scale * dot;
    mx = s0 > mx ? s0 : mx;
  }
  mx = warp_max(mx);
  // pass 2: the totals
  for (int j0 = 0; j0 < t; j0 += 32) {
    const int j = j0 + lane;
    if (j < t) scores_e_jet(qs, krow + static_cast<int64_t>(j) * d, plane, d, n1, scale, mx, s, e);
    for (int m = 0; m < n1; ++m) {
      const T sum = warp_sum(j < t ? e[m * 32] : T(0));
      if (lane == 0) tot[m] += sum;
    }
  }
  __syncwarp();
  // pass 3: p_0 = e_0 / tot_0, p_m = (e_m - sum_{j=1..m} tot_j p_{m-j}) / tot_0,
  // over e in place
  const int64_t out_plane = bsz * t * static_cast<int64_t>(t);
  S* outr = out + item * t;
  for (int j = lane; j < t; j += 32) {
    scores_e_jet(qs, krow + static_cast<int64_t>(j) * d, plane, d, n1, scale, mx, s, e);
    for (int m = 0; m < n1; ++m) {
      T acc = T(0);
      for (int jj = 1; jj <= m; ++jj) acc += tot[jj] * e[(m - jj) * 32];
      e[m * 32] = (e[m * 32] - acc) / tot[0];
      st(outr + m * out_plane + j, e[m * 32]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in;
// a refused opt-in is returned, and cleared so no later launch reports it.
template <typename K>
cudaError_t allow_smem(K kernel, int64_t smem) {
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

int64_t blocks_of(int64_t items, int per_block) { return (items + per_block - 1) / per_block; }

// A persistent grid: as many blocks as the SMs hold at once, at most one a
// tile.
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, int64_t smem, int64_t tiles, unsigned* grid) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      static_cast<size_t>(smem));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *grid = static_cast<unsigned>(std::min<int64_t>(tiles, std::max(per_sm, 1) * int64_t{sms}));
  return cudaSuccess;
}

int64_t table_bytes(int n_ints, int n_reals) { return 4LL * n_ints + 8LL * n_reals; }

template <typename S>
cudaError_t act_jet_rt(const void* x, void* out, int64_t n_elem, int n1, int act, const int* tab,
                       const double* re, int n_ints, int n_reals, int units, int warps,
                       bool staged, cudaStream_t stream) {
  using T = typename Compute<S>::T;
  const int epad = 32 * units;
  const int64_t smem = tile_bytes(dense_words(n1, epad, 0), sizeof(T)) +
                       (staged ? table_bytes(n_ints, n_reals) : 0);
  auto kernel = staged ? &act_jet_rt_kernel<S, true> : &act_jet_rt_kernel<S, false>;
  unsigned grid = 0;
  const cudaError_t err =
      persistent_grid(kernel, warps * 32, smem, (n_elem + epad - 1) / epad, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, warps * 32, smem, stream>>>(static_cast<const S*>(x), static_cast<S*>(out),
                                             n_elem, n1, act, tab, re, n_ints, n_reals, units);
  return cudaGetLastError();
}

template <typename S>
cudaError_t jet_dense_rt(const void* x, const void* w, const void* bias, void* out, int64_t bsz,
                         int din, int dout, int n1, int act, const int* tab, const double* re,
                         int n_ints, int n_reals, int rows, int kc, int warps, bool staged,
                         cudaStream_t stream) {
  using T = typename Compute<S>::T;
  const int cols = std::min(dout, kDenseCols), epad = (rows * cols + 31) / 32 * 32;
  const int64_t smem =
      tile_bytes(dense_words(n1, epad, stage_words(n1, rows, kc, cols)), sizeof(T)) +
      (staged ? table_bytes(n_ints, n_reals) : 0);
  const int64_t tiles = (bsz + rows - 1) / rows * ((dout + cols - 1) / cols);
  auto kernel = staged ? &jet_dense_rt_kernel<S, true> : &jet_dense_rt_kernel<S, false>;
  unsigned grid = 0;
  const cudaError_t err = persistent_grid(kernel, warps * 32, smem, tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, warps * 32, smem, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(w), static_cast<const S*>(bias),
      static_cast<S*>(out), bsz, din, dout, n1, act, tab, re, n_ints, n_reals, rows, kc);
  return cudaGetLastError();
}

template <typename S>
cudaError_t jet_rms_norm_rt(const void* x, const void* gamma, void* out, int64_t bsz, int width,
                            int n1, double eps, int warps, cudaStream_t stream) {
  using T = typename Compute<S>::T;
  const int64_t smem = 2LL * n1 * warps * sizeof(T);
  const int64_t blocks = blocks_of(bsz, warps);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = jet_rms_norm_rt_kernel<S>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(gamma), static_cast<S*>(out), bsz, width,
      n1, static_cast<T>(eps));
  return cudaGetLastError();
}

template <typename S>
cudaError_t jet_flash_attention_rt(const void* q, const void* k, const void* v, const void* wo,
                                   void* out, int64_t bsz, int heads, int t, int dh, int dm,
                                   int n1, double scale, int mask, int window, int warps,
                                   cudaStream_t stream) {
  using T = typename Compute<S>::T;
  const int64_t smem = flash_words(n1, dh, dm) * warps * static_cast<int64_t>(sizeof(T));
  const int64_t blocks = blocks_of(bsz * t, warps);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = jet_flash_attention_rt_kernel<S>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
      static_cast<const S*>(q), static_cast<const S*>(k), static_cast<const S*>(v),
      static_cast<const S*>(wo), static_cast<S*>(out), bsz, heads, t, dh, dm, n1,
      static_cast<T>(scale), mask, window);
  return cudaGetLastError();
}

template <typename S>
cudaError_t jet_attention_scores_rt(const void* q, const void* k, void* out, int64_t bsz, int t,
                                    int d, int n1, double scale, int warps, cudaStream_t stream) {
  using T = typename Compute<S>::T;
  const int64_t smem = scores_words(n1, d) * warps * static_cast<int64_t>(sizeof(T));
  const int64_t blocks = blocks_of(bsz * t, warps);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = jet_attention_scores_rt_kernel<S>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), warps * 32, smem, stream>>>(
      static_cast<const S*>(q), static_cast<const S*>(k), static_cast<S*>(out), bsz, t, d, n1,
      static_cast<T>(scale));
  return cudaGetLastError();
}

bool bad_warps(int warps) { return warps < 1 || warps > kMaxWarps; }

}  // namespace

// Each returns a cudaError_t: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for an argument the kernel does not take (a block
// whose shared memory exceeds the limit among them), or cudaSuccess for an
// empty input.  dtype: 0 float32, 1 float64, 2 bfloat16.  tab and reals are
// bell_tables.runtime_table(n1 - 1) on the tensors' device, as int32 and
// float64, n_ints and n_reals long.  The wrappers (tanh_jet.py,
// jet_dense.py, jet_attention.py) choose the geometry so the block fits: K2
// units of 32 elements, K1 rows and kc, the warps and whether the table is
// staged in shared memory (act_jet_geometry, jet_dense_geometry); the caller
// makes the tensors' device current.
extern "C" int act_jet_rt_launch(const void* x, void* out, int64_t n_elem, int n1, int act,
                                 int dtype, const void* tab, const void* reals, int n_ints,
                                 int n_reals, int units, int warps, int staged, void* stream) {
  if (n_elem < 0 || n1 < 1 || act < kTanh || act > kSin || units < 1 || warps < 1 ||
      warps > kDenseMaxWarps || n_ints % 4 || n_reals % 2)
    return cudaErrorInvalidValue;
  if (n_elem == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const int* ti = static_cast<const int*>(tab);
  const double* re = static_cast<const double*>(reals);
  const bool stage = staged != 0;
  if (dtype == kF32)
    return act_jet_rt<float>(x, out, n_elem, n1, act, ti, re, n_ints, n_reals, units, warps,
                             stage, s);
  if (dtype == kF64)
    return act_jet_rt<double>(x, out, n_elem, n1, act, ti, re, n_ints, n_reals, units, warps,
                              stage, s);
  if (dtype == kBF16)
    return act_jet_rt<__nv_bfloat16>(x, out, n_elem, n1, act, ti, re, n_ints, n_reals, units,
                                     warps, stage, s);
  return cudaErrorInvalidValue;
}

extern "C" int jet_dense_rt_launch(const void* x, const void* w, const void* bias, void* out,
                                   int64_t bsz, int din, int dout, int n1, int act, int dtype,
                                   const void* tab, const void* reals, int n_ints, int n_reals,
                                   int rows, int kc, int warps, int staged, void* stream) {
  if (bsz < 0 || din < 1 || dout < 1 || n1 < 1 || act < kNone || act > kSin || rows < 1 ||
      kc < 1 || kc > kMaxKc || warps < 1 || warps > kDenseMaxWarps || n_ints % 4 || n_reals % 2)
    return cudaErrorInvalidValue;
  if (bsz == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const int* ti = static_cast<const int*>(tab);
  const double* re = static_cast<const double*>(reals);
  const bool stage = staged != 0;
  if (dtype == kF32)
    return jet_dense_rt<float>(x, w, bias, out, bsz, din, dout, n1, act, ti, re, n_ints, n_reals,
                               rows, kc, warps, stage, s);
  if (dtype == kF64)
    return jet_dense_rt<double>(x, w, bias, out, bsz, din, dout, n1, act, ti, re, n_ints, n_reals,
                                rows, kc, warps, stage, s);
  if (dtype == kBF16)
    return jet_dense_rt<__nv_bfloat16>(x, w, bias, out, bsz, din, dout, n1, act, ti, re, n_ints,
                                       n_reals, rows, kc, warps, stage, s);
  return cudaErrorInvalidValue;
}

extern "C" int jet_rms_norm_rt_launch(const void* x, const void* gamma, void* out, int64_t bsz,
                                      int width, int n1, int dtype, double eps, int warps,
                                      void* stream) {
  if (bsz < 0 || width < 1 || n1 < 1 || bad_warps(warps)) return cudaErrorInvalidValue;
  if (bsz == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return jet_rms_norm_rt<float>(x, gamma, out, bsz, width, n1, eps, warps, s);
  if (dtype == kF64) return jet_rms_norm_rt<double>(x, gamma, out, bsz, width, n1, eps, warps, s);
  if (dtype == kBF16)
    return jet_rms_norm_rt<__nv_bfloat16>(x, gamma, out, bsz, width, n1, eps, warps, s);
  return cudaErrorInvalidValue;
}

extern "C" int jet_flash_attention_rt_launch(const void* q, const void* k, const void* v,
                                             const void* wo, void* out, int64_t bsz, int heads,
                                             int t, int dh, int dm, int n1, int dtype,
                                             double scale, int mask, int window, int warps,
                                             void* stream) {
  if (bsz < 0 || heads < 1 || t < 1 || dh < 1 || dm < 1 || n1 < 1 || bad_warps(warps))
    return cudaErrorInvalidValue;
  if (mask < kMaskNone || mask > kMaskLocal || (mask == kMaskLocal && window < 1))
    return cudaErrorInvalidValue;
  if (bsz == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return jet_flash_attention_rt<float>(q, k, v, wo, out, bsz, heads, t, dh, dm, n1, scale,
                                         mask, window, warps, s);
  if (dtype == kF64)
    return jet_flash_attention_rt<double>(q, k, v, wo, out, bsz, heads, t, dh, dm, n1, scale,
                                          mask, window, warps, s);
  if (dtype == kBF16)
    return jet_flash_attention_rt<__nv_bfloat16>(q, k, v, wo, out, bsz, heads, t, dh, dm, n1,
                                                 scale, mask, window, warps, s);
  return cudaErrorInvalidValue;
}

extern "C" int jet_attention_scores_rt_launch(const void* q, const void* k, void* out,
                                              int64_t bsz, int t, int d, int n1, int dtype,
                                              double scale, int warps, void* stream) {
  if (bsz < 0 || t < 1 || d < 1 || n1 < 1 || bad_warps(warps)) return cudaErrorInvalidValue;
  if (bsz == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return jet_attention_scores_rt<float>(q, k, out, bsz, t, d, n1, scale, warps, s);
  if (dtype == kF64)
    return jet_attention_scores_rt<double>(q, k, out, bsz, t, d, n1, scale, warps, s);
  if (dtype == kBF16)
    return jet_attention_scores_rt<__nv_bfloat16>(q, k, out, bsz, t, d, n1, scale, warps, s);
  return cudaErrorInvalidValue;
}
