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
// K3 and K4, the trunk's kernels past the templates (its grid(10) engine
// call launches 7 K3 at (11, 2048, 32) and 3 K4 at (11, 1024, 2, 2, 16)).
// Their first versions gave a warp a row or a (row, query), re-read each
// coefficient O(n1) times, reduced every score and mean-square coefficient
// in its own warp sum and ran the recurrences on lane 0.  Now:
//
// * K3: a power-of-two group of lanes a row (16-byte chunks a lane, several
//   rows a warp at W = 32), the row copied once into shared memory by
//   cp.async; the mean square and the output are Cauchy products, kRmsTile
//   coefficients a lane at a time from a sliding window of the row's
//   chunks (one load of a and one of b for kRmsTile x V multiply-adds);
//   the lane partials meet in one sweep through shared memory; every lane
//   runs the rsqrt recurrence.  A persistent grid of warps walks the rows.
// * K4 at T <= 4 (the templates' short-T geometry): a (row, head) a team
//   of lanes, a group of lanes a query, all of a row's heads in one block,
//   q/k/v copied once by cp.async; scores accumulated kTile coefficients at
//   a time from a sliding window, one butterfly over the group each; the T
//   scores kept, so the max and the e-jets share s_0; the value
//   contraction and the jet division on the lane's dims; the projection
//   over heads x Dh a block GEMM from shared memory (f64 mma.sync m8n8k4,
//   f32 FMAs), wo staged once per persistent block.
// * K4 at long T: a block of W warps takes W queries of one row, key tiles
//   of all n1 coefficients staged once by cp.async into padded rows, a
//   lane a key, an online max with the alpha rescale.
// * K4's smallest block (what neither geometry fits): the first version's warp per
//   (row, query), keys read from L2; the wrappers admit what it admits.
// * K5: its first version gave a warp a (row, query), re-read the row's
//   keys from L2 for every query, a lane a key dim by dim, in three passes,
//   and ran every recurrence's multiply-add on two shared loads.  Now the
//   templated kernel's design with N1 an argument: a block of query groups
//   x key splits, a warp on 8 queries x 8 keys, a lane on two pairs; key
//   tiles staged once a block by cp.async (a ring, or the whole row); two
//   passes (online max with rescaled totals, then p); the f64 score jet on
//   the tensor cores (mma.sync m16n8k4) kScoresTile orders at a time from a
//   sliding window of query coefficients, f32 on FMAs; the pairs' jets in
//   shared memory, their e-jet and division recurrences kScoresTile orders
//   at a time from sliding register windows.  The first version stays as
//   the smallest block, for what no tiled block fits.
// Dot products use explicit fused multiply-adds so that every pass
// computes bit-identical scores.
//
// Bound on the H100: the same as the templated kernels' (bytes; FP64
// operations for K1/K2 at high orders).  K1/K2's walk is bounded by the
// instructions around its products (a term's loads and loop steps) and
// their latency, not by the FP64 pipe; PERF.md has their times against the
// bound.  K3 and K4 at the trunk's grid(10) shapes run one wave of the
// card: their time is a block's chain of phases (copy, the Cauchy tiles,
// the serial e-jet, division and rsqrt recurrences through shared memory,
// the projection), not bytes; at 8-16 times those rows the phases of
// other warps overlap and they run at 1.9x (K3) and 4x (K4) their byte
// bound at order 10.  K5 (bound: the output's bytes at order 10, FP64
// operations at 16) spends its time in the score tiles on the tensor cores
// (both passes; ~1.2 x the products they need, the rest zero rows of the
// windows) and the recurrences through shared memory, one block of 8
// warps an SM at (11, 4, 1024, 8) f64, the pairs' jets filling shared
// memory; PERF.md has its times against the bound.
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
// K3: a group of lanes per row, the row's coefficients staged once
// ---------------------------------------------------------------------------

constexpr int kRmsChunk = 32;   // K3: mean-square coefficients reduced in one sweep, at most
constexpr int kRmsTile = 4;     // K3: coefficients a lane accumulates in registers at a time

// Bytes of one K3 row slot (jet_attention.rms_norm_slot_bytes): when
// staged, the row's coefficients (n1 x width of the storage type, padded to
// 16 bytes); then its mean-square jet (n1) and the sweep's scratch (a chunk
// of coefficients x (group + 1) lanes), whose room the rsqrt jet (n1)
// takes once the mean square is complete, in the compute type.
__host__ __device__ inline int64_t rms_slot_bytes(int n1, int width, int group, bool staged,
                                                  int item_s, int item_t) {
  const int64_t chunk = n1 < kRmsChunk ? n1 : kRmsChunk;
  const int64_t scratch = chunk * (group + 1) > n1 ? chunk * (group + 1) : n1;
  return (staged ? tile_bytes(static_cast<int64_t>(n1) * width, item_s) : 0) +
         tile_bytes(n1 + scratch, item_t);
}

// V elements of a stack (16 bytes of P when V > 1, p 16-byte aligned) into
// registers of the compute type.
template <int V, typename T, typename P>
__device__ __forceinline__ void ld_chunk(T (&c)[V], const P* p) {
  if constexpr (V == 1) {
    c[0] = ld(p);
  } else {
    constexpr int per = 16 / sizeof(P);
#pragma unroll
    for (int q = 0; q < V / per; ++q) {
      const Lane16<P> l = reinterpret_cast<const Lane16<P>*>(p)[q];
#pragma unroll
      for (int i = 0; i < per; ++i) c[q * per + i] = ld(&l.v[i]);
    }
  }
}

// V outputs, one 16-byte store when V > 1.
template <int V, typename S, typename T>
__device__ __forceinline__ void st_chunk(S* p, const T (&c)[V]) {
  if constexpr (V == 1) {
    st(p, c[0]);
  } else {
    Lane16<S> l;
#pragma unroll
    for (int i = 0; i < V; ++i) st(&l.v[i], c[i]);
    *reinterpret_cast<Lane16<S>*>(p) = l;
  }
}

__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }

// acc[mm][.] += sum_{i <= m} a_i b_{m-i} for m = m0 + mm < n1, V lanes at
// once: a_i and b_j are V-element chunks from `at(i)` (a_is_b: the same
// sequence, the mean square) or a_i a scalar from `a` (the output).  A
// window of kTile b's slides down as i grows: each step loads one a and
// one b for kTile x V multiply-adds.
template <int V, typename T, typename At>
__device__ __forceinline__ void cauchy_chunks(T (&acc)[kRmsTile][V], At at, const T* a, int m0,
                                              int n1) {
  T w[kRmsTile][V];
#pragma unroll
  for (int mm = 0; mm < kRmsTile; ++mm) {
    if (m0 + mm < n1) {
      at(m0 + mm, w[mm]);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) w[mm][q] = T(0);
    }
  }
  const int top = min(m0 + kRmsTile, n1);
  for (int i = 0; i < top; ++i) {
    T ai[V];
    if (a == nullptr) {
      at(i, ai);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) ai[q] = a[i];
    }
#pragma unroll
    for (int mm = 0; mm < kRmsTile; ++mm)
#pragma unroll
      for (int q = 0; q < V; ++q) acc[mm][q] = fmadd(ai[q], w[mm][q], acc[mm][q]);
#pragma unroll
    for (int mm = kRmsTile - 1; mm > 0; --mm)
#pragma unroll
      for (int q = 0; q < V; ++q) w[mm][q] = w[mm - 1][q];
    if (m0 - i - 1 >= 0) {
      at(m0 - i - 1, w[0]);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) w[0][q] = T(0);
    }
  }
}

// One element of a stack into shared memory of the same type: cp.async
// where it is 4 or 8 bytes, else a plain copy (bfloat16).
template <typename S>
__device__ __forceinline__ void stage_copy(S* dst, const S* src) {
  if constexpr (sizeof(S) >= 4) {
    cp_async_elem(dst, src, true);
  } else {
    *dst = *src;
  }
}

// A group of `group` lanes (a power of two) per row, 32 / group rows a warp;
// a lane takes the row's V-element chunks gl, gl + group, ...  A persistent
// grid: each warp walks its rows 32 / group at a time.  Staged: the rows'
// n1 x width coefficients are copied (16-byte cp.async where V > 1) into
// shared memory in the storage type, and every pass reads them there; else
// (rows too long for a warp's share) from device memory.  V is 16 bytes of
// the storage type where rows are 16-byte aligned, else 1.  The mean
// square and the output are Cauchy products, kRmsTile coefficients at a
// time from a sliding window; the mean square's lane partials meet in one
// sweep over shared memory (kRmsChunk coefficients a sweep); every lane of
// the row runs the rsqrt recurrence.
template <typename S, int V, bool Staged>
__global__ void jet_rms_norm_rt_kernel(const S* __restrict__ x, const S* __restrict__ gamma,
                                       S* __restrict__ out, int64_t bsz, int width, int n1,
                                       typename Compute<S>::T eps, int group) {
  using T = typename Compute<S>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int rpw = 32 / group, r = lane / group, gl = lane % group;   // row of the warp's
  const int64_t plane = bsz * width, groups = (bsz + rpw - 1) / rpw;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * nw;
  const int chunks = (width + V - 1) / V, gp = group + 1;
  const int64_t tile = tile_bytes(static_cast<int64_t>(n1) * width, sizeof(S));
  unsigned char* base =
      smem_raw + (warp * rpw + r) * rms_slot_bytes(n1, width, group, Staged, sizeof(S), sizeof(T));
  S* xs = reinterpret_cast<S*>(base);       // [n1][width] when staged
  T* ms = reinterpret_cast<T*>(base + (Staged ? tile : 0));   // [n1]
  T* scr = ms + n1;                         // [chunk][group + 1], then inv [n1]

  // the coefficients of row r of the warp's g-th rows; the caller commits
  auto stage = [&](int64_t g) {
    const int64_t row = g * rpw + r;
    if (row >= bsz) return;
    const S* xr = x + row * width;
    for (int c = 0; c < n1; ++c)
      for (int ch = gl; ch < chunks; ch += group) {
        if constexpr (V > 1) {
          cp_async_16(xs + c * width + ch * V, xr + c * plane + ch * V, true);
        } else {
          stage_copy(xs + c * width + ch, xr + c * plane + ch);
        }
      }
  };

  int64_t g = static_cast<int64_t>(blockIdx.x) * nw + warp;
  if constexpr (Staged) {
    if (g < groups) stage(g);
  }
  for (; g < groups; g += stride) {
    if constexpr (Staged) {
      cp_async_wait_all();
      __syncwarp();
    }
    const int64_t row = g * rpw + r;
    const bool ok = row < bsz;   // lanes past the last row still take the warp's syncs
    const S* xr = x + (ok ? row : 0) * width;
    auto at_col = [&](int col) {
      return [=](int c, T(&dst)[V]) {
        if constexpr (Staged) ld_chunk<V>(dst, xs + c * width + col);
        else ld_chunk<V>(dst, xr + c * plane + col);
      };
    };

    // the mean-square jet: each lane's partial of kRmsChunk coefficients
    // at a time, then one sweep over the row's lanes
    for (int m0 = 0; m0 < n1; m0 += kRmsChunk) {
      const int mc = min(kRmsChunk, n1 - m0);
      if (ok) {
        for (int mt = m0; mt < m0 + mc; mt += kRmsTile) {
          T acc[kRmsTile][V];
#pragma unroll
          for (int mm = 0; mm < kRmsTile; ++mm)
#pragma unroll
            for (int q = 0; q < V; ++q) acc[mm][q] = T(0);
          for (int ch = gl; ch < chunks; ch += group)
            cauchy_chunks<V>(acc, at_col(ch * V), static_cast<const T*>(nullptr), mt, n1);
#pragma unroll
          for (int mm = 0; mm < kRmsTile; ++mm) {
            if (mt + mm < m0 + mc) {
              T part = acc[mm][0];
#pragma unroll
              for (int q = 1; q < V; ++q) part += acc[mm][q];
              scr[(mt + mm - m0) * gp + gl] = part;
            }
          }
        }
      }
      __syncwarp();
      if (ok) {
        for (int mm = gl; mm < mc; mm += group) {
          T s = T(0);
          for (int l = 0; l < group; ++l) s += scr[mm * gp + l];
          s /= T(width);
          ms[m0 + mm] = m0 + mm == 0 ? s + eps : s;
        }
      }
      __syncwarp();   // ms complete; the scratch is free for the next chunk
    }

    // the rsqrt jet: every lane of the row runs the recurrence and writes
    // the same values, so each reads only what it wrote itself
    T* inv = scr;
    if (ok) {
      const T ms0 = ms[0], r0 = T(1) / ms0;
      inv[0] = T(1) / dev_sqrt(ms0);
      for (int m = 1; m < n1; ++m) {
        T acc = T(0), c = T(0.5) - T(m);   // c = 0.5 j - m, exact as it steps
        for (int j = 1; j <= m; ++j, c += T(0.5)) acc += c * ms[j] * inv[m - j];
        inv[m] = acc * rcp(T(m)) * r0;
      }
      S* outr = out + row * width;
      for (int ch = gl; ch < chunks; ch += group) {
        const int col = ch * V;
        T gv[V];
#pragma unroll
        for (int q = 0; q < V; ++q) gv[q] = ld(gamma + col + q);
        for (int mt = 0; mt < n1; mt += kRmsTile) {
          T acc[kRmsTile][V];
#pragma unroll
          for (int mm = 0; mm < kRmsTile; ++mm)
#pragma unroll
            for (int q = 0; q < V; ++q) acc[mm][q] = T(0);
          cauchy_chunks<V>(acc, at_col(col), inv, mt, n1);
#pragma unroll
          for (int mm = 0; mm < kRmsTile; ++mm) {
            if (mt + mm < n1) {
#pragma unroll
              for (int q = 0; q < V; ++q) acc[mm][q] *= gv[q];
              st_chunk<V>(outr + (mt + mm) * plane + col, acc[mm]);
            }
          }
        }
      }
    }
    __syncwarp();   // done with the rows' copies, ms and inv: the next rows overwrite them
    if constexpr (Staged) {
      if (g + stride < groups) stage(g + stride);
    }
  }
}

// ---------------------------------------------------------------------------
// K4: short T, a group of lanes per (row, query); long T, a warp per query
// with shared key tiles; else a warp per query reading keys from L2
// ---------------------------------------------------------------------------

constexpr int kTile = 4;         // K4: coefficients a lane accumulates in registers at a time
constexpr int kKeyPitch = 33;    // K4 long T: words between the score (e-jet) rows of a warp's keys
constexpr int kProjTiles = 4;    // K4 short T, f64 projection: 8-column tiles a warp takes at once
constexpr int kProjRows = 4;     // K4 short T, f32 projection: rows a thread accumulates at once
constexpr int kProjCols = 4;     // and columns

__device__ __forceinline__ int keep_lo(int qi, int mask, int window) {
  return mask == kMaskLocal ? max(0, qi - window + 1) : 0;
}
__device__ __forceinline__ int keep_hi(int qi, int t, int mask) {
  return mask == kMaskNone ? t : qi + 1;
}

// acc[mm] += sum_{i <= m} a_i b_{m-i} for m = m0 + mm < n1 (a_i at a[i sa],
// b_j at b[j sb], either of the storage or the compute type).  A window of
// kTile b's slides down as i grows: each step loads one a and one b for
// kTile multiply-adds.  Lanes m >= n1 gather terms that are never stored.
template <typename T, typename A, typename B>
__device__ __forceinline__ void cauchy_tile(T (&acc)[kTile], const A* a, int sa, const B* b,
                                            int sb, int m0, int n1) {
  T w[kTile];
#pragma unroll
  for (int mm = 0; mm < kTile; ++mm) w[mm] = m0 + mm < n1 ? T(ld(b + (m0 + mm) * sb)) : T(0);
  const int top = min(m0 + kTile, n1);
  for (int i = 0; i < top; ++i) {
    const T ai = ld(a + i * sa);
#pragma unroll
    for (int mm = 0; mm < kTile; ++mm) acc[mm] = fmadd(ai, w[mm], acc[mm]);
#pragma unroll
    for (int mm = kTile - 1; mm > 0; --mm) w[mm] = w[mm - 1];
    w[0] = m0 - i - 1 >= 0 ? T(ld(b + (m0 - i - 1) * sb)) : T(0);
  }
}

// The e-jet of one score jet s (stride ss) for the max mx into e (stride es).
template <typename T>
__device__ __forceinline__ void exp_jet(const T* s, int ss, T mx, T* e, int es, int n1) {
  e[0] = dev_exp(s[0] - mx);
  for (int m = 1; m < n1; ++m) {
    T acc = T(0), tj = T(0);
    for (int j = 1; j <= m; ++j) acc += (tj += T(1)) * s[j * ss] * e[(m - j) * es];
    e[m * es] = acc * rcp(T(m));
  }
}

// o = a / tot as jets over a in place (a_m at a[m sa]), tot_0 floored at 1e-37.
template <typename T>
__device__ __forceinline__ void jet_divide(T* a, int sa, const T* tot, int n1) {
  const T inv0 = T(1) / (tot[0] > T(1e-37) ? tot[0] : T(1e-37));
  for (int m = 0; m < n1; ++m) {
    T r = a[m * sa];
    for (int j = 1; j <= m; ++j) r -= tot[j] * a[(m - j) * sa];
    a[m * sa] = r * inv0;
  }
}

__host__ __device__ constexpr int os_pitch(int hd) { return hd % 2 ? hd : hd + 1; }
__host__ __device__ inline int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Bytes of K4's short-T block (jet_attention.flash_short_bytes): wo (heads
// Dh x Dm) and the rows' output jets for the projection (rows x T x n1,
// padded to 8, at an odd pitch over heads x Dh) in the compute type; then
// every (row, head)'s q, k and v (3 x n1 x T x Dh of the storage type,
// each padded to 16 bytes); then per (row, head) its score and e-jets (T
// queries x T keys x n1 each) and totals (T x n1).
__host__ __device__ inline int64_t flash_short_bytes(int n1, int heads, int t, int dh, int dm,
                                                     int rows, int item_s, int item_t) {
  const int64_t mrows = (static_cast<int64_t>(rows) * t * n1 + 7) / 8 * 8;
  const int hd = heads * dh;
  const int64_t units = static_cast<int64_t>(rows) * heads;
  return tile_bytes(static_cast<int64_t>(hd) * dm, item_t) +
         tile_bytes(mrows * os_pitch(hd), item_t) + units * tile_bytes(3LL * n1 * t * dh, item_s) +
         tile_bytes(units * (2LL * t * t * n1 + static_cast<int64_t>(t) * n1), item_t);
}

// Short T (T <= 4).  A persistent block walks groups of `rows` batch rows
// with all their heads: one (row, head) a team of lanes, the row's T
// queries a group of `group` lanes each (a power of two; the team T
// groups, padded to a power of two), 32 / team teams a warp.  A team copies
// its q, k and v (n1 x T x Dh each, contiguous per coefficient: 16 bytes at
// a time where `wide`) into shared memory by cp.async in the storage type,
// the next rows' as soon as these are computed, under the projection.  A
// group's lanes then take the head dims gl, gl + group, ...: a key's score
// partials kTile coefficients at a time from a sliding window, one
// butterfly over the group per coefficient; the T scores kept, so the max
// and every e-jet read the same s_0; the e-jets a key a lane; totals, value
// contraction (the same sliding window) and the jet division on the lane's
// dims, into the block's output jets.  Then the block projects them onto
// wo, staged once: f64 on the tensor cores (mma.sync m8n8k4), f32 on FMAs.
template <typename S>
__global__ void jet_flash_attention_rt_short_kernel(
    const S* __restrict__ q, const S* __restrict__ k, const S* __restrict__ v,
    const S* __restrict__ wo, S* __restrict__ out, int64_t bsz, int heads, int t, int dh, int dm,
    int n1, typename Compute<S>::T scale, int mask, int window, int group, int rows, int wide) {
  using T = typename Compute<S>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int team = pow2_ceil(t) * group, tpw = 32 / team;
  const int unit = warp * tpw + lane / team, tl = lane % team;   // (row, head) of the block
  const int qi = tl / group, gl = tl - qi * group, slot = unit / heads, h = unit - slot * heads;
  const unsigned gmask = (group == 32 ? 0xffffffffu : ((1u << group) - 1u))
                         << (lane & ~(group - 1));
  const int units = rows * heads, seg = t * dh, hd = heads * dh, op = os_pitch(hd);
  const int64_t plane = bsz * heads * seg, groups = (bsz + rows - 1) / rows;
  const int64_t mrows = static_cast<int64_t>(rows) * t * n1, mpad = (mrows + 7) / 8 * 8;
  const int64_t xbytes = tile_bytes(3LL * n1 * seg, sizeof(S));
  T* ws = reinterpret_cast<T*>(smem_raw);   // [hd][dm]
  T* os = reinterpret_cast<T*>(smem_raw + tile_bytes(static_cast<int64_t>(hd) * dm, sizeof(T)));
  unsigned char* xbase = reinterpret_cast<unsigned char*>(os) + tile_bytes(mpad * op, sizeof(T));
  T* sc = reinterpret_cast<T*>(xbase + units * xbytes) +
          static_cast<int64_t>(unit) * (2 * t * t * n1 + t * n1);   // [query][key][n1]
  T* ej = sc + t * t * n1;                  // [query][key][n1]
  T* tot = ej + t * t * n1;                 // [query][n1]
  const int lo = keep_lo(qi, mask, window), hi = keep_hi(qi, t, mask);

  S* xq = reinterpret_cast<S*>(xbase + static_cast<int64_t>(unit) * xbytes);   // [n1][t][dh]
  const S* xk = xq + n1 * seg;              // xq, xk, xv: [n1][t][dh]
  const S* xv = xk + n1 * seg;

  // the team's q, k, v of the g-th rows: rows which * n1 + c of seg
  // elements each
  auto stage = [&](int64_t g) {
    const int64_t b = g * rows + slot;
    if (unit >= units || b >= bsz) return;
    const int64_t head = (b * heads + h) * seg;
    constexpr int kv = 16 / sizeof(S);      // elements of a 16-byte copy
    const int step = wide ? kv : 1, pieces = seg / step;
    for (int idx = tl; idx < 3 * n1 * pieces; idx += team) {
      const int row = idx / pieces, e = (idx - row * pieces) * step;
      const int which = row / n1, c = row - which * n1;
      const S* src = (which == 0 ? q : which == 1 ? k : v) + c * plane + head + e;
      if (wide) {
        cp_async_16(xq + row * seg + e, src, true);
      } else {
        stage_copy(xq + row * seg + e, src);
      }
    }
  };

  for (int idx = tid; idx < hd * dm; idx += blockDim.x) stage_elem(ws + idx, wo + idx, wo, true);
  int64_t g = blockIdx.x;
  if (g < groups) stage(g);
  for (; g < groups; g += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();   // wo and every team's q, k, v of these rows in place
    const int64_t b0 = g * rows, b = b0 + slot;
    const bool q_ok = unit < units && b < bsz && qi < t;

    if (q_ok) {
      const S* qv = xq + qi * dh;
      for (int j = lo; j < hi; ++j) {
        const S* kk = xk + j * dh;
        for (int m0 = 0; m0 < n1; m0 += kTile) {
          T acc[kTile];
#pragma unroll
          for (int mm = 0; mm < kTile; ++mm) acc[mm] = T(0);
          for (int d = gl; d < dh; d += group) cauchy_tile(acc, qv + d, seg, kk + d, seg, m0, n1);
#pragma unroll
          for (int mm = 0; mm < kTile; ++mm) {
            for (int off = group >> 1; off > 0; off >>= 1)
              acc[mm] += __shfl_xor_sync(gmask, acc[mm], off);
            if (gl == 0 && m0 + mm < n1) sc[(qi * t + j) * n1 + m0 + mm] = acc[mm] * scale;
          }
        }
      }
    }
    __syncwarp();
    if (q_ok) {
      const T* sq = sc + qi * t * n1;
      T mx = sq[lo * n1];
      for (int j = lo + 1; j < hi; ++j) mx = sq[j * n1] > mx ? sq[j * n1] : mx;
      for (int j = lo + gl; j < hi; j += group)
        exp_jet(sq + j * n1, 1, mx, ej + (qi * t + j) * n1, 1, n1);
    }
    __syncwarp();
    if (q_ok) {
      const T* eq = ej + qi * t * n1;
      for (int m = gl; m < n1; m += group) {
        T s = T(0);
        for (int j = lo; j < hi; ++j) s += eq[j * n1 + m];
        tot[qi * n1 + m] = s;
      }
    }
    __syncwarp();
    if (q_ok) {
      const T* eq = ej + qi * t * n1;
      T* orow = os + static_cast<int64_t>(slot * t + qi) * n1 * op + h * dh;   // [n1][op]
      for (int d = gl; d < dh; d += group) {
        for (int m0 = 0; m0 < n1; m0 += kTile) {
          T acc[kTile];
#pragma unroll
          for (int mm = 0; mm < kTile; ++mm) acc[mm] = T(0);
          for (int j = lo; j < hi; ++j)
            cauchy_tile(acc, eq + j * n1, 1, xv + j * dh + d, seg, m0, n1);
#pragma unroll
          for (int mm = 0; mm < kTile; ++mm)
            if (m0 + mm < n1) orow[(m0 + mm) * op + d] = acc[mm];
        }
        jet_divide(orow + d, op, tot + qi * n1, n1);
      }
    }
    __syncthreads();   // os complete; q, k, v are free for the next rows
    if (g + gridDim.x < groups) stage(g + gridDim.x);

    // projection: rows (slot, query, m) of os x wo -> out[m][b0 + slot][query][:];
    // rows past the batch and the padding are computed, never stored.  The
    // next group's compute rewrites os only after its first __syncthreads
    const int64_t out_plane = bsz * t * dm;
    if constexpr (std::is_same<T, double>::value) {
      // lane l holds A[l/4][l%4], B[l%4][l/4] and C[l/4][2 (l%4) + {0, 1}]
      const int gr = lane >> 2, gc = lane & 3;
      const int m_tiles = static_cast<int>(mpad / 8);
      const int n_groups = (dm + 8 * kProjTiles - 1) / (8 * kProjTiles);
      for (int tile = warp; tile < m_tiles * n_groups; tile += nwarps) {
        const int mt = tile / n_groups, n0 = (tile - mt * n_groups) * 8 * kProjTiles;
        double c[kProjTiles][2];
#pragma unroll
        for (int j = 0; j < kProjTiles; ++j) c[j][0] = c[j][1] = 0.0;
        for (int k0 = 0; k0 < hd; k0 += 4) {
          const int kk = k0 + gc;
          const double a = kk < hd ? os[(mt * 8 + gr) * static_cast<int64_t>(op) + kk] : 0.0;
#pragma unroll
          for (int j = 0; j < kProjTiles; ++j) {
            const int nb = n0 + 8 * j + gr;
            const double bv = kk < hd && nb < dm ? ws[kk * dm + nb] : 0.0;
            asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
                "{%0, %1};\n"
                : "+d"(c[j][0]), "+d"(c[j][1])
                : "d"(a), "d"(bv));
          }
        }
        const int64_t row = mt * 8 + gr;
        const int item = static_cast<int>(row / n1), m = static_cast<int>(row - item * n1);
        const int ir = item / t, iq = item - ir * t;
        if (row < mrows && b0 + ir < bsz) {
          S* orow_out = out + m * out_plane + ((b0 + ir) * t + iq) * dm;
#pragma unroll
          for (int j = 0; j < kProjTiles; ++j) {
            const int n = n0 + 8 * j + 2 * gc;
            if (n < dm) st(orow_out + n, c[j][0]);
            if (n + 1 < dm) st(orow_out + n + 1, c[j][1]);
          }
        }
      }
    } else {
      // a warp is 4 row groups x 8 column lanes; a thread accumulates
      // kProjRows rows x kProjCols columns (n = n0 + cl + 8 j)
      const int rgl = lane >> 3, cl = lane & 7, row_groups = nwarps * 4;
      for (int n0 = 0; n0 < dm; n0 += 8 * kProjCols) {
        for (int64_t row0 = (warp * 4 + rgl) * kProjRows; row0 < mrows;
             row0 += row_groups * kProjRows) {
          T accp[kProjRows][kProjCols];
#pragma unroll
          for (int rr = 0; rr < kProjRows; ++rr)
#pragma unroll
            for (int j = 0; j < kProjCols; ++j) accp[rr][j] = T(0);
          const T* orow = os + row0 * op;   // rows past mrows exist (the buffer is padded)
          for (int kk = 0; kk < hd; ++kk) {
            T wv[kProjCols];
#pragma unroll
            for (int j = 0; j < kProjCols; ++j) {
              const int n = n0 + cl + 8 * j;
              wv[j] = n < dm ? ws[kk * dm + n] : T(0);
            }
#pragma unroll
            for (int rr = 0; rr < kProjRows; ++rr) {
              const T ov = orow[rr * op + kk];
#pragma unroll
              for (int j = 0; j < kProjCols; ++j) accp[rr][j] = fmadd(ov, wv[j], accp[rr][j]);
            }
          }
#pragma unroll
          for (int rr = 0; rr < kProjRows; ++rr) {
            const int64_t row = row0 + rr;
            const int item = static_cast<int>(row / n1), m = static_cast<int>(row - item * n1);
            const int ir = item / t, iq = item - ir * t;
            if (row >= mrows || b0 + ir >= bsz) continue;
            S* orow_out = out + m * out_plane + ((b0 + ir) * t + iq) * dm;
#pragma unroll
            for (int j = 0; j < kProjCols; ++j) {
              const int n = n0 + cl + 8 * j;
              if (n < dm) st(orow_out + n, accp[rr][j]);
            }
          }
        }
      }
    }
  }
}

// Words of K4's long-T block (jet_attention.flash_long_words): the key and
// value tiles (n1 x kt keys x (Dh + 1)), then per warp its query's jet and
// value accumulator (n1 x Dh each), the tile's score and e-jets (n1 x
// kKeyPitch each, a key a lane), the totals (n1) and the projected output
// (n1 x Dm).
__host__ __device__ inline int64_t flash_long_words(int n1, int dh, int dm, int warps, int kt) {
  return 2LL * n1 * kt * (dh + 1) +
         static_cast<int64_t>(warps) * n1 * (2LL * dh + 2 * kKeyPitch + 1 + dm);
}

// Long T.  A block of W warps takes W consecutive queries of one batch row.
// Per head each tile of kt keys, all n1 coefficients of K and V, is staged
// once by cp.async into shared rows padded to Dh + 1 words.  A warp's lanes
// take the tile's keys: the score jet over every head dim (the sliding
// window), the online max with the alpha rescale (alpha is exactly 0 on
// the first kept key), the e-jet; then its lanes take the totals by
// coefficient and the value contraction by (kTile coefficients, dim).
// After the keys the jet division, and the head's share of the projection
// accumulated in shared memory, a lane a (coefficient, output column).
template <typename S>
__global__ void jet_flash_attention_rt_long_kernel(
    const S* __restrict__ q, const S* __restrict__ k, const S* __restrict__ v,
    const S* __restrict__ wo, S* __restrict__ out, int64_t bsz, int heads, int t, int dh, int dm,
    int n1, typename Compute<S>::T scale, int mask, int window, int kt) {
  using T = typename Compute<S>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nw = blockDim.x >> 5;
  const int qblocks = (t + nw - 1) / nw;
  const int64_t b = blockIdx.x / qblocks;
  const int q0 = static_cast<int>(blockIdx.x % qblocks) * nw, qi = q0 + warp;
  const bool active = qi < t;
  const int dp = dh + 1, kp = kKeyPitch;
  T* ks = reinterpret_cast<T*>(smem_raw);   // [n1][kt][dp]
  T* vs = ks + n1 * kt * dp;
  T* qs = vs + n1 * kt * dp + static_cast<int64_t>(warp) * n1 * (2 * dh + 2 * kp + 1 + dm);
  T* as = qs + n1 * dh;                     // [n1][dh]
  T* sc = as + n1 * dh;                     // [n1][kp]
  T* ec = sc + n1 * kp;                     // [n1][kp]
  T* tot = ec + n1 * kp;                    // [n1]
  T* rs = tot + n1;                         // [n1][dm]
  const int seg = t * dh;
  const int64_t plane = bsz * heads * seg;
  const T neg = T(kMaskNeg);
  const int lo = keep_lo(qi, mask, window), hi = keep_hi(qi, t, mask);
  const int blo = keep_lo(q0, mask, window);               // the block's keys
  const int bhi = keep_hi(min(q0 + nw, t) - 1, t, mask);
  const int tiles = (n1 + kTile - 1) / kTile;
  for (int idx = lane; idx < n1 * dm; idx += 32) rs[idx] = T(0);

  for (int h = 0; h < heads; ++h) {
    const int64_t head = (b * heads + h) * seg;
    if (active) {
      for (int idx = lane; idx < n1 * dh; idx += 32) {
        const int i = idx / dh, d = idx - i * dh;
        qs[idx] = ld(q + i * plane + head + static_cast<int64_t>(qi) * dh + d);
        as[idx] = T(0);
      }
      for (int m = lane; m < n1; m += 32) tot[m] = T(0);
    }
    T m_run = neg;
    for (int k0 = blo; k0 < bhi; k0 += kt) {
      const int nk = min(kt, bhi - k0);
      __syncthreads();   // every warp is done with the previous tile
      for (int idx = tid; idx < n1 * nk * dh; idx += blockDim.x) {
        const int row = idx / dh, d = idx - row * dh;   // row = c * nk + key
        const int c = row / nk, key = row - c * nk;
        const int64_t src = c * plane + head + static_cast<int64_t>(k0 + key) * dh + d;
        stage_elem(ks + (c * kt + key) * dp + d, k + src, k, true);
        stage_elem(vs + (c * kt + key) * dp + d, v + src, v, true);
      }
      cp_async_wait_all();
      __syncthreads();
      const int j0 = max(lo, k0), j1 = min(hi, k0 + nk);
      if (!active || j0 >= j1) continue;   // warp-uniform
      const int key = k0 + lane;
      const bool kept = key >= j0 && key < j1;
      if (kept) {
        for (int m0 = 0; m0 < n1; m0 += kTile) {
          T acc[kTile];
#pragma unroll
          for (int mm = 0; mm < kTile; ++mm) acc[mm] = T(0);
          for (int d = 0; d < dh; ++d)
            cauchy_tile(acc, qs + d, dh, ks + lane * dp + d, kt * dp, m0, n1);
#pragma unroll
          for (int mm = 0; mm < kTile; ++mm)
            if (m0 + mm < n1) sc[(m0 + mm) * kp + lane] = acc[mm] * scale;
        }
      }
      const T s0 = kept ? sc[lane] : neg;
      const T top = warp_max(s0), m_new = top > m_run ? top : m_run;
      const T alpha = dev_exp(m_run - m_new);
      if (kept) exp_jet(sc + lane, kp, m_new, ec + lane, kp, n1);
      __syncwarp();
      for (int m = lane; m < n1; m += 32) {
        T r = T(0);
        for (int kk = j0 - k0; kk < j1 - k0; ++kk) r += ec[m * kp + kk];
        tot[m] = alpha * tot[m] + r;
      }
      for (int idx = lane; idx < tiles * dh; idx += 32) {
        const int mt = idx / dh, d = idx - mt * dh, m0 = mt * kTile;
        T acc[kTile];
#pragma unroll
        for (int mm = 0; mm < kTile; ++mm)
          acc[mm] = m0 + mm < n1 ? alpha * as[(m0 + mm) * dh + d] : T(0);
        for (int kk = j0 - k0; kk < j1 - k0; ++kk)
          cauchy_tile(acc, ec + kk, kp, vs + kk * dp + d, kt * dp, m0, n1);
#pragma unroll
        for (int mm = 0; mm < kTile; ++mm)
          if (m0 + mm < n1) as[(m0 + mm) * dh + d] = acc[mm];
      }
      m_run = m_new;
    }
    if (active) {
      __syncwarp();   // as and tot complete
      for (int d = lane; d < dh; d += 32) jet_divide(as + d, dh, tot, n1);
      __syncwarp();
      for (int idx = lane; idx < n1 * dm; idx += 32) {
        const int m = idx / dm, n = idx - m * dm;
        T acc = rs[idx];
        for (int d = 0; d < dh; ++d)
          acc = fmadd(as[m * dh + d], ld(wo + (static_cast<int64_t>(h) * dh + d) * dm + n), acc);
        rs[idx] = acc;
      }
      __syncwarp();   // qs, as and tot are rewritten for the next head
    }
  }
  if (!active) return;
  const int64_t out_plane = bsz * t * dm;
  S* outr = out + (b * t + qi) * dm;
  for (int idx = lane; idx < n1 * dm; idx += 32) {
    const int m = idx / dm, n = idx - m * dm;
    st(outr + m * out_plane + n, rs[idx]);
  }
}

// The smallest block, for what neither geometry above fits: a warp per
// (row, query), lanes over the head dims in steps of 32 (any Dh), per head
// two passes over the kept keys read from device memory (the max of s_0,
// then the e-jets, totals and value contraction with that max), the jet
// division, and the head's share of the projection accumulated in shared
// memory.  Its score coefficients are warp sums, one each, the same bits
// in both passes.

// scale sum_{i <= m} q_i . k_{m-i} for the key row kr (a plane apart per
// coefficient), the query in shared memory
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
// K5: query groups x 8-key tiles (the templated kernel's design with N1 an
// argument); the smallest block, a warp per (row, query)
// ---------------------------------------------------------------------------

constexpr int kScoresTile = 4;       // K5: orders a lane keeps in registers at a time
constexpr int kScoresMaxRing = 2;    // K5: key stages in shared memory, at most
static_assert(kScoresTile == 4, "scores_tile_rt stacks the window's orders two by two");

// One value for each of a lane's two (query, key) pairs: one shared load.
template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T x, y;
};

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

__device__ __forceinline__ void st_pair(double* p, const Pair<double>& v) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v.x, v.y));
}
__device__ __forceinline__ void st_pair(float* p, const Pair<float>& v) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(v.x, v.y));
}
__device__ __forceinline__ void st_pair(__nv_bfloat16* p, const Pair<float>& v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

// D += A B on the f64 tensor cores, m16n8k4: lane l holds A[l/4][l%4] (a0)
// and A[l/4 + 8][l%4] (a1), B[l%4][l/4], and D[l/4][2 (l%4) + {0, 1}] (d0,
// d1) and D[l/4 + 8][2 (l%4) + {0, 1}] (d2, d3).
__device__ __forceinline__ void mma_m16n8k4(double& d0, double& d1, double& d2, double& d3,
                                            double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a0), "d"(a1), "d"(b));
}

// Bytes of a tiled K5 block (jet_attention.scores_rt_smem_bytes), words
// of the compute type (item_t bytes) but the keys, kept in the storage
// type (item_s): the scaled queries [groups][n1][nch][32]; the key ring
// [ring][n1][nch][split tiles][32]; per warp its lanes' score and e-jets
// ([2][n1][32] pairs), totals [n1][32] and running maxima [32]; per group
// its queries' totals [n1][8] and maxima [8]; 1/m for m < n1.
__host__ __device__ inline int64_t scores_tiled_bytes(int n1, int nch, int groups, int split,
                                                      int tiles, int ring, int item_s,
                                                      int item_t) {
  return static_cast<int64_t>(item_t) *
             (static_cast<int64_t>(groups) * n1 * nch * 32 +
              static_cast<int64_t>(groups) * split * (5 * n1 + 1) * 32 +
              static_cast<int64_t>(groups) * (n1 + 1) * 8 + n1) +
         static_cast<int64_t>(item_s) * ring * n1 * nch * split * tiles * 32;
}

// Bytes of one key copy: a 4-dim chunk, at most 16 (f64 two copies a
// chunk, f32 one, bfloat16 one of 8 bytes).
template <typename S>
constexpr int kChunkCopy = 4 * sizeof(S) < 16 ? 4 * static_cast<int>(sizeof(S)) : 16;

// Whether a row of d keys' dims splits into whole copies from k.
template <typename S>
__device__ __forceinline__ bool scores_vec(const S* k, int d) {
  constexpr int kEw = kChunkCopy<S> / static_cast<int>(sizeof(S));
  return d % kEw == 0 && (reinterpret_cast<uintptr_t>(k) & (kChunkCopy<S> - 1)) == 0;
}

// Keys key0 .. key0 + 8 ntb - 1 of the batch row kb, all n1 coefficients,
// into one stage [n1][nch][ntb][8 keys][4 dims] of the storage type, by the
// whole block; keys past t and dims past d are zero.  Where `vec`
// (scores_vec) by cp.async copies of kChunkCopy bytes, neighbouring threads
// on neighbouring pieces of a key row; else an element a thread,
// neighbouring threads on neighbouring dims (cp.async for 4 and 8 bytes,
// bfloat16 by a plain load).  The caller's next wait covers them.
template <typename S>
__device__ __forceinline__ void scores_stage_keys(S* buf, const S* kb, int64_t plane, int t,
                                                  int d, int n1, int nch, int ntb, int key0,
                                                  bool vec) {
  const int cwords = nch * ntb * 32;   // one coefficient of the stage
  if (vec) {
    constexpr int kEw = kChunkCopy<S> / static_cast<int>(sizeof(S));   // elements a copy
    constexpr int kPer = 4 / kEw;                                      // copies a chunk
    const int units = ntb * 8 * nch * kPer;
    for (int u = threadIdx.x; u < n1 * units; u += blockDim.x) {
      const int c = u / units, rest = u - c * units;
      const int h = rest % kPer, nc = rest / kPer;
      const int n = nc / nch, ch = nc - n * nch;   // n: key within the stage
      const int key = key0 + n, dd = ch * 4 + h * kEw;
      S* dst = buf + c * cwords + (ch * ntb + (n >> 3)) * 32 + (n & 7) * 4 + h * kEw;
      const bool ok = key < t && dd < d;
      const S* src = ok ? kb + c * plane + static_cast<int64_t>(key) * d + dd : kb;
      if constexpr (kChunkCopy<S> == 16) {
        cp_async_16(dst, src, ok);
      } else {
        cp_async_elem(reinterpret_cast<uint2*>(dst), reinterpret_cast<const uint2*>(src), ok);
      }
    }
    return;
  }
  const int units = ntb * 8 * nch * 4;
  for (int u = threadIdx.x; u < n1 * units; u += blockDim.x) {
    const int c = u / units, rest = u - c * units;
    const int x = rest & 3, nc = rest >> 2;
    const int n = nc / nch, ch = nc - n * nch;
    const int key = key0 + n, dd = ch * 4 + x;
    S* dst = buf + c * cwords + (ch * ntb + (n >> 3)) * 32 + (n & 7) * 4 + x;
    const bool ok = key < t && dd < d;
    const S* src = kb + c * plane + static_cast<int64_t>(key) * d + dd;
    if constexpr (sizeof(S) >= 4) {
      cp_async_elem(dst, ok ? src : kb, ok);
    } else {
      *reinterpret_cast<unsigned short*>(dst) =
          ok ? *reinterpret_cast<const unsigned short*>(src) : static_cast<unsigned short>(0);
    }
  }
}

// The score jet of one 8 x 8 tile for the lane's pairs (query lane/4 of the
// group, keys 2 (lane%4) + {0, 1} of the tile) into sj[m * 32]: s_0, then
// m s_m, what the e-jet recurrence multiplies.  qg: the group's scaled
// query fragments (coefficient i, 4-dim chunk ch at (i nch + ch) 32); kt:
// the tile's key fragments (coefficient c, chunk ch at (c nch + ch)
// kstride); dims past d are 0 in both.  kScoresTile orders m0 .. m0 + 3 at
// a time in registers: along the key coefficients c a window of query
// coefficients Q_{m0 + j - c} slides by one, so a step loads one key and
// one query fragment.  f64 on the tensor cores: m16n8k4 stacks Q_{m - c}
// over Q_{m + 1 - c} against K_c into s_m and s_{m+1} (a product whose two
// query coefficients are both below 0, or whose orders are both past n1,
// is skipped).  f32 on FMAs: a lane's query row and its two keys 4 dims a
// load.  Both passes run the same instructions, so they see the same
// bits.
__device__ __forceinline__ void scores_tile_rt(const double* qg, const double* kt, int nch,
                                               int kstride, int n1, int lane,
                                               Pair<double>* sj) {
  const int qc = nch * 32, kc = nch * kstride;
  for (int m0 = 0; m0 < n1; m0 += kScoresTile) {
    double acc[kScoresTile][2] = {};
    const int top = min(m0 + kScoresTile, n1);
    const bool upper = m0 + 2 < n1;   // the window's orders m0 + 2, m0 + 3 are wanted
    for (int ch = 0; ch < nch; ++ch) {
      const double* qp = qg + ch * 32 + lane;
      const double* kp = kt + ch * kstride + lane;
      double w[kScoresTile];
#pragma unroll
      for (int j = 0; j < kScoresTile; ++j) w[j] = m0 + j < n1 ? qp[(m0 + j) * qc] : 0.0;
      for (int c = 0; c < top; ++c) {
        const double kf = kp[c * kc];
        if (c <= m0 + 1) mma_m16n8k4(acc[0][0], acc[0][1], acc[1][0], acc[1][1], w[0], w[1], kf);
        if (upper) mma_m16n8k4(acc[2][0], acc[2][1], acc[3][0], acc[3][1], w[2], w[3], kf);
#pragma unroll
        for (int j = kScoresTile - 1; j > 0; --j) w[j] = w[j - 1];
        w[0] = c < m0 ? qp[(m0 - c - 1) * qc] : 0.0;
      }
    }
#pragma unroll
    for (int mm = 0; mm < kScoresTile; ++mm) {
      const int m = m0 + mm;
      const double f = m > 0 ? static_cast<double>(m) : 1.0;
      if (m < n1) sj[m * 32] = Pair<double>{acc[mm][0] * f, acc[mm][1] * f};
    }
  }
}

// 4 neighbouring elements of shared memory as floats, one load.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename KS>
__device__ __forceinline__ void scores_tile_rt(const float* qg, const KS* kt, int nch,
                                               int kstride, int n1, int lane, Pair<float>* sj) {
  const int qc = nch * 32, kc = nch * kstride;
  const int qo = (lane >> 2) * 4, ko = (lane & 3) * 8;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int m0 = 0; m0 < n1; m0 += kScoresTile) {
    float acc[kScoresTile][2] = {};
    const int top = min(m0 + kScoresTile, n1);
    for (int ch = 0; ch < nch; ++ch) {
      const float* qp = qg + ch * 32 + qo;
      const KS* kp = kt + ch * kstride + ko;
      float4 w[kScoresTile];
#pragma unroll
      for (int j = 0; j < kScoresTile; ++j) w[j] = m0 + j < n1 ? ld4(qp + (m0 + j) * qc) : zero;
      for (int c = 0; c < top; ++c) {
        const float4 k0 = ld4(kp + c * kc), k1 = ld4(kp + c * kc + 4);
#pragma unroll
        for (int mm = 0; mm < kScoresTile; ++mm) {
          acc[mm][0] = fmaf(w[mm].x, k0.x, acc[mm][0]);
          acc[mm][0] = fmaf(w[mm].y, k0.y, acc[mm][0]);
          acc[mm][0] = fmaf(w[mm].z, k0.z, acc[mm][0]);
          acc[mm][0] = fmaf(w[mm].w, k0.w, acc[mm][0]);
          acc[mm][1] = fmaf(w[mm].x, k1.x, acc[mm][1]);
          acc[mm][1] = fmaf(w[mm].y, k1.y, acc[mm][1]);
          acc[mm][1] = fmaf(w[mm].z, k1.z, acc[mm][1]);
          acc[mm][1] = fmaf(w[mm].w, k1.w, acc[mm][1]);
        }
#pragma unroll
        for (int j = kScoresTile - 1; j > 0; --j) w[j] = w[j - 1];
        w[0] = c < m0 ? ld4(qp + (m0 - c - 1) * qc) : zero;
      }
    }
#pragma unroll
    for (int mm = 0; mm < kScoresTile; ++mm) {
      const int m = m0 + mm;
      const float f = m > 0 ? static_cast<float>(m) : 1.0f;
      if (m < n1) sj[m * 32] = Pair<float>{acc[mm][0] * f, acc[mm][1] * f};
    }
  }
}

// The e-jet of exp(s - shift) for the lane's pairs into ej[m * 32] (sj as
// scores_tile_rt leaves it): e_0 = exp(s_0 - shift), e_m = (1/m)
// sum_{j=1..m} (j s_j) e_{m-j} (inv[m] = 1/m), kScoresTile orders at a
// time: the terms of the earlier orders' e from a window of j s_j that
// slides by one (a load of e and one of j s_j for kScoresTile multiply-adds
// a pair), then the window's own terms from registers.  With Acc, also
// tot[m * 32] += e_m of the valid pairs, the first, then the second.
template <bool Acc, typename T>
__device__ __forceinline__ void scores_exp_jet(const Pair<T>* sj, Pair<T>* ej, T shift, int n1,
                                               const T* inv, T* tot, bool v0, bool v1) {
  const Pair<T> nil{T(0), T(0)};
  auto keep = [&](int m, const Pair<T>& e) {
    ej[m * 32] = e;
    if constexpr (Acc) {
      T s = tot[m * 32];
      if (v0) s += e.x;
      if (v1) s += e.y;
      tot[m * 32] = s;
    }
  };
  const Pair<T> s0 = sj[0];
  keep(0, Pair<T>{dev_exp(s0.x - shift), dev_exp(s0.y - shift)});
  Pair<T> lo[kScoresTile];   // j s_j for j = 1 .. kScoresTile - 1
#pragma unroll
  for (int j = 1; j < kScoresTile; ++j) lo[j] = j < n1 ? sj[j * 32] : nil;
  auto js = [&](int j) { return j < n1 ? sj[j * 32] : nil; };
  for (int m0 = 1; m0 < n1; m0 += kScoresTile) {
    Pair<T> acc[kScoresTile];
#pragma unroll
    for (int mm = 0; mm < kScoresTile; ++mm) acc[mm] = nil;
    Pair<T> w[kScoresTile];
#pragma unroll
    for (int mm = 0; mm < kScoresTile; ++mm) w[mm] = js(m0 + mm);
    for (int i = 0; i < m0; ++i) {   // w[mm] = (j s_j) for j = m0 + mm - i
      const Pair<T> e = ej[i * 32];
#pragma unroll
      for (int mm = 0; mm < kScoresTile; ++mm) {
        acc[mm].x = fmadd(e.x, w[mm].x, acc[mm].x);
        acc[mm].y = fmadd(e.y, w[mm].y, acc[mm].y);
      }
#pragma unroll
      for (int mm = kScoresTile - 1; mm > 0; --mm) w[mm] = w[mm - 1];
      if (i + 1 < m0) w[0] = sj[(m0 - i - 1) * 32];
    }
    Pair<T> ew[kScoresTile];
#pragma unroll
    for (int mm = 0; mm < kScoresTile; ++mm) {
      const int m = m0 + mm;
      if (m < n1) {
        Pair<T> a = acc[mm];
#pragma unroll
        for (int ii = 0; ii < mm; ++ii) {
          a.x = fmadd(ew[ii].x, lo[mm - ii].x, a.x);
          a.y = fmadd(ew[ii].y, lo[mm - ii].y, a.y);
        }
        ew[mm] = Pair<T>{a.x * inv[m], a.y * inv[m]};
        keep(m, ew[mm]);
      }
    }
  }
}

// p = e / tot as jets over ej in place (gt: the query's totals, tot_j at
// gt[j * 8]; inv0 = 1 / tot_0): p_0 = e_0 inv0, p_m = (e_m - sum_{j=1..m}
// tot_j p_{m-j}) inv0, in windows as scores_exp_jet; p_m of the lane's
// keys stored to o[m * out_plane] (and the next key), in one store where
// `pair` (the output's rows hold pairs on 2-element boundaries).
template <typename S, typename T>
__device__ __forceinline__ void scores_divide_store(Pair<T>* ej, const T* gt, T inv0, int n1,
                                                    S* o, int64_t out_plane, bool v0, bool v1,
                                                    bool pair) {
  const Pair<T> nil{T(0), T(0)};
  auto put = [&](int m, const Pair<T>& p) {
    ej[m * 32] = p;
    S* om = o + m * out_plane;
    if (v1 && pair) {
      st_pair(om, p);
    } else {
      if (v0) st(om, p.x);
      if (v1) st(om + 1, p.y);
    }
  };
  const Pair<T> e0 = ej[0];
  put(0, Pair<T>{e0.x * inv0, e0.y * inv0});
  T lo[kScoresTile];   // tot_j for j = 1 .. kScoresTile - 1
#pragma unroll
  for (int j = 1; j < kScoresTile; ++j) lo[j] = j < n1 ? gt[j * 8] : T(0);
  auto tot = [&](int j) { return j < n1 ? gt[j * 8] : T(0); };
  for (int m0 = 1; m0 < n1; m0 += kScoresTile) {
    Pair<T> acc[kScoresTile];
#pragma unroll
    for (int mm = 0; mm < kScoresTile; ++mm) acc[mm] = m0 + mm < n1 ? ej[(m0 + mm) * 32] : nil;
    T w[kScoresTile];
#pragma unroll
    for (int mm = 0; mm < kScoresTile; ++mm) w[mm] = tot(m0 + mm);
    for (int i = 0; i < m0; ++i) {   // w[mm] = tot_j for j = m0 + mm - i
      const Pair<T> p = ej[i * 32];
#pragma unroll
      for (int mm = 0; mm < kScoresTile; ++mm) {
        acc[mm].x = fmadd(-w[mm], p.x, acc[mm].x);
        acc[mm].y = fmadd(-w[mm], p.y, acc[mm].y);
      }
#pragma unroll
      for (int mm = kScoresTile - 1; mm > 0; --mm) w[mm] = w[mm - 1];
      if (i + 1 < m0) w[0] = gt[(m0 - i - 1) * 8];
    }
    Pair<T> pw[kScoresTile];
#pragma unroll
    for (int mm = 0; mm < kScoresTile; ++mm) {
      const int m = m0 + mm;
      if (m < n1) {
        Pair<T> a = acc[mm];
#pragma unroll
        for (int ii = 0; ii < mm; ++ii) {
          a.x = fmadd(-lo[mm - ii], pw[ii].x, a.x);
          a.y = fmadd(-lo[mm - ii], pw[ii].y, a.y);
        }
        pw[mm] = Pair<T>{a.x * inv0, a.y * inv0};
        put(m, pw[mm]);
      }
    }
  }
}

// A block: `groups` groups of 8 queries of one batch row, each taken by
// `split` warps that divide the keys of every stage between them; a warp
// works on 8 queries x 8 keys at a time, a lane on two (query, key) pairs
// (query lane/4, keys 2 (lane%4) + {0, 1}: the mma accumulator's layout).
// Keys come in stages of split x tiles 8-key tiles copied once a block
// into a ring of two stages (the next in flight while the warps work on
// this one, one barrier a stage), or, where one stage holds the row (ring
// 1), copied once for both passes.  Pass 1, per tile: the score jet
// (scores_tile_rt), the lane's running max M of s_0 (on a new max M' its
// totals are rescaled by exp(M - M')), the e-jet with M and its sum into
// the lane's totals.  Then the totals of each query's 4 lanes x split
// warps are merged with the same rescale through shared memory, one
// (query, order) a thread.  Pass 2, per tile: the score and e-jet again,
// with the query's final max, and p over the e-jet, stored.  A lane's jets
// and totals live in shared memory at [m][32] (pairs of the two keys): a
// lane reads only what it wrote, so no barrier inside a tile.  Ragged T
// and D: keys and dims past the end are zero, queries past T not stored.
// f32/bf16 blocks may share an SM two at a time (128 registers a thread);
// f64 ones take up to 255 (at 128 they spilled), since their jets fill
// shared memory long before two 8-warp blocks would fit.
template <typename S>
constexpr int scores_min_blocks() {
  return sizeof(typename Compute<S>::T) == 8 ? 1 : 2;
}

template <typename S>
__global__ void __launch_bounds__(kMaxWarps * 32, scores_min_blocks<S>())
    jet_attention_scores_rt_tiled_kernel(const S* __restrict__ q, const S* __restrict__ k,
                                         S* __restrict__ out, int64_t bsz, int t, int d, int n1,
                                         typename Compute<S>::T scale, int groups, int split,
                                         int tiles, int ring) {
  using T = typename Compute<S>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = (d + 3) >> 2;
  const int ntb = split * tiles, ktb = ntb * 8;   // 8-key tiles and keys a stage
  const int nstages = (t + ktb - 1) / ktb;
  const bool whole = ring == 1;
  const int qblocks = ((t + 7) / 8 + groups - 1) / groups;
  const int64_t b = blockIdx.x / qblocks;
  const int q_first = static_cast<int>(blockIdx.x % qblocks) * groups * 8;
  const int g = warp / split, ks = warp - g * split;
  const int q0 = q_first + g * 8;
  // a warp past the last query still copies keys and meets every barrier
  const bool active = q0 < t;
  const int64_t plane = bsz * t * d;
  const int64_t out_plane = bsz * t * static_cast<int64_t>(t);
  const int qwords = n1 * nch * 32, jwords = (5 * n1 + 1) * 32;
  const int64_t stage_words = static_cast<int64_t>(qwords) * ntb;
  T* qs = reinterpret_cast<T*>(smem_raw);           // [groups][n1][nch][32]
  S* keys = reinterpret_cast<S*>(qs + groups * qwords);   // [ring][n1][nch][ntb][32]
  T* jets = reinterpret_cast<T*>(keys + ring * stage_words);   // [warps][jwords]
  T* wj = jets + warp * jwords;
  Pair<T>* sj = reinterpret_cast<Pair<T>*>(wj) + lane;   // [n1][32] pairs
  Pair<T>* ej = sj + n1 * 32;                            // [n1][32] pairs
  T* ltot = wj + 4 * n1 * 32 + lane;                     // [n1][32], then the maxima [32]
  T* gtot = jets + groups * split * jwords;         // [groups][n1 + 1][8]
  T* gt = gtot + g * (n1 + 1) * 8;                  // the group's totals [n1][8], maxima [8]
  T* inv = gtot + groups * (n1 + 1) * 8;            // [n1]: 1 / m
  const S* kb = k + b * t * d;
  const bool vec = scores_vec(k, d);

  if (whole) scores_stage_keys(keys, kb, plane, t, d, n1, nch, ntb, 0, vec);
  // the block's queries, scaled, in fragment order
  for (int idx = threadIdx.x; idx < groups * qwords; idx += blockDim.x) {
    const int l = idx & 31, rest = idx >> 5;
    const int ch = rest % nch, gi = rest / nch;   // gi = group * n1 + coefficient
    const int i = gi % n1, qi = q_first + (gi / n1) * 8 + (l >> 2), dd = ch * 4 + (l & 3);
    qs[idx] = qi < t && dd < d ? T(ld(q + i * plane + (b * t + qi) * d + dd)) * scale : T(0);
  }
  for (int m = threadIdx.x; m < n1; m += blockDim.x) inv[m] = m > 0 ? T(1) / T(m) : T(1);
  for (int m = 0; m < n1; ++m) ltot[m * 32] = T(0);
  if (whole) cp_async_wait_all();
  __syncthreads();   // the queries (and the whole row) are in
  const T* qg = qs + g * qwords;
  const int r = lane >> 2, c2 = (lane & 3) * 2;
  const bool q_ok = q0 + r < t;
  S* outr = out + (b * t + (q_ok ? q0 + r : 0)) * t + c2;
  const bool pair = (t & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & (2 * sizeof(S) - 1)) == 0;
  T run = lowest<T>(), mx = T(0), inv0 = T(0);

  for (int pass = 0; pass < 2; ++pass) {
    // the ring: stage st in slot st % 2 (the barrier after the merge keeps
    // pass 2's first copy off keys that pass 1 still reads)
    if (!whole) scores_stage_keys(keys, kb, plane, t, d, n1, nch, ntb, 0, vec);
    for (int st = 0; st < nstages; ++st) {
      if (!whole) {
        cp_async_wait_all();
        __syncthreads();   // stage st is in; every warp is done with stage st - 1
        if (st + 1 < nstages)
          scores_stage_keys(keys + ((st + 1) & 1) * stage_words, kb, plane, t, d, n1, nch, ntb,
                            (st + 1) * ktb, vec);
      }
      if (!active) continue;
      const S* buf = keys + (whole ? 0 : st & 1) * stage_words;
      for (int nt = 0; nt < tiles; ++nt) {
        const int tile = ks * tiles + nt, key0 = st * ktb + tile * 8;
        if (key0 >= t) break;   // warp-uniform
        scores_tile_rt(qg, buf + tile * 32, nch, ntb * 32, n1, lane, sj);
        const bool v0 = key0 + c2 < t, v1 = key0 + c2 + 1 < t;
        if (pass == 0) {
          if (v0 || v1) {
            const Pair<T> s0 = sj[0];
            T tm = v0 ? s0.x : lowest<T>();
            if (v1 && s0.y > tm) tm = s0.y;
            if (tm > run) {   // a new max: rescale the totals
              const T alpha = dev_exp(run - tm);
              for (int m = 0; m < n1; ++m) ltot[m * 32] *= alpha;
              run = tm;
            }
            scores_exp_jet<true>(sj, ej, run, n1, inv, ltot, v0, v1);
          }
        } else if (q_ok && (v0 || v1)) {
          scores_exp_jet<false>(sj, ej, mx, n1, inv, ltot, false, false);
          scores_divide_store(ej, gt + r, inv0, n1, outr + key0, out_plane, v0, v1, pair);
        }
      }
    }
    if (pass == 1) break;

    // merge the (max, totals) of each query's 4 lanes in each of its split
    // warps with the same rescale: M = the largest max, tot_m = sum of
    // exp(max - M) tot_m over the warps, then the lanes, in order
    ltot[n1 * 32] = run;
    __syncthreads();
    const T* grp = jets + g * split * jwords + 4 * n1 * 32;   // the group's first warp's totals
    for (int it = ks * 32 + lane; it < 8 * n1; it += split * 32) {
      const int rr = it & 7, m = it >> 3;
      T mm = lowest<T>();
      for (int sl = 0; sl < split; ++sl)
        for (int j = 0; j < 4; ++j) {
          const T v = grp[sl * jwords + n1 * 32 + rr * 4 + j];
          mm = v > mm ? v : mm;
        }
      T s = T(0);
      for (int sl = 0; sl < split; ++sl)
        for (int j = 0; j < 4; ++j) {
          const T* wt = grp + sl * jwords + rr * 4 + j;
          s += dev_exp(wt[n1 * 32] - mm) * wt[m * 32];
        }
      gt[m * 8 + rr] = s;
      if (m == 0) gt[n1 * 8 + rr] = mm;
    }
    __syncthreads();
    mx = gt[n1 * 8 + r];
    inv0 = T(1) / gt[r];
  }
}

// The smallest block, for what no tiled block fits: a warp per (row,
// query), lanes over keys, three passes (max, totals, probabilities),
// recomputing the score jet in each from one read of the key (its
// coefficients dim by dim), every per-key jet at a stride of 32 in shared
// memory; the wrappers admit what it admits.

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

bool bad_warps(int warps) { return warps < 1 || warps > kMaxWarps; }

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

template <typename S, int V, bool Staged>
cudaError_t jet_rms_norm_rt_as(const void* x, const void* gamma, void* out, int64_t bsz,
                               int width, int n1, double eps, int group, int warps,
                               cudaStream_t stream) {
  using T = typename Compute<S>::T;
  const int rpw = 32 / group;
  const int64_t smem =
      rms_slot_bytes(n1, width, group, Staged, sizeof(S), sizeof(T)) * rpw * warps;
  auto kernel = jet_rms_norm_rt_kernel<S, V, Staged>;
  unsigned grid = 0;
  const cudaError_t err =
      persistent_grid(kernel, warps * 32, smem, blocks_of(blocks_of(bsz, rpw), warps), &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, warps * 32, smem, stream>>>(static_cast<const S*>(x),
                                             static_cast<const S*>(gamma), static_cast<S*>(out),
                                             bsz, width, n1, static_cast<T>(eps), group);
  return cudaGetLastError();
}

template <typename S>
cudaError_t jet_rms_norm_rt(const void* x, const void* gamma, void* out, int64_t bsz, int width,
                            int n1, double eps, int vec, int group, int warps, bool staged,
                            cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(S);
  if (vec == kV) {
    if (width % kV || ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15))
      return cudaErrorInvalidValue;
    return staged ? jet_rms_norm_rt_as<S, kV, true>(x, gamma, out, bsz, width, n1, eps, group,
                                                    warps, stream)
                  : jet_rms_norm_rt_as<S, kV, false>(x, gamma, out, bsz, width, n1, eps, group,
                                                     warps, stream);
  }
  if (vec != 1) return cudaErrorInvalidValue;
  return staged ? jet_rms_norm_rt_as<S, 1, true>(x, gamma, out, bsz, width, n1, eps, group, warps,
                                                 stream)
                : jet_rms_norm_rt_as<S, 1, false>(x, gamma, out, bsz, width, n1, eps, group,
                                                  warps, stream);
}

// group > 0: the short-T kernel, `rows` batch rows a block (all their
// heads, 32 / team (row, head) pairs a warp); else, with
// key_tile > 0, the long-T kernel, `rows` queries (warps) a block; else
// the smallest block, `rows` warps.
template <typename S>
cudaError_t jet_flash_attention_rt(const void* q, const void* k, const void* v, const void* wo,
                                   void* out, int64_t bsz, int heads, int t, int dh, int dm,
                                   int n1, double scale, int mask, int window, int group,
                                   int rows, int key_tile, cudaStream_t stream) {
  using T = typename Compute<S>::T;
  const S* qs = static_cast<const S*>(q);
  const S* ks = static_cast<const S*>(k);
  const S* vs = static_cast<const S*>(v);
  const S* ws = static_cast<const S*>(wo);
  S* os = static_cast<S*>(out);
  const T sc = static_cast<T>(scale);
  if (group > 0) {
    const int team = pow2_ceil(t) * group;
    if (t > 4 || (group & (group - 1)) || team > 32) return cudaErrorInvalidValue;
    const int64_t warps = blocks_of(static_cast<int64_t>(rows) * heads, 32 / team);
    if (warps > kMaxWarps) return cudaErrorInvalidValue;
    const int wide = (t * dh * sizeof(S)) % 16 == 0 &&
                     !((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v)) & 15);
    const int64_t smem =
        flash_short_bytes(n1, heads, t, dh, dm, rows, sizeof(S), sizeof(T));
    auto kernel = jet_flash_attention_rt_short_kernel<S>;
    unsigned grid = 0;
    const cudaError_t err = persistent_grid(kernel, static_cast<int>(warps) * 32, smem,
                                            blocks_of(bsz, rows), &grid);
    if (err != cudaSuccess) return err;
    kernel<<<grid, static_cast<unsigned>(warps) * 32, smem, stream>>>(
        qs, ks, vs, ws, os, bsz, heads, t, dh, dm, n1, sc, mask, window, group, rows, wide);
    return cudaGetLastError();
  }
  if (bad_warps(rows)) return cudaErrorInvalidValue;
  if (key_tile > 0) {
    if (key_tile > 32) return cudaErrorInvalidValue;
    const int64_t smem = flash_long_words(n1, dh, dm, rows, key_tile) * int64_t{sizeof(T)};
    const int64_t blocks = bsz * ((t + rows - 1) / rows);
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    auto kernel = jet_flash_attention_rt_long_kernel<S>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(blocks), rows * 32, smem, stream>>>(
        qs, ks, vs, ws, os, bsz, heads, t, dh, dm, n1, sc, mask, window, key_tile);
    return cudaGetLastError();
  }
  const int64_t smem = flash_words(n1, dh, dm) * rows * int64_t{sizeof(T)};
  const int64_t blocks = blocks_of(bsz * t, rows);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = jet_flash_attention_rt_kernel<S>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), rows * 32, smem, stream>>>(
      qs, ks, vs, ws, os, bsz, heads, t, dh, dm, n1, sc, mask, window);
  return cudaGetLastError();
}

// groups > 0: the tiled kernel, `groups` query groups of `split` warps, a
// stage `tiles` 8-key tiles a warp, `ring` stages (1 only where one stage
// holds every key); groups == 0: the smallest block, `split` warps (tiles
// and ring 0).
template <typename S>
cudaError_t jet_attention_scores_rt(const void* q, const void* k, void* out, int64_t bsz, int t,
                                    int d, int n1, double scale, int groups, int split,
                                    int tiles, int ring, cudaStream_t stream) {
  using T = typename Compute<S>::T;
  const S* qs = static_cast<const S*>(q);
  const S* ks = static_cast<const S*>(k);
  S* os = static_cast<S*>(out);
  if (groups == 0) {
    if (bad_warps(split) || tiles != 0 || ring != 0) return cudaErrorInvalidValue;
    const int64_t smem = scores_words(n1, d) * split * static_cast<int64_t>(sizeof(T));
    const int64_t blocks = blocks_of(bsz * t, split);
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    auto kernel = jet_attention_scores_rt_kernel<S>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(blocks), split * 32, smem, stream>>>(
        qs, ks, os, bsz, t, d, n1, static_cast<T>(scale));
    return cudaGetLastError();
  }
  if (split < 1 || groups * split > kMaxWarps || tiles < 1 || ring < 1 || ring > kScoresMaxRing)
    return cudaErrorInvalidValue;
  if (ring == 1 && static_cast<int64_t>(split) * tiles * 8 < t) return cudaErrorInvalidValue;
  const int64_t smem = scores_tiled_bytes(n1, (d + 3) / 4, groups, split, tiles, ring,
                                          sizeof(S), sizeof(T));
  const int64_t blocks = bsz * (((t + 7) / 8 + groups - 1) / groups);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = jet_attention_scores_rt_tiled_kernel<S>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), groups * split * 32, smem, stream>>>(
      qs, ks, os, bsz, t, d, n1, static_cast<T>(scale), groups, split, tiles, ring);
  return cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for an argument the kernel does not take (a block
// whose shared memory exceeds the limit among them), or cudaSuccess for an
// empty input.  dtype: 0 float32, 1 float64, 2 bfloat16.  tab and reals are
// bell_tables.runtime_table(n1 - 1) on the tensors' device, as int32 and
// float64, n_ints and n_reals long.  The wrappers (tanh_jet.py,
// jet_dense.py, jet_attention.py) choose the geometry so the block fits: K2
// units of 32 elements, K1 rows and kc, the warps and whether the table is
// staged in shared memory (act_jet_geometry, jet_dense_geometry); K3 the
// vector width (1, or 16 bytes where rows are 16-byte aligned), lanes a
// row, warps and whether rows are staged (rms_norm_geometry); K4 the kernel
// and its tiles (flash_geometry); K5 the kernel and its tiles
// (scores_runtime_geometry).  The caller makes the tensors' device current.
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
                                      int width, int n1, int dtype, double eps, int vec,
                                      int group, int warps, int staged, void* stream) {
  if (bsz < 0 || width < 1 || n1 < 1 || group < 1 || group > 32 || (group & (group - 1)) ||
      bad_warps(warps))
    return cudaErrorInvalidValue;
  if (bsz == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const bool stage = staged != 0;
  if (dtype == kF32)
    return jet_rms_norm_rt<float>(x, gamma, out, bsz, width, n1, eps, vec, group, warps, stage,
                                  s);
  if (dtype == kF64)
    return jet_rms_norm_rt<double>(x, gamma, out, bsz, width, n1, eps, vec, group, warps, stage,
                                   s);
  if (dtype == kBF16)
    return jet_rms_norm_rt<__nv_bfloat16>(x, gamma, out, bsz, width, n1, eps, vec, group, warps,
                                          stage, s);
  return cudaErrorInvalidValue;
}

extern "C" int jet_flash_attention_rt_launch(const void* q, const void* k, const void* v,
                                             const void* wo, void* out, int64_t bsz, int heads,
                                             int t, int dh, int dm, int n1, int dtype,
                                             double scale, int mask, int window, int group,
                                             int rows, int key_tile, void* stream) {
  if (bsz < 0 || heads < 1 || t < 1 || dh < 1 || dm < 1 || n1 < 1 || group < 0 || rows < 1 ||
      key_tile < 0)
    return cudaErrorInvalidValue;
  if (mask < kMaskNone || mask > kMaskLocal || (mask == kMaskLocal && window < 1))
    return cudaErrorInvalidValue;
  if (bsz == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return jet_flash_attention_rt<float>(q, k, v, wo, out, bsz, heads, t, dh, dm, n1, scale,
                                         mask, window, group, rows, key_tile, s);
  if (dtype == kF64)
    return jet_flash_attention_rt<double>(q, k, v, wo, out, bsz, heads, t, dh, dm, n1, scale,
                                          mask, window, group, rows, key_tile, s);
  if (dtype == kBF16)
    return jet_flash_attention_rt<__nv_bfloat16>(q, k, v, wo, out, bsz, heads, t, dh, dm, n1,
                                                 scale, mask, window, group, rows, key_tile, s);
  return cudaErrorInvalidValue;
}

extern "C" int jet_attention_scores_rt_launch(const void* q, const void* k, void* out,
                                              int64_t bsz, int t, int d, int n1, int dtype,
                                              double scale, int groups, int split, int tiles,
                                              int ring, void* stream) {
  if (bsz < 0 || t < 1 || d < 1 || n1 < 1 || groups < 0) return cudaErrorInvalidValue;
  if (bsz == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return jet_attention_scores_rt<float>(q, k, out, bsz, t, d, n1, scale, groups, split, tiles,
                                          ring, s);
  if (dtype == kF64)
    return jet_attention_scores_rt<double>(q, k, out, bsz, t, d, n1, scale, groups, split, tiles,
                                           ring, s);
  if (dtype == kBF16)
    return jet_attention_scores_rt<__nv_bfloat16>(q, k, out, bsz, t, d, n1, scale, groups,
                                                  split, tiles, ring, s);
  return cudaErrorInvalidValue;
}
