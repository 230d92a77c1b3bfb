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
//   memory, laid out [coefficient][thread] (or [coefficient][lane]) so a
//   warp's accesses hit distinct banks; the wrappers size blocks so that
//   the working set fits (jet_attention.py / tanh_jet.py mirror each
//   formula) and refuse, naming the bytes, only where one warp does not.
// * The dense epilogue (K1, K2) walks the tables of
//   bell_tables.py::runtime_table, read from device memory: each output
//   order's terms as records (m, count, j_1..j_count) with their
//   coefficients, the tanh / sigmoid Horner rows, 1/m! for sin.  Every
//   thread of a warp reads the same record (one broadcast load), and the
//   products and sums round one by one, in ref.py's order, as in the
//   templated epilogue.  The output orders are computed from the highest
//   down, each stored over its input coefficient, which no lower order
//   reads.
// * bfloat16 is loaded into float, computed on the float path (FMAs; no
//   tensor cores) and rounded to bfloat16 once, on the store: the
//   reference's promote_types(dtype, float32).
//
// Designs, one a kernel: K2 a thread per element; K1 a thread per output
// element (row, column), its N1 dot products over Din straight from device
// memory (x broadcast across the row's threads, w coalesced), the bias on
// c_0, then the epilogue; K3 a warp per row (lanes over W, warp sums of the
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
// operations for K1/K2 at high orders), but these are simple kernels that
// are right, not fast: the epilogue is a chain of dependent table loads,
// K1 re-reads its row of x for every output column (from L1), K4 and K5
// re-read keys and values per query from L2 and reduce each score
// coefficient across the warp.  Their times against the bound are in
// PERF.md; making them fast is later work.
#include <cuda_bf16.h>

#include "act_jet.cuh"  // jetk::Act, jetk::DType, fdb::mul / fdb::add, dev_tanh / sin / cos

namespace {

using namespace jetk;

constexpr int kBF16 = 2;             // DTYPE_CODES[torch.bfloat16]
constexpr int kSmemLimit = 232448;   // shared memory a block can use on Hopper
constexpr int kMaxWarps = 8;         // warps of a K3/K4/K5 block, at most
constexpr double kMaskNeg = -1e30;
enum Mask : int { kMaskNone = 0, kMaskCausal = 1, kMaskLocal = 2 };
// positions of bell_tables.runtime_table's header
enum Table : int { kOrder = 0, kRecords = 1, kCoefs = 2, kTanhRows = 3, kSigmoidRows = 4,
                   kInvFact = 5 };

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

// z[k * stride] <- sigma(z) as a jet for k < n1 (the tables of order
// n1 - 1); f is scratch of the same layout.  A no-op for kNone.
template <typename T>
__device__ void act_jet_runtime(int act, int n1, const int* __restrict__ tab,
                                const double* __restrict__ re, T* z, T* f, int stride) {
  if (act == kNone) return;
  const T z0 = z[0];
  if (act == kSin) {
    const T s = dev_sin(z0), c = dev_cos(z0);
    const double* inv = re + tab[kInvFact];
    for (int m = 0; m < n1; ++m) {
      const T v = (m % 4 == 0) ? s : (m % 4 == 1) ? c : (m % 4 == 2) ? -s : -c;
      f[m * stride] = fdb::mul(v, T(inv[m]));
    }
  } else {
    const T u = act == kTanh ? dev_tanh(z0) : T(0.5) * (dev_tanh(T(0.5) * z0) + T(1));
    const int* rows = tab + tab[act == kTanh ? kTanhRows : kSigmoidRows];
    for (int m = 0; m < n1; ++m) {
      const int lo = rows[m], hi = rows[m + 1];
      T acc = T(re[hi - 1]);
      for (int i = hi - 2; i >= lo; --i) acc = fdb::add(fdb::mul(acc, u), T(re[i]));
      f[m * stride] = acc;
    }
  }
  const int* recs = tab + tab[kRecords];   // recs[k - 1]: order k's first record
  const int* coefs = tab + tab[kCoefs];    // coefs[k - 1]: order k's first coefficient
  for (int k = n1 - 1; k >= 1; --k) {
    const int end = recs[k];
    int t = coefs[k - 1];
    T acc = T(0);
    for (int p = recs[k - 1]; p < end; ++t) {
      const int m = tab[p], cnt = tab[p + 1];
      T prod = fdb::mul(f[m * stride], T(re[t]));
      for (int i = 0; i < cnt; ++i) prod = fdb::mul(prod, z[tab[p + 2 + i] * stride]);
      acc = p == recs[k - 1] ? prod : fdb::add(acc, prod);
      p += 2 + cnt;
    }
    z[k * stride] = acc;
  }
  z[0] = f[0];
}

// ---------------------------------------------------------------------------
// K2 and K1: a thread per element, its stack z and Taylor stack F in shared
// memory
// ---------------------------------------------------------------------------

template <typename S>
__global__ void act_jet_rt_kernel(const S* __restrict__ x, S* __restrict__ out, int64_t n_elem,
                                  int n1, int act, const int* __restrict__ tab,
                                  const double* __restrict__ re) {
  using T = typename Compute<S>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride = blockDim.x;
  T* z = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  T* f = z + n1 * stride;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_elem) return;
  for (int k = 0; k < n1; ++k) z[k * stride] = ld(x + k * n_elem + i);
  act_jet_runtime<T>(act, n1, tab, re, z, f, stride);
  for (int k = 0; k < n1; ++k) st(out + k * n_elem + i, z[k * stride]);
}

template <typename S>
__global__ void jet_dense_rt_kernel(const S* __restrict__ x, const S* __restrict__ w,
                                    const S* __restrict__ bias, S* __restrict__ out,
                                    int64_t bsz, int din, int dout, int n1, int act,
                                    const int* __restrict__ tab, const double* __restrict__ re) {
  using T = typename Compute<S>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride = blockDim.x;
  T* z = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  T* f = z + n1 * stride;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= bsz * dout) return;
  const int64_t b = idx / dout;
  const int o = static_cast<int>(idx - b * dout);
  const int64_t plane_in = bsz * din;
  for (int p = 0; p < n1; ++p) {
    const S* xr = x + p * plane_in + b * din;
    T acc = T(0);
    for (int i = 0; i < din; ++i) acc = fmadd(ld(xr + i), ld(w + static_cast<int64_t>(i) * dout + o), acc);
    if (p == 0) acc += ld(bias + o);
    z[p * stride] = acc;
  }
  act_jet_runtime<T>(act, n1, tab, re, z, f, stride);
  const int64_t plane_out = bsz * dout;
  for (int p = 0; p < n1; ++p) st(out + p * plane_out + idx, z[p * stride]);
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

template <typename S>
cudaError_t act_jet_rt(const void* x, void* out, int64_t n_elem, int n1, int act, const int* tab,
                       const double* re, int threads, cudaStream_t stream) {
  using T = typename Compute<S>::T;
  const int64_t smem = 2LL * n1 * threads * sizeof(T);
  const int64_t blocks = blocks_of(n_elem, threads);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = act_jet_rt_kernel<S>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const S*>(x), static_cast<S*>(out), n_elem, n1, act, tab, re);
  return cudaGetLastError();
}

template <typename S>
cudaError_t jet_dense_rt(const void* x, const void* w, const void* bias, void* out, int64_t bsz,
                         int din, int dout, int n1, int act, const int* tab, const double* re,
                         int threads, cudaStream_t stream) {
  using T = typename Compute<S>::T;
  const int64_t smem = 2LL * n1 * threads * sizeof(T);
  const int64_t blocks = blocks_of(bsz * dout, threads);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = jet_dense_rt_kernel<S>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(w), static_cast<const S*>(bias),
      static_cast<S*>(out), bsz, din, dout, n1, act, tab, re);
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

bool bad_threads(int threads) { return threads < 32 || threads > 1024 || threads % 32; }
bool bad_warps(int warps) { return warps < 1 || warps > kMaxWarps; }

}  // namespace

// Each returns a cudaError_t: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for an argument the kernel does not take (a block
// whose shared memory exceeds the limit among them), or cudaSuccess for an
// empty input.  dtype: 0 float32, 1 float64, 2 bfloat16.  tab and reals are
// bell_tables.runtime_table(n1 - 1) on the tensors' device, as int32 and
// float64.  The wrappers (tanh_jet.py, jet_dense.py, jet_attention.py)
// choose threads / warps so the block fits; the caller makes the tensors'
// device current.
extern "C" int act_jet_rt_launch(const void* x, void* out, int64_t n_elem, int n1, int act,
                                 int dtype, const void* tab, const void* reals, int threads,
                                 void* stream) {
  if (n_elem < 0 || n1 < 1 || act < kTanh || act > kSin || bad_threads(threads))
    return cudaErrorInvalidValue;
  if (n_elem == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const int* ti = static_cast<const int*>(tab);
  const double* re = static_cast<const double*>(reals);
  if (dtype == kF32) return act_jet_rt<float>(x, out, n_elem, n1, act, ti, re, threads, s);
  if (dtype == kF64) return act_jet_rt<double>(x, out, n_elem, n1, act, ti, re, threads, s);
  if (dtype == kBF16)
    return act_jet_rt<__nv_bfloat16>(x, out, n_elem, n1, act, ti, re, threads, s);
  return cudaErrorInvalidValue;
}

extern "C" int jet_dense_rt_launch(const void* x, const void* w, const void* bias, void* out,
                                   int64_t bsz, int din, int dout, int n1, int act, int dtype,
                                   const void* tab, const void* reals, int threads,
                                   void* stream) {
  if (bsz < 0 || din < 1 || dout < 1 || n1 < 1 || act < kNone || act > kSin ||
      bad_threads(threads))
    return cudaErrorInvalidValue;
  if (bsz == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const int* ti = static_cast<const int*>(tab);
  const double* re = static_cast<const double*>(reals);
  if (dtype == kF32)
    return jet_dense_rt<float>(x, w, bias, out, bsz, din, dout, n1, act, ti, re, threads, s);
  if (dtype == kF64)
    return jet_dense_rt<double>(x, w, bias, out, bsz, din, dout, n1, act, ti, re, threads, s);
  if (dtype == kBF16)
    return jet_dense_rt<__nv_bfloat16>(x, w, bias, out, bsz, din, dout, n1, act, ti, re,
                                       threads, s);
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
