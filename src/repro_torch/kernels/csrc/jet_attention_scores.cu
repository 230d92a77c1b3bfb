// K5: fused jet attention scores.  Q/K coefficient stacks (n+1, B, T, D) ->
// the softmaxed score jet (n+1, B, Tq, Tk), one launch.
//
// Replaces kernels/jet_attention.py::jet_attention_scores_pallas (body
// attention_scores_jet_body) of the JAX package.  The TPU kernel holds a
// block of whole (T, D) stacks in VMEM and runs the Cauchy terms on the MXU.
// Here a warp owns a tile of 8 queries x 8 keys at a time, and each lane two
// (query, key) pairs of it: query l/4, keys 2 (l%4) + {0, 1}, the layout of
// the accumulator of mma.sync m8n8k4.  Per pair:
//
//   s_m   = scale sum_{i+j=m} q_i . k_j
//   pass 1, over the keys with a running max M of s_0 (online softmax):
//     M' = max(M, s_0),  tot_m <- exp(M - M') tot_m + e_m,
//     e_0 = exp(s_0 - M'),  e_m = (1/m) sum_{j=1..m} j s_j e_{m-j}
//   pass 2, the keys again with the final M and totals:
//     p_0 = e_0 / tot_0,  p_m = (e_m - sum_{j=1..m} tot_j p_{m-j}) / tot_0
//   computed over the e-jet in place (p_m needs only e_m and p_{<m}).
//
// The scores are recomputed in pass 2 rather than stored: a row's N1 T
// scores do not fit on chip at T = 1024, and the output bytes are the
// bound.  Pass 2 recomputes the e-jet exactly as pass 1 did, so at T = 1
// (tot = e) every p_m above order 0 is exactly 0, as in the plain version;
// taking p = exp(s - log tot) as one jet recurrence instead (first tried)
// leaves ~1e-17 there, against a plain result of 0.
//
// The score contraction: s_m of an 8 x 8 tile is sum_i Q_i K_{m-i}^T.  In
// f64 it runs on the tensor cores: mma.sync m16n8k4 stacks two query
// coefficients (i, i + 1) against one key coefficient per instruction, in
// the time of one m8n8k4 (which reaches half the f64 tensor rate on
// Hopper), so 25 instructions cover the 45 products of N1 = 9 per 4 dims.
// In f32 each lane runs the same sums as FMAs for its two pairs (TF32
// would break the f32 gates).  Queries (scaled) and keys sit in
// shared memory in fragment order: for each coefficient and 4 dims, 8 rows
// x 4 dims contiguous, so a lane's fragment is word `lane` of a 32-word run
// and a warp's fragment load is one contiguous read; dims past D are 0.
//
// A block: `groups` query groups of 8 queries of one batch row, each taken
// by `split` warps that divide the keys of every stage between them; the
// split slices' (max, totals) are merged through shared memory with the
// same exp(M - M') rescale.  Keys come in stages of 8 split tiles keys
// (`tiles` 8-key tiles a warp), copied by the whole block with cp.async
// (16 bytes a copy where D allows) into a ring of two stages: the next
// stage's copy is in flight while the warps work on the current one, one
// barrier a stage.  Where the row's keys fit in one stage (`ring` 1), they
// are copied once and read by both passes.  The wrapper
// (jet_attention.py::scores_geometry) picks the geometry and mirrors
// smem_bytes below.  Ragged T and D: keys and dims past the end are
// zero-filled and masked, queries past T are not stored.  f32 accumulates
// in f32, f64 in f64.
//
// Bound on the H100: bytes.  The output is N1 B T^2 words against 2 N1 B T D
// of input; at (3, 4, 1024, 8) f64 that is 100.7 MB written, 30 us at
// 3.35 TB/s.  What holds it at 2.5-3.2x that at T = 1024 and 4.7-6.3x at
// T = 256 (one wave of 128 blocks; PERF.md): the FP64 work (the two
// passes' exp and recurrences, ~60 f64 operations a pair at N1 = 3; at
// N1 = 9 also the 2 x 45 x 8 MACs a pair on the tensor cores, ~100 us at
// (4, 1024, 8)), the copies of each row's keys from L2 (each block copies
// its row once per pass), and the stores, which overlap only in part.
// Occupancy: the f64 kernels at N1 >= 8 hold 168 registers a thread, so an
// SM takes one 8-warp block (two would need at most 128 registers a
// thread, where they spilled), and the geometries chosen at the timed
// shapes use 97-157 KB of shared memory; the grid there is ~128 blocks,
// one an SM, and 4-warp blocks two an SM (the same 8 warps) measured
// slower.  So these run 8 warps an SM, latency-bound.
// Measured and dropped: copying the whole row in rounds behind mbarriers
// so pass 1 starts early (slower), each block of a row walking the keys
// from another stage (no gain once copies read whole sectors), a key split
// of 16 warps (slower at (4, 256, 8)), a third ring stage (no gain), the
// f64 scores on FMAs (1.5-2x slower).
#include "act_jet.cuh"  // jetk::DType, JETK_FOR_EACH_N1
#include "cp_async.cuh"

namespace {

using namespace jetk;

constexpr int kMaxWarps = 16;        // 512 threads: 128 registers a thread at most

// Threads a block at most: 256 for the f64 kernels at N1 >= 8, so they may
// hold up to 255 registers (at 128 they spilled).
template <typename T, int N1>
constexpr int max_threads() {
  return sizeof(T) == 8 && N1 >= 8 ? 256 : kMaxWarps * 32;
}
constexpr int kMaxRing = 2;          // stages in flight: the one read, the one copied
constexpr int64_t kSmemLimit = 232448;

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }
// 1 / x for x >= 1 (a row's total tot_0: its max key adds exp(0)), to
// within an ulp: the approximate f32 reciprocal and Newton steps, no
// out-of-line slow path as the division has.  Exactly 1 at x = 1.
__device__ __forceinline__ float dev_rcp(float x) {
  const float r = __fdividef(1.0f, x);
  return fmaf(fmaf(-x, r, 1.0f), r, r);
}
__device__ __forceinline__ double dev_rcp(double x) {
  double r = static_cast<double>(__fdividef(1.0f, static_cast<float>(x)));
  r = fma(fma(-x, r, 1.0), r, r);
  return fma(fma(-x, r, 1.0), r, r);
}

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

// Bytes of a block's shared memory, elements of `item` bytes: the scaled
// queries [groups][N1][nch][32], the key ring [ring][N1][nch][split
// tiles][32] and the merge slots [groups split][8][N1 + 1].  Mirrored by
// jet_attention.py::scores_smem_bytes.
int64_t smem_bytes(int n1, int nch, int groups, int split, int tiles, int ring, int item) {
  return static_cast<int64_t>(item) * (static_cast<int64_t>(groups) * n1 * nch * 32 +
                                       static_cast<int64_t>(ring) * n1 * nch * split * tiles * 32 +
                                       static_cast<int64_t>(groups) * split * 8 * (n1 + 1));
}

// Copy keys key0 .. key0 + 8 ntb - 1 of batch row kb (all N1 coefficients)
// into one stage: [N1][nch][ntb][8 keys][4 dims].  Called by the whole
// block; keys past t and dims past d are zero-filled.  Where d allows
// 16-byte copies, neighbouring threads take neighbouring 16 bytes of a key
// row (a warp reads 512 contiguous bytes a coefficient: whole sectors);
// taking a key's 4 dims a thread in two f64 copies read every sector half
// by each copy, twice the L2 traffic.
template <typename T, int N1>
__device__ __forceinline__ void stage_keys(T* buf, const T* kb, int64_t plane, int t, int d,
                                           int nch, int ntb, int key0, bool vec) {
  const int cwords = nch * ntb * 32;  // one coefficient of the stage
  if (vec) {
    constexpr int kPer = static_cast<int>(sizeof(T)) / 4;  // 16-byte copies a 4-dim chunk
    constexpr int kEw = 16 / static_cast<int>(sizeof(T));  // elements a copy
    const int units = ntb * 8 * nch * kPer;
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      const int h = u % kPer, rest = u / kPer;
      const int n = rest / nch, ch = rest - n * nch;  // n: key within the stage
      const int key = key0 + n, dd = ch * 4 + h * kEw;
      T* dst = buf + (ch * ntb + (n >> 3)) * 32 + (n & 7) * 4 + h * kEw;
      const T* src = kb + static_cast<int64_t>(key) * d + dd;
      const bool ok = key < t && dd < d;
#pragma unroll
      for (int c = 0; c < N1; ++c) cp_async_16(dst + c * cwords, ok ? src + c * plane : kb, ok);
    }
  } else {
    const int units = ntb * 8 * nch;
    for (int u = threadIdx.x; u < units; u += blockDim.x) {
      const int n = u / nch, ch = u - n * nch;
      const int key = key0 + n, dd = ch * 4;
      T* dst = buf + (ch * ntb + (n >> 3)) * 32 + (n & 7) * 4;
      const T* src = kb + static_cast<int64_t>(key) * d + dd;
#pragma unroll
      for (int c = 0; c < N1; ++c) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const bool ok = key < t && dd + x < d;
          cp_async_elem(dst + c * cwords + x, ok ? src + c * plane + x : kb, ok);
        }
      }
    }
  }
}

// D = A B + D on the f64 tensor cores.  m8n8k4: lane l holds A[l/4][l%4],
// B[l%4][l/4] and D[l/4][2 (l%4) + {0, 1}].  m16n8k4 stacks a second 8 x 4
// A below the first (a1 = A[l/4 + 8][l%4]) into D rows 8-15 (d2, d3): two
// m8n8k4 products that share B, in the time of one m8n8k4 on Hopper.
__device__ __forceinline__ void mma_m8(double& d0, double& d1, double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}
__device__ __forceinline__ void mma_m16(double& d0, double& d1, double& d2, double& d3,
                                        double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d0), "+d"(d1), "+d"(d2), "+d"(d3)
      : "d"(a0), "d"(a1), "d"(b));
}

// Vector of V floats in one shared-memory load.
template <int V>
struct SmemVec;
template <>
struct SmemVec<2> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[2]) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  }
};
template <>
struct SmemVec<4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
};

// s[m][u] for the lane's pairs (query lane/4, key 2 (lane%4) + u) of one
// 8 x 8 tile: qg the query group's fragments, kt the tile's (coefficient c,
// chunk ch at kt + (c nch + ch) kstride).  On the tensor cores the query
// coefficients go two at a time (i, i + 1) against every key coefficient c
// with i + 1 + c < N1 (m16n8k4), the product that is left (i, N1 - 1 - i)
// alone (m8n8k4): 25 instructions per 4 dims at N1 = 9 for the 45
// products (f64).  On FMAs (f32) a lane reads its two keys' dims, then its
// query's one coefficient at a time, V dims a load (2 or 4 words).  Only
// the key fragments and one or two query fragments are live: holding all
// of both spilled at N1 >= 6.
template <typename T, int N1>
__device__ __forceinline__ void score_tile(const T* qg, const T* kt, int nch, int kstride,
                                           int lane, T (&s)[N1][2]) {
#pragma unroll
  for (int m = 0; m < N1; ++m) s[m][0] = s[m][1] = T(0);
  if constexpr (sizeof(T) == 8) {
    // (i, c) and (i, c + 2) share no accumulator, so each sweep over c is a
    // run of independent products; the pairs with i + c even go first, then
    // the odd ones.  The products left over, (i, N1 - 1 - i) for even i,
    // all land in s[N1 - 1]: they run in the sweep that does not touch it
    // (N1 - 1 - i has that sweep's parity).
    constexpr int kLeftPar = N1 % 2 == 1 ? 0 : 1;
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch) {
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        // the key coefficients c = par, par + 2, ... (a sweep uses no other)
        double kf[(N1 + 1) / 2];
#pragma unroll
        for (int c = par; c < N1; c += 2) kf[c / 2] = kt[(c * nch + ch) * kstride + lane];
#pragma unroll
        for (int i = 0; i < N1; i += 2) {
          const double q0 = qg[(i * nch + ch) * 32 + lane];
          if (i + 1 < N1) {
            const double q1 = qg[((i + 1) * nch + ch) * 32 + lane];
#pragma unroll
            for (int c = par; i + 1 + c < N1; c += 2)
              mma_m16(s[i + c][0], s[i + c][1], s[i + 1 + c][0], s[i + 1 + c][1], q0, q1,
                      kf[c / 2]);
          }
          if (par == kLeftPar) mma_m8(s[N1 - 1][0], s[N1 - 1][1], q0, kf[(N1 - 1 - i) / 2]);
        }
      }
    }
  } else {
    constexpr int V = N1 <= 4 ? 4 : 2;
    const int qo = (lane >> 2) * 4, ko = (lane & 3) * 8;
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch) {
#pragma unroll 1
      for (int x0 = 0; x0 < 4; x0 += V) {  // dims past d are 0
        T k0[N1][V], k1[N1][V];
#pragma unroll
        for (int c = 0; c < N1; ++c) {
          SmemVec<V>::load(kt + (c * nch + ch) * kstride + ko + x0, k0[c]);
          SmemVec<V>::load(kt + (c * nch + ch) * kstride + ko + 4 + x0, k1[c]);
        }
#pragma unroll
        for (int i = 0; i < N1; ++i) {
          T qv[V];
          SmemVec<V>::load(qg + (i * nch + ch) * 32 + qo + x0, qv);
#pragma unroll
          for (int x = 0; x < V; ++x) {
#pragma unroll
            for (int c = 0; i + c < N1; ++c) {
              s[i + c][0] += qv[x] * k0[c][x];
              s[i + c][1] += qv[x] * k1[c][x];
            }
          }
        }
      }
    }
  }
}

// e-jet of exp(s - shift) for the lane's pair u, by the power-series
// recurrence; s[m][u] becomes m s_m.
template <typename T, int N1>
__device__ __forceinline__ void exp_jet(T (&s)[N1][2], int u, T shift, T (&e)[N1]) {
  e[0] = dev_exp(s[0][u] - shift);
#pragma unroll
  for (int m = 1; m < N1; ++m) {
    s[m][u] *= T(m);
    T acc = T(0);
#pragma unroll
    for (int j = 1; j <= m; ++j) acc += s[j][u] * e[m - j];
    e[m] = acc * T(1.0 / m);
  }
}

template <typename T, int N1>
__global__ void __launch_bounds__(max_threads<T, N1>(), 1)
    jet_attention_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                T* __restrict__ out, int64_t bsz, int t, int d, T scale,
                                int groups, int split, int tiles, int ring) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = (d + 3) >> 2;
  const int ntb = split * tiles, ktb = ntb * 8;  // 8-key tiles and keys a stage
  const int nstages = (t + ktb - 1) / ktb;
  const bool whole = ring == 1;                  // one stage for both passes
  const int qblocks = ((t + 7) / 8 + groups - 1) / groups;
  const int64_t b = blockIdx.x / qblocks;
  const int g = warp / split, ks = warp - g * split;
  const int q0 = (static_cast<int>(blockIdx.x % qblocks) * groups + g) * 8;
  // a warp past the last query still copies keys and meets every barrier
  const bool active = q0 < t;
  const int64_t plane = bsz * t * d;
  const int64_t out_plane = bsz * t * static_cast<int64_t>(t);
  const int qwords = N1 * nch * 32;
  const int64_t stage_words = static_cast<int64_t>(qwords) * ntb;
  T* qs = reinterpret_cast<T*>(smem_raw);         // [groups][N1][nch][32]
  T* keys = qs + groups * qwords;                 // [ring][N1][nch][ntb][32]
  T* mrg = keys + ring * stage_words;             // [groups split][8][N1 + 1]
  const T* kb = k + b * t * d;
  const bool vec =
      d % (16 / static_cast<int>(sizeof(T))) == 0 && aligned_16(k);

  if (whole) stage_keys<T, N1>(keys, kb, plane, t, d, nch, ntb, 0, vec);
  // the block's queries, scaled, in fragment order
  const int q_first = static_cast<int>(blockIdx.x % qblocks) * groups * 8;
  for (int idx = threadIdx.x; idx < groups * qwords; idx += blockDim.x) {
    const int l = idx & 31, rest = idx >> 5;
    const int ch = rest % nch, gi = rest / nch;   // gi = group * N1 + coefficient
    const int i = gi % N1, qi = q_first + (gi / N1) * 8 + (l >> 2), dd = ch * 4 + (l & 3);
    qs[idx] = qi < t && dd < d ? q[i * plane + (b * t + qi) * d + dd] * scale : T(0);
  }
  if (whole) cp_async_wait_all();
  __syncthreads();  // the queries (and the whole row) are in
  const T* qg = qs + g * qwords;

  const int r = lane >> 2, c2 = (lane & 3) * 2;
  const int qi = q0 + r;
  T* outr = out + (b * t + qi) * t;
  const bool pair_store =
      (t & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & (2 * sizeof(T) - 1)) == 0;
  T run = lowest<T>(), tot[N1], inv0 = T(0);
#pragma unroll
  for (int m = 0; m < N1; ++m) tot[m] = T(0);

  for (int pass = 0; pass < 2; ++pass) {
    // the ring: stage st in slot st % 2 (the barrier after the merge below
    // keeps pass 2's first copy off keys that pass 1 still reads)
    if (!whole) stage_keys<T, N1>(keys, kb, plane, t, d, nch, ntb, 0, vec);
    for (int st = 0; st < nstages; ++st) {
      if (!whole) {
        cp_async_wait_all();
        __syncthreads();  // stage st is in; every warp is done with stage st - 1
        if (st + 1 < nstages)
          stage_keys<T, N1>(keys + ((st + 1) & 1) * stage_words, kb, plane, t, d, nch, ntb,
                            (st + 1) * ktb, vec);
      }
      if (!active) continue;
      const T* buf = keys + (whole ? 0 : st & 1) * stage_words;
      for (int nt = 0; nt < tiles; ++nt) {
        const int tile = ks * tiles + nt, key0 = st * ktb + tile * 8;
        if (key0 >= t) break;  // warp-uniform
        T s[N1][2];
        score_tile<T, N1>(qg, buf + tile * 32, nch, ntb * 32, lane, s);
        const bool v0 = key0 + c2 < t, v1 = key0 + c2 + 1 < t;
        if (pass == 0) {
          // online max of s_0 over the lane's keys, then the e-jets' totals
          T tm = v0 ? s[0][0] : lowest<T>();
          if (v1) tm = dev_max(tm, s[0][1]);
          if (tm > run) {
            const T alpha = dev_exp(run - tm);
#pragma unroll
            for (int m = 0; m < N1; ++m) tot[m] *= alpha;
            run = tm;
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (!(u == 0 ? v0 : v1)) continue;
            T e[N1];
            exp_jet<T, N1>(s, u, run, e);
#pragma unroll
            for (int m = 0; m < N1; ++m) tot[m] += e[m];
          }
        } else {
          // the e-jet with the final max, then p over it; kept in s
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            T e[N1];
            exp_jet<T, N1>(s, u, run, e);
            e[0] *= inv0;
#pragma unroll
            for (int m = 1; m < N1; ++m) {
              T acc = e[m];
#pragma unroll
              for (int j = 1; j <= m; ++j) acc -= tot[j] * e[m - j];
              e[m] = acc * inv0;
            }
#pragma unroll
            for (int m = 0; m < N1; ++m) s[m][u] = e[m];
          }
          if (qi < t) {
            T* o = outr + key0 + c2;
            if (v1 && pair_store) {
#pragma unroll
              for (int m = 0; m < N1; ++m) {
                if constexpr (sizeof(T) == 8)
                  __stcs(reinterpret_cast<double2*>(o + m * out_plane),
                         make_double2(s[m][0], s[m][1]));
                else
                  __stcs(reinterpret_cast<float2*>(o + m * out_plane),
                         make_float2(s[m][0], s[m][1]));
              }
            } else {
#pragma unroll
              for (int m = 0; m < N1; ++m) {
                if (v0) o[m * out_plane] = s[m][0];
                if (v1) o[m * out_plane + 1] = s[m][1];
              }
            }
          }
        }
      }
    }
    if (pass == 1) break;

    // merge the (max, totals) of the 4 lanes of a query, then of the split
    // warps of its group, with the same rescale
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const T other = __shfl_xor_sync(0xffffffffu, run, off);
      const T mx = dev_max(run, other);
      const T a = dev_exp(run - mx), o = dev_exp(other - mx);
#pragma unroll
      for (int m = 0; m < N1; ++m) {
        const T ot = __shfl_xor_sync(0xffffffffu, tot[m], off);
        tot[m] = tot[m] * a + ot * o;
      }
      run = mx;
    }
    if ((lane & 3) == 0) {
      T* slot = mrg + (warp * 8 + r) * (N1 + 1);
      slot[0] = run;
#pragma unroll
      for (int m = 0; m < N1; ++m) slot[1 + m] = tot[m];
    }
    __syncthreads();
    T mx = lowest<T>();
    for (int sl = 0; sl < split; ++sl) mx = dev_max(mx, mrg[((g * split + sl) * 8 + r) * (N1 + 1)]);
#pragma unroll
    for (int m = 0; m < N1; ++m) tot[m] = T(0);
    for (int sl = 0; sl < split; ++sl) {
      const T* slot = mrg + ((g * split + sl) * 8 + r) * (N1 + 1);
      const T a = dev_exp(slot[0] - mx);
#pragma unroll
      for (int m = 0; m < N1; ++m) tot[m] += a * slot[1 + m];
    }
    run = mx;
    inv0 = dev_rcp(tot[0]);
  }
}

template <typename T, int N1>
cudaError_t launch(const void* q, const void* k, void* out, int64_t bsz, int t, int d,
                   double scale, int groups, int split, int tiles, int ring,
                   cudaStream_t stream) {
  const int nch = (d + 3) / 4;
  const int64_t blocks = bsz * (((t + 7) / 8 + groups - 1) / groups);
  const int64_t smem =
      smem_bytes(N1, nch, groups, split, tiles, ring, static_cast<int>(sizeof(T)));
  if (blocks > 0x7fffffff || smem > kSmemLimit || groups * split * 32 > max_threads<T, N1>())
    return cudaErrorInvalidValue;
  auto kernel = jet_attention_scores_kernel<T, N1>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), groups * split * 32, static_cast<size_t>(smem),
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k), static_cast<T*>(out),
                     bsz, t, d, static_cast<T>(scale), groups, split, tiles, ring);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n1(int n1, const void* q, const void* k, void* out, int64_t bsz, int t,
                        int d, double scale, int groups, int split, int tiles, int ring,
                        cudaStream_t stream) {
  switch (n1) {
#define JETK_CASE(N) \
  case N:            \
    return launch<T, N>(q, k, out, bsz, t, d, scale, groups, split, tiles, ring, stream);
    JETK_FOR_EACH_N1(JETK_CASE)
#undef JETK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for an argument the kernel does not take (a
// geometry outside its limits), or cudaSuccess for an empty input.  groups
// x split warps a block (at most 16), tiles 8-key tiles a warp a stage,
// ring stages in shared memory (1 only where one stage holds every key,
// else 2).  The caller makes the tensors' device current.
extern "C" int jet_attention_scores_launch(const void* q, const void* k, void* out,
                                           int64_t bsz, int t, int d, int n1, int dtype,
                                           double scale, int groups, int split, int tiles,
                                           int ring, void* stream) {
  if (bsz < 0 || t < 1 || d < 1) return cudaErrorInvalidValue;
  if (groups < 1 || split < 1 || groups * split > kMaxWarps || tiles < 1 || ring < 1 ||
      ring > kMaxRing)
    return cudaErrorInvalidValue;
  if (ring == 1 && static_cast<int64_t>(split) * tiles * 8 < t) return cudaErrorInvalidValue;
  if (bsz == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_n1<float>(n1, q, k, out, bsz, t, d, scale, groups, split, tiles, ring, s);
  if (dtype == kF64)
    return dispatch_n1<double>(n1, q, k, out, bsz, t, d, scale, groups, split, tiles, ring, s);
  return cudaErrorInvalidValue;
}
