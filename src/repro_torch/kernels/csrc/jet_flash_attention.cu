// K4: flash-jet attention block.  Q/K/V coefficient stacks (n+1, B, H, T, Dh)
// and the output projection wo (H, Dh, Dm) -> the block output jet
// (n+1, B, T, Dm), one launch, no (Tq, Tk) score jet in device memory.
//
// Replaces kernels/jet_attention.py::jet_flash_attention_pallas (body
// _flash_kernel, mask _flash_block_keep) of the JAX package.  For each
// (b, h, query) over its kept keys, in tiles with online statistics (the
// short-T kernel below takes its few keys at once: m' is their max, alpha
// is 1):
//
//   s_m   = scale sum_{i+j=m} q_i . k_j
//   m'    = max(m, s_0);  alpha = exp(m - m')
//   e_0   = exp(s_0 - m'),  e_m = (1/m) sum_{j=1..m} j s_j e_{m-j}
//   t_m  <- alpha t_m + e_m
//   a_m  <- alpha a_m + sum_{i+j=m} e_i v_j
//
// then o = a / t as a jet division (t_0 floored at 1e-37),
// o_m = (a_m - sum_{j=1..m} t_j o_{m-j}) / t_0, and the projection over
// heads x Dh folded into the same launch.  The running max starts at
// MASK_NEG = -1e30, so alpha is exactly 0 on the first key.  The kept keys
// of every mask are one interval [lo, hi): none [0, T), causal [0, q],
// local(w) (q - w, q]; only that interval is visited, which is exact: a
// masked key's e-jet is 0 at every order.  f32 accumulates in f32, f64 in
// f64.
//
// Bound on the H100: bytes.  At the cross-512 serving shape, q/k/v
// (5, 8192, 2, 2, 16) f64 and out (5, 8192, 2, 32), it moves 4 x 21.0 MB,
// 25.0 us at 3.35 TB/s, against ~140 M f64 operations (~8 us of the FP64
// pipe), 84 M of them the projection's multiply-adds.  The first version
// ran one warp per (row, query) with lanes over keys: at T = 2 two lanes
// ran the whole score and softmax chain while 30 waited, each lane read its
// own key row (lanes 128 bytes apart), registers were sized for Dh = 128,
// and the projection was one lane's serial chain of H Dh N1 FMAs per output
// column.  Two kernels now, chosen per launch by the wrapper
// (jet_attention.py::flash_geometry), which also sizes their tiles:
//
// * Short T (T <= 4: the trunk's tokens are its input coordinates).
//   jet_flash_attention_short_kernel gives each (row, query) a group of
//   G = Dh / DPL lanes (rounded up to a power of two, at most 32), DPL = 4
//   head dims a lane (a template).  A 128-thread block owns RB consecutive
//   batch rows, every query of each.  Per head a group reads its query's
//   dims and its kept keys' and values' straight from device memory: the
//   G lanes read neighbouring words, so every 32-byte sector is used
//   whole.  All kept keys (at most TK, a template: 2 or 4) are taken at
//   once: partial dot products per lane, one butterfly over the group for
//   every score, the softmax over the row (its max, the e-jets, the
//   totals) with no running rescale, then the value contraction and the
//   jet division on the lane's own dims.  Each group's output jet goes to
//   shared memory (rows of odd pitch); after the last head the block runs
//   the projection (RB T N1, H Dh) x (H Dh, Dm) from there: in f64 on the
//   tensor cores (mma.sync m8n8k4, a warp on 8 rows x 32 columns), in f32
//   on FMAs in 4 x 4 register tiles.  Staging K and V in shared memory
//   instead (first tried) measured slower at N1 = 5 and 9: its 88 KB a
//   block left two blocks, 8 warps, an SM for a kernel bound by latency.
// * Long T.  jet_flash_attention_long_kernel keeps the first version's warp
//   per query with lanes over keys, but a block of W warps takes W
//   consecutive queries of one batch row and stages each tile of KT keys of
//   K and V once, with contiguous copies, into shared memory rows padded to
//   Dh + 1 words (the lanes' strided key reads hit distinct banks); every
//   warp reads the tile there.  KT shrinks to 8, then W, then KT again,
//   until the block fits in shared memory.
//
// Register arrays are sized by DPL and TK, not for the largest head dim.
// What it leaves for later: more warps an SM at short T (the kernel is
// bound by latency: 128-thread blocks of ~124 registers at N1 = 5), double-
// buffered key tiles at long T, and fusing the q/k/v projections in.
#include "act_jet.cuh"  // jetk::DType, JETK_FOR_EACH_N1
#include "cp_async.cuh"

namespace {

using namespace jetk;

constexpr int kShortThreads = 128;
constexpr int kShortTMax = 4;  // the short-T kernel's key slots
constexpr int kOsRowTile = 8;  // output-jet rows in shared memory: a multiple of this
constexpr int kProjRows = 4;   // f32 projection: rows a thread accumulates at once
constexpr int kProjCols = 4;   // and columns
constexpr int kProjTiles = 4;  // f64 projection: 8-column tiles a warp takes at once
constexpr double kMaskNeg = -1e30;
enum Mask : int { kMaskNone = 0, kMaskCausal = 1, kMaskLocal = 2 };

__device__ __forceinline__ float dev_exp(float x) { return expf(x); }
__device__ __forceinline__ double dev_exp(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ T dev_max(T a, T b) {
  return a > b ? a : b;
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

// Kept keys of query qi: [lo, hi).
__device__ __forceinline__ int keep_lo(int qi, int mask, int window) {
  return mask == kMaskLocal ? max(0, qi - window + 1) : 0;
}
__device__ __forceinline__ int keep_hi(int qi, int t, int mask) {
  return mask == kMaskNone ? t : qi + 1;
}

// e-jet of one key from its score jet s and the running max (updated in
// place); returns alpha, the factor that rescales what came before.
template <typename T, int N1>
__device__ __forceinline__ T softmax_step(const T (&s)[N1], T& m_run, T (&e)[N1]) {
  const T m_new = dev_max(m_run, s[0]);
  const T alpha = dev_exp(m_run - m_new);
  e[0] = dev_exp(s[0] - m_new);
#pragma unroll
  for (int m = 1; m < N1; ++m) {
    T r = T(0);
#pragma unroll
    for (int j = 1; j <= m; ++j) r += T(j) * s[j] * e[m - j];
    e[m] = r * T(1.0 / m);
  }
  m_run = m_new;
  return alpha;
}

// o = a / t as jets, for one head dim.
template <typename T, int N1>
__device__ __forceinline__ void jet_divide(const T (&a)[N1], const T (&tot)[N1], T inv0,
                                           T (&o)[N1]) {
  o[0] = a[0] * inv0;
#pragma unroll
  for (int m = 1; m < N1; ++m) {
    T r = a[m];
#pragma unroll
    for (int j = 1; j <= m; ++j) r -= tot[j] * o[m - j];
    o[m] = r * inv0;
  }
}

// ---------------------------------------------------------------------------
// short T: a group of `group` lanes per (row, query), lanes over head dims
// ---------------------------------------------------------------------------

// Row pitch of the output jets in shared memory: odd, so the projection's
// four row groups of a warp read distinct banks.
__host__ __device__ constexpr int os_pitch(int hd) { return hd % 2 ? hd : hd + 1; }

template <typename T, int N1, int DPL, int TK>
__global__ void __launch_bounds__(kShortThreads)
    jet_flash_attention_short_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                     const T* __restrict__ v, const T* __restrict__ wo,
                                     T* __restrict__ out, int64_t bsz, int heads, int t,
                                     int dh, int dm, T scale, int mask, int window,
                                     int group, int rb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int g = tid / group, gl = tid - g * group;           // group, lane in group
  const unsigned gmask = (group == 32 ? 0xffffffffu : ((1u << group) - 1u))
                         << (lane & ~(group - 1));
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * rb;
  const int rows = bsz - b0 < rb ? static_cast<int>(bsz - b0) : rb;
  const int items = rb * t, r = g / t, qi = g - r * t;
  const bool active = g < items && r < rows;
  const int seg = t * dh;                                     // one (row, head) of a plane
  const int hd = heads * dh, op = os_pitch(hd);
  const int64_t plane = bsz * heads * seg;
  T* os = reinterpret_cast<T*>(smem_raw);                     // [items * N1][op]
  const int lo = keep_lo(qi, mask, window), hi = keep_hi(qi, t, mask);

  for (int h = 0; h < heads; ++h) {
    T qv[N1][DPL];
    const int64_t head = ((b0 + (active ? r : 0)) * heads + h) * seg;  // (b, h, 0, 0)
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = gl + group * c;
#pragma unroll
      for (int i = 0; i < N1; ++i)
        qv[i][c] = (active && d < dh) ? q[i * plane + head + qi * dh + d] : T(0);
    }
    if (active) {
      // the query's kept keys lo .. hi-1 (at most TK), all at once: scores,
      // then the softmax over them, then the values
      const T* kb = k + head;
      const T* vb = v + head;
      T s[TK][N1];
#pragma unroll
      for (int jj = 0; jj < TK; ++jj) {
#pragma unroll
        for (int m = 0; m < N1; ++m) s[jj][m] = T(0);
        if (lo + jj < hi) {
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            const int d = gl + group * c;
            if (d < dh) {
              T kc[N1];
#pragma unroll
              for (int i = 0; i < N1; ++i) kc[i] = __ldg(kb + i * plane + (lo + jj) * dh + d);
#pragma unroll
              for (int m = 0; m < N1; ++m)
#pragma unroll
                for (int i = 0; i <= m; ++i) s[jj][m] += qv[i][c] * kc[m - i];
            }
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < TK; ++jj)
#pragma unroll
        for (int m = 0; m < N1; ++m) {
          for (int off = group >> 1; off > 0; off >>= 1)
            s[jj][m] += __shfl_xor_sync(gmask, s[jj][m], off);
          s[jj][m] *= scale;
        }
      T mx = s[0][0];   // key lo is always kept
#pragma unroll
      for (int jj = 1; jj < TK; ++jj)
        if (lo + jj < hi) mx = dev_max(mx, s[jj][0]);
      T e[TK][N1], tot[N1];
#pragma unroll
      for (int m = 0; m < N1; ++m) tot[m] = T(0);
#pragma unroll
      for (int jj = 0; jj < TK; ++jj) {
        e[jj][0] = lo + jj < hi ? dev_exp(s[jj][0] - mx) : T(0);
#pragma unroll
        for (int m = 1; m < N1; ++m) {
          T acc = T(0);
#pragma unroll
          for (int j = 1; j <= m; ++j) acc += T(j) * s[jj][j] * e[jj][m - j];
          e[jj][m] = acc * T(1.0 / m);
        }
#pragma unroll
        for (int m = 0; m < N1; ++m) tot[m] += e[jj][m];
      }
      const T inv0 = T(1) / dev_max(tot[0], T(1e-37));
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = gl + group * c;
        if (d < dh) {
          T a[N1], o[N1];
#pragma unroll
          for (int m = 0; m < N1; ++m) a[m] = T(0);
#pragma unroll
          for (int jj = 0; jj < TK; ++jj) {
            if (lo + jj < hi) {
              T vc[N1];
#pragma unroll
              for (int i = 0; i < N1; ++i) vc[i] = __ldg(vb + i * plane + (lo + jj) * dh + d);
#pragma unroll
              for (int m = 0; m < N1; ++m)
#pragma unroll
                for (int i = 0; i <= m; ++i) a[m] += e[jj][i] * vc[m - i];
            }
          }
          jet_divide(a, tot, inv0, o);
#pragma unroll
          for (int m = 0; m < N1; ++m) os[(g * N1 + m) * op + h * dh + d] = o[m];
        }
      }
    }
  }
  __syncthreads();   // os is read below

  // projection: rows (item, m) of os x wo -> out[m][b0 + r][qi][:]
  const int mrows = items * N1;
  const int64_t out_plane = bsz * t * dm;
  if constexpr (sizeof(T) == 8) {
    // f64 on the tensor cores (mma.sync m8n8k4): each warp takes 8 rows x
    // kProjTiles 8-column tiles, so each A fragment feeds kProjTiles
    // independent products; lane l holds A[l/4][l%4], B[l%4][l/4] and
    // C[l/4][2 (l%4) + {0, 1}].  Past hd and dm the fragments are 0; rows
    // past mrows exist (the buffer is padded to 8) and are not stored.
    const int gr = lane >> 2, gc = lane & 3;
    const int m_tiles = (mrows + 7) / 8, n_groups = (dm + 8 * kProjTiles - 1) / (8 * kProjTiles);
    for (int tile = warp; tile < m_tiles * n_groups; tile += nwarps) {
      const int mt = tile / n_groups, n0 = (tile - mt * n_groups) * 8 * kProjTiles;
      double c[kProjTiles][2];
#pragma unroll
      for (int j = 0; j < kProjTiles; ++j) c[j][0] = c[j][1] = 0.0;
#pragma unroll 2
      for (int k0 = 0; k0 < hd; k0 += 4) {
        const int kk = k0 + gc;
        const double a = kk < hd ? os[(mt * 8 + gr) * op + kk] : 0.0;
#pragma unroll
        for (int j = 0; j < kProjTiles; ++j) {
          const int nb = n0 + 8 * j + gr;
          const double bv =
              kk < hd && nb < dm ? __ldg(wo + static_cast<int64_t>(kk) * dm + nb) : 0.0;
          asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
              "{%0, %1};\n"
              : "+d"(c[j][0]), "+d"(c[j][1])
              : "d"(a), "d"(bv));
        }
      }
      const int row = mt * 8 + gr, item = row / N1, m = row - item * N1;
      const int ir = item / t, iq = item - ir * t;
      if (row < mrows && ir < rows) {
        T* orow_out = out + m * out_plane + ((b0 + ir) * t + iq) * dm;
#pragma unroll
        for (int j = 0; j < kProjTiles; ++j) {
          const int n = n0 + 8 * j + 2 * gc;
          if (n < dm) orow_out[n] = c[j][0];
          if (n + 1 < dm) orow_out[n + 1] = c[j][1];
        }
      }
    }
  } else {
    // f32 on FMAs (no TF32): a warp is 4 row groups x 8 column lanes; a
    // thread accumulates kProjRows rows x kProjCols columns
    // (n = n0 + cl + 8 j), so each os value feeds kProjCols FMAs and each
    // wo value kProjRows
    const int rgl = lane >> 3, cl = lane & 7;
    const int row_groups = nwarps * 4;
    for (int n0 = 0; n0 < dm; n0 += 8 * kProjCols) {
      for (int row0 = (warp * 4 + rgl) * kProjRows; row0 < mrows;
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
            wv[j] = n < dm ? __ldg(wo + static_cast<int64_t>(kk) * dm + n) : T(0);
          }
#pragma unroll
          for (int rr = 0; rr < kProjRows; ++rr) {
            const T ov = orow[rr * op + kk];
#pragma unroll
            for (int j = 0; j < kProjCols; ++j) accp[rr][j] += ov * wv[j];
          }
        }
#pragma unroll
        for (int rr = 0; rr < kProjRows; ++rr) {
          const int row = row0 + rr, item = row / N1, m = row - item * N1;
          const int ir = item / t, iq = item - ir * t;
          if (row >= mrows || ir >= rows) continue;
          T* orow_out = out + m * out_plane + ((b0 + ir) * t + iq) * dm;
#pragma unroll
          for (int j = 0; j < kProjCols; ++j) {
            const int n = n0 + cl + 8 * j;
            if (n < dm) orow_out[n] = accp[rr][j];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// long T: a warp per query, lanes over keys, key tiles shared by the block
// ---------------------------------------------------------------------------

template <typename T, int N1, int DPL>
__global__ void __launch_bounds__(256)
    jet_flash_attention_long_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                    const T* __restrict__ v, const T* __restrict__ wo,
                                    T* __restrict__ out, int64_t bsz, int heads, int t,
                                    int dh, int dm, T scale, int mask, int window, int kt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nw = blockDim.x >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int qblocks = (t + nw - 1) / nw;
  const int64_t b = blockIdx.x / qblocks;
  const int q0 = static_cast<int>(blockIdx.x % qblocks) * nw;
  const int qi = q0 + warp;
  const bool active = qi < t;
  const int dp = dh + 1;                                   // padded key row
  T* ks = reinterpret_cast<T*>(smem_raw);                  // [N1][kt][dp]
  T* vs = ks + N1 * kt * dp;
  T* qs = vs + N1 * kt * dp + static_cast<int64_t>(warp) * (heads + 1) * N1 * dh;
  T* os = qs + N1 * dh;                                    // [heads][N1][dh]
  const int seg = t * dh;
  const int64_t plane = bsz * heads * seg;
  const T neg = T(kMaskNeg);
  const int lo = keep_lo(qi, mask, window), hi = keep_hi(qi, t, mask);
  // the block's keys: lo and hi grow with the query
  const int blo = keep_lo(q0, mask, window);
  const int bhi = keep_hi(min(q0 + nw, t) - 1, t, mask);

  for (int h = 0; h < heads; ++h) {
    const int64_t head = (b * heads + h) * seg;            // (b, h, 0, 0) in a plane
    if (active) {
      for (int idx = lane; idx < N1 * dh; idx += 32) {
        const int i = idx / dh, d = idx - i * dh;
        qs[idx] = q[i * plane + head + static_cast<int64_t>(qi) * dh + d];
      }
    }
    T m_run = neg;
    T tot[N1], acc[N1][DPL];
#pragma unroll
    for (int m = 0; m < N1; ++m) {
      tot[m] = T(0);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[m][c] = T(0);
    }

    for (int k0 = blo; k0 < bhi; k0 += kt) {
      const int nk = min(kt, t - k0);
      __syncthreads();   // every warp is done with the previous tile
      for (int idx = tid; idx < N1 * nk * dh; idx += blockDim.x) {
        const int row = idx / dh, d = idx - row * dh;      // row = i * nk + key
        const int i = row / nk, key = row - i * nk;
        const int64_t src = i * plane + head + static_cast<int64_t>(k0 + key) * dh + d;
        cp_async_elem(ks + (i * kt + key) * dp + d, k + src, true);
        cp_async_elem(vs + (i * kt + key) * dp + d, v + src, true);
      }
      cp_async_wait_all();
      __syncthreads();
      const int j0 = max(lo, k0), j1 = min(hi, k0 + nk);
      if (!active || j0 >= j1) continue;                   // warp-uniform

      const int key = k0 + lane;
      const bool kept = lane < nk && key >= j0 && key < j1;
      T s[N1];
#pragma unroll
      for (int m = 0; m < N1; ++m) s[m] = T(0);
      if (kept) {
        const T* kr = ks + lane * dp;
        for (int d = 0; d < dh; ++d) {
          T qc[N1], kc[N1];
#pragma unroll
          for (int i = 0; i < N1; ++i) {
            qc[i] = qs[i * dh + d];
            kc[i] = kr[i * kt * dp + d];
          }
#pragma unroll
          for (int m = 0; m < N1; ++m)
#pragma unroll
            for (int i = 0; i <= m; ++i) s[m] += qc[i] * kc[m - i];
        }
#pragma unroll
        for (int m = 0; m < N1; ++m) s[m] *= scale;
      }
      const T s0m = kept ? s[0] : neg;
      const T m_new = dev_max(m_run, warp_max(s0m));
      const T alpha = dev_exp(m_run - m_new);
      T e[N1];
      e[0] = kept ? dev_exp(s0m - m_new) : T(0);
#pragma unroll
      for (int m = 1; m < N1; ++m) {
        T r = T(0);
#pragma unroll
        for (int j = 1; j <= m; ++j) r += T(j) * s[j] * e[m - j];
        e[m] = r * T(1.0 / m);
      }
#pragma unroll
      for (int m = 0; m < N1; ++m) {
        tot[m] = alpha * tot[m] + warp_sum(e[m]);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[m][c] *= alpha;
      }
      for (int kk = j0 - k0; kk < j1 - k0; ++kk) {
        T ek[N1];
#pragma unroll
        for (int i = 0; i < N1; ++i) ek[i] = __shfl_sync(0xffffffffu, e[i], kk);
        const T* vr = vs + kk * dp;
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = lane + 32 * c;
          if (d < dh) {
            T vc[N1];
#pragma unroll
            for (int j = 0; j < N1; ++j) vc[j] = vr[j * kt * dp + d];
#pragma unroll
            for (int m = 0; m < N1; ++m)
#pragma unroll
              for (int i = 0; i <= m; ++i) acc[m][c] += ek[i] * vc[m - i];
          }
        }
      }
      m_run = m_new;
    }

    if (active) {
      const T inv0 = T(1) / dev_max(tot[0], T(1e-37));
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        if (d < dh) {
          T a[N1], o[N1];
#pragma unroll
          for (int m = 0; m < N1; ++m) a[m] = acc[m][c];
          jet_divide(a, tot, inv0, o);
#pragma unroll
          for (int m = 0; m < N1; ++m) os[(h * N1 + m) * dh + d] = o[m];
        }
      }
    }
    __syncwarp();   // qs is rewritten for the next head; os is read below
  }
  if (!active) return;

  const int64_t out_plane = bsz * t * dm;
  T* outr = out + (b * t + qi) * dm;
  for (int n = lane; n < dm; n += 32) {
    T r[N1];
#pragma unroll
    for (int m = 0; m < N1; ++m) r[m] = T(0);
    for (int h = 0; h < heads; ++h) {
      for (int d = 0; d < dh; ++d) {
        const T w = __ldg(wo + (static_cast<int64_t>(h) * dh + d) * dm + n);
        const T* oc = os + h * N1 * dh + d;
#pragma unroll
        for (int m = 0; m < N1; ++m) r[m] += oc[m * dh] * w;
      }
    }
#pragma unroll
    for (int m = 0; m < N1; ++m) outr[m * out_plane + n] = r[m];
  }
}

// Shared memory of each kernel, in words; jet_attention.py::flash_geometry
// computes the same.
template <typename T>
int64_t short_smem_words(int n1, int heads, int t, int dh, int rb) {
  const int64_t mrows =
      (static_cast<int64_t>(rb) * t * n1 + kOsRowTile - 1) / kOsRowTile * kOsRowTile;
  return mrows * os_pitch(heads * dh);
}
int64_t long_smem_words(int n1, int heads, int dh, int warps, int kt) {
  return 2LL * n1 * kt * (dh + 1) + static_cast<int64_t>(warps) * (heads + 1) * n1 * dh;
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in;
// a refused opt-in is returned, and cleared so no later launch reports it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// Short T: `group` lanes per query, `rows` batch rows per block, 4 head
// dims a lane, TK key slots (>= t).
template <typename T, int N1, int TK>
cudaError_t launch_short(const T* q, const T* k, const T* v, const T* wo, T* out,
                         int64_t bsz, int heads, int t, int dh, int dm, double scale, int mask,
                         int window, int group, int rows, cudaStream_t stream) {
  if (group > 32 || (group & (group - 1)) || group * 4 < dh || rows < 1 || t > TK ||
      rows * t * group > kShortThreads)
    return cudaErrorInvalidValue;
  const int64_t blocks = (bsz + rows - 1) / rows;
  const size_t smem = sizeof(T) * short_smem_words<T>(N1, heads, t, dh, rows);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = jet_flash_attention_short_kernel<T, N1, 4, TK>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kShortThreads, smem, stream>>>(
      q, k, v, wo, out, bsz, heads, t, dh, dm, static_cast<T>(scale), mask, window, group,
      rows);
  return cudaGetLastError();
}

// Long T: `rows` warps (queries) per block, key tiles of `key_tile` keys.
template <typename T, int N1, int DPL>
cudaError_t launch_long(const T* q, const T* k, const T* v, const T* wo, T* out,
                        int64_t bsz, int heads, int t, int dh, int dm, double scale, int mask,
                        int window, int rows, int key_tile, cudaStream_t stream) {
  if (rows < 1 || rows > 8 || key_tile < 1 || key_tile > 32 || 32 * DPL < dh)
    return cudaErrorInvalidValue;
  const int64_t blocks = bsz * ((t + rows - 1) / rows);
  const size_t smem = sizeof(T) * long_smem_words(N1, heads, dh, rows, key_tile);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = jet_flash_attention_long_kernel<T, N1, DPL>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), rows * 32, smem, stream>>>(
      q, k, v, wo, out, bsz, heads, t, dh, dm, static_cast<T>(scale), mask, window,
      key_tile);
  return cudaGetLastError();
}

template <typename T, int N1, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v, const void* wo, void* out,
                   int64_t bsz, int heads, int t, int dh, int dm, double scale, int mask,
                   int window, int group, int rows, int key_tile, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* wt = static_cast<const T*>(wo);
  T* ot = static_cast<T*>(out);
  if (group == 0)
    return launch_long<T, N1, DPL>(qt, kt, vt, wt, ot, bsz, heads, t, dh, dm, scale, mask,
                                   window, rows, key_tile, stream);
  if constexpr (DPL == 4) {   // flash_geometry gives the short-T kernel 4 dims a lane
    if (t <= 2)
      return launch_short<T, N1, 2>(qt, kt, vt, wt, ot, bsz, heads, t, dh, dm, scale, mask,
                                    window, group, rows, stream);
    return launch_short<T, N1, kShortTMax>(qt, kt, vt, wt, ot, bsz, heads, t, dh, dm, scale,
                                           mask, window, group, rows, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, int N1>
cudaError_t dispatch_dpl(int dpl, const void* q, const void* k, const void* v,
                         const void* wo, void* out, int64_t bsz, int heads, int t, int dh,
                         int dm, double scale, int mask, int window, int group, int rows,
                         int key_tile, cudaStream_t stream) {
  switch (dpl) {
    case 1:
      return launch<T, N1, 1>(q, k, v, wo, out, bsz, heads, t, dh, dm, scale, mask, window,
                              group, rows, key_tile, stream);
    case 2:
      return launch<T, N1, 2>(q, k, v, wo, out, bsz, heads, t, dh, dm, scale, mask, window,
                              group, rows, key_tile, stream);
    case 4:
      return launch<T, N1, 4>(q, k, v, wo, out, bsz, heads, t, dh, dm, scale, mask, window,
                              group, rows, key_tile, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_n1(int n1, int dpl, const void* q, const void* k, const void* v,
                        const void* wo, void* out, int64_t bsz, int heads, int t, int dh,
                        int dm, double scale, int mask, int window, int group, int rows,
                        int key_tile, cudaStream_t stream) {
  switch (n1) {
#define JETK_CASE(N)                                                                     \
  case N:                                                                                \
    return dispatch_dpl<T, N>(dpl, q, k, v, wo, out, bsz, heads, t, dh, dm, scale, mask, \
                              window, group, rows, key_tile, stream);
    JETK_FOR_EACH_N1(JETK_CASE)
#undef JETK_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t: the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for an argument the kernel does not take, or
// cudaSuccess for an empty input.  mask: 0 none, 1 causal, 2 local (window
// >= 1).  The tiling comes from jet_attention.py::flash_geometry: group > 0
// runs the short-T kernel (group lanes per query, `rows` batch rows per
// block), group == 0 the long-T kernel (`rows` queries per block, key tiles
// of key_tile); head dims per lane dpl is 1, 2 or 4.  The caller makes the
// tensors' device current.
extern "C" int jet_flash_attention_launch(const void* q, const void* k, const void* v,
                                          const void* wo, void* out, int64_t bsz, int heads,
                                          int t, int dh, int dm, int n1, int dtype,
                                          double scale, int mask, int window, int group,
                                          int rows, int key_tile, int dpl, void* stream) {
  if (bsz < 0 || heads < 1 || t < 1 || dh < 1 || dh > 128 || dm < 1 || group < 0)
    return cudaErrorInvalidValue;
  if (mask < kMaskNone || mask > kMaskLocal || (mask == kMaskLocal && window < 1))
    return cudaErrorInvalidValue;
  if (bsz == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_n1<float>(n1, dpl, q, k, v, wo, out, bsz, heads, t, dh, dm, scale, mask,
                              window, group, rows, key_tile, s);
  if (dtype == kF64)
    return dispatch_n1<double>(n1, dpl, q, k, v, wo, out, bsz, heads, t, dh, dm, scale, mask,
                               window, group, rows, key_tile, s);
  return cudaErrorInvalidValue;
}
