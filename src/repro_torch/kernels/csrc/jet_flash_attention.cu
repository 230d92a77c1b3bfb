// K4: flash-jet attention block.  Q/K/V coefficient stacks (n+1, B, H, T, Dh)
// and the output projection wo (H, Dh, Dm) -> the block output jet
// (n+1, B, T, Dm), one launch, no (Tq, Tk) score jet in device memory.
//
// Replaces kernels/jet_attention.py::jet_flash_attention_pallas (body
// _flash_kernel, mask _flash_block_keep) of the JAX package.  The TPU kernel
// carries its running statistics in VMEM scratch across a sequential KV grid
// axis; here one warp owns one (batch row b, query q) pair and walks the
// keys itself, 32 at a time (one key per lane), for each head in turn:
//
//   s_m   = scale sum_{i+j=m} q_i . k_j                  (lane = key)
//   m'    = max(m, max_keys s_0 over kept keys);  alpha = exp(m - m')
//   e_0   = exp(s_0 - m') on kept keys, exactly 0 elsewhere
//   e_m   = (1/m) sum_{j=1..m} j s_j e_{m-j}
//   t_m  <- alpha t_m + sum_keys e_m                     (warp shuffles)
//   a_m  <- alpha a_m + sum_keys sum_{i+j=m} e_i v_j     (lane = head dim)
//
// and, after the last key, o = a / t as a jet division (t_0 floored at
// 1e-37), o_m = (a_m - sum_{j=1..m} t_j o_{m-j}) / t_0.  Because the warp
// holds every head of its (b, q) pair, the projection over heads x Dh folds
// into the epilogue with no second reduction: each head's o goes to the
// warp's slice of shared memory, then lanes (over Dm) contract it with wo.
// The running max starts at MASK_NEG = -1e30, so alpha is exactly 0 on the
// first block; a masked key's e-jet is 0 at every order.  The kept keys of
// every mask are one interval, [lo, hi): none [0, T), causal [0, q],
// local(w) (q - w, q]; the warp visits only that interval, which is exact:
// a block with no kept key leaves m, t and a unchanged.
//
// Layout: q/k/v contiguous (the wrapper's caller makes them so); the
// running max and total jet live in registers (every lane holds a copy),
// the accumulator jet in registers with up to kMaxDPL head dims per lane
// (Dh <= 128), the query row of the current head and each head's output
// jet in a per-warp slice of dynamic shared memory, (H + 1)(n+1) Dh words.
// wo stays in device memory and is read through the read-only cache: every
// warp of a block reads the same (H Dh Dm) words, 8 KB at the served shape,
// so after the first warp they are L1 hits, and the model width is not
// capped by shared memory.  f32 accumulates in f32, f64 in f64.
//
// Bound on the H100: bytes.  At the cross-512 serving shape, q/k/v
// (5, 8192, 2, 2, 16) f64 and out (5, 8192, 2, 32), it moves 4 x 21.0 MB,
// 25.0 us at 3.35 TB/s, against ~160 MFLOP.  At T = 2 only 2 of 32 lanes hold a key;
// what this simple design leaves for later: several (b, q) pairs per warp
// when T is small, K/V tiles staged once per block for long T, and DMMA
// tiles for the score and value contractions.
#include "act_jet.cuh"  // jetk::DType, JETK_FOR_EACH_N1

namespace {

using namespace jetk;

constexpr int kWarps = 4;    // (b, q) pairs per block
constexpr int kMaxDPL = 4;   // head dims per lane: Dh <= 32 kMaxDPL
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

template <typename T, int N1>
__global__ void __launch_bounds__(kWarps * 32)
    jet_flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ wo,
                               T* __restrict__ out, int64_t bsz, int heads, int t, int dh,
                               int dm, T scale, int mask, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;  // b * T + qi
  if (row >= bsz * t) return;  // the whole warp leaves; nothing below syncs the block
  const int64_t b = row / t;
  const int qi = static_cast<int>(row % t);
  T* qs = reinterpret_cast<T*>(smem_raw) + static_cast<int64_t>(warp) * (heads + 1) * N1 * dh;
  T* os = qs + N1 * dh;  // [heads][N1][dh]
  const int64_t plane = bsz * heads * t * dh;  // one coefficient of q, k or v
  const T neg = T(kMaskNeg);
  const int lo = mask == kMaskLocal ? max(0, qi - window + 1) : 0;
  const int hi = mask == kMaskNone ? t : qi + 1;

  for (int h = 0; h < heads; ++h) {
    const int64_t head = (b * heads + h) * static_cast<int64_t>(t) * dh;  // (b, h, 0, 0)
    for (int idx = lane; idx < N1 * dh; idx += 32) {
      const int i = idx / dh, d = idx - i * dh;
      qs[idx] = q[i * plane + head + static_cast<int64_t>(qi) * dh + d];
    }
    __syncwarp();

    T m_run = neg;
    T tot[N1];
    T acc[N1][kMaxDPL];
#pragma unroll
    for (int m = 0; m < N1; ++m) {
      tot[m] = T(0);
#pragma unroll
      for (int c = 0; c < kMaxDPL; ++c) acc[m][c] = T(0);
    }

    for (int k0 = lo; k0 < hi; k0 += 32) {
      const int key = k0 + lane;
      const bool kept = key < hi;
      T s[N1];
#pragma unroll
      for (int m = 0; m < N1; ++m) s[m] = T(0);
      if (kept) {
        const T* kr = k + head + static_cast<int64_t>(key) * dh;
        for (int d = 0; d < dh; ++d) {
          T qc[N1], kc[N1];
#pragma unroll
          for (int i = 0; i < N1; ++i) {
            qc[i] = qs[i * dh + d];
            kc[i] = kr[i * plane + d];
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
        e[m] = r / T(m);
      }
#pragma unroll
      for (int m = 0; m < N1; ++m) {
        tot[m] = alpha * tot[m] + warp_sum(e[m]);
#pragma unroll
        for (int c = 0; c < kMaxDPL; ++c) acc[m][c] *= alpha;
      }
      const int n_keys = min(32, hi - k0);
      for (int kk = 0; kk < n_keys; ++kk) {
        T ek[N1];
#pragma unroll
        for (int i = 0; i < N1; ++i) ek[i] = __shfl_sync(0xffffffffu, e[i], kk);
        const T* vr = v + head + static_cast<int64_t>(k0 + kk) * dh;
#pragma unroll
        for (int c = 0; c < kMaxDPL; ++c) {
          const int d = lane + 32 * c;
          if (d < dh) {
            T vc[N1];
#pragma unroll
            for (int j = 0; j < N1; ++j) vc[j] = vr[j * plane + d];
#pragma unroll
            for (int m = 0; m < N1; ++m) {
#pragma unroll
              for (int i = 0; i <= m; ++i) acc[m][c] += ek[i] * vc[m - i];
            }
          }
        }
      }
      m_run = m_new;
    }

    const T inv0 = T(1) / dev_max(tot[0], T(1e-37));
#pragma unroll
    for (int c = 0; c < kMaxDPL; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) {
        T o[N1];
        o[0] = acc[0][c] * inv0;
#pragma unroll
        for (int m = 1; m < N1; ++m) {
          T r = acc[m][c];
#pragma unroll
          for (int j = 1; j <= m; ++j) r -= tot[j] * o[m - j];
          o[m] = r * inv0;
        }
#pragma unroll
        for (int m = 0; m < N1; ++m) os[(h * N1 + m) * dh + d] = o[m];
      }
    }
    __syncwarp();  // qs is rewritten for the next head; os is read below
  }

  const int64_t out_plane = bsz * t * dm;
  T* outr = out + row * dm;
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

template <typename T, int N1>
cudaError_t launch(const void* q, const void* k, const void* v, const void* wo, void* out,
                   int64_t bsz, int heads, int t, int dh, int dm, double scale, int mask,
                   int window, cudaStream_t stream) {
  const int64_t blocks = (bsz * t + kWarps - 1) / kWarps;
  const size_t smem = sizeof(T) * kWarps * static_cast<size_t>(heads + 1) * N1 * dh;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = jet_flash_attention_kernel<T, N1>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(wo), static_cast<T*>(out), bsz, heads, t, dh, dm,
      static_cast<T>(scale), mask, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n1(int n1, const void* q, const void* k, const void* v, const void* wo,
                        void* out, int64_t bsz, int heads, int t, int dh, int dm,
                        double scale, int mask, int window, cudaStream_t stream) {
  switch (n1) {
#define JETK_CASE(N) \
  case N:            \
    return launch<T, N>(q, k, v, wo, out, bsz, heads, t, dh, dm, scale, mask, window, stream);
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
// >= 1).  The caller makes the tensors' device current.
extern "C" int jet_flash_attention_launch(const void* q, const void* k, const void* v,
                                          const void* wo, void* out, int64_t bsz, int heads,
                                          int t, int dh, int dm, int n1, int dtype,
                                          double scale, int mask, int window, void* stream) {
  if (bsz < 0 || heads < 1 || t < 1 || dh < 1 || dh > 32 * kMaxDPL || dm < 1)
    return cudaErrorInvalidValue;
  if (mask < kMaskNone || mask > kMaskLocal || (mask == kMaskLocal && window < 1))
    return cudaErrorInvalidValue;
  if (bsz == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_n1<float>(n1, q, k, v, wo, out, bsz, heads, t, dh, dm, scale, mask, window,
                              s);
  if (dtype == kF64)
    return dispatch_n1<double>(n1, q, k, v, wo, out, bsz, heads, t, dh, dm, scale, mask,
                               window, s);
  return cudaErrorInvalidValue;
}
