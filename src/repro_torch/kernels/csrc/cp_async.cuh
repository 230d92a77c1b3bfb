// cp.async helpers shared by the kernels that stage tiles in shared memory
// (jet_dense.cu, jet_flash_attention.cu, jet_attention_scores.cu,
// jet_runtime.cu).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace jetk {

// One T from device memory to shared memory, asynchronously; zero-filled
// instead when !pred (src-size 0 reads nothing from src, which must still
// be a valid address).
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
               "n"(sizeof(T)), "r"(pred ? static_cast<int>(sizeof(T)) : 0));
}

// 16 bytes (16 / sizeof(T) elements) from device memory to shared memory,
// both addresses 16-byte aligned; zero-filled instead when !pred.
template <typename T>
__device__ __forceinline__ void cp_async_16(T* dst, const T* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ bool aligned_16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Wait for every copy this thread issued; a __syncthreads() after it makes
// the whole block's copies visible.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace jetk
