// Pieces shared by K1's scan kernels (topk_kernel.cu, topk_high_kernel.cu,
// topk_int_kernel.cu): a 64-bit min, cp.async into shared memory with zero
// fill, and the launch helpers of a kernel instance that opts into more
// dynamic shared memory than the default 48 KiB.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// An unnamed namespace, as in select.cuh: every source that includes this
// gets its own copy.
namespace {

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// cp.async of BYTES (16 or 4) from gmem, of which `src` are read and the
// rest zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(src)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One instance of a scan kernel and the dynamic shared memory it takes.
struct Variant {
  const void* fn;
  size_t smem;
};

// Lets the instance take its shared memory; cudaErrorInvalidValue for an
// instance this build lacks (fn null).
inline cudaError_t prepare(const Variant& v) {
  if (v.fn == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(v.smem));
}

// Blocks of `threads` threads of the instance that fit on one SM at once,
// written to *blocks_per_sm.
inline cudaError_t occupancy(const Variant& v, int threads, int* blocks_per_sm) {
  const cudaError_t err = prepare(v);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, v.fn,
                                                       threads, v.smem);
}

}  // namespace
