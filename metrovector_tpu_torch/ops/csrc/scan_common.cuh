// Pieces shared by K1's scan kernels (topk_kernel.cu, topk_high_kernel.cu,
// topk_int_kernel.cu): a 64-bit min, cp.async into shared memory with zero
// fill, the launch helpers of a kernel instance that opts into more
// dynamic shared memory than the default 48 KiB, and the warp-per-query
// merge of the splits' lists that pass 2 runs.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "select.cuh"

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


constexpr int kWarpMergeThreads = 256;
constexpr int kMaxSplits = 512;  // ops/select.py::MAX_SPLITS
constexpr int kSplitsPerLane = kMaxSplits / 32;

// One warp per query: merge S sorted lists of k into the final top-k.
__global__ void __launch_bounds__(kWarpMergeThreads)
    warp_merge_kernel(const float* __restrict__ part_s,
                      const int* __restrict__ part_i, int64_t nq, int k,
                      int splits, float* __restrict__ out_s,
                      int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int64_t gq =
      static_cast<int64_t>(blockIdx.x) * (kWarpMergeThreads / 32) + (threadIdx.x >> 5);
  if (gq >= nq) return;  // whole warp; the kernel has no block barrier
  const float* ps = part_s + gq * splits * k;
  const int* pi = part_i + gq * splits * k;
  float* os = out_s + gq * k;
  int* oi = out_i + gq * k;

  // Lane owns splits lane + 32u: its head position and head entry.
  int pos[kSplitsPerLane];
  float hs[kSplitsPerLane];
  int hi[kSplitsPerLane];
#pragma unroll
  for (int u = 0; u < kSplitsPerLane; ++u) {
    const int sp = lane + 32 * u;
    pos[u] = 0;
    hs[u] = sp < splits ? ps[static_cast<int64_t>(sp) * k] : -CUDART_INF_F;
    hi[u] = sp < splits ? pi[static_cast<int64_t>(sp) * k] : kSentinel;
  }
  for (int j = 0; j < k; ++j) {
    float bs = -CUDART_INF_F;
    int bi = kSentinel;
#pragma unroll
    for (int u = 0; u < kSplitsPerLane; ++u) {
      if (better(hs[u], hi[u], bs, bi)) {
        bs = hs[u];
        bi = hi[u];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float s2 = __shfl_xor_sync(kFull, bs, o);
      const int i2 = __shfl_xor_sync(kFull, bi, o);
      if (better(s2, i2, bs, bi)) {
        bs = s2;
        bi = i2;
      }
    }
    if (!(bs > -CUDART_INF_F)) {  // every list is exhausted
      for (int jj = j + lane; jj < k; jj += 32) {
        os[jj] = -CUDART_INF_F;
        oi[jj] = -1;
      }
      return;
    }
    if (lane == 0) {
      os[j] = bs;
      oi[j] = bi;
    }
    // Row indices are unique, so exactly one head holds the winner.
#pragma unroll
    for (int u = 0; u < kSplitsPerLane; ++u) {
      if (hi[u] == bi && hs[u] == bs) {
        const int64_t base = static_cast<int64_t>(lane + 32 * u) * k;
        const int p = ++pos[u];
        hs[u] = p < k ? ps[base + p] : -CUDART_INF_F;
        hi[u] = p < k ? pi[base + p] : kSentinel;
      }
    }
  }
}

// Pass 2 for lists of k in shared memory that the merge tree does not take:
// warp_merge_kernel over part_* [nq, splits, k] into out_* [nq, k].
inline cudaError_t warp_merge(const float* part_s, const int* part_i, int64_t nq,
                              int k, int splits, float* out_s, int* out_i,
                              cudaStream_t stream) {
  constexpr int kPerBlock = kWarpMergeThreads / 32;
  warp_merge_kernel<<<static_cast<unsigned>((nq + kPerBlock - 1) / kPerBlock),
                      kWarpMergeThreads, 0, stream>>>(part_s, part_i, nq, k, splits,
                                                      out_s, out_i);
  return cudaGetLastError();
}

}  // namespace
