// Row gather and fused gather + exact rescore + top-k, for Hopper (sm_90a).
//
// Replaces the Pallas kernel metrovector_tpu/ops/gather_kernel.py::
// gather_rows and the re-rank it feeds (ops/distances.py::rescore_topk,
// index/pq.py::_rerank_impl).
//
// gather_kernel: out[r] = db[clamp(idx[r], 0, N-1)], a byte copy (so
// bit-exact for every dtype), in 16-, 4- or 1-byte words as the row width
// and alignment allow. The TPU kernel fetched 8-row strips because Mosaic
// cannot DMA one row; Hopper loads any row, so there is no N % 8 rule. It
// is bound by HBM: one read and one write of each gathered byte.
//
// rescore_kernel: one block per query over its R candidate rows:
//
//   dot(q, x)  in f32 FFMA, no tensor cores, no TF32: lane l of a warp
//              accumulates d = 4l..4l+3, 4l+128.. in order, then the 32
//              partial sums meet in a fixed xor butterfly;
//   score      L2: 2 dot - |x|^2; IP: dot;
//              cosine: dot * 1/sqrt(max(|x|^2, 1e-30)) * 1/sqrt(max(|q|^2,
//              1e-30)), |q|^2 summed over d in order from the raw query;
//   candidates with row -1 score -inf;
//   a bitonic sort in shared memory by (score descending, key ascending),
//   where the key is the candidate's position (tie_rows = 0, the PQ
//   re-rank) or its row (tie_rows = 1, rescore_topk); the first k are
//   written, -inf slots with row -1.
//
// What bounds it: at R = 400, D = 128 f32 a query reads 200 KB of
// scattered rows, so the gather from HBM/L2 sets the pace; each warp reads
// one whole row per 16-byte load instruction (D = 128 f32).
//
// Any R: above 4096 candidates (the sort's 32 KB of shared memory) each
// block takes one chunk of 4096 of a query's candidates, sorts it the same
// way and writes its best min(k, 4096) (score, key) pairs to a [Q, chunks,
// L] scratch; the merge tree of select.cuh folds the chunks into the top k
// (keys are positions in the whole candidate row, so ties by position hold
// across chunks). D is bounded only by the query's place in shared memory
// beside the sort; the wrapper checks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGatherBlocks = 4096;
constexpr int kChunk = 4096;  // candidates sorted in one block

enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };  // DistanceMetric values
enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };

template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const V* __restrict__ db, int64_t n, int64_t row_words,
                  const int64_t* __restrict__ idx, int64_t r,
                  V* __restrict__ out) {
  const int64_t total = r * row_words;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += step) {
    const int64_t rr = e / row_words;
    int64_t src = idx[rr];
    src = src < 0 ? 0 : (src >= n ? n - 1 : src);
    out[e] = db[src * row_words + (e - rr * row_words)];
  }
}

template <typename V>
cudaError_t launch_gather(const void* db, int64_t n, int64_t row_bytes,
                          const int64_t* idx, int64_t r, void* out,
                          cudaStream_t stream) {
  const int64_t words = row_bytes / static_cast<int64_t>(sizeof(V));
  const int64_t total = r * words;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < kGatherBlocks ? want : kGatherBlocks);
  gather_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(db), n, words, idx, r, static_cast<V*>(out));
  return cudaGetLastError();
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Block (query, chunk) scores candidates [chunk*chunk_len, +chunk_len) of
// the query's row and sorts them in shared memory. With `final` (one
// chunk) it writes the query's top k as the result; otherwise the chunk's
// best k (score, key) pairs go to out_* as [nq, chunks, k] for the merge.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rescore_kernel(const float* __restrict__ q, const T* __restrict__ db,
                   const float* __restrict__ norms,
                   const int* __restrict__ cand, int64_t n, int d, int r,
                   int chunk_len, int p, int k, int metric, int tie_rows,
                   int vec, int final_out, float* __restrict__ out_s,
                   int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                               // [d] the query
  float* ss = qs + ((d + 3) / 4) * 4;             // [p] scores
  int* ks = reinterpret_cast<int*>(ss + p);       // [p] tie keys
  __shared__ float qin_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t gq = blockIdx.x;
  const int* cq = cand + gq * r;
  const int c0 = blockIdx.y * chunk_len;
  const int len = r - c0 < chunk_len ? r - c0 : chunk_len;

  for (int e = tid; e < d; e += kThreads) qs[e] = q[gq * d + e];
  __syncthreads();
  if (tid == 0) {
    float qq = 0.f;
    if (metric == kCosine) {
      for (int e = 0; e < d; ++e) qq = fmaf(qs[e], qs[e], qq);
    }
    qin_s = 1.0f / sqrtf(fmaxf(qq, 1e-30f));
  }
  __syncthreads();
  const float qin = qin_s;

  for (int c = warp; c < p; c += kWarps) {
    if (c >= len) {  // padding up to the sort's power of two
      if (lane == 0) {
        ss[c] = -CUDART_INF_F;
        ks[c] = kSentinel;
      }
      continue;
    }
    const int row = cq[c0 + c];
    const bool valid = row >= 0;
    const int64_t safe = row < 0 ? 0 : (row >= n ? n - 1 : row);
    const T* x = db + safe * d;
    float acc = 0.f;
    if (vec) {  // d % 4 == 0 and an aligned corpus
      for (int d0 = 4 * lane; d0 < d; d0 += 128) {
        const float4 v = load4(x + d0);
        acc = fmaf(qs[d0], v.x, acc);
        acc = fmaf(qs[d0 + 1], v.y, acc);
        acc = fmaf(qs[d0 + 2], v.z, acc);
        acc = fmaf(qs[d0 + 3], v.w, acc);
      }
    } else {
      for (int d0 = 4 * lane; d0 < d; d0 += 128) {
        for (int t = 0; t < 4 && d0 + t < d; ++t) {
          acc = fmaf(qs[d0 + t], to_f32(x[d0 + t]), acc);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
    if (lane == 0) {
      const float nrm = norms[safe];
      float s = acc;
      if (metric == kL2) {
        s = 2.0f * acc - nrm;
      } else if (metric == kCosine) {
        s = acc * (1.0f / sqrtf(fmaxf(nrm, 1e-30f))) * qin;
      }
      ss[c] = valid ? s : -CUDART_INF_F;
      ks[c] = tie_rows ? (valid ? row : kSentinel) : c0 + c;
    }
  }
  __syncthreads();

  // Bitonic sort, best first.
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < p; i += kThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const float si = ss[i], sj = ss[j];
          const int ki = ks[i], kj = ks[j];
          const bool up = (i & size) == 0;
          if (up ? better(sj, kj, si, ki) : better(si, ki, sj, kj)) {
            ss[i] = sj;
            ks[i] = kj;
            ss[j] = si;
            ks[j] = ki;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int j = tid; j < k; j += kThreads) {
    const float s = ss[j];
    const int key = ks[j];
    if (final_out) {
      out_s[gq * k + j] = s;
      out_i[gq * k + j] = s > -CUDART_INF_F ? (tie_rows ? key : cq[key]) : -1;
    } else {
      const int64_t o = (gq * gridDim.y + blockIdx.y) * k + j;
      out_s[o] = s;
      out_i[o] = key;
    }
  }
}

template <typename T>
cudaError_t launch_rescore(const float* q, const void* db, const float* norms,
                           const int* cand, int64_t nq, int64_t n, int d,
                           int r, int k, int metric, int tie_rows,
                           float* part_s, int* part_i, float* tmp_s,
                           int* tmp_i, float* out_s, int* out_i,
                           cudaStream_t stream) {
  const int chunk_len = r < kChunk ? r : kChunk;
  const int chunks = (r + chunk_len - 1) / chunk_len;
  int p = 1;
  while (p < chunk_len) p <<= 1;
  const size_t smem = (static_cast<size_t>((d + 3) / 4) * 4 + 2 * p) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      rescore_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int vec = d % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(db) % (4 * sizeof(T)) == 0;
  const dim3 grid(static_cast<unsigned>(nq), static_cast<unsigned>(chunks));
  if (chunks == 1) {
    rescore_kernel<T><<<grid, kThreads, smem, stream>>>(
        q, static_cast<const T*>(db), norms, cand, n, d, r, chunk_len, p, k,
        metric, tie_rows, vec, 1, out_s, out_i);
    return cudaGetLastError();
  }
  const int len = k < chunk_len ? k : chunk_len;
  rescore_kernel<T><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(db), norms, cand, n, d, r, chunk_len, p, len,
      metric, tie_rows, vec, 0, part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge_tree(part_s, part_i, tmp_s, tmp_i, nq, chunks, len, k,
                    tie_rows ? nullptr : cand, r, out_s, out_i, stream);
}

}  // namespace

extern "C" {

// out[i] = db[clamp(idx[i], 0, n-1)] for rows of row_bytes bytes; returns
// the cudaError_t of the launch.
int mvt_gather_rows(const void* db, int64_t n, int64_t row_bytes,
                    const int64_t* idx, int64_t r, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(db) |
                      reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && a % 16 == 0) {
    return launch_gather<uint4>(db, n, row_bytes, idx, r, out, st);
  }
  if (row_bytes % 4 == 0 && a % 4 == 0) {
    return launch_gather<uint32_t>(db, n, row_bytes, idx, r, out, st);
  }
  return launch_gather<uint8_t>(db, n, row_bytes, idx, r, out, st);
}

// Exact rescore of cand [nq, r] (int32 rows, -1 = none) against db [n, d]
// (f32 / f16 / bf16 by db_dtype) and the top k into out_* [nq, k]. Above
// 4096 candidates part_* hold [nq, chunks, min(k, 4096)] and part_* and
// tmp_* are as large as the merge tree needs (ops/select.py); below they
// are unused.
int mvt_rescore(const float* q, const void* db, int db_dtype,
                const float* norms, const int* cand, int64_t nq, int64_t n,
                int d, int r, int k, int metric, int tie_rows, float* part_s,
                int* part_i, float* tmp_s, int* tmp_i, float* out_s,
                int* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (db_dtype) {
    case kF32:
      return launch_rescore<float>(q, db, norms, cand, nq, n, d, r, k, metric,
                                   tie_rows, part_s, part_i, tmp_s, tmp_i,
                                   out_s, out_i, st);
    case kF16:
      return launch_rescore<__half>(q, db, norms, cand, nq, n, d, r, k,
                                    metric, tie_rows, part_s, part_i, tmp_s,
                                    tmp_i, out_s, out_i, st);
    case kBF16:
      return launch_rescore<__nv_bfloat16>(q, db, norms, cand, nq, n, d, r, k,
                                           metric, tie_rows, part_s, part_i,
                                           tmp_s, tmp_i, out_s, out_i, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
