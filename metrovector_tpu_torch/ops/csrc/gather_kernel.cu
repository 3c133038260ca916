// Row gather and fused gather + exact rescore + top-k, for Hopper (sm_90a).
//
// Replaces the Pallas kernel metrovector_tpu/ops/gather_kernel.py::
// gather_rows and the re-rank it feeds (ops/distances.py::rescore_topk,
// index/pq.py::_rerank_impl).
//
// What bounds both: the scattered rows. A re-rank of R = 400 candidates at
// D = 128 f32 reads 200 KB of rows a query from HBM, 6.5 MB at batch 32:
// two microseconds at 3.35 TB/s, but only if some 3 MB are in flight at
// once. A design that walks a query's rows one after another is bound by
// the latency of each row's dependent loads instead (index, then row, then
// norm). So both kernels give every row its own group of 8 lanes and keep
// several rows' loads outstanding per group, and the grid is sized to the
// work: rows for the gather, (query, split) blocks for the rescore.
//
// gather_kernel: out[r] = db[clamp(idx[r], 0, N-1)], a byte copy (so
// bit-exact for every dtype). A group of 8 lanes takes one row: it loads
// the row's index once (int32 or int64, a template, so either is one
// launch), clamps it, and copies the row in 16-, 4- or 1-byte words as the
// row width and alignment allow, each lane with 4 words in flight; no
// division per word. The TPU kernel fetched 8-row strips because Mosaic
// cannot DMA one row; Hopper loads any row, so there is no N % 8 rule.
//
// rescore_kernel: block (query, split) rescores the split's candidates, a
// contiguous run of split_len of the query's R (the split plan is
// ops/gather_kernel.py::rescore_plan: enough splits that the batch fills
// the card, at most 64 a query, at most 4096 candidates a split):
//
//   staging    the split's candidate rows and the query go to shared
//              memory in one coalesced pass;
//   dot(q, x)  in f32 FFMA, no tensor cores, no TF32: lane l (0..7) of a
//              row's group accumulates d = 4l..4l+3, 4l+32..4l+35, ... in
//              ascending order, with the row's 4 x 16-byte loads (D = 128
//              f32) and a second row's issued before the first FMA; the 8
//              partial sums then meet in a fixed xor butterfly (4, 2, 1),
//              so the same inputs give the same bits in every run;
//   score      L2: 2 dot - |x|^2; IP: dot; cosine: dot * 1/sqrt(max(|x|^2,
//              1e-30)) * 1/sqrt(max(|q|^2, 1e-30)), |q|^2 summed over d in
//              order from the raw query; the norm is loaded with the row;
//              candidates with row -1 score -inf;
//   selection  by (score descending, key ascending), the key being the
//              candidate's position in the query's row (tie_rows = 0, the
//              PQ re-rank) or its row (tie_rows = 1, rescore_topk). For a
//              list of m = min(k, split_len) <= 32 each warp keeps a
//              running top 32 in registers (a 32-wide shuffle sort of each
//              chunk that has an entry above the running m-th, merged in),
//              and warp 0 takes the best of the 4 warps' lists the same
//              way; longer lists sort the split in shared memory (bitonic);
//   merge      one split: the top k is the answer. Several: each block
//              writes its sorted list to part [Q, S, m]; with merge =
//              kMergeBlock (k <= 32, at most 4096 list entries) the block
//              that finishes a query last (a counter per query, raised
//              after a fence, reset by that block) folds the S lists by the
//              warp selection and writes the answer; otherwise the merge
//              tree of select.cuh folds them (kMergeTree). The keys are
//              global positions or rows, so ties resolve exactly as in one
//              sorted pass, whatever order the blocks finish in (pairs
//              equal in score and key are the same candidate row and give
//              the same output).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "select.cuh"

namespace {

constexpr int kGroup = 8;  // lanes per row, in both kernels

constexpr int kGatherThreads = 128;
constexpr int kGatherRows = kGatherThreads / kGroup;  // rows a block, per pass
constexpr int kGatherUnroll = 4;                      // words in flight a lane
constexpr int64_t kGatherMaxBlocks = int64_t{1} << 20;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / kGroup;
constexpr int kRowsInFlight = 2;  // rows a group scores at once
constexpr int kWarpList = 32;     // lists up to this long: warp selection

enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };  // DistanceMetric values
enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };
enum Merge { kMergeNone = 0, kMergeBlock = 1, kMergeTree = 2 };

template <typename V, typename I>
__global__ void __launch_bounds__(kGatherThreads)
    gather_kernel(const V* __restrict__ db, int64_t n, int64_t words,
                  const I* __restrict__ idx, int64_t r, V* __restrict__ out) {
  const int lane = threadIdx.x % kGroup;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kGatherRows;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kGatherRows +
                     threadIdx.x / kGroup;
       row < r; row += step) {
    int64_t src = static_cast<int64_t>(idx[row]);
    src = src < 0 ? 0 : (src >= n ? n - 1 : src);
    const V* from = db + src * words;
    V* to = out + row * words;
    for (int64_t w0 = lane; w0 < words; w0 += kGroup * kGatherUnroll) {
      V v[kGatherUnroll] = {};
#pragma unroll
      for (int u = 0; u < kGatherUnroll; ++u) {
        const int64_t w = w0 + u * kGroup;
        if (w < words) v[u] = from[w];
      }
#pragma unroll
      for (int u = 0; u < kGatherUnroll; ++u) {
        const int64_t w = w0 + u * kGroup;
        if (w < words) to[w] = v[u];
      }
    }
  }
}

template <typename V, typename I>
cudaError_t launch_gather(const void* db, int64_t n, int64_t row_bytes,
                          const void* idx, int64_t r, void* out,
                          cudaStream_t stream) {
  const int64_t words = row_bytes / static_cast<int64_t>(sizeof(V));
  const int64_t want = (r + kGatherRows - 1) / kGatherRows;
  const unsigned blocks =
      static_cast<unsigned>(want < kGatherMaxBlocks ? want : kGatherMaxBlocks);
  gather_kernel<V, I><<<blocks, kGatherThreads, 0, stream>>>(
      static_cast<const V*>(db), n, words, static_cast<const I*>(idx), r,
      static_cast<V*>(out));
  return cudaGetLastError();
}

template <typename I>
cudaError_t gather_by_width(const void* db, int64_t n, int64_t row_bytes,
                            const void* idx, int64_t r, void* out,
                            cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(db) |
                      reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && a % 16 == 0) {
    return launch_gather<uint4, I>(db, n, row_bytes, idx, r, out, stream);
  }
  if (row_bytes % 4 == 0 && a % 4 == 0) {
    return launch_gather<uint32_t, I>(db, n, row_bytes, idx, r, out, stream);
  }
  return launch_gather<uint8_t, I>(db, n, row_bytes, idx, r, out, stream);
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

// A warp's 32 (s, key) pairs, one a lane, sorted best first: a bitonic
// network with partners by shuffle.
__device__ __forceinline__ void warp_sort32(float& s, int& key, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ps = __shfl_xor_sync(kFull, s, stride);
      const int pk = __shfl_xor_sync(kFull, key, stride);
      const bool keep_better = ((lane & stride) == 0) == ((lane & size) == 0);
      if (keep_better ? better(ps, pk, s, key) : better(s, key, ps, pk)) {
        s = ps;
        key = pk;
      }
    }
  }
}

// A bitonic sequence of 32 pairs, one a lane, sorted best first.
__device__ __forceinline__ void warp_merge32(float& s, int& key, int lane) {
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const float ps = __shfl_xor_sync(kFull, s, stride);
    const int pk = __shfl_xor_sync(kFull, key, stride);
    const bool keep_better = (lane & stride) == 0;
    if (keep_better ? better(ps, pk, s, key) : better(s, key, ps, pk)) {
      s = ps;
      key = pk;
    }
  }
}

// Lane i of the calling warp ends with the i-th best of the entries
// (s, key)[e] for e in chunks of 32 that start at first, first + step, ...
// below n (i < m <= 32 are exact; the rest may be stale): a running top 32
// in registers, and each chunk that has an entry above the running m-th is
// sorted and merged in (the better of lane i and the chunk's 31 - i, a
// bitonic sequence, then sorted).
__device__ __forceinline__ void warp_top32(const float* s, const int* key,
                                           int first, int step, int n, int m,
                                           float& rv, int& rk, int lane) {
  rv = -CUDART_INF_F;
  rk = kSentinel;
  for (int ch = first; ch < n; ch += step) {
    const int e = ch + lane;
    float cs = e < n ? s[e] : -CUDART_INF_F;
    int ck = e < n ? key[e] : kSentinel;
    const float ts = __shfl_sync(kFull, rv, m - 1);
    const int tk = __shfl_sync(kFull, rk, m - 1);
    if (!__any_sync(kFull, better(cs, ck, ts, tk))) continue;
    warp_sort32(cs, ck, lane);
    const float os = __shfl_sync(kFull, cs, 31 - lane);
    const int ok = __shfl_sync(kFull, ck, 31 - lane);
    if (better(os, ok, rv, rk)) {
      rv = os;
      rk = ok;
    }
    warp_merge32(rv, rk, lane);
  }
}

// The block's best m <= 32 of (s, key)[0, n) in shared memory, sorted, in
// warp 0's lanes: each warp takes every kWarps-th chunk of 32 and writes
// its best m to (ws, wk)[warp * m, +m), then warp 0 takes the best of
// those. Up to 32 entries warp 0 alone. Called by the whole block.
__device__ __forceinline__ void block_top32(const float* s, const int* key,
                                            int n, int m, float* ws, int* wk,
                                            float& rv, int& rk, int lane,
                                            int warp) {
  if (n <= 32) {
    if (warp == 0) warp_top32(s, key, 0, 32, n, m, rv, rk, lane);
    return;
  }
  warp_top32(s, key, warp * 32, kWarps * 32, n, m, rv, rk, lane);
  if (lane < m) {
    ws[warp * m + lane] = rv;
    wk[warp * m + lane] = rk;
  }
  __syncthreads();
  if (warp == 0) warp_top32(ws, wk, 0, 32, kWarps * m, m, rv, rk, lane);
}

template <typename T, bool kVec, bool kWarpSelect>
__global__ void __launch_bounds__(kThreads)
    rescore_kernel(const float* __restrict__ q, const T* __restrict__ db,
                   const float* __restrict__ norms,
                   const int* __restrict__ cand, int64_t n, int d, int r,
                   int splits, int split_len, int m, int k, int sort_len,
                   int room, int metric, int tie_rows, int merge,
                   float* __restrict__ part_s, int* __restrict__ part_i,
                   unsigned* __restrict__ arrivals, float* __restrict__ out_s,
                   int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                    // [d, padded to 4]
  int* rows = reinterpret_cast<int*>(qs + (d + 3) / 4 * 4);  // [split_len]
  float* ss = reinterpret_cast<float*>(rows + split_len);    // [sort_len]
  int* ks = reinterpret_cast<int*>(ss + sort_len);           // [sort_len]
  float* ls = reinterpret_cast<float*>(ks + sort_len);       // [room] lists
  int* li = reinterpret_cast<int*>(ls + room);               // [room]
  // Past the warps' lists (warp selection): the splits' lists to fold.
  float* fs = ls + (kWarpSelect ? kWarps * kWarpList : 0);
  int* fi = li + (kWarpSelect ? kWarps * kWarpList : 0);
  __shared__ float qin_s;
  __shared__ int last_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t gq = blockIdx.x / splits;
  const int split = static_cast<int>(blockIdx.x % splits);
  const int* cq = cand + gq * r;
  const int c0 = split * split_len;
  const int len = r - c0 < split_len ? r - c0 : split_len;

  for (int e = tid; e < d; e += kThreads) qs[e] = q[gq * d + e];
  for (int c = tid; c < len; c += kThreads) rows[c] = cq[c0 + c];
  __syncthreads();
  if (metric == kCosine && tid == 0) {  // used after the next barrier
    float qq = 0.f;
    for (int e = 0; e < d; ++e) qq = fmaf(qs[e], qs[e], qq);
    qin_s = 1.0f / sqrtf(fmaxf(qq, 1e-30f));
  }

  // Scoring: group g takes candidates base + g and base + g + 16.
  const int g = tid / kGroup;
  const int l8 = tid % kGroup;
  for (int base = 0; base < len; base += kGroups * kRowsInFlight) {
    int row[kRowsInFlight];
    const T* x[kRowsInFlight];
    float nrm[kRowsInFlight], acc[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int c = base + g + u * kGroups;
      row[u] = c < len ? rows[c] : -1;
      const int64_t safe = row[u] < 0 ? 0 : (row[u] >= n ? n - 1 : row[u]);
      x[u] = db + safe * d;
      nrm[u] = row[u] >= 0 && l8 == 0 ? norms[safe] : 0.f;
      acc[u] = 0.f;
    }
    if (kVec) {  // d % 4 == 0 and an aligned corpus
      for (int d0 = 4 * l8; d0 < d; d0 += 4 * 4 * kGroup) {
        float4 v[kRowsInFlight][4];
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int e = d0 + 4 * kGroup * j;
            v[u][j] = row[u] >= 0 && e < d ? load4(x[u] + e)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = d0 + 4 * kGroup * j;
          if (e < d) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + e);
#pragma unroll
            for (int u = 0; u < kRowsInFlight; ++u) {
              acc[u] = fmaf(qv.x, v[u][j].x, acc[u]);
              acc[u] = fmaf(qv.y, v[u][j].y, acc[u]);
              acc[u] = fmaf(qv.z, v[u][j].z, acc[u]);
              acc[u] = fmaf(qv.w, v[u][j].w, acc[u]);
            }
          }
        }
      }
    } else {
      for (int d0 = 4 * l8; d0 < d; d0 += 4 * kGroup) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (d0 + t < d) {
#pragma unroll
            for (int u = 0; u < kRowsInFlight; ++u) {
              if (row[u] >= 0) {
                acc[u] = fmaf(qs[d0 + t], to_f32(x[u][d0 + t]), acc[u]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      acc[u] += __shfl_xor_sync(kFull, acc[u], 4);
      acc[u] += __shfl_xor_sync(kFull, acc[u], 2);
      acc[u] += __shfl_xor_sync(kFull, acc[u], 1);
      const int c = base + g + u * kGroups;
      if (l8 == 0 && c < len) {
        float s = acc[u];
        if (metric == kL2) {
          s = 2.0f * acc[u] - nrm[u];
        } else if (metric == kCosine) {
          s = acc[u] * (1.0f / sqrtf(fmaxf(nrm[u], 1e-30f)));
        }
        const bool valid = row[u] >= 0;
        ss[c] = valid ? s : -CUDART_INF_F;
        ks[c] = tie_rows ? (valid ? row[u] : kSentinel) : c0 + c;
      }
    }
  }
  __syncthreads();
  if (metric == kCosine) {
    const float qin = qin_s;
    for (int c = tid; c < len; c += kThreads) ss[c] = ss[c] * qin;
    __syncthreads();
  }

  // The split's best m, sorted, to out (one split) or to its part list.
  float* dst_s = out_s + gq * k;
  int* dst_i = out_i + gq * k;
  if (merge != kMergeNone) {
    dst_s = part_s + (gq * splits + split) * m;
    dst_i = part_i + (gq * splits + split) * m;
  }
  const bool final_out = merge == kMergeNone;
  if (kWarpSelect) {
    float rv;
    int rk;
    block_top32(ss, ks, len, m, ls, li, rv, rk, lane, warp);
    if (warp == 0 && lane < m) {
      dst_s[lane] = rv;
      dst_i[lane] = final_out ? (rv > -CUDART_INF_F ? (tie_rows ? rk : cq[rk]) : -1)
                              : rk;
    }
  } else {
    for (int c = len + tid; c < sort_len; c += kThreads) {
      ss[c] = -CUDART_INF_F;
      ks[c] = kSentinel;
    }
    __syncthreads();
    for (int size = 2; size <= sort_len; size <<= 1) {  // bitonic, best first
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < sort_len; i += kThreads) {
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
    for (int j = tid; j < m; j += kThreads) {
      const float s = ss[j];
      const int key = ks[j];
      dst_s[j] = s;
      dst_i[j] = final_out ? (s > -CUDART_INF_F ? (tie_rows ? key : cq[key]) : -1)
                           : key;
    }
  }
  // The last-block fold is planned only for k <= 32 (so warp selection).
  if (!kWarpSelect || merge != kMergeBlock) return;

  // The block that finishes the query's last split folds its S lists.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(arrivals + gq, 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const int total = splits * m;
  const float* src_s = part_s + gq * total;
  const int* src_i = part_i + gq * total;
  for (int e = tid; e < total; e += kThreads) {
    fs[e] = __ldcg(src_s + e);
    fi[e] = __ldcg(src_i + e);
  }
  __syncthreads();
  float rv;
  int rk;
  block_top32(fs, fi, total, k, ls, li, rv, rk, lane, warp);
  if (warp == 0 && lane < k) {
    out_s[gq * k + lane] = rv;
    out_i[gq * k + lane] = rv > -CUDART_INF_F ? (tie_rows ? rk : cq[rk]) : -1;
  }
  if (tid == 0) arrivals[gq] = 0;  // ready for the next launch
}

struct RescoreArgs {
  const float* q;
  const void* db;
  const float* norms;
  const int* cand;
  int64_t nq, n;
  int d, r, k, metric, tie_rows;
  int splits, split_len, list_len, merge, sort_len, room;
  size_t smem;
  float* part_s;
  int* part_i;
  float* tmp_s;
  int* tmp_i;
  unsigned* arrivals;
  float* out_s;
  int* out_i;
};

template <typename T, bool kVec, bool kWarpSelect>
cudaError_t launch_rescore(const RescoreArgs& a, cudaStream_t stream) {
  auto kernel = rescore_kernel<T, kVec, kWarpSelect>;
  if (a.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(a.smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(a.nq * a.splits), kThreads, a.smem, stream>>>(
      a.q, static_cast<const T*>(a.db), a.norms, a.cand, a.n, a.d, a.r,
      a.splits, a.split_len, a.list_len, a.k, a.sort_len, a.room, a.metric,
      a.tie_rows, a.merge, a.part_s, a.part_i, a.arrivals, a.out_s, a.out_i);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.merge != kMergeTree) return err;
  return merge_tree(a.part_s, a.part_i, a.tmp_s, a.tmp_i, a.nq, a.splits,
                    a.list_len, a.k, a.tie_rows ? nullptr : a.cand, a.r,
                    a.out_s, a.out_i, stream);
}

template <typename T>
cudaError_t rescore_by_shape(const RescoreArgs& a, cudaStream_t stream) {
  const bool vec = a.d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.db) % (4 * sizeof(T)) == 0;
  const bool warp_select = a.list_len <= kWarpList;
  if (vec) {
    return warp_select ? launch_rescore<T, true, true>(a, stream)
                       : launch_rescore<T, true, false>(a, stream);
  }
  return warp_select ? launch_rescore<T, false, true>(a, stream)
                     : launch_rescore<T, false, false>(a, stream);
}

}  // namespace

extern "C" {

// out[i] = db[clamp(idx[i], 0, n-1)] for rows of row_bytes bytes, idx int32
// (idx_bytes = 4) or int64 (8); returns the cudaError_t of the launch.
int mvt_gather_rows(const void* db, int64_t n, int64_t row_bytes,
                    const void* idx, int idx_bytes, int64_t r, void* out,
                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4) {
    return gather_by_width<int32_t>(db, n, row_bytes, idx, r, out, st);
  }
  if (idx_bytes == 8) {
    return gather_by_width<int64_t>(db, n, row_bytes, idx, r, out, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Exact rescore of cand [nq, r] (int32 rows, -1 = none) against db [n, d]
// (f32 / f16 / bf16 by db_dtype) and the top k into out_* [nq, k], by the
// split plan of ops/gather_kernel.py::rescore_plan: `splits` blocks a query
// of split_len candidates, lists of list_len, `merge` (0 none, 1 by the
// last block, 2 by the merge tree), sort_len and room (entries of the
// sort and of the lists in shared memory), smem bytes. With splits > 1
// part_* hold [nq, splits, list_len]; tmp_* are the merge tree's room
// (merge 2); arrivals [nq] are zero before the launch and after it
// (merge 1). Unused pointers may be null.
int mvt_rescore(const float* q, const void* db, int db_dtype,
                const float* norms, const int* cand, int64_t nq, int64_t n,
                int d, int r, int k, int metric, int tie_rows, int splits,
                int split_len, int list_len, int merge, int sort_len,
                int room, int64_t smem, float* part_s, int* part_i,
                float* tmp_s, int* tmp_i, unsigned* arrivals, float* out_s,
                int* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const RescoreArgs a{q, db, norms, cand, nq, n, d, r, k, metric, tie_rows,
                      splits, split_len, list_len, merge, sort_len, room,
                      static_cast<size_t>(smem), part_s, part_i, tmp_s, tmp_i,
                      arrivals, out_s, out_i};
  switch (db_dtype) {
    case kF32:
      return rescore_by_shape<float>(a, st);
    case kF16:
      return rescore_by_shape<__half>(a, st);
    case kBF16:
      return rescore_by_shape<__nv_bfloat16>(a, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
