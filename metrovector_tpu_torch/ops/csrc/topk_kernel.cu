// Exact fused distance + top-k search over a device-resident corpus, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel metrovector_tpu/ops/topk_kernel.py::fused_topk
// (body `_make_kernel`). It computes what that kernel computes, without ever
// writing the [Q, N] score matrix to device memory:
//
//   score(q, x) = L2:      2 q.x - |x|^2
//                 cosine:  q.x * 1/sqrt(max(|x|^2, 1e-30))   (q pre-normalized)
//                 IP:      q.x
//   rows >= num_valid and rows with valid_mask == 0 score -inf;
//   per query, the k best (score descending, index ascending), best first;
//   slots that stay -inf carry index -1.
//
// What bounds it on an H100: at batch 256 over 1M x 128 f32 the scan is
// 2*Q*N*D ~ 67 GFLOP of f32 FFMA against 512 MB of corpus, ~130 FLOP per
// byte, so it is bound by the CUDA cores' f32 rate (67 TFLOP/s on the data
// sheet), not by HBM (3.35 TB/s). That is an estimate from the data sheet;
// on an H100 SXM at 700 W this kernel reaches about a third of that rate,
// and removing parts of it showed the FFMA loop alone at about half, with
// the top-k selection and the staging of corpus chunks taking the rest
// (PERF.md). What the design does about the bound:
//
// * Pass 1 (scan_kernel), grid (ceil(Q/32), S). A block stages its 32 query
//   rows in shared memory once, then walks its share of the corpus in tiles
//   of 128 rows x 64 dims. Each thread owns a 4 x 4 block of (query, row)
//   dots in registers (one broadcast 16-byte load of 4 query values and 4
//   loads of corpus values feed 16 FFMAs), accumulated in f32
//   over d = 0..D-1 in order, with no tensor cores and no TF32, so
//   precision "highest" stays f32-faithful. The x-dimension of the grid is
//   the query tile, so the blocks that read one stretch of the corpus run
//   together and share it through L2: the corpus comes from HBM about once.
// * Each block keeps a sorted candidate list of k entries per query in
//   shared memory. The warp that computed a query's dots owns its list and
//   keeps the list's k-th entry in registers: it tests 32 scores at once
//   with one ballot, and only rows that beat the k-th entry pay for a
//   warp-wide insertion; most tiles cost one vote per query.
// * The grid holds about one wave: S is chosen from the occupancy the
//   runtime reports, so no second, mostly empty wave of blocks trails.
// * Pass 2 (warp_merge_kernel), one warp per query, merges the S sorted
//   partial lists ([Q, S, k] scratch allocated by the caller) into the
//   final top-k.
//
// Any k and any D, in two more variants of the scan (template flags):
// * BIG_K (k > 256): the lists no longer fit in shared memory. Each query's
//   list of L = min(k, rows per split) entries lives in the [Q, S, L]
//   scratch itself, and the warp that owns the query appends rows that
//   beat its k-th entry to a 64-entry buffer in shared memory, merged into
//   the list when full (select.cuh, as the ADC scan does). The merge tree
//   of select.cuh then folds the S lists into the top k.
// * WIDE (the query tile of all D dims does not fit in half the shared
//   memory): only the 64-dim chunk of the 32 queries that the step needs is
//   staged, beside the corpus chunk. The dots still accumulate over
//   d = 0..D-1 in order.
//
// Row offsets are 64-bit (N*D passes 2^31 at 100M x 768). The corpus may
// be float, __half or __nv_bfloat16 (converted to f32 per element with the
// intrinsics); queries are f32. Limits: 1 <= k <= N < 2^31, S <= 512; the
// Python wrapper checks them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "select.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 32;        // queries per block
constexpr int kRT = 128;       // corpus rows per tile
constexpr int kDC = 64;        // dims per staged chunk
constexpr int kXStride = kDC + 1;  // padded: row r starts on bank r % 32
constexpr int kStageLoads = kRT * kDC / 4 / kThreads;
constexpr int kQStageLoads = kQT * kDC / 4 / kThreads;
constexpr int kMaxK = 256;  // lists in shared memory up to this k
constexpr int kPerLane = kMaxK / 32;
constexpr int kMaxSplits = 512;
constexpr int kSplitsPerLane = kMaxSplits / 32;

enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };  // DistanceMetric values
enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive elements as f32, in one 16- or 8-byte load (the caller
// guarantees the alignment).
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

// Insert (s, idx) into the sorted list (ls, li) of length k, dropping the
// last entry. Called by a whole warp with the same arguments.
__device__ void warp_insert(float* ls, int* li, int k, float s, int idx,
                            int lane) {
  int pos = 0;
  for (int j = lane; j < k; j += 32) pos += better(ls[j], li[j], s, idx);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) pos += __shfl_xor_sync(kFull, pos, o);
  if (pos >= k) return;  // pos is the same in every lane
  float ts[kPerLane];
  int ti[kPerLane];
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    const int j = lane + 32 * u;
    if (j >= pos && j < k - 1) {
      ts[u] = ls[j];
      ti[u] = li[j];
    }
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    const int j = lane + 32 * u;
    if (j >= pos && j < k - 1) {
      ls[j + 1] = ts[u];
      li[j + 1] = ti[u];
    }
  }
  if (lane == 0) {
    ls[pos] = s;
    li[pos] = idx;
  }
  __syncwarp();
}

// One thread's share of a [kRT x kDC] corpus chunk: kStageLoads groups of
// 4 consecutive elements, loaded as f32 into registers (zeros past the
// split's rows or past D).
template <typename T>
__device__ __forceinline__ void stage_load(float4 (&v)[kStageLoads],
                                           const T* __restrict__ db,
                                           int64_t t0, int64_t d0,
                                           int64_t row_end, int64_t d,
                                           int vec4, int tid) {
#pragma unroll
  for (int j = 0; j < kStageLoads; ++j) {
    const int e = tid + j * kThreads;
    const int r = e / (kDC / 4);
    const int c = (e % (kDC / 4)) * 4;
    const int64_t row = t0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < row_end && d0 + c < d) {
      const T* p = db + row * d + d0 + c;
      if (vec4) {  // d % 4 == 0 and an aligned corpus: one load
        x = load4(p);
      } else {
        const int64_t left = d - d0 - c;
        x.x = to_f32(p[0]);
        if (left > 1) x.y = to_f32(p[1]);
        if (left > 2) x.z = to_f32(p[2]);
        if (left > 3) x.w = to_f32(p[3]);
      }
    }
    v[j] = x;
  }
}

__device__ __forceinline__ void stage_store(const float4 (&v)[kStageLoads],
                                            float* xs, int tid) {
#pragma unroll
  for (int j = 0; j < kStageLoads; ++j) {
    const int e = tid + j * kThreads;
    float* dst = xs + (e / (kDC / 4)) * kXStride + (e % (kDC / 4)) * 4;
    dst[0] = v[j].x;
    dst[1] = v[j].y;
    dst[2] = v[j].z;
    dst[3] = v[j].w;
  }
}

// One thread's share of the [kQT x kDC] query chunk at dims d0.. (zeros
// past the batch or past D), stored transposed: qs[c][query]. Lanes take
// consecutive queries, so the shared-memory stores hit distinct banks.
__device__ __forceinline__ void stage_q_load(float4 (&v)[kQStageLoads],
                                             const float* __restrict__ q,
                                             int64_t q0, int64_t nq,
                                             int64_t d0, int64_t d, int tid) {
#pragma unroll
  for (int j = 0; j < kQStageLoads; ++j) {
    const int e = tid + j * kThreads;
    const int qq = e % kQT;
    const int c = (e / kQT) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + qq < nq) {
      const float* p = q + (q0 + qq) * d + d0 + c;
      const int64_t left = d - d0 - c;
      if (left > 0) x.x = p[0];
      if (left > 1) x.y = p[1];
      if (left > 2) x.z = p[2];
      if (left > 3) x.w = p[3];
    }
    v[j] = x;
  }
}

__device__ __forceinline__ void stage_q_store(const float4 (&v)[kQStageLoads],
                                              float* qs, int tid) {
#pragma unroll
  for (int j = 0; j < kQStageLoads; ++j) {
    const int e = tid + j * kThreads;
    float* dst = qs + ((e / kQT) * 4) * kQT + e % kQT;
    dst[0] = v[j].x;
    dst[kQT] = v[j].y;
    dst[2 * kQT] = v[j].z;
    dst[3 * kQT] = v[j].w;
  }
}

template <typename T, bool WIDE, bool BIG_K>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const float* __restrict__ q, const T* __restrict__ db,
                const float* __restrict__ norms,
                const float* __restrict__ mask, int64_t nq, int64_t n,
                int64_t d, int64_t num_valid, int k, int metric,
                int64_t rows_per_split, int splits, int vec4,
                float* __restrict__ part_s, int* __restrict__ part_i) {
  // BIG_K: k is the length of each split's list, which lives in part_*.
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;  // [d][kQT] transposed (WIDE: [kDC][kQT], one chunk)
  float* xs = qs + kQT * (WIDE ? kDC : d);  // [kRT][kXStride] corpus chunk
  float* sws = xs + kRT * kXStride;  // [kWarps][kRT] one query's scores
  float* cs = sws + kWarps * kRT;    // [kQT][k] candidate scores (BIG_K:
                                     // [kQT][kBuf] buffers)
  int* ci = reinterpret_cast<int*>(cs + kQT * (BIG_K ? kBuf : k));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kQT;
  const int split = blockIdx.y;
  const int64_t row_begin = split * rows_per_split;
  const int64_t row_end = min64(n, row_begin + rows_per_split);

  if (!WIDE) {
    const int64_t q_elems = static_cast<int64_t>(kQT) * d;
    for (int64_t e = tid; e < q_elems; e += kThreads) {
      const int64_t g = q0 * d + e;  // coalesced read of query row e / d
      qs[(e % d) * kQT + e / d] = g < nq * d ? q[g] : 0.f;
    }
  }
  if (BIG_K) {  // each warp clears the lists of the 4 queries it owns
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int64_t gq = q0 + 4 * warp + a;
      if (gq < nq) {
        float* ls = part_s + (gq * splits + split) * k;
        int* li = part_i + (gq * splits + split) * k;
        for (int j = lane; j < k; j += 32) {
          ls[j] = -CUDART_INF_F;
          li[j] = kSentinel;
        }
      }
    }
    __syncwarp();
  } else {
    for (int e = tid; e < kQT * k; e += kThreads) {
      cs[e] = -CUDART_INF_F;
      ci[e] = kSentinel;
    }
  }
  __syncthreads();

  // Thread (warp, lane) owns queries 4 warp + a and rows lane + 32b: the
  // four query values of one dim are one 16-byte broadcast load. The walk
  // is a flat sequence of steps (tile, 64-dim chunk).
  const int64_t ntiles = row_end > row_begin ? (row_end - row_begin + kRT - 1) / kRT : 0;
  const int nchunks = static_cast<int>((d + kDC - 1) / kDC);
  const int64_t steps = ntiles * nchunks;
  float4 stage[kStageLoads];
  float4 qstage[kQStageLoads];
  if (steps > 0) {
    stage_load(stage, db, row_begin, 0, row_end, d, vec4, tid);
    stage_store(stage, xs, tid);
    if (WIDE) {
      stage_q_load(qstage, q, q0, nq, 0, d, tid);
      stage_q_store(qstage, qs, tid);
    }
  }
  __syncthreads();

  // Warp w owns queries 4w..4w+3 end to end: their dots, their candidate
  // lists, and each list's current k-th entry, cached in registers.
  float* sw = sws + warp * kRT;
  float ws[4];
  int wi[4];
  int cnt[4];  // BIG_K: each query's buffer fill
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    ws[a] = -CUDART_INF_F;
    wi[a] = kSentinel;
    cnt[a] = 0;
  }
  float acc[4][4];
  for (int64_t st = 0; st < steps; ++st) {
    const int chunk = static_cast<int>(st % nchunks);
    const int64_t t0 = row_begin + (st / nchunks) * kRT;
    const int64_t d0 = static_cast<int64_t>(chunk) * kDC;
    const int dc = static_cast<int>(min64(kDC, d - d0));
    if (chunk == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    }
    const float* qcol = qs + (WIDE ? 0 : d0 * kQT) + 4 * warp;
#pragma unroll 8
    for (int c = 0; c < dc; ++c) {
      const float4 q4 = *reinterpret_cast<const float4*>(qcol + c * kQT);
      const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
      float xv[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) xv[b] = xs[(lane + 32 * b) * kXStride + c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(qv[a], xv[b], acc[a][b]);
    }
    __syncthreads();  // every warp is done with xs
    if (st + 1 < steps) {  // stage the next chunk
      const int next = chunk + 1 == nchunks ? 0 : chunk + 1;
      stage_load(stage, db, next == 0 ? t0 + kRT : t0,
                 static_cast<int64_t>(next) * kDC, row_end, d, vec4, tid);
      stage_store(stage, xs, tid);
      if (WIDE) {
        stage_q_load(qstage, q, q0, nq, static_cast<int64_t>(next) * kDC, d,
                     tid);
        stage_q_store(qstage, qs, tid);
      }
    }
    if (chunk + 1 == nchunks) {
      // Epilogue and masks, then each query's 4 x 32 scores go against its
      // k-th entry; only rows that beat it reach the warp-wide insertion.
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int64_t row = t0 + lane + 32 * b;
        const bool live = row < row_end && row < num_valid &&
                          (mask == nullptr || mask[row] != 0.f);
        const float nrm = live ? norms[row] : 0.f;
        const float inv = 1.0f / sqrtf(fmaxf(nrm, 1e-30f));
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float dot = acc[a][b];
          float s = dot;
          if (metric == kL2) {
            s = 2.0f * dot - nrm;
          } else if (metric == kCosine) {
            s = dot * inv;
          }
          acc[a][b] = live ? s : -CUDART_INF_F;
        }
      }
      if (BIG_K) {  // through the buffers into the lists in part_*
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int qq = 4 * warp + a;
          const int64_t gq = q0 + qq;
          if (gq >= nq) continue;  // the same in every lane
          float* ls = part_s + (gq * splits + split) * k;
          int* li = part_i + (gq * splits + split) * k;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            offer(acc[a][b], static_cast<int>(t0 + lane + 32 * b), ls, li, k,
                  cs + qq * kBuf, ci + qq * kBuf, cnt[a], ws[a], wi[a], lane);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4 && !BIG_K; ++a) {
        const int qq = 4 * warp + a;
        bool beats = false;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int idx = static_cast<int>(t0 + lane + 32 * b);
          beats |= acc[a][b] > -CUDART_INF_F &&
                   better(acc[a][b], idx, ws[a], wi[a]);
        }
        // Most tiles hold no row that beats the k-th entry: one vote.
        if (q0 + qq >= nq || !__any_sync(kFull, beats)) continue;
#pragma unroll
        for (int b = 0; b < 4; ++b) sw[32 * b + lane] = acc[a][b];
        __syncwarp();
        float* ls = cs + qq * k;
        int* li = ci + qq * k;
        for (int b = 0; b < 4; ++b) {
          const float s = sw[32 * b + lane];
          const int idx = static_cast<int>(t0 + lane + 32 * b);
          unsigned m = __ballot_sync(
              kFull, s > -CUDART_INF_F && better(s, idx, ls[k - 1], li[k - 1]));
          while (m) {
            const int src = __ffs(m) - 1;
            m &= m - 1;
            warp_insert(ls, li, k, __shfl_sync(kFull, s, src),
                        __shfl_sync(kFull, idx, src), lane);
          }
        }
        ws[a] = ls[k - 1];
        wi[a] = li[k - 1];
        __syncwarp();  // sw is rewritten by the next query
      }
    }
    __syncthreads();  // the next chunk is staged
  }

  if (BIG_K) {  // the buffers' last entries
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qq = 4 * warp + a;
      const int64_t gq = q0 + qq;
      if (gq < nq && cnt[a] > 0) {
        flush_buffer(part_s + (gq * splits + split) * k,
                     part_i + (gq * splits + split) * k, k, cs + qq * kBuf,
                     ci + qq * kBuf, cnt[a], lane);
      }
    }
    return;
  }
  for (int e = tid; e < kQT * k; e += kThreads) {
    const int qq = e / k;
    const int j = e % k;
    const int64_t gq = q0 + qq;
    if (gq < nq) {
      const int64_t o = (gq * splits + split) * k + j;
      part_s[o] = cs[e];
      part_i[o] = ci[e];
    }
  }
}

// One warp per query: merge S sorted lists of k into the final top-k.
__global__ void __launch_bounds__(kThreads)
    warp_merge_kernel(const float* __restrict__ part_s,
                      const int* __restrict__ part_i, int64_t nq, int k,
                      int splits, float* __restrict__ out_s,
                      int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int64_t gq = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
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

size_t scan_smem_bytes(int64_t d, int k, int wide, int big_k) {
  const size_t lists = static_cast<size_t>(kQT) * (big_k ? kBuf : k);
  return (static_cast<size_t>(kQT) * (wide ? kDC : d) +
          static_cast<size_t>(kRT) * kXStride +
          static_cast<size_t>(kWarps) * kRT + lists) *
             sizeof(float) +
         lists * sizeof(int);
}

template <typename T>
const void* pick_t(int wide, int big_k) {
  if (wide) {
    return big_k ? reinterpret_cast<const void*>(scan_kernel<T, true, true>)
                 : reinterpret_cast<const void*>(scan_kernel<T, true, false>);
  }
  return big_k ? reinterpret_cast<const void*>(scan_kernel<T, false, true>)
               : reinterpret_cast<const void*>(scan_kernel<T, false, false>);
}

const void* pick(int db_dtype, int wide, int big_k) {
  switch (db_dtype) {
    case kF32:
      return pick_t<float>(wide, big_k);
    case kF16:
      return pick_t<__half>(wide, big_k);
    case kBF16:
      return pick_t<__nv_bfloat16>(wide, big_k);
    default:
      return nullptr;
  }
}

cudaError_t prepare(const void* fn, size_t smem) {
  if (fn == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// Launch the scan and the merge on `stream`. Returns the cudaError_t of the
// launches (0 on success). `mask` may be null. For k <= 256 the caller
// allocates part_* as [nq, splits, k] (list_len = k, tmp_* unused); above,
// part_* as [nq, splits, list_len] and both part_* and tmp_* as large as
// every level of the merge tree needs (ops/select.py::merge_scratch).
// out_* are [nq, k]. `wide` stages queries chunk by chunk.
int mvt_fused_topk(const float* q, const void* db, int db_dtype,
                   const float* norms, const float* mask, int64_t nq,
                   int64_t n, int64_t d, int64_t num_valid, int k, int metric,
                   int splits, int64_t rows_per_split, int list_len, int wide,
                   float* part_s, int* part_i, float* tmp_s, int* tmp_i,
                   float* out_s, int* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int big_k = k > kMaxK;
  const void* fn = pick(db_dtype, wide, big_k);
  int kl = big_k ? list_len : k;
  const size_t smem = scan_smem_bytes(d, kl, wide, big_k);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return err;
  const size_t esz = db_dtype == kF32 ? 4 : 2;
  int vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(db) % (4 * esz) == 0;
  void* args[] = {&q,     &db,    &norms,         &mask,   &nq,
                  &n,     &d,     &num_valid,     &kl,     &metric,
                  &rows_per_split, &splits, &vec4, &part_s, &part_i};
  const dim3 grid(static_cast<unsigned>((nq + kQT - 1) / kQT),
                  static_cast<unsigned>(splits));
  err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, smem, st);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (big_k) {
    return merge_tree(part_s, part_i, tmp_s, tmp_i, nq, splits, list_len, k,
                      nullptr, 0, out_s, out_i, st);
  }
  const unsigned merge_blocks = static_cast<unsigned>((nq + kWarps - 1) / kWarps);
  warp_merge_kernel<<<merge_blocks, kThreads, 0, st>>>(part_s, part_i, nq, k,
                                                        splits, out_s, out_i);
  return cudaGetLastError();
}

// Scan blocks that fit on one SM at once for this corpus dtype, D, list
// length and variant, written to *blocks_per_sm; returns the cudaError_t.
int mvt_fused_topk_occupancy(int db_dtype, int64_t d, int k, int wide,
                             int big_k, int* blocks_per_sm) {
  const void* fn = pick(db_dtype, wide, big_k);
  const size_t smem = scan_smem_bytes(d, k, wide, big_k);
  const cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                       kThreads, smem);
}

const char* mvt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
