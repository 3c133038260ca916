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
// * Pass 2 (merge_kernel), one warp per query, merges the S sorted partial
//   lists ([Q, S, k] scratch allocated by the caller) into the final top-k.
//
// Row offsets are 64-bit (N*D passes 2^31 at 100M x 768). The corpus may
// be float, __half or __nv_bfloat16 (converted to f32 per element with the
// intrinsics); queries are f32. Limits: 1 <= k <= 256, D <= 1024,
// S <= 512, N < 2^31; the Python wrapper checks them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 32;        // queries per block
constexpr int kRT = 128;       // corpus rows per tile
constexpr int kDC = 64;        // dims per staged chunk
constexpr int kXStride = kDC + 1;  // padded: row r starts on bank r % 32
constexpr int kStageLoads = kRT * kDC / 4 / kThreads;
constexpr int kMaxK = 256;
constexpr int kPerLane = kMaxK / 32;
constexpr int kMaxSplits = 512;
constexpr int kSplitsPerLane = kMaxSplits / 32;
constexpr int kSentinel = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

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

// (s, i) ranks before (t, j): score descending, then index ascending.
__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const float* __restrict__ q, const T* __restrict__ db,
                const float* __restrict__ norms,
                const float* __restrict__ mask, int64_t nq, int64_t n,
                int64_t d, int64_t num_valid, int k, int metric,
                int64_t rows_per_split, int splits, int vec4,
                float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [d][kQT], transposed
  float* xs = qs + kQT * d;          // [kRT][kXStride] staged corpus chunk
  float* sws = xs + kRT * kXStride;  // [kWarps][kRT] one query's scores
  float* cs = sws + kWarps * kRT;    // [kQT][k] candidate scores
  int* ci = reinterpret_cast<int*>(cs + kQT * k);  // [kQT][k] indices

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kQT;
  const int split = blockIdx.y;
  const int64_t row_begin = split * rows_per_split;
  const int64_t row_end = min64(n, row_begin + rows_per_split);

  const int64_t q_elems = static_cast<int64_t>(kQT) * d;
  for (int64_t e = tid; e < q_elems; e += kThreads) {
    const int64_t g = q0 * d + e;  // coalesced read of query row e / d
    qs[(e % d) * kQT + e / d] = g < nq * d ? q[g] : 0.f;
  }
  for (int e = tid; e < kQT * k; e += kThreads) {
    cs[e] = -CUDART_INF_F;
    ci[e] = kSentinel;
  }
  __syncthreads();

  // Thread (warp, lane) owns queries 4 warp + a and rows lane + 32b: the
  // four query values of one dim are one 16-byte broadcast load. The walk
  // is a flat sequence of steps (tile, 64-dim chunk).
  const int64_t ntiles = row_end > row_begin ? (row_end - row_begin + kRT - 1) / kRT : 0;
  const int nchunks = static_cast<int>((d + kDC - 1) / kDC);
  const int64_t steps = ntiles * nchunks;
  float4 stage[kStageLoads];
  if (steps > 0) {
    stage_load(stage, db, row_begin, 0, row_end, d, vec4, tid);
    stage_store(stage, xs, tid);
  }
  __syncthreads();

  // Warp w owns queries 4w..4w+3 end to end: their dots, their candidate
  // lists, and each list's current k-th entry, cached in registers.
  float* sw = sws + warp * kRT;
  float ws[4];
  int wi[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    ws[a] = -CUDART_INF_F;
    wi[a] = kSentinel;
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
    const float* qcol = qs + d0 * kQT + 4 * warp;
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
#pragma unroll
      for (int a = 0; a < 4; ++a) {
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
    merge_kernel(const float* __restrict__ part_s,
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

size_t scan_smem_bytes(int64_t d, int k) {
  return (static_cast<size_t>(kQT) * d + static_cast<size_t>(kRT) * kXStride +
          static_cast<size_t>(kWarps) * kRT + static_cast<size_t>(kQT) * k) *
             sizeof(float) +
         static_cast<size_t>(kQT) * k * sizeof(int);
}

template <typename T>
cudaError_t prepare(int64_t d, int k, size_t* smem) {
  *smem = scan_smem_bytes(d, k);
  return cudaFuncSetAttribute(scan_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename T>
cudaError_t occupancy(int64_t d, int k, int* blocks_per_sm) {
  size_t smem = 0;
  const cudaError_t err = prepare<T>(d, k, &smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, scan_kernel<T>, kThreads, smem);
}

template <typename T>
cudaError_t launch(const float* q, const void* db, const float* norms,
                   const float* mask, int64_t nq, int64_t n, int64_t d,
                   int64_t num_valid, int k, int metric, int splits,
                   int64_t rows_per_split, float* part_s, int* part_i,
                   float* out_s, int* out_i, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = prepare<T>(d, k, &smem);
  if (err != cudaSuccess) return err;
  const uintptr_t align = 4 * sizeof(T);
  const int vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(db) % align == 0;
  const dim3 grid(static_cast<unsigned>((nq + kQT - 1) / kQT),
                  static_cast<unsigned>(splits));
  scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(db), norms, mask, nq, n, d, num_valid, k,
      metric, rows_per_split, splits, vec4, part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned merge_blocks = static_cast<unsigned>((nq + kWarps - 1) / kWarps);
  merge_kernel<<<merge_blocks, kThreads, 0, stream>>>(part_s, part_i, nq, k,
                                                       splits, out_s, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch both passes on `stream`. Returns the cudaError_t of the launches
// (0 on success). `mask` may be null. The caller allocates part_* as
// [nq, splits, k] and out_* as [nq, k].
int mvt_fused_topk(const float* q, const void* db, int db_dtype,
                   const float* norms, const float* mask, int64_t nq,
                   int64_t n, int64_t d, int64_t num_valid, int k, int metric,
                   int splits, int64_t rows_per_split, float* part_s,
                   int* part_i, float* out_s, int* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (db_dtype) {
    case kF32:
      return launch<float>(q, db, norms, mask, nq, n, d, num_valid, k, metric,
                           splits, rows_per_split, part_s, part_i, out_s,
                           out_i, s);
    case kF16:
      return launch<__half>(q, db, norms, mask, nq, n, d, num_valid, k,
                            metric, splits, rows_per_split, part_s, part_i,
                            out_s, out_i, s);
    case kBF16:
      return launch<__nv_bfloat16>(q, db, norms, mask, nq, n, d, num_valid, k,
                                   metric, splits, rows_per_split, part_s,
                                   part_i, out_s, out_i, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Scan blocks that fit on one SM at once for this corpus dtype, D and k,
// written to *blocks_per_sm; returns the cudaError_t.
int mvt_fused_topk_occupancy(int db_dtype, int64_t d, int k,
                             int* blocks_per_sm) {
  switch (db_dtype) {
    case kF32:
      return occupancy<float>(d, k, blocks_per_sm);
    case kF16:
      return occupancy<__half>(d, k, blocks_per_sm);
    case kBF16:
      return occupancy<__nv_bfloat16>(d, k, blocks_per_sm);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* mvt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
