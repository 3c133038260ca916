// Exact sparse (ELL + overflow) scan with a fused top-k, for Hopper (sm_90a).
//
// Replaces the Pallas kernel benchmarks/sparse_vmem_proto.py::
// vmem_tiled_dots (body `_kernel`) and the scoring it stood in for,
// metrovector_tpu/sparse.py::_sparse_topk_ell (`_ell_dots`, `_ovf_add`,
// `_ell_scores`, the masks and lax.top_k). The corpus is in ELL layout:
// cols/vals [n, R] (pad entries: column 0, value 0), plus a per-row CSR
// tail for the entries of rows wider than R (ovf_ptr [n+1], ovf_cols,
// ovf_vals). Queries come transposed, qt [dim, Q] f32.
//
// ell_dots_kernel (the TPU kernel's contract):
//   dots[n, q] = sum over r = 0..R-1, in that order, in f32, of
//                qt[cols[n, r], q] * vals[n, r]
// with the product and the sum each rounded on their own (no FMA), as the
// plain PyTorch version rounds them: the two agree bit for bit.
//
// ell_topk_kernel: the same sum, then the row's overflow entries in order;
//   score = IP: s;  L2: 2 s - |x|^2;  cosine: s * 1/sqrt(max(|x|^2, 1e-30))
//   (queries pre-normalized); rows >= num_rows and rows with mask == 0
//   score exactly -inf; per query the k best (score descending, row
//   ascending), best first; slots that stay -inf carry row -1. The
//   [Q, n] score matrix never reaches device memory.
//
// What bounds it on an H100: every ELL entry needs the Q query values of
// its column. At the SPLADE-scale point (1M rows x 48 entries, Q = 256)
// that is 12.3 G multiply-adds (0.37 ms at the f32 rate), 387 MB of ELL
// arrays (0.12 ms of HBM), and 49 GB of query reads. qt is 31 MB at a
// 30,522-term vocabulary and fits in the 50 MB L2, so those reads are L2
// hits, and L2 bandwidth sets the pace. The design keeps the reads
// contiguous: the lanes of a warp lie across 32 queries, so one entry
// costs one 128-byte line of qt per 32 queries; the entry's column and
// value reach the warp by shuffles from one coalesced load per 32 entries.
// Staging a vocabulary tile of qt in shared memory instead would re-walk
// the ELL arrays once per tile (227 KB holds under 2,000 terms of 32
// queries), so it is not done.
//
// ell_topk: grid (ceil(Q / QT), S), QT = 32 QG queries per block (QG in
// {1, 2, 4, 8}: one warp covers QG groups of 32 queries, so a block of 256
// queries reads each ELL entry once). A block walks its split's rows in
// tiles of 256/QG rows, each warp scoring 32/QG rows one after another, and
// writes the tile's scores to shared memory; then one warp per query offers
// them to the query's sorted list through a 64-entry buffer (select.cuh, as
// the ADC scan does). Lists (L = min(k, rows per split) entries) and
// buffers live in device scratch, [Q, S, L] and [Q, S, 64], and stay in
// L2: shared memory holds only the 33 KB score tile, so the occupancy that
// hides the L2 latency of the query reads is set by registers, not by
// shared memory. (With lists and buffers in shared memory a block of 256
// queries fit once per SM; the best such variant, 64 queries a block,
// took 13.7 ms at batch 256, k = 10, on an H100 SXM at 700 W, against
// 11.7 ms now: PERF.md.) The S lists merge in select.cuh's merge_kernel
// (L = k <= 1024) or its merge tree.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDotsGroups = 8;  // ell_dots: 8 x 32 queries per pass
constexpr int kTileScores = 256;  // rows x queries/32 in one score tile

enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };  // DistanceMetric values

// acc + x * v with the product and the sum each rounded: never fused.
__device__ __forceinline__ float mul_add(float acc, float x, float v) {
  return __fadd_rn(acc, __fmul_rn(x, v));
}

// One warp per row (grid-stride), lanes across queries, 8 x 32 queries per
// pass over the row's entries.
__global__ void __launch_bounds__(kThreads)
    ell_dots_kernel(const float* __restrict__ qt, const int* __restrict__ cols,
                    const float* __restrict__ vals, int64_t n, int r,
                    int64_t nq, float* __restrict__ dots) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < n; row += warps) {
    const int* rc = cols + row * r;
    const float* rv = vals + row * r;
    for (int64_t g0 = 0; g0 < nq; g0 += 32 * kDotsGroups) {
      float acc[kDotsGroups];
#pragma unroll
      for (int g = 0; g < kDotsGroups; ++g) acc[g] = 0.f;
      for (int j0 = 0; j0 < r; j0 += 32) {
        const int cl = j0 + lane < r ? rc[j0 + lane] : 0;
        const float vl = j0 + lane < r ? rv[j0 + lane] : 0.f;
        const int m = r - j0 < 32 ? r - j0 : 32;
#pragma unroll 4
        for (int t = 0; t < m; ++t) {
          const int c = __shfl_sync(kFull, cl, t);
          const float v = __shfl_sync(kFull, vl, t);
          const float* qrow = qt + static_cast<int64_t>(c) * nq + g0 + lane;
#pragma unroll
          for (int g = 0; g < kDotsGroups; ++g) {
            if (g0 + 32 * g + lane < nq) acc[g] = mul_add(acc[g], qrow[32 * g], v);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kDotsGroups; ++g) {
        if (g0 + 32 * g + lane < nq) dots[row * nq + g0 + 32 * g + lane] = acc[g];
      }
    }
  }
}

// Shared memory of one ell_topk block: the score tile and the buffer fills.
__host__ __device__ constexpr size_t topk_smem_bytes(int qg) {
  return static_cast<size_t>(32 * qg) * ((kTileScores / qg + 1) * 4 + 4);
}

template <int QG>
__global__ void __launch_bounds__(kThreads)
    ell_topk_kernel(const float* __restrict__ qt, const int* __restrict__ cols,
                    const float* __restrict__ vals,
                    const int64_t* __restrict__ ovf_ptr,
                    const int* __restrict__ ovf_cols,
                    const float* __restrict__ ovf_vals,
                    const float* __restrict__ norms,
                    const float* __restrict__ mask, int64_t nq, int64_t n,
                    int r, int64_t num_rows, int k, int metric,
                    int64_t rows_per_split, float* __restrict__ part_s,
                    int* __restrict__ part_i, float* __restrict__ buf_s,
                    int* __restrict__ buf_i) {
  // k is the length of each split's list ([nq, splits, k] in part_*); the
  // buffers are [nq, splits, kBuf] in buf_*.
  constexpr int QT = 32 * QG;
  constexpr int kRows = kTileScores / QG;  // rows per tile
  constexpr int kStride = kRows + 1;       // score tile row: distinct banks
  constexpr int kRowsPerWarp = kRows / kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sc = reinterpret_cast<float*>(smem_raw);  // [QT][kStride] scores
  int* bc = reinterpret_cast<int*>(sc + QT * kStride);  // [QT] buffer fill

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * QT;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int64_t row_begin = split * rows_per_split;
  const int64_t row_end =
      row_begin + rows_per_split < n ? row_begin + rows_per_split : n;

  // Query qq's list and buffer in this split.
  auto slot = [&](int qq) { return (q0 + qq) * splits + split; };
  for (int64_t e = tid; e < static_cast<int64_t>(QT) * k; e += kThreads) {
    const int qq = static_cast<int>(e / k);
    if (q0 + qq < nq) {
      part_s[slot(qq) * k + e % k] = -CUDART_INF_F;
      part_i[slot(qq) * k + e % k] = kSentinel;
    }
  }
  for (int e = tid; e < QT; e += kThreads) bc[e] = 0;
  __syncthreads();

  for (int64_t t0 = row_begin; t0 < row_end; t0 += kRows) {
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int t = warp * kRowsPerWarp + i;
      const int64_t row = t0 + t;  // the same in every lane
      const bool live = row < row_end && row < num_rows &&
                        (mask == nullptr || mask[row] != 0.f);
      float acc[QG];
#pragma unroll
      for (int g = 0; g < QG; ++g) acc[g] = 0.f;
      if (live) {
        const int* rc = cols + row * r;
        const float* rv = vals + row * r;
        for (int j0 = 0; j0 < r; j0 += 32) {
          const int cl = j0 + lane < r ? rc[j0 + lane] : 0;
          const float vl = j0 + lane < r ? rv[j0 + lane] : 0.f;
          const int m = r - j0 < 32 ? r - j0 : 32;
#pragma unroll 4
          for (int j = 0; j < m; ++j) {
            const int c = __shfl_sync(kFull, cl, j);
            const float v = __shfl_sync(kFull, vl, j);
            const float* qrow = qt + static_cast<int64_t>(c) * nq + q0 + lane;
#pragma unroll
            for (int g = 0; g < QG; ++g) {
              if (q0 + 32 * g + lane < nq) acc[g] = mul_add(acc[g], qrow[32 * g], v);
            }
          }
        }
        if (ovf_ptr != nullptr) {  // the row's entries past R, in order
          for (int64_t e = ovf_ptr[row]; e < ovf_ptr[row + 1]; ++e) {
            const float v = ovf_vals[e];
            const float* qrow = qt + static_cast<int64_t>(ovf_cols[e]) * nq + q0 + lane;
#pragma unroll
            for (int g = 0; g < QG; ++g) {
              if (q0 + 32 * g + lane < nq) acc[g] = mul_add(acc[g], qrow[32 * g], v);
            }
          }
        }
        const float nrm = norms[row];
        const float inv = 1.0f / sqrtf(fmaxf(nrm, 1e-30f));
#pragma unroll
        for (int g = 0; g < QG; ++g) {
          if (metric == kL2) {
            acc[g] = 2.0f * acc[g] - nrm;
          } else if (metric == kCosine) {
            acc[g] = acc[g] * inv;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < QG; ++g) {
        sc[(32 * g + lane) * kStride + t] = live ? acc[g] : -CUDART_INF_F;
      }
    }
    __syncthreads();  // the tile's scores are complete

    for (int qq = warp; qq < QT; qq += kWarps) {
      if (q0 + qq >= nq) break;
      float* lsq = part_s + slot(qq) * k;
      int* liq = part_i + slot(qq) * k;
      int cnt = bc[qq];
      float ts = lsq[k - 1];  // the list's k-th entry, refreshed per flush
      int ti = liq[k - 1];
#pragma unroll
      for (int b = 0; b < kRows / 32; ++b) {  // most chunks: one vote
        offer(sc[qq * kStride + 32 * b + lane], static_cast<int>(t0 + 32 * b + lane),
              lsq, liq, k, buf_s + slot(qq) * kBuf, buf_i + slot(qq) * kBuf,
              cnt, ts, ti, lane);
      }
      __syncwarp();
      if (lane == 0) bc[qq] = cnt;
    }
    __syncthreads();  // the score tile is rewritten by the next tile
  }

  for (int qq = warp; qq < QT; qq += kWarps) {  // the buffers' last entries
    if (q0 + qq < nq && bc[qq] > 0) {
      flush_buffer(part_s + slot(qq) * k, part_i + slot(qq) * k, k,
                   buf_s + slot(qq) * kBuf, buf_i + slot(qq) * kBuf, bc[qq],
                   lane);
    }
  }
}

const void* pick(int qg) {
  switch (qg) {
    case 1:
      return reinterpret_cast<const void*>(ell_topk_kernel<1>);
    case 2:
      return reinterpret_cast<const void*>(ell_topk_kernel<2>);
    case 4:
      return reinterpret_cast<const void*>(ell_topk_kernel<4>);
    case 8:
      return reinterpret_cast<const void*>(ell_topk_kernel<8>);
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

// dots [n, nq] = the ELL contraction of qt [dim, nq] with cols/vals [n, r];
// returns the cudaError_t of the launch.
int mvt_ell_dots(const float* qt, const int* cols, const float* vals,
                 int64_t n, int r, int64_t nq, float* dots, void* stream) {
  const int64_t want = (n + kWarps - 1) / kWarps;
  const unsigned blocks =
      static_cast<unsigned>(want < 132 * 64 ? (want < 1 ? 1 : want) : 132 * 64);
  ell_dots_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      qt, cols, vals, n, r, nq, dots);
  return cudaGetLastError();
}

// Launch the scan and the merge on `stream`; returns the cudaError_t of the
// launches (0 on success). ovf_ptr may be null (no overflow), mask may be
// null. Each split's list has list_len entries in part_* ([nq, splits,
// list_len]) and its buffer kBuf entries in buf_* ([nq, splits, 64]). When
// list_len == k <= 1024 the lists merge in shared memory and tmp_* is
// unused; otherwise part_* and tmp_* are as large as every level of the
// merge tree needs (ops/select.py::merge_scratch). out_* are [nq, k].
int mvt_ell_topk(const float* qt, const int* cols, const float* vals,
                 const int64_t* ovf_ptr, const int* ovf_cols,
                 const float* ovf_vals, const float* norms, const float* mask,
                 int64_t nq, int64_t n, int r, int64_t num_rows, int k,
                 int metric, int qg, int splits, int64_t rows_per_split,
                 int list_len, float* part_s, int* part_i, float* buf_s,
                 int* buf_i, float* tmp_s, int* tmp_i, float* out_s,
                 int* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* fn = pick(qg);
  const size_t smem = topk_smem_bytes(qg);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&qt,       &cols,     &vals,   &ovf_ptr,  &ovf_cols,
                  &ovf_vals, &norms,    &mask,   &nq,       &n,
                  &r,        &num_rows, &list_len, &metric, &rows_per_split,
                  &part_s,   &part_i,   &buf_s,  &buf_i};
  const int qt_rows = 32 * qg;
  const dim3 grid(static_cast<unsigned>((nq + qt_rows - 1) / qt_rows),
                  static_cast<unsigned>(splits));
  err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, smem, st);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (list_len == k && k <= kMergeThreads * kMergePerThread) {
    merge_kernel<<<static_cast<unsigned>(nq), kMergeThreads,
                   merge_smem_bytes(k), st>>>(part_s, part_i, nq, k, splits,
                                              out_s, out_i);
    return cudaGetLastError();
  }
  return merge_tree(part_s, part_i, tmp_s, tmp_i, nq, splits, list_len, k,
                    nullptr, 0, out_s, out_i, st);
}

// Scan blocks of QG query groups that fit on one SM at once, written to
// *blocks_per_sm; returns the cudaError_t.
int mvt_ell_topk_occupancy(int qg, int* blocks_per_sm) {
  const void* fn = pick(qg);
  const size_t smem = topk_smem_bytes(qg);
  const cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                       kThreads, smem);
}

}  // extern "C"
