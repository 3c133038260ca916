// PQ asymmetric-distance (ADC) scan with a fused top-k, for Hopper (sm_90a).
//
// Replaces the Pallas kernel metrovector_tpu/ops/adc_kernel.py::
// fused_adc_topk (body `_make_adc_kernel`). It computes what that kernel
// computes, for uint8 codes [N, m] or nibble-packed codes [N, ceil(m/2)]
// (even subspaces in the low nibble) and an f32 or bf16 lookup table
// LUT[q, j*ksub + c] = q_j . C[j, c] built outside the kernel:
//
//   s(q, x)     = sum over j = 0..m-1, in that order, in f32, of
//                 LUT[q, j*ksub + code_j(x)]
//   score(q, x) = L2:     2 s - |x^|^2
//                 cosine: s * 1/sqrt(max(|x^|^2, 1e-30))   (q pre-normalized)
//                 IP:     s
//   rows >= num_valid and rows with mask == 0 score exactly -inf;
//   per query the k best (score descending, row ascending), best first;
//   slots that stay -inf carry row -1.
//
// The TPU kernel multiplies one-hot code matrices by the LUT on the MXU,
// because a TPU has no fast gather. Hopper does: here the LUT of a tile of
// QT queries sits in shared memory and each row's sum is m shared-memory
// lookups. What bounds it on an H100: a row costs m bytes (or m/2) of HBM
// but m * QT lookups, so at 1M rows the scan is bound by shared-memory
// lookups, not by HBM (16 MB of codes). What the design does about it:
//
// * Grid (ceil(Q/QT), S). A block stages the LUT of its QT queries once,
//   then walks its share of the rows in tiles of 256, one row per thread.
//   The thread reads its row's codes four bytes at a time and, for each
//   subspace in ascending order, adds that code's LUT entry of all QT
//   queries into QT registers: a code is decoded once for QT queries.
// * With ksub = 16 the 32 lanes of a warp read at most 16 distinct LUT
//   words of one subspace, one per bank: no bank conflicts. With ksub = 256
//   random codes collide on banks; a bf16 LUT halves the words.
// * Rows that are masked or past num_valid skip the lookups.
// * QT is one of {1, 2, 4, 8, 16, 32}. A larger tile decodes a code for
//   more queries but needs more shared memory, so fewer blocks share an
//   SM and the lookups' latency shows; the wrapper takes the largest tile
//   that still leaves 3 blocks per SM (at most the batch), which on an
//   H100 beat the largest tile that fits by up to 2x (PERF.md).
// * Each block keeps a sorted list of k entries per query in shared memory
//   (k up to 1024, so the lists, a 64-entry buffer per query, the LUT and
//   a 256-row score tile of QT queries must fit). One
//   warp per query tests 32 scores against the list's k-th entry with one
//   ballot; rows that beat it are appended to the query's buffer, and a
//   full buffer is sorted and merged into the list at once (select.cuh).
//   Inserting each row on its own, with a warp-wide shift of the list, took
//   most of the kernel's time at k = 400 (PERF.md). Above k = 1024 the
//   lists (L = min(k, rows per split) entries) live in the [Q, S, L]
//   scratch in device memory instead; only the buffers stay in shared
//   memory.
// * Pass 2 (merge_kernel, select.cuh) merges the S partial lists, one
//   block per query (a warp per query walking the list heads in turn took
//   0.3 ms at k = 400 whatever the batch; PERF.md); above k = 1024 the
//   merge tree of select.cuh folds them.
//
// Codes must be < ksub (as PQ encoding makes them); the wrapper checks
// shapes, dtypes and limits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kThreads;  // rows per tile, one per thread

enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };  // DistanceMetric values
enum LutType { kLutF32 = 0, kLutBF16 = 1 };

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Bytes b..b+3 of a row's codes as one little-endian word; bytes past
// `cols` read as 0. `vec`: cols % 4 == 0 and the codes are 4-byte aligned.
__device__ __forceinline__ uint32_t code_word(const uint8_t* rc, int b,
                                              int cols, int vec) {
  if (vec) return *reinterpret_cast<const uint32_t*>(rc + b);
  uint32_t w = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (b + t < cols) w |= static_cast<uint32_t>(rc[b + t]) << (8 * t);
  }
  return w;
}

template <int QT, typename LT>
__device__ __forceinline__ void add_lookup(float (&acc)[QT], const LT* lq,
                                           int mk) {
#pragma unroll
  for (int qq = 0; qq < QT; ++qq) acc[qq] += as_f32(lq[qq * mk]);
}

template <int QT, bool PACKED, typename LT, bool GLOBAL>
__global__ void __launch_bounds__(kThreads)
    adc_scan_kernel(const void* lut_raw, const uint8_t* __restrict__ codes,
                    int cols, const float* __restrict__ norms,
                    const float* __restrict__ mask, int64_t nq, int64_t n,
                    int m, int ksub, int64_t num_valid, int k, int metric,
                    int64_t rows_per_split, int vec,
                    float* __restrict__ part_s, int* __restrict__ part_i) {
  // GLOBAL: k is the length of each split's list, which lives in part_*
  // ([nq, splits, k]) instead of shared memory.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int mk = m * ksub;
  const int ks = GLOBAL ? 0 : k;
  float* cs = reinterpret_cast<float*>(smem_raw);  // [QT][k] list scores
  int* ci = reinterpret_cast<int*>(cs + QT * ks);  // [QT][k] list rows
  float* bs = reinterpret_cast<float*>(ci + QT * ks);  // [QT][kBuf] buffer
  int* bi = reinterpret_cast<int*>(bs + QT * kBuf);   // [QT][kBuf]
  int* bc = bi + QT * kBuf;                           // [QT] buffer fill
  float* sc = reinterpret_cast<float*>(bc + QT);      // [QT][kRows] scores
  LT* ls = reinterpret_cast<LT*>(sc + QT * kRows);    // [QT][mk] the LUT

  const LT* lut = static_cast<const LT*>(lut_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * QT;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int64_t row_begin = split * rows_per_split;
  const int64_t row_end =
      row_begin + rows_per_split < n ? row_begin + rows_per_split : n;

  // The tile's LUT rows are contiguous in global memory; queries past the
  // batch repeat its last entry (their results are never written).
  const int64_t lut_end = nq * mk;
  for (int e = tid; e < QT * mk; e += kThreads) {
    const int64_t g = q0 * mk + e;
    ls[e] = lut[g < lut_end ? g : lut_end - 1];
  }
  // Query qq's list: in shared memory, or its split's list in part_*.
  auto list_s = [&](int qq) {
    return GLOBAL ? part_s + ((q0 + qq) * splits + split) * k : cs + qq * k;
  };
  auto list_i = [&](int qq) {
    return GLOBAL ? part_i + ((q0 + qq) * splits + split) * k : ci + qq * k;
  };
  if (GLOBAL) {
    for (int64_t e = tid; e < static_cast<int64_t>(QT) * k; e += kThreads) {
      const int qq = static_cast<int>(e / k);
      if (q0 + qq < nq) {
        list_s(qq)[e % k] = -CUDART_INF_F;
        list_i(qq)[e % k] = kSentinel;
      }
    }
  } else {
    for (int e = tid; e < QT * k; e += kThreads) {
      cs[e] = -CUDART_INF_F;
      ci[e] = kSentinel;
    }
  }
  for (int e = tid; e < QT; e += kThreads) bc[e] = 0;
  __syncthreads();

  for (int64_t t0 = row_begin; t0 < row_end; t0 += kRows) {
    const int64_t row = t0 + tid;
    const bool live = row < row_end && row < num_valid &&
                      (mask == nullptr || mask[row] != 0.f);
    float acc[QT];
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) acc[qq] = 0.f;
    if (live) {
      const uint8_t* rc = codes + row * cols;
      for (int b = 0; b < cols; b += 4) {
        const uint32_t w = code_word(rc, b, cols, vec);
        if (PACKED) {
#pragma unroll
          for (int t = 0; t < 8; ++t) {  // nibble t is subspace 2b + t
            const int j = 2 * b + t;
            if (j < m) {
              add_lookup<QT>(acc, ls + j * ksub + ((w >> (4 * t)) & 15u), mk);
            }
          }
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int j = b + t;
            if (j < m) {
              add_lookup<QT>(acc, ls + j * ksub + ((w >> (8 * t)) & 255u), mk);
            }
          }
        }
      }
    }
    const float nrm = live ? norms[row] : 0.f;
    const float inv = 1.0f / sqrtf(fmaxf(nrm, 1e-30f));
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {
      float s = acc[qq];
      if (metric == kL2) {
        s = 2.0f * s - nrm;
      } else if (metric == kCosine) {
        s = s * inv;
      }
      sc[qq * kRows + tid] = live ? s : -CUDART_INF_F;
    }
    __syncthreads();

    for (int qq = warp; qq < QT; qq += kWarps) {
      if (q0 + qq >= nq) break;
      float* lsq = list_s(qq);
      int* liq = list_i(qq);
      float* bsq = bs + qq * kBuf;
      int* biq = bi + qq * kBuf;
      int cnt = bc[qq];
      float ts = lsq[k - 1];  // the list's k-th entry, refreshed per flush
      int ti = liq[k - 1];
      for (int b = 0; b < kRows / 32; ++b) {
        const float s = sc[qq * kRows + 32 * b + lane];
        const int idx = static_cast<int>(t0 + 32 * b + lane);
        bool pass = s > -CUDART_INF_F && better(s, idx, ts, ti);
        unsigned vote = __ballot_sync(kFull, pass);
        if (vote == 0) continue;  // most chunks: one vote
        if (cnt + __popc(vote) > kBuf) {
          flush_buffer(lsq, liq, k, bsq, biq, cnt, lane);
          cnt = 0;
          ts = lsq[k - 1];
          ti = liq[k - 1];
          pass = s > -CUDART_INF_F && better(s, idx, ts, ti);
          vote = __ballot_sync(kFull, pass);
        }
        if (pass) {
          const int at = cnt + __popc(vote & ((1u << lane) - 1u));
          bsq[at] = s;
          biq[at] = idx;
        }
        cnt += __popc(vote);
      }
      __syncwarp();
      if (lane == 0) bc[qq] = cnt;
    }
    __syncthreads();  // the score tile is rewritten by the next tile
  }

  for (int qq = warp; qq < QT; qq += kWarps) {  // the buffers' last entries
    if (q0 + qq < nq && bc[qq] > 0) {
      flush_buffer(list_s(qq), list_i(qq), k, bs + qq * kBuf,
                   bi + qq * kBuf, bc[qq], lane);
    }
  }
  if (GLOBAL) return;
  __syncthreads();

  for (int e = tid; e < QT * k; e += kThreads) {
    const int qq = e / k;
    const int64_t gq = q0 + qq;
    if (gq < nq) {
      const int64_t o = (gq * splits + split) * k + e % k;
      part_s[o] = cs[e];
      part_i[o] = ci[e];
    }
  }
}

template <bool PACKED, typename LT, bool GLOBAL>
const void* pick_qt(int qt) {
  switch (qt) {
    case 1:
      return reinterpret_cast<const void*>(adc_scan_kernel<1, PACKED, LT, GLOBAL>);
    case 2:
      return reinterpret_cast<const void*>(adc_scan_kernel<2, PACKED, LT, GLOBAL>);
    case 4:
      return reinterpret_cast<const void*>(adc_scan_kernel<4, PACKED, LT, GLOBAL>);
    case 8:
      return reinterpret_cast<const void*>(adc_scan_kernel<8, PACKED, LT, GLOBAL>);
    case 16:
      return reinterpret_cast<const void*>(adc_scan_kernel<16, PACKED, LT, GLOBAL>);
    case 32:
      return reinterpret_cast<const void*>(adc_scan_kernel<32, PACKED, LT, GLOBAL>);
    default:
      return nullptr;
  }
}

template <typename LT>
const void* pick_lt(int qt, int packed4, int global) {
  if (global) {
    return packed4 ? pick_qt<true, LT, true>(qt) : pick_qt<false, LT, true>(qt);
  }
  return packed4 ? pick_qt<true, LT, false>(qt) : pick_qt<false, LT, false>(qt);
}

const void* pick(int qt, int packed4, int lut_dtype, int global) {
  if (lut_dtype == kLutF32) return pick_lt<float>(qt, packed4, global);
  if (lut_dtype == kLutBF16) return pick_lt<__nv_bfloat16>(qt, packed4, global);
  return nullptr;
}

// smem_k: the length of the lists kept in shared memory, 0 when they live
// in device memory.
size_t scan_smem_bytes(int qt, int lut_dtype, int mk, int smem_k) {
  const size_t lsz = lut_dtype == kLutF32 ? 4 : 2;
  return static_cast<size_t>(qt) *
         (static_cast<size_t>(smem_k) * 8 + kBuf * 8 + 4 + kRows * 4 +
          static_cast<size_t>(mk) * lsz);
}

cudaError_t prepare(const void* fn, size_t smem) {
  if (fn == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// Launch the scan and the merge on `stream`; returns the cudaError_t of the
// launches (0 on success). `lut` is [nq, m*ksub] f32 (lut_dtype 0) or bf16
// (1); `codes` [n, cols] u8; `mask` may be null. With list_len 0 the lists
// stay in shared memory (k <= 1024): the caller allocates part_* as
// [nq, splits, k] and tmp_* is unused. Otherwise each split's list has
// list_len entries in part_*, and part_* and tmp_* are as large as every
// level of the merge tree needs (ops/select.py::merge_scratch). out_* are
// [nq, k].
int mvt_adc_topk(const void* lut, int lut_dtype, const uint8_t* codes,
                 int cols, int packed4, const float* norms, const float* mask,
                 int64_t nq, int64_t n, int m, int ksub, int64_t num_valid,
                 int k, int metric, int qt, int splits, int64_t rows_per_split,
                 int list_len, float* part_s, int* part_i, float* tmp_s,
                 int* tmp_i, float* out_s, int* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lists_global = list_len > 0;
  const void* fn = pick(qt, packed4, lut_dtype, lists_global);
  int kl = lists_global ? list_len : k;
  const size_t smem =
      scan_smem_bytes(qt, lut_dtype, m * ksub, lists_global ? 0 : k);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return err;
  int vec = cols % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0;
  void* args[] = {&lut,  &codes, &cols, &norms,     &mask, &nq,
                  &n,    &m,     &ksub, &num_valid, &kl,   &metric,
                  &rows_per_split, &vec, &part_s, &part_i};
  const dim3 grid(static_cast<unsigned>((nq + qt - 1) / qt),
                  static_cast<unsigned>(splits));
  err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, smem, st);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (lists_global) {
    return merge_tree(part_s, part_i, tmp_s, tmp_i, nq, splits, list_len, k,
                      nullptr, 0, out_s, out_i, st);
  }
  merge_kernel<<<static_cast<unsigned>(nq), kMergeThreads, merge_smem_bytes(k),
                 st>>>(part_s, part_i, nq, k, splits, out_s, out_i);
  return cudaGetLastError();
}

// Scan blocks that fit on one SM at once for this variant with lists of
// smem_k entries in shared memory (0: in device memory), written to
// *blocks_per_sm; returns the cudaError_t.
int mvt_adc_topk_occupancy(int lut_dtype, int packed4, int qt, int m,
                           int ksub, int smem_k, int* blocks_per_sm) {
  const void* fn = pick(qt, packed4, lut_dtype, smem_k == 0);
  const size_t smem = scan_smem_bytes(qt, lut_dtype, m * ksub, smem_k);
  const cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                       kThreads, smem);
}

}  // extern "C"
