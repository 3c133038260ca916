#pragma once

// PQ asymmetric-distance (ADC) scan with a fused top-k, for Hopper (sm_90a):
// the kernel template and the pieces it shares with the IVF bucket-bias
// kernel. adc_kernel.cu instantiates it and holds its C entry points;
// adc_bucket_kernel.cu, a translation unit of its own that nvcc compiles in
// parallel, holds the bucket kernel.
//
// Replaces the Pallas kernel metrovector_tpu/ops/adc_kernel.py::
// fused_adc_topk (body `_make_adc_kernel`). It computes what that kernel
// computes, for uint8 codes [N, m] or nibble-packed codes [N, ceil(m/2)]
// (even subspaces in the low nibble) and an f32, bf16 or int8 lookup table
// LUT[q, j*ksub + c] = q_j . C[j, c] built outside the kernel (int8: the
// f32 table quantized per query, LUT8 = rint(LUT / sq[q]) in [-127, 127]):
//
//   s(q, x)     = sum over j = 0..m-1, in that order, in f32, of
//                 LUT[q, j*ksub + code_j(x)]
//                 (int8: f32(the int32 sum of the LUT8 entries) * sq[q],
//                 the sum exact, the product rounded once)
//   score(q, x) = L2:     2 s - |x^|^2
//                 cosine: s * 1/sqrt(max(|x^|^2, 1e-30))   (q pre-normalized)
//                 IP:     s
//   rows >= num_valid and rows with mask == 0 score exactly -inf;
//   per query the k best (score descending, row ascending), best first;
//   slots that stay -inf carry row -1.
//
// The IVF bucket-bias variant (IVF-PQ's scan) is a kernel of its own,
// adc_bucket_kernel.cu: it walks only the probed buckets of the index's
// bucket layout and reuses this file's pieces.
//
// The TPU kernel multiplies one-hot code matrices by the LUT on the MXU,
// because a TPU has no fast gather. Hopper does: the LUT of a tile of QT
// queries sits in shared memory and a row's sum is m lookups per query.
// What bounds the scan is shared memory: an SM serves one 4-byte load of a
// warp a clock, one 8-byte load in two and one 16-byte load in two to four
// (a half-warp or quarter-warp a pass; measured on an H100, PERF.md), so
// with ksub = 16 a warp's lookups of 32 rows for one f32 query cost a clock
// however they are laid out: at pq4, batch 256, 8.19 G lookups take at
// least 0.98 ms. Next comes the selection at k = 400: the warm-up of each
// split's list and the buffer flushes. The design:
//
// * Grid (ceil(Q/QT), S). A block stages the LUT of its QT queries once,
//   query-interleaved in 8-byte entries: [QT/GW][m*ksub][GW], GW = 2
//   queries of an f32 LUT or 4 of a bf16 one. One 8-byte load fetches one
//   code's entries for GW queries, and a half-warp's 16 lanes read 16
//   distinct entries (ksub = 16) in one pass: a clock for 32 lookups of an
//   f32 LUT, as before, with half the load instructions, and half a clock
//   for a bf16 LUT. (16-byte entries of 4 f32 queries cost more: a
//   quarter-warp's 8 lanes often hit two entries of one bank group.) Each
//   query still adds its m entries in ascending j in f32, so the sums are
//   the plain version's bit for bit. An int8 LUT (the lookup route: ksub >
//   16, or a pq4 LUT too large for adc_int8_mma_kernel.cu's product) holds
//   GW = 8 queries an entry, biased to unsigned bytes, in a quarter of the
//   f32 table's shared memory, and adds two queries an integer add
//   (lut8_row; exact: |sum| <= 127 m).
// * A tile is 256 rows, one per thread. The thread reads its row's codes
//   16 bytes at a time (one load for pq4 and pq8 rows), the first 16 bytes,
//   the norm and the mask value a tile ahead; it decodes each code once for
//   all QT queries and scores the row.
// * Selection (select.cuh): each query's bar in shared memory is the
//   larger of its list's k-th entry and the group bar, which the splits of
//   the query share through slots [Q, S]. The scoring threads test their
//   own row against the bar's score and vote; only rows that pass are
//   written to the score tile, with one candidate bit each. Then one warp
//   per query walks the set bits, appends rows that beat the bar by the
//   exact rank rule to a 64-entry buffer, merges a full buffer into the
//   sorted list at once and publishes the list's entry for the group bar.
//   Past the warm-up most tiles cost a query one load and one vote.
// * QT is one of {1, 2, 4, 8, 16, 32}: the wrapper picks it and where the
//   lists live (shared memory up to k = 1024) from the occupancy the
//   runtime reports (PERF.md has the sweep). In device memory each split's
//   list (L = min(k, rows per split) entries) sits in the [Q, S, L]
//   scratch; only the buffers stay in shared memory.
// * Pass 2 merges the S partial lists: merge_kernel (select.cuh), one block
//   per query, or the merge tree of select.cuh past 64 splits (and for
//   lists in device memory), where one block folding the lists one by one
//   took longer than the tree's log2(S) launches.
//
// Codes must be < ksub (as PQ encoding makes them); the wrapper checks
// shapes, dtypes and limits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = kThreads;     // rows per tile, one per thread
constexpr int kWords = kRows / 32;  // candidate words per query and tile

enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };  // DistanceMetric values
enum LutType { kLutF32 = 0, kLutBF16 = 1, kLutI8 = 2 };

// A row's sum of LUT entries: int32 for an int8 LUT, else f32.
template <typename LT>
using AccOf = std::conditional_t<std::is_same_v<LT, int8_t>, int, float>;

// Add the GW entries at p (one code, GW consecutive queries) to a[0..GW),
// from one shared-memory load.
template <int GW>
__device__ __forceinline__ void lut_add(float* a, const float* p) {
  if constexpr (GW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] += v.x;
    a[1] += v.y;
    a[2] += v.z;
    a[3] += v.w;
  } else if constexpr (GW == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] += v.x;
    a[1] += v.y;
  } else {
    a[0] += *p;
  }
}

__device__ __forceinline__ float bf_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

template <int GW>
__device__ __forceinline__ void lut_add(float* a, const __nv_bfloat16* p) {
  if constexpr (GW == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    a[0] += bf_lo(u.x);
    a[1] += bf_hi(u.x);
    a[2] += bf_lo(u.y);
    a[3] += bf_hi(u.y);
  } else if constexpr (GW == 2) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    a[0] += bf_lo(u);
    a[1] += bf_hi(u);
  } else {
    a[0] += __bfloat162float(*p);
  }
}

// The int8 LUT (the lookup route of ops/adc_kernel.py::int8_lut_route:
// ksub > 16, and a ksub <= 16 LUT whose 32 queries do not fit the
// tensor-core product of adc_int8_mma_kernel.cu) is staged with each entry
// biased, e + 128 in [1, 255], and a row's sums add two queries at once in
// the 16-bit lanes of a 32-bit word: over 256 subspaces a lane reaches at
// most 255 * 256 < 2^16, so nothing carries into the other lane, and every
// 256 subspaces the lanes are widened into int32 sums. Minus 128 m, they
// are the plain version's sums exactly. The entries stay 1 byte, 8 queries
// an 8-byte load widened with prmt. Entries pre-widened to 16 bits (4
// queries a load, no prmt) timed within 1-7 % of it at sift1m-pq on an
// H100 (PERF.md), but double the LUT's shared memory: a query's LUT of m
// ksub entries must fit one block, and every m that ran with 1-byte
// entries still does.
using Lut8Smem = uint8_t;
constexpr int kLaneSpan = 256;  // subspaces a lane may add before widening

// The LUT type as it sits in shared memory.
template <typename LT>
struct SmemOf {
  using type = LT;
};
template <>
struct SmemOf<int8_t> {
  using type = Lut8Smem;
};

template <typename ST, typename LT>
__device__ __forceinline__ ST to_smem(LT v) {
  if constexpr (std::is_same_v<LT, int8_t>) {
    return static_cast<ST>(static_cast<int>(v) + 128);
  } else {
    return v;
  }
}

// Add the GW biased entries at p (one code, GW consecutive queries) to the
// lanes l[0 .. (GW + 1) / 2): queries 2 i and 2 i + 1 in the low and high
// 16 bits of l[i].
template <int GW>
__device__ __forceinline__ void lane_add(unsigned* l, const uint8_t* p) {
  if constexpr (GW == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    l[0] += __byte_perm(u.x, 0, 0x4140);
    l[1] += __byte_perm(u.x, 0, 0x4342);
    l[2] += __byte_perm(u.y, 0, 0x4140);
    l[3] += __byte_perm(u.y, 0, 0x4342);
  } else if constexpr (GW == 4) {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    l[0] += __byte_perm(u, 0, 0x4140);
    l[1] += __byte_perm(u, 0, 0x4342);
  } else if constexpr (GW == 2) {
    l[0] += __byte_perm(*reinterpret_cast<const unsigned short*>(p), 0, 0x4140);
  } else {
    l[0] += *p;
  }
}

// A row's score before the metric: the f32 sum, or the int8 LUT's int32 sum
// rounded to f32 times the query's scale.
__device__ __forceinline__ float lut_sum(float acc, const float*, int64_t) {
  return acc;
}
__device__ __forceinline__ float lut_sum(int acc, const float* sq, int64_t q) {
  return __fmul_rn(__int2float_rn(acc), __ldg(sq + q));
}

// Bytes b..b+15 of a row's codes as four little-endian words; bytes past
// `cols` read as 0. vec 16: cols % 16 == 0 and 16-byte aligned codes (one
// load); vec 4: cols % 4 == 0 and 4-byte aligned; else byte by byte.
__device__ __forceinline__ uint4 code_block(const uint8_t* rc, int b, int cols,
                                            int vec) {
  if (vec == 16) return *reinterpret_cast<const uint4*>(rc + b);
  uint32_t w[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int o = b + 4 * t;
    w[t] = 0;
    if (vec == 4) {
      if (o < cols) w[t] = *reinterpret_cast<const uint32_t*>(rc + o);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (o + u < cols) w[t] |= static_cast<uint32_t>(rc[o + u]) << (8 * u);
      }
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Shared memory of one scan block (bytes): the LUT, then per query the
// bar, two score tiles and two sets of candidate words (tiles alternate),
// the buffer and its fill, and the lists when they live in shared memory
// (smem_k entries, else 0).
__host__ __device__ constexpr size_t lut_bytes(int qt, int lsz, int mk) {
  return (static_cast<size_t>(qt) * mk * lsz + 15) / 16 * 16;
}
__host__ __device__ constexpr size_t scan_smem_bytes(int qt, int lsz, int mk,
                                                     int smem_k) {
  return lut_bytes(qt, lsz, mk) +
         static_cast<size_t>(qt) * (8 + 2 * (4 * kRows + 4 * kWords) + 8 * kBuf + 4 +
                                    8 * static_cast<size_t>(smem_k));
}

// Stage the LUT of queries q0 .. q0 + QT - 1 in shared memory,
// query-interleaved: ls[G][mk][GW]. Queries past the batch repeat its last
// entry (their results are never written). Called by the whole block.
template <int QT, int GW, typename ST, typename LT>
__device__ __forceinline__ void stage_lut(ST* ls, const LT* lut, int64_t q0,
                                          int64_t nq, int mk) {
  const int64_t lut_end = nq * mk;
  for (int e = threadIdx.x; e < QT * mk; e += kThreads) {
    const int qq = e / mk;
    const int c = e - qq * mk;
    const int64_t g = (q0 + qq) * mk + c;
    ls[((qq / GW) * mk + c) * GW + qq % GW] =
        to_smem<ST>(lut[g < lut_end ? g : lut_end - 1]);
  }
}

// A row's int8-LUT sums for QT queries (codes whose first 16 bytes are
// cw0, nibble-packed or not; the staged entries ls[G][mk][GW]): the biased
// entries added in lanes, kLaneSpan subspaces at a time, then widened.
template <int QT, int GW, bool PACKED>
__device__ __forceinline__ void lut8_row(int (&acc)[QT], const Lut8Smem* ls,
                                         const uint8_t* rc, uint4 cw0, int cols,
                                         int vec, int m, int ksub, int mk) {
  constexpr int G = QT / GW;
  constexpr int kLanes = (QT + 1) / 2;
  constexpr int kPer = (GW + 1) / 2;        // lane words of one load
  constexpr int kPerWord = PACKED ? 8 : 4;  // codes a 32-bit word
  constexpr int kSpanCols = kLaneSpan / (PACKED ? 2 : 1);  // bytes of kLaneSpan codes
#pragma unroll
  for (int qq = 0; qq < QT; ++qq) acc[qq] = -128 * m;
  for (int b0 = 0; b0 < cols; b0 += kSpanCols) {
    unsigned lanes[kLanes];
#pragma unroll
    for (int i = 0; i < kLanes; ++i) lanes[i] = 0;
    const int b1 = min(cols, b0 + kSpanCols);
    for (int b = b0; b < b1; b += 16) {
      const uint4 cw = b == 0 ? cw0 : code_block(rc, b, cols, vec);
      const uint32_t w[4] = {cw.x, cw.y, cw.z, cw.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int u = 0; u < kPerWord; ++u) {
          const int j = PACKED ? 2 * b + 8 * t + u : b + 4 * t + u;
          if (j < m) {
            const unsigned c = PACKED ? (w[t] >> (4 * u)) & 15u : (w[t] >> (8 * u)) & 255u;
            const Lut8Smem* e = ls + (j * ksub + c) * GW;
#pragma unroll
            for (int g = 0; g < G; ++g) lane_add<GW>(lanes + kPer * g, e + g * mk * GW);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      acc[2 * i] += static_cast<int>(lanes[i] & 0xffffu);
      if (2 * i + 1 < QT) acc[2 * i + 1] += static_cast<int>(lanes[i] >> 16);
    }
  }
}

// Merge a launch's split lists into out_* (the scan kernels' pass 2).
inline cudaError_t merge_splits(float* part_s, int* part_i, float* tmp_s,
                                int* tmp_i, int64_t nq, int splits, int kl,
                                int k, bool tree, float* out_s, int* out_i,
                                cudaStream_t st) {
  if (tree) {
    return merge_tree(part_s, part_i, tmp_s, tmp_i, nq, splits, kl, k, nullptr,
                      0, out_s, out_i, st);
  }
  merge_kernel<<<static_cast<unsigned>(nq), kMergeThreads, merge_smem_bytes(k),
                 st>>>(part_s, part_i, nq, k, splits, out_s, out_i);
  return cudaGetLastError();
}

template <int QT, bool PACKED, typename LT, bool GLOBAL>
__global__ void __launch_bounds__(kThreads)
    adc_scan_kernel(const void* lut_raw, const float* __restrict__ lut_scale,
                    const uint8_t* __restrict__ codes,
                    int cols, const float* __restrict__ norms,
                    const float* __restrict__ mask, int64_t nq, int64_t n,
                    int m, int ksub, int64_t num_valid, int k, int metric,
                    int64_t rows_per_split, int vec, int topk,
                    float* __restrict__ part_s, int* __restrict__ part_i,
                    unsigned long long* __restrict__ slots) {
  // GLOBAL: k is the length of each split's list, which lives in part_*
  // ([nq, splits, k]) instead of shared memory; topk is the k asked for.
  // slots ([nq, splits]) holds the group bars' keys (select.cuh).
  // lut_scale ([nq] f32): the int8 LUT's per-query scale (else unused).
  // Queries per LUT load: 8-byte entries, which a half-warp's 16 lanes
  // read in one pass when their codes differ (ksub = 16).
  using ST = typename SmemOf<LT>::type;
  constexpr int kEntry = 8 / static_cast<int>(sizeof(ST));
  constexpr int GW = QT < kEntry ? QT : kEntry;
  constexpr int G = QT / GW;
  constexpr int kPerWarp = (QT + kWarps - 1) / kWarps;  // queries a warp selects for
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int mk = m * ksub;
  const int ks = GLOBAL ? 0 : k;
  ST* ls = reinterpret_cast<ST*>(smem_raw);  // [G][mk][GW] the LUT
  auto* bar = reinterpret_cast<unsigned long long*>(
      smem_raw + lut_bytes(QT, sizeof(ST), mk));      // [QT] rank keys
  float* sc2 = reinterpret_cast<float*>(bar + QT);    // [2][QT][kRows] scores
  unsigned* cand2 = reinterpret_cast<unsigned*>(sc2 + 2 * QT * kRows);  // [2][QT][kWords]
  float* bs = reinterpret_cast<float*>(cand2 + 2 * QT * kWords);  // [QT][kBuf] buffer
  int* bi = reinterpret_cast<int*>(bs + QT * kBuf);          // [QT][kBuf]
  int* bc = bi + QT * kBuf;                                  // [QT] buffer fill
  float* cs = reinterpret_cast<float*>(bc + QT);             // [QT][k] lists
  int* ci = reinterpret_cast<int*>(cs + QT * ks);

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

  stage_lut<QT, GW>(ls, lut, q0, nq, mk);
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
  for (int e = tid; e < QT; e += kThreads) {
    bc[e] = 0;
    bar[e] = 0;
  }
  __syncthreads();

  // A thread's row of the next tile is loaded a tile ahead: its first 16
  // bytes of codes, its norm and its mask value.
  auto fetch = [&](int64_t row, uint4& cw, float& nrm, float& keep, bool& in) {
    in = row < row_end && row < num_valid;
    cw = in ? code_block(codes + row * cols, 0, cols, vec) : make_uint4(0, 0, 0, 0);
    nrm = in ? norms[row] : 0.f;
    keep = in && mask != nullptr ? mask[row] : 1.f;
  };
  uint4 next_cw;
  float next_nrm, next_keep;
  bool next_in;
  fetch(row_begin + tid, next_cw, next_nrm, next_keep, next_in);

  // Warp w selects for queries w, w + 8, ...; at the top of each tile its
  // lanes load those queries' group slots, so that the loads are in flight
  // during the scan.
  const int place = bar_place(splits, topk);
  for (int64_t t0 = row_begin; t0 < row_end; t0 += kRows) {
    // Tiles alternate between two score tiles and sets of words: a warp
    // still selecting for tile t reads one while the others score tile t + 1
    // into the other, and the one barrier a tile keeps them a tile apart.
    // (The bars may be read while a selecting lane raises them: a stale bar
    // only lets more rows through.)
    const int par = static_cast<int>(((t0 - row_begin) / kRows) & 1);
    float* sc = sc2 + par * QT * kRows;
    unsigned* cand = cand2 + par * QT * kWords;
    unsigned long long group[kPerWarp];
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int qq = warp + kWarps * j;
      group[j] = qq < QT && q0 + qq < nq
                     ? group_slot(slots, q0 + qq, split, splits, topk, lane)
                     : ~0ull;
    }
    const int64_t row = t0 + tid;
    const uint4 cw0 = next_cw;
    const float nrm = next_nrm;
    const bool live = next_in && next_keep != 0.f;
    fetch(row + kRows, next_cw, next_nrm, next_keep, next_in);
    AccOf<LT> acc[QT];
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) acc[qq] = 0;
    if constexpr (std::is_same_v<LT, int8_t>) {
      if (live) lut8_row<QT, GW, PACKED>(acc, ls, codes + row * cols, cw0, cols, vec, m, ksub, mk);
    } else if (live) {
      const uint8_t* rc = codes + row * cols;
      for (int b = 0; b < cols; b += 16) {
        const uint4 cw = b == 0 ? cw0 : code_block(rc, b, cols, vec);
        const uint32_t w[4] = {cw.x, cw.y, cw.z, cw.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          constexpr int kPerWord = PACKED ? 8 : 4;
#pragma unroll
          for (int u = 0; u < kPerWord; ++u) {
            const int j = PACKED ? 2 * b + 8 * t + u : b + 4 * t + u;
            if (j < m) {
              const unsigned c = PACKED ? (w[t] >> (4 * u)) & 15u : (w[t] >> (8 * u)) & 255u;
              const LT* e = ls + (j * ksub + c) * GW;
#pragma unroll
              for (int g = 0; g < G; ++g) lut_add<GW>(acc + GW * g, e + g * mk * GW);
            }
          }
        }
      }
    }
    const float inv = 1.0f / sqrtf(fmaxf(nrm, 1e-30f));
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {
      // (queries past the batch read the last query's scale: never written)
      float s = lut_sum(acc[qq], lut_scale, q0 + qq < nq ? q0 + qq : nq - 1);
      if (metric == kL2) {
        s = 2.0f * s - nrm;
      } else if (metric == kCosine) {
        s = s * inv;
      }
      float bs_q;  // a float compare; select_tile applies the exact rule
      int bi_q;
      unrank(bar[qq], bs_q, bi_q);
      const bool pass = live && s >= bs_q;
      if (pass) sc[qq * kRows + tid] = s;
      const unsigned vote = __ballot_sync(kFull, pass);
      if (lane == 0) cand[qq * kWords + warp] = vote;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int qq = warp + kWarps * j;
      if (qq >= QT || q0 + qq >= nq) break;  // the same in every lane
      select_tile(sc + qq * kRows, [&](int w) { return cand[qq * kWords + w]; }, kWords,
                  [&](int b) { return static_cast<int>(t0 + b); }, list_s(qq),
                  list_i(qq), k, bs + qq * kBuf, bi + qq * kBuf, bc + qq,
                  bar + qq, group[j],
                  slots == nullptr ? nullptr : slots + (q0 + qq) * splits + split,
                  place, lane);
    }
  }

  for (int j = 0; warp + kWarps * j < QT; ++j) {  // the buffers' last entries
    // (its own warp's queries: no barrier needed)
    const int qq = warp + kWarps * j;
    if (q0 + qq < nq && bc[qq] > 0) {
      flush_buffer(list_s(qq), list_i(qq), k, bs + qq * kBuf, bi + qq * kBuf,
                   bc[qq], lane);
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

}  // namespace
