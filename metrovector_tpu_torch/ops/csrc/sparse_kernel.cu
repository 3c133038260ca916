// Exact sparse (ELL + overflow) scan with a fused top-k, for Hopper (sm_90a),
// driven by the queries' nonzeros.
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
// What bounds it on an H100. Learned-sparse queries are sparse too: at the
// SPLADE-scale point (1M rows x 48 entries, 256 nonzeros a query over
// 30,522 terms) 0.84 % of qt is nonzero, and a term holds about 2.1 of a
// batch of 256 queries (0.27 of a batch of 32). Reading the dense line
// qt[c, :] for every ELL entry moves 49 GB from L2 per batch of 256, 99 %
// of it multiplied by zero. Here a batch is first turned into
// postings: for each (query tile, term) the tile's nonzero query values,
// queries ascending (postings_*_kernel: count, scan, fill; nothing waits on
// the host). A row then costs its ELL entries (387 MB of ELL arrays a pass
// from HBM: 0.12 ms, the bound) and its products with nonzero query values
// (about 100 a row at batch 256, 13 at 32). What the card spends is
// instructions and shared-memory traffic per product, not bytes: laying
// the products out across lanes (shuffles), ordering the adds that hit one
// query, and the selection.
//
// Skipping a zero query value keeps the sum bit for bit: acc starts at +0
// and never becomes -0, and acc + (+-0) = acc. The one product that is not
// +-0 is 0 * inf or 0 * NaN, so an entry whose value is not finite reads the
// whole line qt[c, q0:q0+QT] instead of the postings. Postings keep every
// value != 0 (inf and NaN too) and drop -0.
//
// The scatter. One warp walks one row, 32 entries at a time in slot order:
// lane i takes entry i and looks up its term's postings (two offsets of
// qptr, from L1/L2; the lookups of a row's first 64 entries are in flight
// together, and when 32 or fewer of them have products, as at small
// batches, those are gathered into one chunk). A warp prefix sum lays the
// chunk's products out in entry order, and the lanes take 32 products at a
// time (a binary search by shuffles finds each product's entry). The
// products of one entry go to distinct queries; where two entries of a
// round hit the same query, the lanes take turns in entry order (an
// atomicMax bid on a per-warp tag per query, cheaper here than
// __match_any_sync), so every accumulator adds in slot order. A row's
// accumulators live in shared memory, one float per query of the block's
// tile. A warp loads the first 64 entries of its next row before it
// starts on the current one.
//
// ell_topk: grid (query tiles, S), QT = 32 QG queries a block, ROWS rows a
// tile (QG, ROWS: template parameters chosen on the host, by measurement).
// The warps score a tile of rows into the [QT][ROWS + 1] score tile; the
// epilogue marks, per query, the rows that beat the query's bar (a bit per
// row). Then one lane per query takes its marked rows into the query's
// list. The bar is the list's k-th entry, raised to the best k-th entry
// any split's full list has reached (a 64-bit atomicMax key per query), so
// after the first rows of a split almost no row is a candidate. For k <= 16
// the lists live in shared memory and a candidate is inserted in place;
// longer lists live in device scratch, [Q, S, L], and candidates pass
// through select.cuh's 64-entry buffer and flush_buffer. The S lists merge
// in select.cuh's merge_kernel or, past 64 lists or for long lists, its
// merge tree.
//
// ell_dots: each warp keeps its row's QT accumulators in shared memory and
// stores them as one coalesced line of dots; no lane waits for a group of
// queries that the batch does not have.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kDotsBlocks = 132 * 8;  // ell_dots: one wave of blocks

enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };  // DistanceMetric values

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// ---------------------------------------------------------------------------
// Postings of a batch: key = tile * dim + term, qptr [keys + 1] offsets,
// one entry per nonzero: (global query index, value bits) as an int2. One
// warp per key, kWarps keys a block.

__device__ __forceinline__ const float* key_line(const float* qt, int64_t key,
                                                 int64_t dim, int64_t nq,
                                                 int qtile, int64_t* q0,
                                                 int* m) {
  const int64_t b = key / dim;
  *q0 = b * qtile;
  *m = static_cast<int>(nq - *q0 < qtile ? nq - *q0 : qtile);
  return qt + (key - b * dim) * nq + *q0;
}

// Nonzeros per key, and per block.
__global__ void __launch_bounds__(kThreads)
    postings_count_kernel(const float* __restrict__ qt, int64_t dim,
                          int64_t nq, int qtile, int64_t keys,
                          int* __restrict__ counts,
                          int* __restrict__ block_sums) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t key = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  int cnt = 0;
  if (key < keys) {
    int64_t q0;
    int m;
    const float* line = key_line(qt, key, dim, nq, qtile, &q0, &m);
    for (int j = lane; j < m; j += 32) cnt += line[j] != 0.f;
    cnt = __reduce_add_sync(kFull, cnt);
    if (lane == 0) counts[key] = cnt;
  }
  if (lane == 0) warp_sums[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
    block_sums[blockIdx.x] = s;
  }
}

// One block: the exclusive prefix sums of the nb block totals, in place;
// the grand total goes to *end.
__global__ void __launch_bounds__(kScanThreads)
    postings_scan_kernel(int* __restrict__ block_sums, int64_t nb,
                         int* __restrict__ end) {
  __shared__ int warp_before[32];
  __shared__ int round_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int64_t base = 0; base < nb; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    const int x = i < nb ? block_sums[i] : 0;
    const int incl = warp_inclusive_sum(x, lane);
    if (lane == 31) warp_before[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int t = warp_before[lane];
      const int ti = warp_inclusive_sum(t, lane);
      warp_before[lane] = ti - t;
      if (lane == 31) round_total = ti;
    }
    __syncthreads();
    if (i < nb) block_sums[i] = carry + warp_before[warp] + incl - x;
    carry += round_total;
    __syncthreads();  // warp_before and round_total are reused
  }
  if (threadIdx.x == 0) *end = carry;
}

// Each warp writes its key's offset and entries: the nonzero values of
// qt[term, tile's queries], queries ascending.
__global__ void __launch_bounds__(kThreads)
    postings_fill_kernel(const float* __restrict__ qt, int64_t dim, int64_t nq,
                         int qtile, int64_t keys,
                         const int* __restrict__ counts,
                         const int* __restrict__ block_before,
                         int* __restrict__ qptr, int2* __restrict__ post) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t key = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (lane == 0) warp_sums[warp] = key < keys ? counts[key] : 0;
  __syncthreads();
  if (key >= keys) return;  // the same in every lane
  int pos = block_before[blockIdx.x];
  for (int w = 0; w < warp; ++w) pos += warp_sums[w];
  if (lane == 0) qptr[key] = pos;
  int64_t q0;
  int m;
  const float* line = key_line(qt, key, dim, nq, qtile, &q0, &m);
  for (int j0 = 0; j0 < m; j0 += 32) {
    const int j = j0 + lane;
    const float x = j < m ? line[j] : 0.f;
    const bool nz = x != 0.f;  // drops +-0, keeps inf and NaN
    const unsigned vote = __ballot_sync(kFull, nz);
    if (nz) {
      post[pos + __popc(vote & lanes_below(lane))] =
          make_int2(static_cast<int>(q0 + j), __float_as_int(x));
    }
    pos += __popc(vote);
  }
}

// ---------------------------------------------------------------------------
// The scatter shared by both scan kernels.

// One block's view of the postings: its query tile [q0, q0 + nqt).
struct Postings {
  const float* qt;     // [dim, nq], for entries whose value is not finite
  const int* qptr;     // this tile's term offsets, [dim + 1]
  const int2* post;    // (global query, value bits)
  int64_t nq;
  int64_t q0;
  int nqt;
};

// One entry of a row as a lane holds it: its column and value, and where
// its products come from: the postings qptr[c] .. qptr[c + 1] (p0, cnt),
// or for a value that is not finite the whole line of the tile (p0 = -1),
// since 0 * inf and 0 * NaN are NaN.
struct Entry {
  int c;
  float v;
  int p0;
  int cnt;
};

__device__ __forceinline__ Entry lookup(int c, float v, bool has,
                                        const Postings& p) {
  Entry en{c, v, 0, 0};
  if (has) {
    if (isfinite(v)) {
      en.p0 = p.qptr[c];
      en.cnt = p.qptr[c + 1] - en.p0;
    } else {
      en.p0 = -1;
      en.cnt = p.nqt;
    }
  }
  return en;
}

// Product e0 + lane of a chunk laid out by the exclusive prefix `excl` of
// its entries' counts: its query q (local to the tile; -1 - lane past the
// chunk's `total`), the query value x and the entry's value v.
__device__ __forceinline__ void fetch(const Entry& en, int excl, int total,
                                      int e0, const Postings& p, int lane,
                                      int& q, float& x, float& v) {
  const int e = e0 + lane;
  int s = 0;  // the entry of product e: the last lane starting at or before e
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (__shfl_sync(kFull, excl, s + step) <= e) s += step;
  }
  const int sc = __shfl_sync(kFull, en.c, s);
  const int sp = __shfl_sync(kFull, en.p0, s);
  const int off = e - __shfl_sync(kFull, excl, s);
  v = __shfl_sync(kFull, en.v, s);
  q = -1 - lane;  // distinct from every query while idle
  x = 0.f;
  if (e < total) {
    if (sp >= 0) {
      const int2 e2 = p.post[sp + off];
      q = static_cast<int>(e2.x - p.q0);
      x = __int_as_float(e2.y);
    } else {
      q = off;
      x = p.qt[static_cast<int64_t>(sc) * p.nq + p.q0 + off];
    }
  }
}

// Add the products of one chunk of a row's entries (lane i holds entry i)
// to the row's accumulators acc[q * stride], in entry order, 32 at a time.
__device__ __forceinline__ void scatter_chunk(const Entry& en, const Postings& p,
                                              float* acc, int stride, int* tags,
                                              int& epoch, int lane) {
  const int incl = warp_inclusive_sum(en.cnt, lane);
  const int excl = incl - en.cnt;
  const int total = __shfl_sync(kFull, incl, 31);
  if (total == 0) return;
  int q;
  float x, v;
  for (int e0 = 0; e0 < total; e0 += 32) {
    fetch(en, excl, total, e0, p, lane, q, x, v);
    const float prod = __fmul_rn(x, v);
    // Lanes that share a query take turns, lowest lane (earliest entry)
    // first: each pending lane bids (epoch, 31 - lane) for its query's tag,
    // and the highest bid adds. Epochs grow within a row: older bids lose.
    bool pending = e0 + lane < total;
    while (__any_sync(kFull, pending)) {
      const int bid = (++epoch << 5) | (31 - lane);
      if (pending) atomicMax(tags + q, bid);
      __syncwarp();
      if (pending && tags[q] == bid) {
        acc[q * stride] = __fadd_rn(acc[q * stride], prod);
        pending = false;
      }
      __syncwarp();
    }
  }
}

// The lane of the n-th (from 0) set bit of m; m must have more than n.
__device__ __forceinline__ int nth_set(unsigned m, int n) {
  int lo = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    if (__popc(m & ((2u << (lo + step - 1)) - 1u)) <= n) lo += step;
  }
  return lo;
}

// The first 64 entries of a row: lane i holds entries i and 32 + i.
struct RowHead {
  int c[2];
  float v[2];
};

__device__ __forceinline__ RowHead load_head(const int* __restrict__ cols,
                                             const float* __restrict__ vals,
                                             int64_t row, int64_t n, int r,
                                             int lane) {
  RowHead h;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = 32 * u + lane;
    const bool in = row < n && j < r;
    h.c[u] = in ? cols[row * r + j] : 0;
    h.v[u] = in ? vals[row * r + j] : 0.f;
  }
  return h;
}

// Add a row's ELL entries (the first 64 from `h`), then its overflow
// entries, to its accumulators.
__device__ __forceinline__ void scatter_row(
    const RowHead& h, int64_t row, const int* __restrict__ cols,
    const float* __restrict__ vals, int r, const int64_t* __restrict__ ovf_ptr,
    const int* __restrict__ ovf_cols, const float* __restrict__ ovf_vals,
    const Postings& p, float* acc, int stride, int* tags, int lane) {
  int epoch = 0;
  const Entry a = lookup(h.c[0], h.v[0], lane < r, p);  // both in flight
  const Entry b = lookup(h.c[1], h.v[1], 32 + lane < r, p);
  const unsigned ma = __ballot_sync(kFull, a.cnt > 0);
  const unsigned mb = __ballot_sync(kFull, b.cnt > 0);
  const int na = __popc(ma);
  if (na + __popc(mb) <= 32) {
    // The entries with products fit one chunk: gather them, in slot order,
    // into lanes 0, 1, ... (an entry without products adds nothing).
    const bool from_a = lane < na;
    const int src = from_a ? nth_set(ma, lane) : nth_set(mb, lane - na);
    const Entry ea{__shfl_sync(kFull, a.c, src), __shfl_sync(kFull, a.v, src),
                   __shfl_sync(kFull, a.p0, src), __shfl_sync(kFull, a.cnt, src)};
    const Entry eb{__shfl_sync(kFull, b.c, src), __shfl_sync(kFull, b.v, src),
                   __shfl_sync(kFull, b.p0, src), __shfl_sync(kFull, b.cnt, src)};
    Entry m = from_a ? ea : eb;
    if (lane >= na + __popc(mb)) m.cnt = 0;
    scatter_chunk(m, p, acc, stride, tags, epoch, lane);
  } else {
    scatter_chunk(a, p, acc, stride, tags, epoch, lane);
    scatter_chunk(b, p, acc, stride, tags, epoch, lane);
  }
  for (int j0 = 64; j0 < r; j0 += 32) {
    const bool in = j0 + lane < r;
    scatter_chunk(lookup(in ? cols[row * r + j0 + lane] : 0,
                         in ? vals[row * r + j0 + lane] : 0.f, in, p),
                  p, acc, stride, tags, epoch, lane);
  }
  if (ovf_ptr != nullptr) {  // the row's entries past R, in order
    const int64_t end = ovf_ptr[row + 1];
    for (int64_t e0 = ovf_ptr[row]; e0 < end; e0 += 32) {
      const bool in = e0 + lane < end;
      scatter_chunk(lookup(in ? ovf_cols[e0 + lane] : 0,
                           in ? ovf_vals[e0 + lane] : 0.f, in, p),
                    p, acc, stride, tags, epoch, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// ell_dots: one warp per row (grid-stride), grid.y over query tiles.

template <int QG>
__global__ void __launch_bounds__(kThreads)
    ell_dots_kernel(const float* __restrict__ qt, const int* __restrict__ qptr,
                    const int2* __restrict__ post, int64_t dim,
                    const int* __restrict__ cols, const float* __restrict__ vals,
                    int64_t n, int r, int64_t nq, float* __restrict__ dots,
                    int64_t ldo) {
  constexpr int QT = 32 * QG;
  __shared__ float acc_all[kWarps][QT];
  __shared__ int tags_all[kWarps][QT];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* acc = acc_all[warp];
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * QT;
  const Postings p{qt, qptr + blockIdx.y * dim, post, nq, q0,
                   static_cast<int>(nq - q0 < QT ? nq - q0 : QT)};
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  RowHead next = load_head(cols, vals, row, n, r, lane);
  for (; row < n; row += warps) {
    const RowHead h = next;
    next = load_head(cols, vals, row + warps, n, r, lane);
#pragma unroll
    for (int g = 0; g < QG; ++g) {
      acc[32 * g + lane] = 0.f;
      tags_all[warp][32 * g + lane] = 0;
    }
    __syncwarp();
    scatter_row(h, row, cols, vals, r, nullptr, nullptr, nullptr, p, acc, 1,
                tags_all[warp], lane);
    float* out = dots + row * ldo + q0;
#pragma unroll
    for (int g = 0; g < QG; ++g) {
      if (32 * g + lane < p.nqt) out[32 * g + lane] = acc[32 * g + lane];
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// ell_topk

// ell_topk keeps a block's lists in shared memory up to this length: a
// lane inserts in place, in O(k), which beats the buffered lists in device
// memory for short lists only (at k = 10 by about a quarter at batch 256,
// while at k = 100 the buffers win; PERF.md). tools/sparse_kernel_sweep.py
// builds -DMVT_K4_SMEM_LIST_K=0 to time k = 10 with the lists in device
// memory.
#ifndef MVT_K4_SMEM_LIST_K
#define MVT_K4_SMEM_LIST_K 16
#endif
constexpr int kSmemListK = MVT_K4_SMEM_LIST_K;

__host__ __device__ constexpr bool lists_in_smem(int list_len) {
  return list_len <= kSmemListK;
}

// Shared memory of one ell_topk block: the score tile, each warp's tags,
// per query the tile's candidate rows and the bar, and the block's lists
// when they fit (lists_in_smem).
__host__ __device__ constexpr size_t topk_smem_bytes(int qg, int rows,
                                                     int list_len) {
  return static_cast<size_t>(32 * qg) *
         ((rows + 1) * 4 + 4 * kWarps + 12 +
          (lists_in_smem(list_len) ? 8 * list_len : 0));
}

// One ell_topk block: the rows of split blockIdx.y against the queries of
// tile blockIdx.x. Warps score a tile of kRows rows into shared memory;
// then warp w < QG selects for the tile's queries 32 w .. 32 w + 31, one
// query a lane. A lane keeps the rank_key of its query's k-th entry (0
// until the list holds k rows), raised to the query's kth_key, which holds
// the best k-th entry any split's full list has reached (kth_key is zeroed
// by the caller; null when a split's list is shorter than the k asked
// for): a row that does not beat it has k better rows and cannot enter.
//  - SMALL (lists_in_smem): the lane inserts a passing row into its
//    query's sorted list in shared memory; the list goes to part_* at the
//    end.
//  - otherwise the lists are part_* ([nq, S, k]) in device memory: a
//    passing row goes to the query's buffer (buf_*, [nq, S, kBuf]), and a
//    buffer past half full is merged into its list (select.cuh's
//    flush_buffer) before the next tile.
template <int QG, int ROWS, bool SMALL>
__global__ void __launch_bounds__(kThreads)
    ell_topk_kernel(const float* __restrict__ qt, const int* __restrict__ qptr,
                    const int2* __restrict__ post, int64_t dim,
                    const int* __restrict__ cols,
                    const float* __restrict__ vals,
                    const int64_t* __restrict__ ovf_ptr,
                    const int* __restrict__ ovf_cols,
                    const float* __restrict__ ovf_vals,
                    const float* __restrict__ norms,
                    const float* __restrict__ mask, int64_t nq, int64_t n,
                    int r, int64_t num_rows, int k, int metric,
                    int64_t rows_per_split, float* __restrict__ part_s,
                    int* __restrict__ part_i, float* __restrict__ buf_s,
                    int* __restrict__ buf_i,
                    unsigned long long* __restrict__ kth_key) {
  constexpr int kRows = ROWS;
  static_assert(2 * kRows <= kBuf && kRows <= 32, "a buffer half full takes a tile");
  constexpr int QT = 32 * QG;
  constexpr int kStride = kRows + 1;  // score tile row: distinct banks
  constexpr int kRowsPerWarp = kRows / kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* sc = reinterpret_cast<float*>(smem_raw);  // [QT][kStride] scores
  int* tags_all = reinterpret_cast<int*>(sc + QT * kStride);  // [kWarps][QT]
  int* tags = tags_all + warp * QT;
  unsigned* cand = reinterpret_cast<unsigned*>(tags_all + kWarps * QT);  // [QT]
  float* bar_s = reinterpret_cast<float*>(cand + QT);  // [QT] the bar
  int* bar_i = reinterpret_cast<int*>(bar_s + QT);
  float* list_s = reinterpret_cast<float*>(bar_i + QT);  // [k][QT]
  int* list_i = reinterpret_cast<int*>(list_s + k * QT);

  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * QT;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int64_t row_begin = split * rows_per_split;
  const int64_t row_end =
      row_begin + rows_per_split < n ? row_begin + rows_per_split : n;
  const Postings p{qt, qptr + blockIdx.x * dim, post, nq, q0,
                   static_cast<int>(nq - q0 < QT ? nq - q0 : QT)};

  // Query qq's list and buffer in this split.
  auto slot = [&](int qq) { return (q0 + qq) * splits + split; };
  if (!SMALL) {
    for (int64_t e = tid; e < static_cast<int64_t>(QT) * k; e += kThreads) {
      const int qq = static_cast<int>(e / k);
      if (q0 + qq < nq) {
        part_s[slot(qq) * k + e % k] = -CUDART_INF_F;
        part_i[slot(qq) * k + e % k] = kSentinel;
      }
    }
  }
  for (int e = tid; e < QT; e += kThreads) {
    cand[e] = 0;
    bar_s[e] = -CUDART_INF_F;
    bar_i[e] = kSentinel;
  }
  __syncthreads();

  // The bar of query q: the better of its list's k-th entry (once the list
  // holds k rows) and kth_key[q]. Its lane keeps it in bs/bi and publishes
  // it in bar_s/bar_i for the scoring warps, which mark in cand[q] the
  // rows of the tile that beat it.
  const int qq = 32 * warp + lane;
  const bool selects = warp < QG && q0 + qq < nq;
  const int64_t mine = slot(selects ? qq : 0);
  int cnt = 0;  // SMALL: the list's length; else the buffer's fill
  float bs = -CUDART_INF_F;
  int bi = kSentinel;
  auto raise_bar = [&](float s, int i) {  // the list's k-th entry is (s, i)
    if (better(s, i, bs, bi)) {
      bs = s;
      bi = i;
    }
    if (kth_key != nullptr) atomicMax(kth_key + q0 + qq, rank_key(s, i));
  };
  auto flush_over = [&](int limit) {  // the warp's buffers past `limit`
    unsigned due = __ballot_sync(kFull, cnt > limit);
    while (due != 0) {
      const int src = __ffs(due) - 1;
      due &= due - 1;
      const int64_t at = slot(32 * warp + src);
      flush_buffer(part_s + at * k, part_i + at * k, k, buf_s + at * kBuf,
                   buf_i + at * kBuf, __shfl_sync(kFull, cnt, src), lane);
      if (lane == src) {
        cnt = 0;
        const float last = part_s[at * k + k - 1];
        if (last > -CUDART_INF_F) raise_bar(last, part_i[at * k + k - 1]);
      }
    }
  };

  RowHead next = load_head(cols, vals, row_begin + warp * kRowsPerWarp, row_end, r, lane);
  for (int64_t t0 = row_begin; t0 < row_end; t0 += kRows) {
    unsigned long long other = 0;  // another split's list may be ahead
    if (selects && kth_key != nullptr) other = __ldcg(kth_key + q0 + qq);
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int t = warp * kRowsPerWarp + i;
      const int64_t row = t0 + t;  // the same in every lane
      const RowHead h = next;  // this warp's next row: here, or the next tile's
      next = load_head(cols, vals,
                       i + 1 < kRowsPerWarp ? row + 1 : row + kRows - (kRowsPerWarp - 1),
                       row_end, r, lane);
      const bool live = row < row_end && row < num_rows &&
                        (mask == nullptr || mask[row] != 0.f);
      float* col = sc + t;
#pragma unroll
      for (int g = 0; g < QG; ++g) {
        col[(32 * g + lane) * kStride] = live ? 0.f : -CUDART_INF_F;
        tags[32 * g + lane] = 0;
      }
      __syncwarp();
      if (live) {
        const float nrm = norms[row];  // in flight during the scatter
        scatter_row(h, row, cols, vals, r, ovf_ptr, ovf_cols, ovf_vals, p, col,
                    kStride, tags, lane);
        const float inv = 1.0f / sqrtf(fmaxf(nrm, 1e-30f));
#pragma unroll
        for (int g = 0; g < QG; ++g) {
          const int q = 32 * g + lane;
          float& s = col[q * kStride];
          if (metric == kL2) {
            s = 2.0f * s - nrm;
          } else if (metric == kCosine) {
            s = s * inv;
          }
          if (q < p.nqt && s > -CUDART_INF_F &&
              better(s, static_cast<int>(row), bar_s[q], bar_i[q])) {
            atomicOr(cand + q, 1u << t);
          }
        }
      }
    }
    __syncthreads();  // the tile's scores and candidates are complete

    if (warp < QG) {
      if (selects) {
        unsigned todo = cand[qq];
        cand[qq] = 0;
        float os;
        int oi;
        unrank(other, os, oi);
        if (better(os, oi, bs, bi)) {
          bs = os;
          bi = oi;
        }
        while (todo != 0) {
          const int t = __ffs(todo) - 1;
          todo &= todo - 1;
          const float v = sc[qq * kStride + t];
          const int row = static_cast<int>(t0 + t);
          if (!better(v, row, bs, bi)) continue;
          if (SMALL) {  // insert; a full list drops its last entry
            int j = cnt < k ? cnt : k - 1;
            for (; j > 0 && better(v, row, list_s[(j - 1) * QT + qq],
                                   list_i[(j - 1) * QT + qq]); --j) {
              list_s[j * QT + qq] = list_s[(j - 1) * QT + qq];
              list_i[j * QT + qq] = list_i[(j - 1) * QT + qq];
            }
            list_s[j * QT + qq] = v;
            list_i[j * QT + qq] = row;
            cnt += cnt < k;
            if (cnt == k) raise_bar(list_s[(k - 1) * QT + qq], list_i[(k - 1) * QT + qq]);
          } else {
            buf_s[mine * kBuf + cnt] = v;
            buf_i[mine * kBuf + cnt] = row;
            ++cnt;
          }
        }
      }
      if (!SMALL) flush_over(kBuf - kRows);  // every buffer takes a tile
      if (selects) {
        bar_s[qq] = bs;
        bar_i[qq] = bi;
      }
    }
    __syncthreads();  // the score tile is rewritten by the next tile
  }
  if (SMALL) {
    for (int j = 0; selects && j < k; ++j) {
      part_s[mine * k + j] = j < cnt ? list_s[j * QT + qq] : -CUDART_INF_F;
      part_i[mine * k + j] = j < cnt ? list_i[j * QT + qq] : kSentinel;
    }
  } else if (warp < QG) {
    flush_over(0);  // the buffers' last entries
  }
}

// The instantiations the host may choose: QG in {1, 2, 4, 8} query groups,
// each with the ROWS that ops/sparse_kernel.py::_tile_shape gives it (16
// rows at QG = 8, else 32: the sweep in PERF.md), lists in shared memory or
// not. -DMVT_K4_ALL_TILES builds 16 and 32 rows at every QG, for
// tools/sparse_kernel_sweep.py; an unbuilt shape is refused.
template <int QG, int ROWS>
const void* pick_lists(bool small) {
  return small ? reinterpret_cast<const void*>(ell_topk_kernel<QG, ROWS, true>)
               : reinterpret_cast<const void*>(ell_topk_kernel<QG, ROWS, false>);
}

template <int QG>
const void* pick_rows(int rows, bool small) {
#ifdef MVT_K4_ALL_TILES
  if (rows == 16) return pick_lists<QG, 16>(small);
  if (rows == 32) return pick_lists<QG, 32>(small);
  return nullptr;
#else
  constexpr int kRows = QG == 8 ? 16 : 32;
  return rows == kRows ? pick_lists<QG, kRows>(small) : nullptr;
#endif
}

const void* pick(int qg, int rows, bool small) {
  switch (qg) {
    case 1:
      return pick_rows<1>(rows, small);
    case 2:
      return pick_rows<2>(rows, small);
    case 4:
      return pick_rows<4>(rows, small);
    case 8:
      return pick_rows<8>(rows, small);
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

// The postings of qt [dim, nq] for query tiles of qtile (a multiple of 32):
// qptr [tiles * dim + 1], post [dim * nq] int2 (room for every nonzero).
// scratch holds tiles * dim + ceil(tiles * dim / 8) ints. Returns the
// cudaError_t of the launches.
int mvt_query_postings(const float* qt, int64_t dim, int64_t nq, int qtile,
                       int* scratch, int* qptr, int2* post, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t keys = (nq + qtile - 1) / qtile * dim;
  if (keys == 0) return cudaMemsetAsync(qptr, 0, sizeof(int), st);
  const int64_t nb = (keys + kWarps - 1) / kWarps;
  int* counts = scratch;
  int* block_sums = scratch + keys;
  postings_count_kernel<<<static_cast<unsigned>(nb), kThreads, 0, st>>>(
      qt, dim, nq, qtile, keys, counts, block_sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  postings_scan_kernel<<<1, kScanThreads, 0, st>>>(block_sums, nb, qptr + keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  postings_fill_kernel<<<static_cast<unsigned>(nb), kThreads, 0, st>>>(
      qt, dim, nq, qtile, keys, counts, block_sums, qptr, post);
  return cudaGetLastError();
}

// dots [n, nq] = the ELL contraction of qt [dim, nq] with cols/vals [n, r],
// through the postings of query tiles of 32 qg; row i of dots starts at
// dots + i * ldo. Returns the cudaError_t of the launch.
int mvt_ell_dots(const float* qt, const int* qptr, const int2* post,
                 int64_t dim, const int* cols,
                 const float* vals, int64_t n, int r, int64_t nq, int qg,
                 float* dots, int64_t ldo, void* stream) {
  const int64_t tiles = (nq + 32 * qg - 1) / (32 * qg);
  const int64_t want = (n + kWarps - 1) / kWarps;
  int64_t per_tile = kDotsBlocks / tiles;
  per_tile = per_tile < 1 ? 1 : per_tile;
  const dim3 grid(static_cast<unsigned>(want < per_tile ? (want < 1 ? 1 : want) : per_tile),
                  static_cast<unsigned>(tiles));
  const void* fn = qg == 1   ? reinterpret_cast<const void*>(ell_dots_kernel<1>)
                   : qg == 2 ? reinterpret_cast<const void*>(ell_dots_kernel<2>)
                   : qg == 4 ? reinterpret_cast<const void*>(ell_dots_kernel<4>)
                   : qg == 8 ? reinterpret_cast<const void*>(ell_dots_kernel<8>)
                             : nullptr;
  if (fn == nullptr) return cudaErrorInvalidValue;
  void* args[] = {&qt, &qptr, &post, &dim, &cols, &vals, &n, &r, &nq, &dots,
                  &ldo};
  const cudaError_t err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, 0,
                                           static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launch the scan and the merge on `stream`; returns the cudaError_t of the
// launches (0 on success). qptr / post are the postings of query tiles of
// 32 qg (mvt_query_postings). ovf_ptr may be null (no
// overflow), mask may be null. Each split's list has list_len entries in
// part_* ([nq, splits, list_len]) and its buffer kBuf entries in buf_*
// ([nq, splits, 64]). When list_len == k <= 1024 the lists merge in shared
// memory and tmp_* is unused; otherwise part_* and tmp_* are as large as
// every level of the merge tree needs (ops/select.py::merge_scratch).
// With `tree` the lists fold in the merge tree; without it (list_len == k
// <= 1024 only) in merge_kernel, one list after another. out_* are [nq, k].
int mvt_ell_topk(const float* qt, const int* qptr, const int2* post,
                 int64_t dim, const int* cols,
                 const float* vals, const int64_t* ovf_ptr,
                 const int* ovf_cols, const float* ovf_vals,
                 const float* norms, const float* mask, int64_t nq, int64_t n,
                 int r, int64_t num_rows, int k, int metric, int qg, int rows,
                 int splits, int64_t rows_per_split, int list_len, int tree,
                 float* part_s, int* part_i, float* buf_s, int* buf_i,
                 unsigned long long* kth_key, float* tmp_s, int* tmp_i,
                 float* out_s, int* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* fn = pick(qg, rows, lists_in_smem(list_len));
  const size_t smem = topk_smem_bytes(qg, rows, list_len);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&qt,       &qptr,     &post,                      &dim,
                  &cols,     &vals,     &ovf_ptr,  &ovf_cols,       &ovf_vals,
                  &norms,    &mask,     &nq,       &n,              &r,
                  &num_rows, &list_len, &metric,   &rows_per_split, &part_s,
                  &part_i,   &buf_s,    &buf_i,    &kth_key};
  const int qt_rows = 32 * qg;
  const dim3 grid(static_cast<unsigned>((nq + qt_rows - 1) / qt_rows),
                  static_cast<unsigned>(splits));
  err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, smem, st);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (!tree) {
    merge_kernel<<<static_cast<unsigned>(nq), kMergeThreads,
                   merge_smem_bytes(k), st>>>(part_s, part_i, nq, k, splits,
                                              out_s, out_i);
    return cudaGetLastError();
  }
  return merge_tree(part_s, part_i, tmp_s, tmp_i, nq, splits, list_len, k,
                    nullptr, 0, out_s, out_i, st);
}

// Scan blocks of (qg, rows) with lists of list_len that fit on one SM at
// once, written to *blocks_per_sm; returns the cudaError_t.
int mvt_ell_topk_occupancy(int qg, int rows, int list_len, int* blocks_per_sm) {
  const void* fn = pick(qg, rows, lists_in_smem(list_len));
  const size_t smem = topk_smem_bytes(qg, rows, list_len);
  const cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                       kThreads, smem);
}

}  // extern "C"
