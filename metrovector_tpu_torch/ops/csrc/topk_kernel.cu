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
// byte, so the bound is the CUDA cores' f32 rate (67 TFLOP/s on the data
// sheet), not HBM (3.35 TB/s). Beside the FFMAs, each dim of a thread's
// dots costs shared-memory loads, and an SM serves a 16-byte warp load in
// two clocks when it touches 4 distinct addresses and in four when it
// touches 8 or more (measured on an H100, PERF.md). What holds the scan
// below the FFMA rate is the FFMA loop itself: its loads issue beside the
// FFMAs and their latency shows at 16 warps an SM, the most that 128
// registers a thread allow; the selection takes the rest. The design:
//
// * Pass 1 (scan_kernel), grid (ceil(Q/QB), S), 8 warps. A block owns QB
//   queries and walks its share of the corpus in tiles of RB rows, QB x RB
//   = 32 x 256 at every batch (a 64 x 128 tile, built with
//   -DMVT_K1_ALL_TILES for the sweep, was slower at batches 128 and 256:
//   PERF.md). Each thread owns an 8 x 4
//   block of (query, row) dots; a warp owns 32 queries x 32 rows, its lanes
//   4 query groups x 8 row groups. Both chunks sit in shared memory
//   dim-major, so per dim a thread makes two 16-byte loads of its queries
//   (4 distinct addresses a warp) and one of its rows (8) for 32 FFMAs.
//   Dots accumulate in f32 over d = 0..D-1 in order with fmaf, no tensor
//   cores and no TF32, so precision "highest" stays f32-faithful and
//   integer data stays exact.
// * Staging: 16 dims at a time. A warp loads whole 16-byte pieces of 8
//   (f32) or 16 (16-bit) consecutive chunk rows, coalesced, into registers
//   while the FFMAs run on the chunk before, then stores them transposed,
//   f16/bf16 converted to f32, with the column XOR-swizzled by the dim
//   (swz) so that neither the stores nor the loads conflict on banks. Two
//   chunks alternate; one barrier a chunk. Any D takes the same kernel.
// * Selection (select.cuh): each query's bar is the larger of its list's
//   k-th entry and the group bar, which the splits of the query share
//   through slots [Q, S]. After a tile's last chunk each thread tests its
//   32 dots against its queries' bar scores (a float compare), writes those
//   that pass to the score tile and votes; the warps' raw votes go to
//   shared memory. Then one warp per query assembles the query's candidate
//   words from the votes, appends the rows that beat the bar by the exact
//   rank rule to a 64-entry buffer, merges a full buffer into the sorted
//   list and publishes the list's entry for the group bar. The selection
//   overlaps the next tile's first chunk: the score tile is rewritten only
//   after that chunk's barrier. Lists of k <= 256 live in shared memory;
//   above (BIG_K) each split's list of L = min(k, rows per split) entries
//   lives in the [Q, S, L] scratch.
// * The grid holds about one wave: S is chosen from the occupancy the
//   runtime reports. Pass 2 merges the S sorted lists: warp_merge_kernel,
//   one warp per query, for k <= 256 (up to 64 splits, or k <= 32), else the
//   merge tree of select.cuh.
//
// * The affine int8 load (the uint8 cosine space, whose device codes are
//   c' = c - 128): the corpus is int8 and each code becomes (c' + off) *
//   scale in f32 (off = 128 - zero_point; two roundings, no fused
//   multiply-add) as it is staged, which is the reference's dequantizing
//   read (metrovector_tpu/engine.py::_search_uint8_dequant, which XLA fuses
//   into the matmul). No dequantized copy of the corpus exists: it reads a
//   quarter of the f32 bytes, and the FFMA loop is the same.
//
// Row offsets are 64-bit (N*D passes 2^31 at 100M x 768). The corpus may
// be float, __half, __nv_bfloat16 or int8 (affine); queries are f32.
// Limits: 1 <= k <= N < 2^31, S <= 512; the Python wrapper checks them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "scan_common.cuh"
#include "select.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTQ = 8;      // queries per thread
constexpr int kTR = 4;      // rows per thread
constexpr int kBK = 16;     // dims per staged chunk
constexpr int kMaxK = 256;  // lists in shared memory up to this k

enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };  // DistanceMetric values
enum DType { kF32 = 0, kF16 = 1, kBF16 = 2, kI8Affine = 3 };

// The affine int8 load's dequantization: x = (c + off) * scale.
struct Affine {
  float off, scale;
};

// The block tiles: QB queries x RB = 8192 / QB rows. A warp owns 32 x 32
// dots, so the 8 warps are QB / 32 along the queries and RB / 32 along the
// rows.
enum TileId { k32x256 = 0, k64x128 = 1 };

template <int QB>
struct Tile {
  static constexpr int kRB = 8192 / QB;
  static constexpr int kWR = kRB / 32;     // warps along the rows
  static constexpr int kWords = kRB / 32;  // candidate words per query
  static_assert((QB / 32) * kWR == kWarps, "8 warps of 32 x 32");
};

// Element e of a 16-byte piece of T as f32 (int8: dequantized by aff).
template <typename T>
__device__ __forceinline__ float piece_at(const uint4& u, int e, Affine aff) {
  if constexpr (sizeof(T) == 1) {
    const int h = e >> 2;
    const unsigned w = h == 0 ? u.x : (h == 1 ? u.y : (h == 2 ? u.z : u.w));
    const int c = static_cast<signed char>((w >> (8 * (e & 3))) & 0xffu);
    return __fmul_rn(__fadd_rn(static_cast<float>(c), aff.off), aff.scale);
  } else if constexpr (sizeof(T) == 4) {
    const unsigned w = e == 0 ? u.x : (e == 1 ? u.y : (e == 2 ? u.z : u.w));
    return __uint_as_float(w);
  } else {
    const int h = e >> 1;
    const unsigned w = h == 0 ? u.x : (h == 1 ? u.y : (h == 2 ? u.z : u.w));
    const unsigned short b = static_cast<unsigned short>((e & 1) ? w >> 16 : w & 0xffffu);
    if constexpr (std::is_same_v<T, __half>) {
      return __half2float(__ushort_as_half(b));
    } else {
      return __uint_as_float(static_cast<unsigned>(b) << 16);
    }
  }
}

// The 16-byte piece of a row at p, dims c0.. of d (16 / sizeof(T) of
// them; zeros past d, or all zeros when !in). vec: d * sizeof(T) % 16 == 0
// and an aligned corpus, so the piece is wholly inside d or past it.
template <typename T>
__device__ __forceinline__ uint4 load_piece(const T* __restrict__ p, bool in,
                                            int64_t c0, int64_t d, bool vec) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  if (vec) {
    return in && c0 < d ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
  }
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (in && c0 + e < d) {
      unsigned bits;
      if constexpr (sizeof(T) == 4) {
        bits = __float_as_uint(__ldg(reinterpret_cast<const float*>(p) + e));
      } else if constexpr (sizeof(T) == 1) {
        bits = __ldg(reinterpret_cast<const unsigned char*>(p) + e);
      } else {
        bits = __ldg(reinterpret_cast<const unsigned short*>(p) + e);
      }
      w[e * sizeof(T) / 4] |= bits << (8 * ((e * sizeof(T)) % 4));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The chunks in shared memory are dim-major, [kBK][rows], with the column
// of dim c XOR-swizzled by swz(c) (bits 3-4): the staging stores of a warp
// (8 or 16 consecutive rows x the 4 or 2 pieces of a chunk row) then hit 32
// distinct banks, and the compute loads, 16 bytes of 4 consecutive columns
// each, stay 16-byte aligned and within one 32-column block.
__host__ __device__ constexpr int swz(int c) { return ((c >> 2) & 3) << 3; }

// Shared memory of one scan block: two chunks of the queries and of the
// corpus (both f32, dim-major), the bars, the score tile, the warps' votes,
// then per query the buffer and its fill, and the list (none for BIG_K).
template <int QB>
__host__ __device__ constexpr size_t operand_bytes() {
  return 2 * static_cast<size_t>(kBK) * (QB + Tile<QB>::kRB) * sizeof(float);
}
template <int QB, bool BIG_K>
__host__ __device__ constexpr size_t scan_smem(int k) {
  constexpr int RB = Tile<QB>::kRB;
  return operand_bytes<QB>() + 4 * 32 * kWarps +
         static_cast<size_t>(QB) *
             (8 + 4 * RB + 8 * kBuf + 4 + (BIG_K ? 0 : 8 * static_cast<size_t>(k)));
}

template <typename T, int QB, bool BIG_K>
__global__ void __launch_bounds__(kThreads, 2)
    scan_kernel(const float* __restrict__ q, const T* __restrict__ db,
                const float* __restrict__ norms,
                const float* __restrict__ mask, int64_t nq, int64_t n,
                int64_t d, int64_t num_valid, int k, int topk, int metric,
                int64_t rows_per_split, int splits, int lists, int vec, Affine aff,
                float* __restrict__ part_s, int* __restrict__ part_i,
                unsigned long long* __restrict__ slots,
                const float* __restrict__ seed_s, const int* __restrict__ seed_i,
                int kseed, int seed_mul, int excl) {
  // BIG_K: k is the length of each split's list, which lives in part_*
  // ([nq, lists, k]: the splits' lists, then the seed's); topk is the k
  // asked for. slots ([nq, splits]) holds the group bars' keys
  // (select.cuh). aff: the int8 corpus's dequantization. seed_* (may be
  // null): the seed whose floor starts each query's bar (select.cuh's
  // seed_floor); excl > 0: rows r with r % excl == 0 never score.
  using TL = Tile<QB>;
  constexpr int RB = TL::kRB;
  constexpr int kWords = TL::kWords;
  constexpr int kPerWarp = QB / kWarps;  // queries a warp selects for
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [2][kBK][QB] query chunks
  float* xs = qs + 2 * kBK * QB;                    // [2][kBK][RB] corpus chunks
  auto* bar = reinterpret_cast<unsigned long long*>(
      smem_raw + operand_bytes<QB>());                         // [QB]
  float* sc = reinterpret_cast<float*>(bar + QB);            // [QB][RB]
  unsigned* votes = reinterpret_cast<unsigned*>(sc + QB * RB);  // [kWarps][32]
  float* bs = reinterpret_cast<float*>(votes + kWarps * 32);  // [QB][kBuf]
  int* bi = reinterpret_cast<int*>(bs + QB * kBuf);
  int* bc = bi + QB * kBuf;                                  // [QB]
  float* cs = reinterpret_cast<float*>(bc + QB);             // [QB][k]
  int* ci = reinterpret_cast<int*>(cs + (BIG_K ? 0 : QB * k));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * QB;
  const int split = blockIdx.y;
  // Rows are below 2^31 (the wrapper checks N).
  const int row_begin = static_cast<int>(split * rows_per_split);
  const int row_end = static_cast<int>(min64(n, row_begin + rows_per_split));
  const int valid_end = static_cast<int>(min64(num_valid, row_end));
  const bool xvec = vec & 1;
  const bool qvec = vec & 2;  // d % 4 == 0 and aligned queries

  auto list_s = [&](int qq) {
    return BIG_K ? part_s + ((q0 + qq) * lists + split) * k : cs + qq * k;
  };
  auto list_i = [&](int qq) {
    return BIG_K ? part_i + ((q0 + qq) * lists + split) * k : ci + qq * k;
  };
  if (BIG_K) {
    for (int64_t e = tid; e < static_cast<int64_t>(QB) * k; e += kThreads) {
      const int qq = static_cast<int>(e / k);
      if (q0 + qq < nq) {
        list_s(qq)[e % k] = -CUDART_INF_F;
        list_i(qq)[e % k] = kSentinel;
      }
    }
  } else {
    for (int e = tid; e < QB * k; e += kThreads) {
      cs[e] = -CUDART_INF_F;
      ci[e] = kSentinel;
    }
  }
  for (int e = tid; e < QB; e += kThreads) {
    bar[e] = q0 + e < nq ? seed_floor(seed_s, seed_i, kseed, seed_mul, q0 + e, topk) : 0ull;
    bc[e] = 0;
  }

  // Staging: a chunk row of the corpus is XP 16-byte pieces (XE elements
  // each), of a query 4 pieces; thread t copies corpus pieces t + 256 i and
  // query piece t (t < 4 QB), so a warp reads whole chunk rows (coalesced),
  // and stores them transposed.
  constexpr int XP = static_cast<int>(sizeof(T));
  constexpr int XE = 16 / XP;
  constexpr int NPX = RB * XP / kThreads;
  const bool q_stages = tid < QB * 4;
  const int qr = tid >> 2;
  const int qp = tid & 3;
  const bool q_in = q_stages && q0 + qr < nq;
  const float* qrow = q + (q_in ? q0 + qr : 0) * d + 4 * qp;
  uint4 xraw[NPX];
  float4 qraw;
  auto load_step = [&](int t0, int d0) {
#pragma unroll
    for (int i = 0; i < NPX; ++i) {
      const int f = tid + kThreads * i;
      const int row = t0 + f / XP;
      const int c0 = d0 + (f % XP) * XE;
      const bool in = row < row_end;
      xraw[i] = load_piece<T>(db + static_cast<int64_t>(in ? row : 0) * d + c0, in, c0, d,
                              xvec);
    }
    const int64_t c = d0 + 4 * qp;
    if (qvec) {  // c % 4 == 0 and d % 4 == 0: the 4 dims are in or past d
      qraw = q_in && c < d ? __ldg(reinterpret_cast<const float4*>(qrow + d0))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      qraw.x = q_in && c < d ? __ldg(qrow + d0) : 0.f;
      qraw.y = q_in && c + 1 < d ? __ldg(qrow + d0 + 1) : 0.f;
      qraw.z = q_in && c + 2 < d ? __ldg(qrow + d0 + 2) : 0.f;
      qraw.w = q_in && c + 3 < d ? __ldg(qrow + d0 + 3) : 0.f;
    }
  };
  auto store_step = [&](int buf) {
    float* xb = xs + buf * kBK * RB;
#pragma unroll
    for (int i = 0; i < NPX; ++i) {
      const int f = tid + kThreads * i;
      const int r = f / XP;
      const int p = f % XP;
#pragma unroll
      for (int e = 0; e < XE; ++e) {
        const int c = p * XE + e;
        xb[c * RB + (r ^ swz(c))] = piece_at<T>(xraw[i], e, aff);
      }
    }
    if (q_stages) {
      float* qb = qs + buf * kBK * QB;
      const float v[4] = {qraw.x, qraw.y, qraw.z, qraw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = qp * 4 + e;
        qb[c * QB + (qr ^ swz(c))] = v[e];
      }
    }
  };

  // Thread (warp, lane) owns queries wq*32 + 16h + 4qg + i and tile rows
  // wr*32 + 4rg + j (h < 2; i, j < 4): per dim one 16-byte load of its rows
  // and two of its queries (8 or 4 distinct 16-byte words a warp, in one
  // 128-byte line) feed 32 FFMAs.
  const int wq = warp / TL::kWR;
  const int wr = warp % TL::kWR;
  const int qg = lane >> 3;
  const int rg = lane & 7;
  const int nchunks = static_cast<int>((d + kBK - 1) / kBK);
  if (row_begin < row_end) {
    load_step(row_begin, 0);
    store_step(0);
  }
  __syncthreads();

  const int place = bar_place(splits, topk);
  int buf = 0;
  for (int t0 = row_begin; t0 < row_end; t0 += RB) {
    float acc[kTQ][kTR];
#pragma unroll
    for (int a = 0; a < kTQ; ++a)
#pragma unroll
      for (int b = 0; b < kTR; ++b) acc[a][b] = 0.f;
    const int r0 = t0 + wr * 32 + 4 * rg;  // row j of this thread is r0 + j
    float nrm[kTR];
    unsigned live = 0;  // bit j: row r0 + j scores
    for (int c = 0; c < nchunks; ++c) {
      const bool last = c + 1 == nchunks;
      if (last) {  // the epilogue's loads, in flight during this chunk
#pragma unroll
        for (int b = 0; b < kTR; ++b) {
          const int row = r0 + b;
          const bool in = row < valid_end;
          nrm[b] = in ? __ldg(norms + row) : 0.f;
          live |= (in && (mask == nullptr || __ldg(mask + row) != 0.f) &&
                   (excl == 0 || row % excl != 0))
                  << b;
        }
      }
      const bool more = !last || t0 + RB < row_end;
      if (more) {  // the next chunk's loads, in flight during this one
        load_step(last ? t0 + RB : t0, last ? 0 : (c + 1) * kBK);
      }
      const float* qb = qs + buf * kBK * QB + wq * 32;
      const float* xb = xs + buf * kBK * RB + wr * 32;
#pragma unroll
      for (int cc = 0; cc < kBK; ++cc) {
        const float4 qa =
            *reinterpret_cast<const float4*>(qb + cc * QB + ((4 * qg) ^ swz(cc)));
        const float4 qh =
            *reinterpret_cast<const float4*>(qb + cc * QB + ((4 * qg + 16) ^ swz(cc)));
        const float4 xv = *reinterpret_cast<const float4*>(xb + cc * RB + ((4 * rg) ^ swz(cc)));
        const float qv[kTQ] = {qa.x, qa.y, qa.z, qa.w, qh.x, qh.y, qh.z, qh.w};
        const float xw[kTR] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int a = 0; a < kTQ; ++a)
#pragma unroll
          for (int b = 0; b < kTR; ++b) acc[a][b] = fmaf(qv[a], xw[b], acc[a][b]);
      }
      if (more) store_step(buf ^ 1);
      if (!last) {
        __syncthreads();  // the next chunk is in place; this one is done with
        buf ^= 1;
      }
    }

    // Epilogue and masks: each dot goes against its query's bar score (a
    // float compare; select_tile applies the exact rank rule to the few
    // that pass), a passing score goes to its bit's slot of the score tile,
    // and the warp's 32 votes go to shared memory as they are, lane 4a + j
    // holding the vote of query a, row j. The group slots' loads for the
    // selection go first.
    unsigned long long group[kPerWarp];
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int64_t gq = q0 + warp + kWarps * j;
      group[j] = gq < nq ? group_slot(slots, gq, split, splits, topk, lane) : ~0ull;
    }
    float inv[kTR];
    if (metric == kCosine) {
#pragma unroll
      for (int j = 0; j < kTR; ++j) inv[j] = 1.0f / sqrtf(fmaxf(nrm[j], 1e-30f));
    }
    unsigned my_vote = 0;
#pragma unroll
    for (int a = 0; a < kTQ; ++a) {
      const int qq = wq * 32 + 16 * (a >> 2) + 4 * qg + (a & 3);
      float bs_q;
      int bi_q;
      unrank(bar[qq], bs_q, bi_q);
      if (q0 + qq >= nq) bs_q = CUDART_INF_F;  // nothing passes
#pragma unroll
      for (int j = 0; j < kTR; ++j) {
        float s = acc[a][j];
        if (metric == kL2) {
          s = 2.0f * s - nrm[j];
        } else if (metric == kCosine) {
          s = s * inv[j];
        }
        const bool pass = ((live >> j) & 1u) && s >= bs_q;
        if (pass) sc[qq * RB + wr * 32 + 8 * j + rg] = s;
        const unsigned vote = __ballot_sync(kFull, pass);
        if (lane == 4 * a + j) my_vote = vote;
      }
    }
    votes[warp * 32 + lane] = my_vote;
    __syncthreads();  // the tile's candidates are complete

#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int qq = warp + kWarps * j;
      if (q0 + qq >= nq) break;  // the same in every lane
      // Word w of query qq (rows 32w + 4rg + j of the tile, bit 8j + rg):
      // byte qg of the votes of warp (qq / 32, w) for query a, rows j.
      const int wq_q = qq >> 5;
      const int a_q = 4 * ((qq >> 4) & 1) + (qq & 3);
      const int qg_q = (qq >> 2) & 3;
      select_tile(
          sc + qq * RB,
          [&](int w) {
            const unsigned* v = votes + (wq_q * TL::kWR + w) * 32 + 4 * a_q;
            unsigned word = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) word |= ((v[j] >> (8 * qg_q)) & 0xffu) << (8 * j);
            return word;
          },
          kWords, [&](int b) { return t0 + (b & ~31) + 4 * (b & 7) + ((b >> 3) & 3); },
          list_s(qq), list_i(qq), k, bs + qq * kBuf, bi + qq * kBuf, bc + qq,
          bar + qq, group[j],
          slots == nullptr ? nullptr : slots + (q0 + qq) * splits + split,
          place, lane);
    }
    // The next tile's epilogue rewrites the score tile and the votes after
    // at least one chunk barrier when a tile has two chunks or more, so a
    // warp's selection overlaps the other warps' next FFMAs; with one chunk
    // a barrier keeps them apart. (The bars may be read while a selecting
    // lane raises them: a stale bar only lets more rows through.)
    if (nchunks == 1) __syncthreads();
    buf ^= 1;
  }

  for (int j = 0; j < kPerWarp; ++j) {  // the buffers' last entries
    const int qq = warp + kWarps * j;  // its own warp's queries: no barrier
    if (q0 + qq < nq && bc[qq] > 0) {
      flush_buffer(list_s(qq), list_i(qq), k, bs + qq * kBuf, bi + qq * kBuf,
                   bc[qq], lane);
    }
  }
  if (BIG_K) return;
  __syncthreads();
  for (int e = tid; e < QB * k; e += kThreads) {
    const int qq = e / k;
    const int64_t gq = q0 + qq;
    if (gq < nq) {
      const int64_t o = (gq * lists + split) * k + e % k;
      part_s[o] = cs[e];
      part_i[o] = ci[e];
    }
  }
}


template <typename T, int QB>
Variant variant_of(int k, int big_k) {
  return big_k ? Variant{reinterpret_cast<const void*>(scan_kernel<T, QB, true>),
                         scan_smem<QB, true>(k)}
               : Variant{reinterpret_cast<const void*>(scan_kernel<T, QB, false>),
                         scan_smem<QB, false>(k)};
}

template <typename T>
Variant variant_t(int tile, int k, int big_k) {
  switch (tile) {
    case k32x256:
      return variant_of<T, 32>(k, big_k);
#ifdef MVT_K1_ALL_TILES
    case k64x128:
      return variant_of<T, 64>(k, big_k);
#endif
    default:
      return Variant{nullptr, 0};
  }
}

Variant variant(int db_dtype, int tile, int k, int big_k) {
  switch (db_dtype) {
    case kF32:
      return variant_t<float>(tile, k, big_k);
    case kF16:
      return variant_t<__half>(tile, k, big_k);
    case kBF16:
      return variant_t<__nv_bfloat16>(tile, k, big_k);
    case kI8Affine:
      return variant_t<int8_t>(tile, k, big_k);
    default:
      return Variant{nullptr, 0};
  }
}

int tile_queries(int tile) { return tile == k32x256 ? 32 : 64; }

}  // namespace

extern "C" {

// Launch the scan and the merge on `stream`. Returns the cudaError_t of the
// launches (0 on success). `mask` may be null. For k <= 256 the caller
// allocates part_* as [nq, lists, k] (list_len = k); above, as [nq,
// lists, list_len], lists = splits + nseed. With `tree` (always above
// k = 256) part_* and tmp_* are as large as every level of the merge tree
// needs (ops/select.py::merge_scratch) and the tree folds the lists; else
// warp_merge_kernel does (lists <= 512) and tmp_* is unused. slots is [nq,
// splits] zeros (the group bars, select.cuh). out_* are [nq, k]. `tile` is
// a TileId. db_dtype kI8Affine: int8 codes read as (c + aff_off) *
// aff_scale. The seed (seed_s / seed_i [nq, kseed], null for none; indices
// times seed_mul) starts every bar at its floor and enters the fold as the
// last nseed lists; excl > 0 leaves rows r % excl == 0 out of the scan.
int mvt_fused_topk(const float* q, const void* db, int db_dtype,
                   float aff_off, float aff_scale,
                   const float* norms, const float* mask, int64_t nq,
                   int64_t n, int64_t d, int64_t num_valid, int k, int metric,
                   int tile, int splits, int64_t rows_per_split, int list_len,
                   int tree,
                   float* part_s, int* part_i,
                   unsigned long long* slots, float* tmp_s, int* tmp_i,
                   float* out_s, int* out_i, const float* seed_s,
                   const int* seed_i, int kseed, int seed_mul, int nseed,
                   int excl, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int big_k = k > kMaxK;
  int kl = big_k ? list_len : k;
  const Variant v = variant(db_dtype, tile, kl, big_k);
  cudaError_t err = prepare(v);
  if (err != cudaSuccess) return err;
  const size_t esz = db_dtype == kF32 ? 4 : (db_dtype == kI8Affine ? 1 : 2);
  Affine aff{aff_off, aff_scale};
  int vec = ((d * esz) % 16 == 0 && reinterpret_cast<uintptr_t>(db) % 16 == 0 ? 1 : 0) |
            ((d * 4) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 ? 2 : 0);
  int lists = splits + (seed_s != nullptr ? nseed : 0);
  err = seed_lists(seed_s, seed_i, kseed, seed_mul, nq, lists, splits, kl, part_s,
                   part_i, st);
  if (err != cudaSuccess) return err;
  void* args[] = {&q,     &db,    &norms,         &mask,   &nq,
                  &n,     &d,     &num_valid,     &kl,     &k,
                  &metric, &rows_per_split, &splits, &lists, &vec, &aff, &part_s,
                  &part_i, &slots, &seed_s, &seed_i, &kseed, &seed_mul, &excl};
  const int qb = tile_queries(tile);
  const dim3 grid(static_cast<unsigned>((nq + qb - 1) / qb),
                  static_cast<unsigned>(splits));
  err = cudaLaunchKernel(v.fn, grid, dim3(kThreads), args, v.smem, st);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (big_k || tree) {
    return merge_tree(part_s, part_i, tmp_s, tmp_i, nq, lists, kl, k,
                      nullptr, 0, out_s, out_i, st);
  }
  return warp_merge(part_s, part_i, nq, k, lists, out_s, out_i, st);
}

// Scan blocks that fit on one SM at once for this corpus dtype, tile, list
// length and variant, written to *blocks_per_sm; returns the cudaError_t
// (cudaErrorInvalidValue for a tile this build lacks).
int mvt_fused_topk_occupancy(int db_dtype, int tile, int k, int big_k,
                             int* blocks_per_sm) {
  return occupancy(variant(db_dtype, tile, k, big_k), kThreads, blocks_per_sm);
}

const char* mvt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
