// Fused distance + top-k over an int8 corpus with int8 queries, for Hopper
// (sm_90a): exact integer dots on the tensor cores.
//
// Replaces the integer path of the Pallas kernel
// metrovector_tpu/ops/topk_kernel.py::fused_topk (`_make_kernel`,
// `int_path`: :610-614, the static scale :646-648, the uint8 offset bias
// :649-654, the deferred-scale inner product :696-705 and :722-736, chosen
// at :917-948). It computes what that path computes:
//
//   dot(q, x)   = f32(sum_d q_d x_d), the int32 sum exact, rounded once
//   s(q, x)     = dot * scale                       (not in deferred mode)
//                 + bias_scale * bias_row[x]        (uint8 offset spaces)
//                 each step rounded to f32, no fused multiply-add
//   score(q, x) = L2:     2 s - |x|^2
//                 cosine: s * 1/sqrt(max(|x|^2, 1e-30))   (q pre-normalized)
//                 IP:     s
//   rows >= num_valid and rows with valid_mask == 0 score -inf; per query
//   the k best (score descending, index ascending); -inf slots carry -1.
//   Deferred mode (int8 IP, no bias, scale > 0): the raw dots are ranked
//   and only the k outputs are multiplied by scale, so of two raw dots that
//   round to one scaled value the higher stays first.
//
// What bounds it on an H100: the corpus, one byte an element. At deep10m
// (10M x 96 codes, batch 128) that is 0.96 GB, 0.29 ms at 3.35 TB/s,
// against 2 Q N D = 0.25 T integer operations, 0.12 ms at the 1,979 TOPS
// dense int8 rate. The design:
//
// * Rows and queries may sit in wider rows (the engine's blocks are padded
//   to 128 dims): the kernel takes each one's row stride and reads only the
//   first D bytes of a row, zeros past D.
// * The scan (int_scan_kernel), grid (ceil(Q/64), S), 8 warps, on the
//   scaffold of topk_high_kernel.cu. A block owns QB = 64 queries and walks
//   its split's rows in tiles of RB = 128, 64 dims (two mma k steps) a
//   chunk. cp.async copies each chunk of rows and queries into a ring of
//   NS = 3 stages in shared memory, two chunks ahead across tile
//   boundaries; where D is not a multiple of 16 (or the corpus is not
//   16-byte aligned) the rows' bytes are loaded and stored one by one
//   instead, zeros past D. Any D takes the same kernel.
// * mma.sync.m16n8k32 (s8 in, s32 accumulate): rows are M, queries are N.
//   Warp w owns tile rows 16 w .. + 15 and all 64 queries (8 n-tiles). A
//   lane's fragments are 32-bit words; the 16-byte pieces of a 64-byte
//   stage row are XOR-swizzled by (row / 2) % 4, so that the 8 rows (or
//   queries) of a fragment load hit 32 distinct banks. The int32 sums are
//   exact for D < 2^17 (the wrapper checks).
// * Selection as in topk_kernel.cu (select.cuh): a per-query bar shared by
//   the splits through slots [Q, S], a float compare in the epilogue, the
//   exact rank rule in select_tile. Lists of k <= 128 live in shared
//   memory; above (BIG_K) each split's list of L = min(k, rows per split)
//   entries lives in the [Q, S, L] scratch.
// * Pass 2 merges the S sorted lists (merge_kernel, or the merge tree), then
//   in deferred mode scale_kernel multiplies the [Q, k] scores by scale.
//
// Row offsets are 64-bit. Limits: 1 <= k <= N < 2^31, S <= 512; the Python
// wrapper checks them.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "scan_common.cuh"
#include "select.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kQB = 64;                 // queries per block
constexpr int kRB = 128;                // rows per tile: 16 a warp
constexpr int kBK = 64;                 // dims (bytes) per chunk: two mma k steps
constexpr int kNS = 3;                  // stages of the cp.async ring
constexpr int kWords = kRB / 32;        // candidate words per query and tile
constexpr int kPerWarp = kQB / kWarps;  // queries a warp selects for
constexpr int kNT = kQB / 8;            // n-tiles of a warp
constexpr int kMaxK = 128;              // lists in shared memory up to this k
// A stage: the rows' chunk, [kRB][16] words, then the queries', [kQB][16].
constexpr int kStageWords = (kRB + kQB) * 16;
static_assert(kQB * 4 == kThreads, "one 16-byte query piece a thread");

enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };  // DistanceMetric values

// c += a b on the tensor cores: a is the 16 x 32 row fragment (4 words), b
// the 32 x 8 query fragment (2 words), c the 16 x 8 int32 accumulators.
__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The 16-byte piece p (bytes 16p .. 16p + 15 of a chunk) of stage row r sits
// at piece p ^ swz(r): a fragment load (word t of one piece, rows g = 0..7)
// then hits 32 distinct banks.
__host__ __device__ constexpr int swz(int r) { return (r >> 1) & 3; }

// Word w (bytes 4w .. 4w + 3) of stage row r.
__device__ __forceinline__ int word_at(int r, int w) {
  return r * 16 + 4 * ((w >> 2) ^ swz(r)) + (w & 3);
}

// Shared memory of one scan block: the ring, then the bars, the score tile,
// the candidate words, per query the buffer and its fill, and the list
// (none for BIG_K).
__host__ __device__ constexpr size_t ring_bytes() {
  return static_cast<size_t>(kNS) * kStageWords * sizeof(unsigned);
}
template <bool BIG_K>
__host__ __device__ constexpr size_t scan_smem(int k) {
  return ring_bytes() +
         static_cast<size_t>(kQB) *
             (8 + 4 * kRB + 4 * kWords + 8 * kBuf + 4 +
              (BIG_K ? 0 : 8 * static_cast<size_t>(k)));
}

template <bool BIG_K>
__global__ void __launch_bounds__(kThreads, 2)
    int_scan_kernel(const int8_t* __restrict__ q, int64_t qstride,
                    const int8_t* __restrict__ db, int64_t ldb,
                    const float* __restrict__ norms,
                    const float* __restrict__ mask,
                    const float* __restrict__ bias, float scale,
                    float bias_scale, int defer, int64_t nq, int64_t n,
                    int64_t d, int64_t num_valid, int k, int topk, int metric,
                    int64_t rows_per_split, int splits, int vec,
                    float* __restrict__ part_s, int* __restrict__ part_i,
                    unsigned long long* __restrict__ slots) {
  // BIG_K: k is the length of each split's list, which lives in part_*;
  // topk is the k asked for. slots ([nq, splits]) holds the group bars'
  // keys (select.cuh). q is [nq][qstride] bytes and db [n][ldb], of which
  // the first d of a row are read.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned* ring = reinterpret_cast<unsigned*>(smem_raw);  // [kNS][kStageWords]
  auto* bar = reinterpret_cast<unsigned long long*>(smem_raw + ring_bytes());
  float* sc = reinterpret_cast<float*>(bar + kQB);                 // [kQB][kRB]
  unsigned* cand = reinterpret_cast<unsigned*>(sc + kQB * kRB);    // [kQB][kWords]
  float* bs = reinterpret_cast<float*>(cand + kQB * kWords);       // [kQB][kBuf]
  int* bi = reinterpret_cast<int*>(bs + kQB * kBuf);
  int* bc = bi + kQB * kBuf;                                       // [kQB]
  float* cs = reinterpret_cast<float*>(bc + kQB);                  // [kQB][k]
  int* ci = reinterpret_cast<int*>(cs + (BIG_K ? 0 : kQB * k));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kQB;
  const int split = blockIdx.y;
  // Rows are below 2^31 (the wrapper checks N).
  const int row_begin = static_cast<int>(split * rows_per_split);
  const int row_end = static_cast<int>(min64(n, row_begin + rows_per_split));
  const int valid_end = static_cast<int>(min64(num_valid, row_end));

  auto list_s = [&](int qq) {
    return BIG_K ? part_s + ((q0 + qq) * splits + split) * k : cs + qq * k;
  };
  auto list_i = [&](int qq) {
    return BIG_K ? part_i + ((q0 + qq) * splits + split) * k : ci + qq * k;
  };
  if (BIG_K) {
    for (int64_t e = tid; e < static_cast<int64_t>(kQB) * k; e += kThreads) {
      const int qq = static_cast<int>(e / k);
      if (q0 + qq < nq) {
        list_s(qq)[e % k] = -CUDART_INF_F;
        list_i(qq)[e % k] = kSentinel;
      }
    }
  } else {
    for (int e = tid; e < kQB * k; e += kThreads) {
      cs[e] = -CUDART_INF_F;
      ci[e] = kSentinel;
    }
  }
  for (int e = tid; e < kQB; e += kThreads) {
    bar[e] = 0;
    bc[e] = 0;
  }
  for (int e = tid; e < kQB * kWords; e += kThreads) cand[e] = 0;

  // The copies of step s (tile s / nch, chunk s % nch) into stage s % kNS:
  // rows' pieces tid and tid + 256 (row f / 4, piece f % 4), zeros past the
  // split's rows or past D; the query piece tid (query tid / 4, piece tid %
  // 4), zeros past D (the queries' bytes past D up to a multiple of 16 are
  // zero). vec: D % 16 == 0 and aligned corpus rows, so a piece is wholly
  // inside D or past it (cp.async); else the bytes one by one, stored
  // directly (visible after the barriers that precede the stage's use).
  const int nch = static_cast<int>((d + kBK - 1) / kBK);
  const int64_t steps = static_cast<int64_t>((row_end - row_begin + kRB - 1) / kRB) * nch;
  const int qr = tid >> 2;
  const int qp = tid & 3;
  const bool q_in = q0 + qr < nq;
  const int8_t* qsrc = q + (q_in ? q0 + qr : 0) * qstride + 16 * qp;
  auto issue = [&](int64_t s) {
    if (s < steps) {
      unsigned* st = ring + (s % kNS) * kStageWords;
      const int t0 = row_begin + static_cast<int>(s / nch) * kRB;
      const int64_t d0 = static_cast<int64_t>(s % nch) * kBK;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int f = tid + kThreads * i;
        const int r = f >> 2;
        const int p = f & 3;
        const int row = t0 + r;
        const bool in = row < row_end;
        const int64_t c0 = d0 + 16 * p;
        const int8_t* src = db + static_cast<int64_t>(in ? row : 0) * ldb + c0;
        unsigned* dst = st + r * 16 + 4 * (p ^ swz(r));
        if (vec) {
          cp_async<16>(dst, in && c0 < d ? src : db, in && c0 < d ? 16 : 0);
        } else {
          unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            if (in && c0 + e < d) {
              w[e >> 2] |= static_cast<unsigned>(
                               __ldg(reinterpret_cast<const unsigned char*>(src) + e))
                           << (8 * (e & 3));
            }
          }
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      const bool q_rd = q_in && d0 + 16 * qp < d;
      cp_async<16>(st + kRB * 16 + qr * 16 + 4 * (qp ^ swz(qr)),
                   q_rd ? qsrc + d0 : q, q_rd ? 16 : 0);
    }
    cp_async_commit();  // one group a step, empty or not
  };

  // Lane (g, t) = (lane / 4, lane % 4) holds the dots of tile rows 16 warp
  // + g + 8 h and queries 8 nt + 2 t + e in element 2 h + e of acc[nt].
  // n-tiles wholly past nq are skipped (the same in the warp).
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ntiles = q0 >= nq ? 0 : static_cast<int>(min64(kNT, (nq - q0 + 7) / 8));
  const int ra = warp * 16 + g;  // rows ra and ra + 8 of each tile
  const int rb = ra + 8;
  for (int s = 0; s < kNS - 1; ++s) issue(s);

  const int place = bar_place(splits, topk);
  int64_t s = 0;
  for (int t0 = row_begin; t0 < row_end; t0 += kRB) {
    int acc[kNT][4];
#pragma unroll
    for (int b = 0; b < kNT; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][e] = 0;
    float nrm[2], brow[2];
    unsigned live = 0;  // bit h: row ra + 8 h of the tile scores
    for (int c = 0; c < nch; ++c, ++s) {
      if (c + 1 == nch) {  // the epilogue's loads, in flight during this chunk
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = t0 + ra + 8 * h;
          const bool in = row < valid_end;
          nrm[h] = in ? __ldg(norms + row) : 0.f;
          brow[h] = in && bias != nullptr ? __ldg(bias + row) : 0.f;
          live |= (in && (mask == nullptr || __ldg(mask + row) != 0.f)) << h;
        }
      }
      cp_async_wait<kNS - 2>();  // this step's copies have landed
      __syncthreads();           // for every thread; the last stage is free
      issue(s + kNS - 1);
      const unsigned* st = ring + (s % kNS) * kStageWords;
      const unsigned* qs = st + kRB * 16;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const unsigned a0 = st[word_at(ra, 8 * kk + t)];
        const unsigned a1 = st[word_at(rb, 8 * kk + t)];
        const unsigned a2 = st[word_at(ra, 8 * kk + 4 + t)];
        const unsigned a3 = st[word_at(rb, 8 * kk + 4 + t)];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          if (nt < ntiles) {
            const int qq = nt * 8 + g;
            mma_s8(acc[nt], a0, a1, a2, a3, qs[word_at(qq, 8 * kk + t)],
                   qs[word_at(qq, 8 * kk + 4 + t)]);
          }
        }
      }
    }

    // Epilogue and masks: each dot goes against its query's bar score (a
    // float compare; select_tile applies the exact rank rule to the few
    // that pass); a passing score goes to the score tile and its bit to the
    // query's candidate words. The group slots' loads go first.
    unsigned long long group[kPerWarp];
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int64_t gq = q0 + warp + kWarps * j;
      group[j] = gq < nq ? group_slot(slots, gq, split, splits, topk, lane) : ~0ull;
    }
    float inv[2], badd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      inv[h] = metric == kCosine ? 1.0f / sqrtf(fmaxf(nrm[h], 1e-30f)) : 0.f;
      badd[h] = __fmul_rn(bias_scale, brow[h]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qq = nt * 8 + 2 * t + e;
        float bs_q;
        int bi_q;
        unrank(bar[qq], bs_q, bi_q);
        if (q0 + qq >= nq) bs_q = CUDART_INF_F;  // nothing passes
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float sv = __int2float_rn(acc[nt][2 * h + e]);
          if (!defer) sv = __fmul_rn(sv, scale);
          if (bias != nullptr) sv = __fadd_rn(sv, badd[h]);
          if (metric == kL2) {
            sv = __fsub_rn(__fmul_rn(2.0f, sv), nrm[h]);
          } else if (metric == kCosine) {
            sv = __fmul_rn(sv, inv[h]);
          }
          if (((live >> h) & 1u) && sv >= bs_q) {
            const int rr = ra + 8 * h;
            sc[qq * kRB + rr] = sv;
            atomicOr(cand + qq * kWords + (rr >> 5), 1u << (rr & 31));
          }
        }
      }
    }
    __syncthreads();  // the tile's candidates are complete

#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int qq = warp + kWarps * j;
      if (q0 + qq >= nq) break;  // the same in every lane
      select_tile(
          sc + qq * kRB, [&](int w) { return cand[qq * kWords + w]; }, kWords,
          [&](int b) { return t0 + b; }, list_s(qq), list_i(qq), k,
          bs + qq * kBuf, bi + qq * kBuf, bc + qq, bar + qq, group[j],
          slots == nullptr ? nullptr : slots + (q0 + qq) * splits + split,
          place, lane);
      if (lane < kWords) cand[qq * kWords + lane] = 0;  // the word it read
    }
    // The next tile's epilogue rewrites the score tile and the candidate
    // words after the barrier of its first chunk, which waits for every
    // warp's selection. (The bars may be read while a selecting lane raises
    // them: a stale bar only lets more rows through.)
  }
  cp_async_wait<0>();  // the empty groups past the last step

  for (int j = 0; j < kPerWarp; ++j) {  // the buffers' last entries
    const int qq = warp + kWarps * j;  // its own warp's queries: no barrier
    if (q0 + qq < nq && bc[qq] > 0) {
      flush_buffer(list_s(qq), list_i(qq), k, bs + qq * kBuf, bi + qq * kBuf,
                   bc[qq], lane);
    }
  }
  if (BIG_K) return;
  __syncthreads();
  for (int e = tid; e < kQB * k; e += kThreads) {
    const int qq = e / k;
    const int64_t gq = q0 + qq;
    if (gq < nq) {
      const int64_t o = (gq * splits + split) * k + e % k;
      part_s[o] = cs[e];
      part_i[o] = ci[e];
    }
  }
}

// The deferred scale: out[e] *= scale over the [Q, k] scores (-inf stays).
__global__ void __launch_bounds__(kThreads)
    scale_kernel(float* __restrict__ out, int64_t count, float scale) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e < count) out[e] = __fmul_rn(out[e], scale);
}

Variant variant(int k, int big_k) {
  return big_k ? Variant{reinterpret_cast<const void*>(int_scan_kernel<true>),
                         scan_smem<true>(k)}
               : Variant{reinterpret_cast<const void*>(int_scan_kernel<false>),
                         scan_smem<false>(k)};
}

}  // namespace

extern "C" {

// Launch the scan, the merge and (defer) the scale on `stream`. Returns the
// cudaError_t of the launches (0 on success). q is [nq][qstride] int8 (q
// and qstride 16-byte aligned, zeros from d up to a multiple of 16); db is
// [n][ldb] int8 of which the first d of a row are read; `mask` and `bias`
// may be null.
// For k <= 128 the caller allocates part_* as [nq, splits, k] (list_len =
// k); above, as [nq, splits, list_len]. With `tree` (always above k = 128)
// part_* and tmp_* are as large as every level of the merge tree needs
// (ops/select.py::merge_scratch) and the tree folds the lists; else
// merge_kernel does and tmp_* is unused. slots is [nq, splits] zeros (the
// group bars, select.cuh). out_* are [nq, k].
int mvt_fused_topk_int(const int8_t* q, int64_t qstride, const int8_t* db,
                       int64_t ldb, const float* norms, const float* mask,
                       const float* bias, float scale, float bias_scale,
                       int defer, int64_t nq, int64_t n, int64_t d,
                       int64_t num_valid, int k, int metric, int splits,
                       int64_t rows_per_split, int list_len, int tree,
                       float* part_s, int* part_i, unsigned long long* slots,
                       float* tmp_s, int* tmp_i, float* out_s, int* out_i,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int big_k = k > kMaxK;
  int kl = big_k ? list_len : k;
  const Variant v = variant(kl, big_k);
  cudaError_t err = prepare(v);
  if (err != cudaSuccess) return err;
  int vec = (d % 16 == 0 && ldb % 16 == 0 &&
             reinterpret_cast<uintptr_t>(db) % 16 == 0) ? 1 : 0;
  void* args[] = {&q,     &qstride, &db, &ldb,  &norms,  &mask, &bias,
                  &scale, &bias_scale, &defer,  &nq,     &n,    &d,
                  &num_valid, &kl,  &k,         &metric, &rows_per_split,
                  &splits, &vec,    &part_s,    &part_i, &slots};
  const dim3 grid(static_cast<unsigned>((nq + kQB - 1) / kQB),
                  static_cast<unsigned>(splits));
  err = cudaLaunchKernel(v.fn, grid, dim3(kThreads), args, v.smem, st);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (big_k || tree) {
    err = merge_tree(part_s, part_i, tmp_s, tmp_i, nq, splits, kl, k, nullptr,
                     0, out_s, out_i, st);
  } else {
    merge_kernel<<<static_cast<unsigned>(nq), kMergeThreads, merge_smem_bytes(k),
                   st>>>(part_s, part_i, nq, k, splits, out_s, out_i);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || !defer) return err;
  const int64_t count = nq * k;
  scale_kernel<<<static_cast<unsigned>((count + kThreads - 1) / kThreads), kThreads,
                 0, st>>>(out_s, count, scale);
  return cudaGetLastError();
}

// Scan blocks that fit on one SM at once for this list length and variant,
// written to *blocks_per_sm; returns the cudaError_t.
int mvt_fused_topk_int_occupancy(int k, int big_k, int* blocks_per_sm) {
  return occupancy(variant(k, big_k), kThreads, blocks_per_sm);
}

}  // extern "C"
