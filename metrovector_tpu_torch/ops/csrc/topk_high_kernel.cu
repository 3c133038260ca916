// Fused distance + top-k at precision "high" for Hopper (sm_90a): the f32
// operands split into bf16 pairs and multiplied on the tensor cores.
//
// Replaces the bf16x3 branch of the Pallas kernel
// metrovector_tpu/ops/topk_kernel.py::fused_topk (`_make_kernel`,
// :615-637). It computes what that branch computes: for every f32 operand v
//
//   v_hi = bf16_rn(v),   v_lo = bf16_rn(v - f32(v_hi))
//   q.x  ~ q_hi.x_hi + q_hi.x_lo + q_lo.x_hi      (products exact, f32 sums)
//
// then the metric epilogue, masks and top-k of topk_kernel.cu:
//
//   score(q, x) = L2:      2 q.x - |x|^2
//                 cosine:  q.x * 1/sqrt(max(|x|^2, 1e-30))   (q pre-normalized)
//                 IP:      q.x
//   rows >= num_valid and rows with valid_mask == 0 score -inf; per query
//   the k best (score descending, index ascending); -inf slots carry -1.
//
// What bounds it on an H100: three bf16 products of Q x N x D, 6 Q N D
// operations, against the f32 corpus read once. At batch 256 over 1M x 960
// that is 1.47e12 operations, 1.49 ms at the 989 TFLOP/s dense bf16 rate,
// and 3.84 GB, 1.15 ms at 3.35 TB/s; at 1M x 128, 0.199 and 0.153 ms. The
// FFMA kernel (topk_kernel.cu) serves "highest": TF32 or bf16 products there
// would break its exactness contract. The design:
//
// * A first pass (split_queries_kernel) splits each query once per call
//   into [Q][ceil(D/16)] chunks of 16 hi and 16 lo bf16 in the order the
//   fragments below take them; dims past D are zeros.
// * The scan (high_scan_kernel), grid (ceil(Q/64), S), 8 warps. A block owns
//   QB = 64 queries and walks its split's rows in tiles of RB = 128, 16 dims
//   (one mma k step) a chunk. The blocks of one split are launched side by
//   side, so the corpus comes from device memory about once and from L2 for
//   the other query tiles. cp.async copies each chunk of f32 rows and of
//   split queries into a ring of NS = 3 stages in shared memory, two chunks
//   ahead across tile boundaries (no registers held, one barrier a chunk).
//   Any D takes the same kernel.
// * mma.sync.m16n8k16 (bf16 in, f32 accumulate): rows are M, queries are N.
//   Warp w owns tile rows 16 w .. + 15 and all 64 queries (8 n-tiles). Each
//   lane loads its 8 f32 values of the row fragment (four 8-byte loads; the
//   rows' 16-byte pieces are XOR-swizzled so that a half-warp hits 32
//   banks) and splits them in registers (packed cvt.rn.bf16x2), so every
//   element is split once a query tile; a query fragment (hi and lo) is one
//   16-byte load. x_hi q_hi accumulates in one register set, x_lo q_hi +
//   x_hi q_lo in another, ~2^-8 as large: the truncating tensor-core adds
//   of the big sum are not repeated for the small terms
//   (engine.py::SearchEngine._verify_eps derives the bound).
// * Selection as in topk_kernel.cu (select.cuh): each query's bar is the
//   larger of its list's k-th entry and the group bar shared by the splits
//   through slots [Q, S]. After a tile's last chunk each dot goes against
//   its query's bar score; a passing score goes to the score tile and its
//   bit into the query's candidate words (shared-memory atomicOr); one warp
//   per query then runs select_tile and clears its words, while the next
//   tile's chunks are in flight. Lists of k <= 128 live in shared memory;
//   above (BIG_K) each split's list of L = min(k, rows per split) entries
//   lives in the [Q, S, L] scratch. Up to k = 22 two blocks fit on an SM.
// * The grid holds about one wave (S from the occupancy the runtime
//   reports). Pass 2 merges the S sorted lists: merge_kernel (select.cuh),
//   one block per query, for k <= 128 (up to 64 splits, or k <= 32), else
//   the merge tree.
//
// Built without --use_fast_math: the split must not flush subnormals
// (v - f32(v_hi) is subnormal for small v). Row offsets are 64-bit. The
// corpus and queries are f32. Limits: 1 <= k <= N < 2^31, S <= 512; the
// Python wrapper checks them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "scan_common.cuh"
#include "select.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kQB = 64;               // queries per block
constexpr int kRB = 128;              // rows per tile: 16 a warp
constexpr int kBK = 16;               // dims per chunk: one mma k step
constexpr int kNS = 3;                // stages of the cp.async ring
constexpr int kWords = kRB / 32;      // candidate words per query and tile
constexpr int kPerWarp = kQB / kWarps;  // queries a warp selects for
constexpr int kNT = kQB / 8;          // n-tiles of a warp
constexpr int kMaxK = 128;            // lists in shared memory up to this k
// A stage: the rows' chunk, [kRB][kBK] f32, then the queries' split chunk,
// [kQB][16] words; 16 32-bit words a row either way.
constexpr int kStageWords = (kRB + kQB) * 16;
static_assert(kQB * 4 == kThreads, "one 16-byte query piece a thread");

enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };  // DistanceMetric values

__device__ __forceinline__ unsigned bf2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<unsigned*>(&h);
}

// The hi and lo words of the pair (a, b): a in the low half, as mma reads.
__device__ __forceinline__ void split_pair(float a, float b, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf2_bits(h);
  lo = bf2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// c += a b on the tensor cores: a is the 16 x 16 row fragment (4 words), b
// the 16 x 8 query fragment (2 words), c the 16 x 8 f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16-byte piece p (dims 4p .. 4p + 3 of a chunk) of stage row r sits at
// piece p ^ swz(r): a half-warp's 8-byte fragment loads (rows g = 0..3 of
// an 8-row group, pieces t / 2 or 2 + t / 2) then hit 32 distinct banks.
__host__ __device__ constexpr int swz(int r) { return ((r >> 1) & 1) << 1; }

// One thread per (query, chunk): out [nq][nch][16 words]; for t = 0..3,
// words 4t .. 4t + 3 are hi(pair t), hi(pair t + 4), lo(pair t), lo(pair
// t + 4), pair p holding dims 2p, 2p + 1 of the chunk: one 16-byte load
// gives lane t of a quad its hi and lo query fragments.
__global__ void __launch_bounds__(kThreads)
    split_queries_kernel(const float* __restrict__ q, int64_t nq, int64_t d,
                         int nch, uint4* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= nq * nch) return;
  const int64_t c0 = (e % nch) * kBK;
  const float* row = q + (e / nch) * d + c0;
  float v[kBK];
#pragma unroll
  for (int i = 0; i < kBK; ++i) v[i] = c0 + i < d ? row[i] : 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    unsigned h0, l0, h1, l1;
    split_pair(v[2 * t], v[2 * t + 1], h0, l0);
    split_pair(v[2 * t + 8], v[2 * t + 9], h1, l1);
    out[e * 4 + t] = make_uint4(h0, h1, l0, l1);
  }
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
    high_scan_kernel(const uint4* __restrict__ qsplit, int nch,
                     const float* __restrict__ db,
                     const float* __restrict__ norms,
                     const float* __restrict__ mask, int64_t nq, int64_t n,
                     int64_t d, int64_t num_valid, int k, int topk, int metric,
                     int64_t rows_per_split, int splits, int vec,
                     float* __restrict__ part_s, int* __restrict__ part_i,
                     unsigned long long* __restrict__ slots) {
  // BIG_K: k is the length of each split's list, which lives in part_*;
  // topk is the k asked for. slots ([nq, splits]) holds the group bars'
  // keys (select.cuh).
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
  // split's rows or past D; the query piece tid (query tid / 4, 16 bytes t
  // = tid % 4 of its split chunk). vec: D % 4 == 0 and an aligned corpus,
  // so a piece is wholly inside D or past it; else 4 bytes at a time.
  const int64_t steps = static_cast<int64_t>((row_end - row_begin + kRB - 1) / kRB) * nch;
  const int qr = tid >> 2;
  const bool q_in = q0 + qr < nq;
  const uint4* qsrc = qsplit + (q_in ? q0 + qr : 0) * nch * 4 + (tid & 3);
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
        const int64_t c0 = d0 + 4 * p;
        const float* src = db + static_cast<int64_t>(in ? row : 0) * d + c0;
        unsigned* dst = st + r * 16 + 4 * (p ^ swz(r));
        if (vec) {
          cp_async<16>(dst, in && c0 < d ? src : db, in && c0 < d ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool ok = in && c0 + e < d;
            cp_async<4>(dst + e, ok ? src + e : db, ok ? 4 : 0);
          }
        }
      }
      cp_async<16>(st + kRB * 16 + tid * 4, q_in ? qsrc + (s % nch) * 4 : qsplit,
                   q_in ? 16 : 0);
    }
    cp_async_commit();  // one group a step, empty or not
  };

  // Lane (g, t) = (lane / 4, lane % 4) holds the dots of tile rows 16 warp
  // + g + 8 h and queries 8 nt + 2 t + e in element 2 h + e of acc[nt] (big
  // terms) and sml[nt] (small terms). n-tiles wholly past nq are skipped
  // (the same in the warp).
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ntiles = q0 >= nq ? 0 : static_cast<int>(min64(kNT, (nq - q0 + 7) / 8));
  const int ra = warp * 16 + g;  // rows ra and ra + 8 of each tile
  const int rb = ra + 8;
  // Word offsets in a stage of this lane's row values: rows ra (xa*) and rb
  // (xb*), dims 2t, 2t + 1 (x*0) and 2t + 8, 2t + 9 (x*1).
  const int xa0 = ra * 16 + 4 * ((t >> 1) ^ swz(ra)) + 2 * (t & 1);
  const int xa1 = ra * 16 + 4 * ((2 + (t >> 1)) ^ swz(ra)) + 2 * (t & 1);
  const int xb0 = rb * 16 + 4 * ((t >> 1) ^ swz(rb)) + 2 * (t & 1);
  const int xb1 = rb * 16 + 4 * ((2 + (t >> 1)) ^ swz(rb)) + 2 * (t & 1);
  for (int s = 0; s < kNS - 1; ++s) issue(s);

  const int place = bar_place(splits, topk);
  int64_t s = 0;
  for (int t0 = row_begin; t0 < row_end; t0 += kRB) {
    float acc[kNT][4], sml[kNT][4];
#pragma unroll
    for (int b = 0; b < kNT; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[b][e] = 0.f;
        sml[b][e] = 0.f;
      }
    float nrm[2];
    unsigned live = 0;  // bit h: row ra + 8 h of the tile scores
    for (int c = 0; c < nch; ++c, ++s) {
      if (c + 1 == nch) {  // the epilogue's loads, in flight during this chunk
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = t0 + ra + 8 * h;
          const bool in = row < valid_end;
          nrm[h] = in ? __ldg(norms + row) : 0.f;
          live |= (in && (mask == nullptr || __ldg(mask + row) != 0.f)) << h;
        }
      }
      cp_async_wait<kNS - 2>();  // this step's copies have landed
      __syncthreads();           // for every thread; the last stage is free
      issue(s + kNS - 1);
      const unsigned* st = ring + (s % kNS) * kStageWords;
      const float* xs = reinterpret_cast<const float*>(st);
      const float2 v0 = *reinterpret_cast<const float2*>(xs + xa0);
      const float2 v1 = *reinterpret_cast<const float2*>(xs + xb0);
      const float2 v2 = *reinterpret_cast<const float2*>(xs + xa1);
      const float2 v3 = *reinterpret_cast<const float2*>(xs + xb1);
      unsigned ah[4], al[4];
      split_pair(v0.x, v0.y, ah[0], al[0]);
      split_pair(v1.x, v1.y, ah[1], al[1]);
      split_pair(v2.x, v2.y, ah[2], al[2]);
      split_pair(v3.x, v3.y, ah[3], al[3]);
      const unsigned* qs = st + kRB * 16 + g * 16 + 4 * t;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        if (nt < ntiles) {
          const uint4 b = *reinterpret_cast<const uint4*>(qs + nt * 8 * 16);
          mma_bf16(acc[nt], ah, b.x, b.y);  // x_hi q_hi
          mma_bf16(sml[nt], al, b.x, b.y);  // x_lo q_hi
          mma_bf16(sml[nt], ah, b.z, b.w);  // x_hi q_lo
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
    float inv[2];
    if (metric == kCosine) {
#pragma unroll
      for (int h = 0; h < 2; ++h) inv[h] = 1.0f / sqrtf(fmaxf(nrm[h], 1e-30f));
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
          float sv = acc[nt][2 * h + e] + sml[nt][2 * h + e];
          if (metric == kL2) {
            sv = 2.0f * sv - nrm[h];
          } else if (metric == kCosine) {
            sv = sv * inv[h];
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

Variant variant(int k, int big_k) {
  return big_k ? Variant{reinterpret_cast<const void*>(high_scan_kernel<true>),
                         scan_smem<true>(k)}
               : Variant{reinterpret_cast<const void*>(high_scan_kernel<false>),
                         scan_smem<false>(k)};
}

}  // namespace

extern "C" {

// Split the queries into qsplit ([nq][ceil(d/16)][16] 32-bit words, the
// caller's scratch), then launch the scan and the merge on `stream`.
// Returns the cudaError_t of the launches (0 on success). `mask` may be
// null. For k <= 128 the caller allocates part_* as [nq, splits, k]
// (list_len = k); above, as [nq, splits, list_len]. With `tree` (always
// above k = 128) part_* and tmp_* are as large as every level of the merge
// tree needs (ops/select.py::merge_scratch) and the tree folds the lists;
// else merge_kernel does and tmp_* is unused. slots is [nq, splits] zeros
// (the group bars, select.cuh). out_* are [nq, k].
int mvt_fused_topk_high(const float* q, void* qsplit, const float* db,
                        const float* norms, const float* mask, int64_t nq,
                        int64_t n, int64_t d, int64_t num_valid, int k,
                        int metric, int splits, int64_t rows_per_split,
                        int list_len, int tree, float* part_s, int* part_i,
                        unsigned long long* slots, float* tmp_s, int* tmp_i,
                        float* out_s, int* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int big_k = k > kMaxK;
  int kl = big_k ? list_len : k;
  const Variant v = variant(kl, big_k);
  cudaError_t err = prepare(v);
  if (err != cudaSuccess) return err;
  int nch = static_cast<int>((d + kBK - 1) / kBK);
  const int64_t pieces = nq * nch;
  split_queries_kernel<<<static_cast<unsigned>((pieces + kThreads - 1) / kThreads),
                         kThreads, 0, st>>>(q, nq, d, nch, static_cast<uint4*>(qsplit));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const uint4* qs = static_cast<const uint4*>(qsplit);
  int vec = (d % 4 == 0 && reinterpret_cast<uintptr_t>(db) % 16 == 0) ? 1 : 0;
  void* args[] = {&qs,    &nch,    &db,   &norms, &mask,           &nq,
                  &n,     &d,      &num_valid, &kl, &k,            &metric,
                  &rows_per_split, &splits, &vec, &part_s, &part_i, &slots};
  const dim3 grid(static_cast<unsigned>((nq + kQB - 1) / kQB),
                  static_cast<unsigned>(splits));
  err = cudaLaunchKernel(v.fn, grid, dim3(kThreads), args, v.smem, st);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (big_k || tree) {
    return merge_tree(part_s, part_i, tmp_s, tmp_i, nq, splits, kl, k,
                      nullptr, 0, out_s, out_i, st);
  }
  merge_kernel<<<static_cast<unsigned>(nq), kMergeThreads, merge_smem_bytes(k),
                 st>>>(part_s, part_i, nq, k, splits, out_s, out_i);
  return cudaGetLastError();
}

// Scan blocks that fit on one SM at once for this list length and variant,
// written to *blocks_per_sm; returns the cudaError_t.
int mvt_fused_topk_high_occupancy(int k, int big_k, int* blocks_per_sm) {
  return occupancy(variant(k, big_k), kThreads, blocks_per_sm);
}

}  // extern "C"
