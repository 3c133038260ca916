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
// would break its exactness contract. This replaces an mma.sync scan of
// 64-query tiles, which issued at 17.9 % of the bf16 rate and left half
// its n-tiles idle at batch 32. The design (wgmma_scan.cuh has the
// pipeline):
//
// * A first pass (split_queries_kernel) splits each query once per call
//   into its hi and lo bf16 halves, laid out per tile of QB = 2 NW queries
//   (NW in 16, 32, 64, from ops/topk_kernel.py::_high_shape: the tile
//   follows the batch, QB = 32 at batch 32) and per chunk of 32 dims as the
//   image a stage holds: QB rows of 64 bytes of hi, then of lo, in the
//   64-byte swizzle that wgmma reads. Dims past D and queries past nq are
//   zeros. Above 128 queries the tiles take their own blocks, two passes
//   at batch 256 whose blocks of one split run side by side, the second
//   reading the rows from L2: the bf16x3 state of 256 queries (two sets of
//   accumulators, the selection) does not fit one block beside the ring.
// * One block per split of rows and tile of queries. A stage holds 64 f32
//   rows x 32 dims, loaded by TMA with the 128-byte swizzle (zeros past D
//   and past N), and the chunk's query image, loaded by TMA's bulk copy.
// * wgmma.m64nNk16.f32.bf16.bf16 with the rows as A from registers and a
//   consumer warpgroup's NW queries as B from shared memory. Each consumer
//   thread reads its f32 row fragment from the stage and splits it in
//   registers (packed cvt.rn.bf16x2), once per warpgroup and stage, not
//   once per 64-query tile as before. x_hi q_hi accumulates in one register
//   set, x_lo q_hi + x_hi q_lo in another, ~2^-8 as large, one k step of
//   16 dims per wgmma as the mma.sync kernel did: the truncating adds of
//   the big sum are not repeated for the small terms, and the certificate
//   (engine.py::SearchEngine._verify_eps) models these steps as written.
// * Selection through wgmma_scan.cuh's warpgroup state and select.cuh, as
//   in topk_int_kernel.cu; lists of k <= 128 in shared memory where they
//   fit, else in the [Q, S, L] scratch. Pass 2 merges the S sorted lists:
//   warp_merge_kernel (scan_common.cuh), one warp per query, or the merge
//   tree.
//
// Built without --use_fast_math: the split must not flush subnormals
// (v - f32(v_hi) is subnormal for small v). The wrapper hands over a corpus
// whose row stride and base are 16-byte aligned (TMA's rule),
// copying it into zero-padded rows otherwise. Row offsets are 64-bit. The
// corpus and queries are f32. Limits: 1 <= k <= N < 2^31, S <= 512; the
// Python wrapper checks them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "scan_common.cuh"
#include "select.cuh"
#include "wgmma_scan.cuh"

namespace {

constexpr int kChunk = 32;                       // dims a stage: two k steps
constexpr int kRowTile = kScanRows * kChunk * 4;  // bytes of a stage's rows
constexpr int kHalfRow = kChunk * 2;             // bytes of a query's hi (or lo)

enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };  // DistanceMetric values

__host__ __device__ constexpr int stage_bytes(int qb) {
  return kRowTile + 2 * qb * kHalfRow;
}

__device__ __forceinline__ unsigned bf2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<unsigned*>(&h);
}

// The hi and lo words of the pair (a, b): a in the low half, as wgmma reads.
__device__ __forceinline__ void split_pair(float a, float b, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf2_bits(h);
  lo = bf2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

// One thread per (query of the padded tiles, chunk): writes the query's
// 16-byte pieces p = 0..3 (dims 8p .. 8p + 7 of the chunk) of hi and of lo
// into the chunk's image, out + (tile * nch + chunk) * qb * 128 bytes: hi
// rows at 0, lo rows at qb * 64; row r's piece p at 64 r + 16 (p ^ (r / 2 %
// 4)), TMA's 64-byte swizzle.
__global__ void __launch_bounds__(256)
    split_queries_kernel(const float* __restrict__ q, int64_t nq, int64_t d,
                         int nch, int qb, int64_t total,
                         unsigned char* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= total) return;
  const int64_t gq = e / nch;
  const int c = static_cast<int>(e % nch);
  const int64_t tile = gq / qb;
  const int r = static_cast<int>(gq % qb);
  const int64_t c0 = static_cast<int64_t>(c) * kChunk;
  const float* row = q + gq * d + c0;
  unsigned char* img = out + (tile * nch + c) * static_cast<int64_t>(qb) * 2 * kHalfRow;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    unsigned hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t a = 8 * p + 2 * i;
      const float va = gq < nq && c0 + a < d ? row[a] : 0.f;
      const float vb = gq < nq && c0 + a + 1 < d ? row[a + 1] : 0.f;
      split_pair(va, vb, hi[i], lo[i]);
    }
    const int at = r * kHalfRow + 16 * (p ^ ((r >> 1) & 3));
    *reinterpret_cast<uint4*>(img + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(img + qb * kHalfRow + at) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// The compare pass: element i's score (acc + sml, then the metric) replaces
// acc[i]; bit i where it reaches its query's bar and its row scores.
template <int NW, int METRIC>
__device__ __forceinline__ unsigned long long high_pass(float (&acc)[NW / 2],
                                                        const float (&sml)[NW / 2],
                                                        const float* thr, int lane,
                                                        unsigned live,
                                                        const float (&nrm)[2],
                                                        const float (&inv)[2]) {
  unsigned long long pass = 0;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const float2 b2 = *reinterpret_cast<const float2*>(thr + 8 * j + 2 * (lane & 3));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        float sv = acc[i] + sml[i];
        if (METRIC == kL2) {
          sv = 2.0f * sv - nrm[h];
        } else if (METRIC == kCosine) {
          sv = sv * inv[h];
        }
        acc[i] = sv;
        if ((live >> h) & 1u) {
          pass |= static_cast<unsigned long long>(sv >= (e ? b2.y : b2.x)) << i;
        }
      }
    }
  }
  return pass;
}

template <int NW>
__global__ void __launch_bounds__(kScanThreads, 1)
    high_scan_kernel(const unsigned char* __restrict__ qsplit,
                     const __grid_constant__ CUtensorMap rmap,
                     const float* __restrict__ norms,
                     const float* __restrict__ mask, int64_t nq, int64_t n, int nch,
                     int64_t num_valid, int k, int topk, int metric,
                     int64_t rows_per_split, int splits, int lists, int stages,
                     int big, float* __restrict__ part_s, int* __restrict__ part_i,
                     unsigned long long* __restrict__ slots,
                     const float* __restrict__ seed_s, const int* __restrict__ seed_i,
                     int kseed, int seed_mul, int excl) {
  // big: each split's list (length k) lives in part_* ([nq, lists, k]: the
  // splits' lists, then the seed's); topk is the k asked for. slots ([nq,
  // splits]) holds the group bars' keys (select.cuh). seed_* (may be null):
  // the seed whose floor starts each bar; excl > 0: rows r % excl == 0
  // never score.
  constexpr int QB = 2 * NW;
  constexpr int kImage = 2 * QB * kHalfRow;  // a chunk's query image
  extern __shared__ unsigned char smem_raw[];
  const int sb = stage_bytes(QB);
  const ScanSmem sm = scan_layout(smem_raw, sb, stages, 0, NW, big ? 0 : k);
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * QB;
  const int split = blockIdx.y;
  // Rows are below 2^31 (the wrapper checks N).
  const int row_begin = static_cast<int>(split * rows_per_split);
  const int row_end = static_cast<int>(min64(n, row_begin + rows_per_split));
  const int valid_end = static_cast<int>(min64(num_valid, row_end));
  const int tiles = (row_end - row_begin + kScanRows - 1) / kScanRows;
  const int consumers = q0 + NW < nq ? 2 : 1;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(sm.full + s, 1);
      mbar_init(sm.empty + s, 4 * consumers);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 256) {
      const unsigned char* images = qsplit + blockIdx.x * static_cast<int64_t>(nch) * kImage;
      int64_t step = 0;
      for (int t = 0; t < tiles; ++t) {
        for (int c = 0; c < nch; ++c, ++step) {
          const int s = static_cast<int>(step % stages);
          mbar_wait(sm.empty + s, static_cast<unsigned>((step / stages) & 1) ^ 1u);
          unsigned char* st = sm.ring + static_cast<size_t>(s) * sb;
          mbar_expect_tx(sm.full + s, sb);
          tma_load_2d(st, &rmap, sm.full + s, c * kChunk, row_begin + t * kScanRows);
          bulk_load(st + kRowTile, images + static_cast<int64_t>(c) * kImage, kImage,
                    sm.full + s);
        }
      }
    }
    return;
  }

  reg_alloc<kConsumerRegs>();
  if (wg >= consumers) return;  // no query of the tile left for it
  const int tw = threadIdx.x & 127;
  const int warp = tw >> 5;
  const int lane = tw & 31;
  const int bar_id = 1 + wg;
  WgSel S = sel_at(sm.sel[wg], NW, big ? 0 : k);
  S.q0 = q0 + wg * NW;
  S.nq_w = static_cast<int>(min64(NW, nq - S.q0));
  S.k = k;
  S.topk = topk;
  S.split = split;
  S.splits = splits;
  S.lists = lists;
  S.place = bar_place(splits, topk);
  S.big = big;
  S.int_bar = 0;
  S.part_s = part_s;
  S.part_i = part_i;
  S.slots = slots;
  S.seed_s = seed_s;
  S.seed_i = seed_i;
  S.kseed = kseed;
  S.seed_mul = seed_mul;
  sel_init(S, tw);
  wg_sync(bar_id);

  // Lane (g, t) = (lane / 4, lane % 4) holds the dots of tile rows r_lo =
  // 16 warp + g and r_lo + 8 with queries 8 j + 2 t + e in element 4 j + 2 h
  // + e of acc (big terms) and sml (small terms). Its row fragment of k step
  // kk: rows r_lo (words 0, 2) and r_lo + 8 (1, 3), dims 16 kk + 2 t, + 1
  // (0, 1) and + 8 (2, 3); dim d of row r sits at byte 128 r + 16 (d / 4 ^
  // r % 8) + 4 (d % 4) of the stage (TMA's 128-byte swizzle).
  const int r_lo = 16 * warp + (lane >> 2);
  const int g = lane >> 2;  // = r_lo % 8
  int frag[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r_lo + 8 * (i & 1);
      const int dd = 16 * kk + 2 * (lane & 3) + 8 * (i >> 1);
      frag[kk][i] = 128 * r + 16 * ((dd >> 2) ^ g) + 4 * (dd & 3);
    }
  }
  const int qoff = wg * NW * kHalfRow;  // the warpgroup's queries in an image
  float acc[NW / 2], sml[NW / 2];
  int64_t step = 0;
  for (int t = 0; t < tiles; ++t) {
    const int t0 = row_begin + t * kScanRows;
    if (t > 0 && t % kRefresh == 0) sel_refresh(S, warp, lane);
    float nrm[2];
    unsigned live = 0;  // bit h: row r_lo + 8 h of the tile scores
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the epilogue's loads, in flight meanwhile
      const int row = t0 + r_lo + 8 * h;
      const bool in = row < valid_end;
      nrm[h] = in && metric != kIP ? __ldg(norms + row) : 0.f;
      live |= static_cast<unsigned>(in && (mask == nullptr || __ldg(mask + row) != 0.f) &&
                                    (excl == 0 || row % excl != 0))
              << h;
    }
    for (int c = 0; c < nch; ++c, ++step) {
      const int s = static_cast<int>(step % stages);
      mbar_wait(sm.full + s, static_cast<unsigned>((step / stages) & 1));
      const unsigned char* st = sm.ring + static_cast<size_t>(s) * sb;
      const unsigned char* qhi = st + kRowTile + qoff;
      const unsigned char* qlo = qhi + QB * kHalfRow;
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = *reinterpret_cast<const float2*>(st + frag[kk][i]);
          split_pair(v.x, v.y, ah[kk][i], al[kk][i]);
        }
      }
      wgmma_fence();
      fence_regs(acc);
      fence_regs(sml);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int first = c == 0 && kk == 0;
        const uint64_t bhi = smem_desc(qhi + 32 * kk, kHalfRow);
        WgmmaBf16<NW>::mma(acc, ah[kk], bhi, !first);  // x_hi q_hi
        WgmmaBf16<NW>::mma(sml, al[kk], bhi, !first);  // x_lo q_hi
        WgmmaBf16<NW>::mma(sml, ah[kk], smem_desc(qlo + 32 * kk, kHalfRow), 1);  // x_hi q_lo
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(sml);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty + s);  // this warp is done with it
    }

    // Epilogue and masks: the compare pass (the scores kept in acc), then
    // the offers of what passed.
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      inv[h] = metric == kCosine ? 1.0f / sqrtf(fmaxf(nrm[h], 1e-30f)) : 0.f;
    }
    const unsigned long long pass =
        metric == kL2 ? high_pass<NW, kL2>(acc, sml, S.thr, lane, live, nrm, inv)
        : metric == kCosine ? high_pass<NW, kCosine>(acc, sml, S.thr, lane, live, nrm, inv)
                            : high_pass<NW, kIP>(acc, sml, S.thr, lane, live, nrm, inv);
    sel_epilogue<NW>(S, pass, warp, lane, t0 + r_lo, bar_id,
                     [&](int i) { return acc[i]; });
  }
  sel_finish(S, tw, bar_id);
}

const void* high_kernel(int nw) {
  switch (nw) {
    case 16: return reinterpret_cast<const void*>(high_scan_kernel<16>);
    case 32: return reinterpret_cast<const void*>(high_scan_kernel<32>);
    case 64: return reinterpret_cast<const void*>(high_scan_kernel<64>);
    default: return nullptr;
  }
}

Variant variant(int nw, int stages, int k_smem) {
  return Variant{high_kernel(nw), scan_smem(stage_bytes(2 * nw), stages, 0, nw, k_smem)};
}

}  // namespace

extern "C" {

// Split the queries into qsplit (the caller's scratch of ceil(nq / 2 nw)
// tiles x ceil(d / 32) chunks x 256 nw bytes), then launch the scan and the
// merge on `stream`. Returns the cudaError_t of the launches (0 on
// success). db is [n][ldb] f32 of which the first d of a row are read, its
// base and 4 ldb bytes multiples of 16; `mask` may be null. The tile takes
// 2 nw queries (nw in 16, 32, 64) and a ring of `stages` stages. With `big` the lists live in part_*, allocated as [nq,
// splits, list_len]; else in shared memory, part_* as [nq, splits, k]
// (list_len = k). With `tree` (always with big) part_* and tmp_* are as
// large as every level of the merge tree needs (ops/select.py::
// merge_scratch) and the tree folds the lists; else warp_merge_kernel does and
// tmp_* is unused. slots is [nq, splits] zeros (the group bars,
// select.cuh). out_* are [nq, k]. The seed and excl as for mvt_fused_topk
// (part_* then hold splits + nseed lists).
int mvt_fused_topk_high(const float* q, void* qsplit, const float* db,
                        int64_t ldb, const float* norms, const float* mask,
                        int64_t nq,
                        int64_t n, int64_t d, int64_t num_valid, int k,
                        int metric, int nw, int stages, int big, int splits,
                        int64_t rows_per_split, int list_len, int tree,
                        float* part_s, int* part_i, unsigned long long* slots,
                        float* tmp_s, int* tmp_i, float* out_s, int* out_i,
                        const float* seed_s, const int* seed_i, int kseed,
                        int seed_mul, int nseed, int excl, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int kl = big ? list_len : k;
  int nch = static_cast<int>((d + kChunk - 1) / kChunk);
  const Variant v = variant(nw, stages, big ? 0 : kl);
  cudaError_t err = prepare(v);
  if (err != cudaSuccess) return err;
  const int qb = 2 * nw;
  const int64_t tiles_q = (nq + qb - 1) / qb;
  const int64_t pieces = tiles_q * qb * nch;
  split_queries_kernel<<<static_cast<unsigned>((pieces + 255) / 256), 256, 0, st>>>(
      q, nq, d, nch, qb, pieces, static_cast<unsigned char*>(qsplit));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap rmap;
  err = tensor_map_2d(&rmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, db, d, n, 4 * ldb, kChunk,
                      kScanRows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const unsigned char* qs = static_cast<const unsigned char*>(qsplit);
  int lists = splits + (seed_s != nullptr ? nseed : 0);
  err = seed_lists(seed_s, seed_i, kseed, seed_mul, nq, lists, splits, kl, part_s,
                   part_i, st);
  if (err != cudaSuccess) return err;
  void* args[] = {&qs, &rmap, &norms, &mask, &nq, &n, &nch, &num_valid, &kl, &k,
                  &metric, &rows_per_split, &splits, &lists, &stages, &big,
                  &part_s, &part_i, &slots, &seed_s, &seed_i, &kseed, &seed_mul,
                  &excl};
  const dim3 grid(static_cast<unsigned>(tiles_q), static_cast<unsigned>(splits));
  err = cudaLaunchKernel(v.fn, grid, dim3(kScanThreads), args, v.smem, st);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (big || tree) {
    return merge_tree(part_s, part_i, tmp_s, tmp_i, nq, lists, kl, k,
                      nullptr, 0, out_s, out_i, st);
  }
  return warp_merge(part_s, part_i, nq, k, lists, out_s, out_i, st);
}

// Scan blocks of this shape that fit on one SM at once, written to
// *blocks_per_sm (k_smem: the lists' length, in shared memory unless big);
// returns the cudaError_t.
int mvt_fused_topk_high_occupancy(int nw, int stages, int k_smem, int big,
                                  int* blocks_per_sm) {
  return occupancy(variant(nw, stages, big ? 0 : k_smem), kScanThreads, blocks_per_sm);
}

// Dynamic shared memory of a scan block of this shape, for the wrapper's
// plan (ops/topk_kernel.py::_high_shape mirrors it).
long long mvt_fused_topk_high_smem(int nw, int stages, int k_smem) {
  return static_cast<long long>(variant(nw, stages, k_smem).smem);
}

}  // extern "C"
