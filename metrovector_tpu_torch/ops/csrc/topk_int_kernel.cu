// Fused distance + top-k in one pass on the tensor cores, for Hopper
// (sm_90a): int8 queries over an int8 corpus (exact integer dots), or bf16
// queries over a bf16 corpus (exact products summed in f32). One kernel
// body serves both, templated on its operand (S8Op, Bf16Op below).
//
// int8 replaces the integer path of the Pallas kernel
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
// bf16 replaces the single-pass branch of the same kernel (the dot_general
// of :638-644 at precision "default", `_PRECISIONS` :550-557), which the
// reference runs for every BFLOAT16 space and for f32 spaces at "default"
// (bf16 storage, queries cast to bf16): dot(q, x) = sum_d q_d x_d, each
// product exact in f32, summed in f32; the scores as above with scale 1,
// no bias and no deferred mode. The FFMA kernel (topk_kernel.cu) ran this
// branch before, issue-bound on the CUDA cores; its exact f32 products are
// the tensor cores' for bf16 operands, so nothing of the contract is lost
// (unlike at "highest", whose f32 operands bf16 cannot hold). Its bound at
// 1M x 128, batch 256: 256 MB of rows + 4 MB of norms, 0.078 ms at 3.35
// TB/s, against 6.6e10 operations, 0.066 ms at 989 TFLOP/s.
//
// What bounds the int8 scan on an H100: the corpus, one byte an element. At deep10m
// (10M x 96 codes, batch 128) that is 0.96 GB, 0.29 ms at 3.35 TB/s,
// against 2 Q N D = 0.25 T integer operations, 0.12 ms at the 1,979 TOPS
// dense int8 rate. So the scan has about one instruction issue per score
// to spend, at 128 queries, before the epilogue and not the bytes bound it.
// This replaces an mma.sync scan of 64-query tiles, which walked
// the corpus once per 64 queries and stopped its eight warps at every
// tile's epilogue (7.4 ms at deep10m batch 128 on an H100). The design
// (wgmma_scan.cuh has the pipeline):
//
// * One block per split of rows, a tile of QB = 2 NW queries (NW in 16,
//   32, 64, 128: the whole batch up to 256 in one pass over the rows, one
//   set of accumulators, from ops/topk_kernel.py::_int_shape). TMA loads
//   each stage, 64 rows x 128 bytes of dims (128 int8 or 64 bf16), with
//   the 128-byte swizzle that wgmma reads. The tensor map's inner extent
//   is D, so TMA reads D values a row and fills the rest of the 128 bytes
//   with zeros: rows stored padded (the engine's blocks are 128 bytes a row
//   for int8 D = 96; `ldb` is their stride) cost D values, and any D takes
//   the same kernel. The queries' map is [nq, D] too, zeros past D and past
//   nq (the wrapper rounds f32 queries to bf16 once). Where all chunks of
//   QB queries fit (`resident`) they load once; else each stage carries its
//   chunk of them.
// * wgmma.m64nNk32.s32.s8.s8 or wgmma.m64nNk16.f32.bf16.bf16, rows as A (M
//   = 64) and a consumer warpgroup's NW queries as B, both from shared
//   memory: four k steps of 32 bytes a stage. The int32 sums are exact for
//   D < 2^17 (the wrapper checks).
// * The epilogue. In deferred mode each raw int32 dot is compared with an
//   int32 bar, the least dot whose f32 rounding reaches the query's bar
//   (int_bar): one integer compare a score, no float work until a row
//   passes. The other forms do the contract's f32 steps on the accumulator
//   registers. Rows that pass are offered to their queries' buffers
//   (wgmma_scan.cuh): select.cuh's flush_buffer merges a full buffer into
//   its list by the exact rank rule, and the bar shared by the splits
//   through slots [Q, S] raises the compare's bar. Lists of k <= 128 live
//   in shared memory where they fit, else in the [Q, S, L] scratch.
// * Pass 2 merges the S sorted lists (scan_common.cuh's warp_merge_kernel,
//   one warp per query, or the merge tree), then in deferred mode
//   scale_kernel multiplies the [Q, k] scores by scale.
//
// The wrapper hands over rows and queries whose stride and base are 16-byte
// aligned (TMA's rule), copying them into zero-padded rows otherwise. Row
// offsets are 64-bit. Limits: 1 <= k <= N < 2^31, S <= 512; the Python
// wrapper checks them.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "scan_common.cuh"
#include "select.cuh"
#include "wgmma_scan.cuh"

namespace {

constexpr int kChunk = 128;                     // bytes of a row in a stage
constexpr int kRowTile = kScanRows * kChunk;    // bytes of a stage's rows

enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };  // DistanceMetric values

__host__ __device__ constexpr int stage_bytes(int qb, int resident) {
  return kRowTile + (resident ? 0 : qb * kChunk);
}
__host__ __device__ constexpr int q_bytes(int qb, int nch, int resident) {
  return resident ? nch * qb * kChunk : 0;
}

// The operands of a scan: the accumulator type, the values in a stage's
// 128 bytes, the tensor maps' element type, the k step of 32 bytes, and
// what the f32 epilogue reads from an accumulator (`dot`) and keeps in it
// (`keep`, read back by `score`).
struct S8Op {
  using Acc = int;
  static constexpr bool kInt = true;
  static constexpr int kDims = kChunk;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  template <int NW>
  static __device__ __forceinline__ void mma(int (&acc)[NW / 2], uint64_t a, uint64_t b,
                                             int scale_d) {
    WgmmaS8<NW>::mma(acc, a, b, scale_d);
  }
  static __device__ __forceinline__ float dot(int a, float scale) {
    return __fmul_rn(__int2float_rn(a), scale);
  }
  static __device__ __forceinline__ int keep(float s) { return __float_as_int(s); }
  // In deferred mode the accumulator still holds the raw dot.
  static __device__ __forceinline__ float score(int a, int defer) {
    return defer ? __int2float_rn(a) : __int_as_float(a);
  }
};

struct Bf16Op {
  using Acc = float;
  static constexpr bool kInt = false;
  static constexpr int kDims = kChunk / 2;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  template <int NW>
  static __device__ __forceinline__ void mma(float (&acc)[NW / 2], uint64_t a,
                                             uint64_t b, int scale_d) {
    WgmmaBf16SS<NW>::mma(acc, a, b, scale_d);
  }
  static __device__ __forceinline__ float dot(float a, float) { return a; }  // no scale
  static __device__ __forceinline__ float keep(float s) { return s; }
  static __device__ __forceinline__ float score(float a, int) { return a; }
};

// The compare pass of the deferred form: bit i where element i's raw dot
// reaches its query's int32 bar and its row scores (live bit h).
template <int NW>
__device__ __forceinline__ unsigned long long defer_pass(const int (&acc)[NW / 2],
                                                         const float* thr, int lane,
                                                         unsigned live) {
  unsigned long long pass = 0;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int2 b2 = *reinterpret_cast<const int2*>(thr + 8 * j + 2 * (lane & 3));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if ((live >> h) & 1u) {
        const int i = 4 * j + 2 * h;
        pass |= static_cast<unsigned long long>(acc[i] >= b2.x) << i;
        pass |= static_cast<unsigned long long>(acc[i + 1] >= b2.y) << (i + 1);
      }
    }
  }
  return pass;
}

// What the f32 epilogue of a tile reads: the bars, the lane, the live rows,
// and per row h its bias term, squared norm and cosine factor.
struct F {
  const float* thr;
  int lane;
  unsigned live;
  float scale;
  float badd[2], nrm[2], inv[2];
};

// The compare pass of the f32 forms: element i's score, each step rounded
// (f32(dot) * scale for int8, + bias_scale * bias_row, the metric),
// replaces the dot in acc (Op::keep); bit i where it reaches its query's
// bar.
template <class Op, int NW, int METRIC, bool BIAS>
__device__ __forceinline__ unsigned long long float_pass(typename Op::Acc (&acc)[NW / 2],
                                                         const F& f) {
  unsigned long long pass = 0;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const float2 b2 = *reinterpret_cast<const float2*>(f.thr + 8 * j + 2 * (f.lane & 3));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        float sv = Op::dot(acc[i], f.scale);
        if (BIAS) sv = __fadd_rn(sv, f.badd[h]);
        if (METRIC == kL2) {
          sv = __fsub_rn(__fmul_rn(2.0f, sv), f.nrm[h]);
        } else if (METRIC == kCosine) {
          sv = __fmul_rn(sv, f.inv[h]);
        }
        acc[i] = Op::keep(sv);
        if ((f.live >> h) & 1u) {
          pass |= static_cast<unsigned long long>(sv >= (e ? b2.y : b2.x)) << i;
        }
      }
    }
  }
  return pass;
}

// float_pass with or without the bias term (int8 only: bf16 has none).
template <class Op, int NW, int METRIC>
__device__ __forceinline__ unsigned long long metric_pass(typename Op::Acc (&acc)[NW / 2],
                                                          const F& f, bool bias) {
  if constexpr (Op::kInt) {
    if (bias) return float_pass<Op, NW, METRIC, true>(acc, f);
  }
  return float_pass<Op, NW, METRIC, false>(acc, f);
}

template <class Op, int NW>
__global__ void __launch_bounds__(kScanThreads, 1)
    scan_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap rmap,
                    const float* __restrict__ norms,
                    const float* __restrict__ mask,
                    const float* __restrict__ bias, float scale,
                    float bias_scale, int defer, int64_t nq, int64_t n, int nch,
                    int64_t num_valid, int k, int topk, int metric,
                    int64_t rows_per_split, int splits, int lists, int stages,
                    int resident, int big, float* __restrict__ part_s,
                    int* __restrict__ part_i, unsigned long long* __restrict__ slots,
                    const float* __restrict__ seed_s, const int* __restrict__ seed_i,
                    int kseed, int seed_mul, int excl) {
  // big: each split's list (length k) lives in part_* ([nq, lists, k]: the
  // splits' lists, then the seed's); topk is the k asked for. slots ([nq,
  // splits]) holds the group bars' keys (select.cuh). seed_* (may be null):
  // the seed whose floor starts each bar, in the scan's own domain (raw
  // dots in deferred mode); excl > 0: rows r % excl == 0 never score.
  constexpr int QB = 2 * NW;
  extern __shared__ unsigned char smem_raw[];
  const int sb = stage_bytes(QB, resident);
  const ScanSmem sm = scan_layout(smem_raw, sb, stages, q_bytes(QB, nch, resident),
                                  NW, big ? 0 : k);
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
    mbar_init(sm.qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 256) {
      if (resident) {
        mbar_expect_tx(sm.qbar, q_bytes(QB, nch, 1));
        for (int c = 0; c < nch; ++c) {
          tma_load_2d(sm.qres + c * QB * kChunk, &qmap, sm.qbar, c * Op::kDims,
                      static_cast<int>(q0));
        }
      }
      int64_t step = 0;
      for (int t = 0; t < tiles; ++t) {
        for (int c = 0; c < nch; ++c, ++step) {
          const int s = static_cast<int>(step % stages);
          mbar_wait(sm.empty + s, static_cast<unsigned>((step / stages) & 1) ^ 1u);
          unsigned char* st = sm.ring + static_cast<size_t>(s) * sb;
          mbar_expect_tx(sm.full + s, sb);
          tma_load_2d(st, &rmap, sm.full + s, c * Op::kDims, row_begin + t * kScanRows);
          if (!resident) {
            tma_load_2d(st + kRowTile, &qmap, sm.full + s, c * Op::kDims,
                        static_cast<int>(q0));
          }
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
  S.int_bar = defer;
  S.part_s = part_s;
  S.part_i = part_i;
  S.slots = slots;
  S.seed_s = seed_s;
  S.seed_i = seed_i;
  S.kseed = kseed;
  S.seed_mul = seed_mul;
  sel_init(S, tw);
  if (resident) mbar_wait(sm.qbar, 0);
  wg_sync(bar_id);

  // Lane (g, t) = (lane / 4, lane % 4) holds the dots of tile rows r_lo =
  // 16 warp + g and r_lo + 8 with queries 8 j + 2 t + e: acc[4 j + 2 h + e].
  const int r_lo = 16 * warp + (lane >> 2);
  const int qoff = wg * NW * kChunk;  // the warpgroup's queries in a chunk
  typename Op::Acc acc[NW / 2];
  int64_t step = 0;
  for (int t = 0; t < tiles; ++t) {
    const int t0 = row_begin + t * kScanRows;
    if (t > 0 && t % kRefresh == 0) sel_refresh(S, warp, lane);
    float nrm[2], brow[2];
    unsigned live = 0;  // bit h: row r_lo + 8 h of the tile scores
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the epilogue's loads, in flight meanwhile
      const int row = t0 + r_lo + 8 * h;
      const bool in = row < valid_end;
      nrm[h] = in && metric != kIP ? __ldg(norms + row) : 0.f;
      brow[h] = in && bias != nullptr ? __ldg(bias + row) : 0.f;
      live |= static_cast<unsigned>(in && (mask == nullptr || __ldg(mask + row) != 0.f) &&
                                    (excl == 0 || row % excl != 0))
              << h;
    }
    for (int c = 0; c < nch; ++c, ++step) {
      const int s = static_cast<int>(step % stages);
      mbar_wait(sm.full + s, static_cast<unsigned>((step / stages) & 1));
      const unsigned char* st = sm.ring + static_cast<size_t>(s) * sb;
      const unsigned char* qs =
          (resident ? sm.qres + c * QB * kChunk : st + kRowTile) + qoff;
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < kChunk / 32; ++kk) {
        Op::template mma<NW>(acc, smem_desc(st + 32 * kk, kChunk),
                             smem_desc(qs + 32 * kk, kChunk), (c | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty + s);  // this warp is done with it
    }

    // Epilogue and masks: the compare pass (in deferred mode the raw dot
    // against the int32 bar, else the contract's f32 steps, the scores
    // kept in acc, against the float bar), then the offers of what passed.
    unsigned long long pass = 0;
    bool deferred = false;
    if constexpr (Op::kInt) {
      deferred = defer;
      if (defer) pass = defer_pass<NW>(acc, S.thr, lane, live);
    }
    if (!deferred) {
      float inv[2], badd[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        inv[h] = metric == kCosine ? 1.0f / sqrtf(fmaxf(nrm[h], 1e-30f)) : 0.f;
        badd[h] = __fmul_rn(bias_scale, brow[h]);
      }
      const F f{S.thr, lane, live, scale, {badd[0], badd[1]}, {nrm[0], nrm[1]},
                {inv[0], inv[1]}};
      const bool b = bias != nullptr;
      pass = metric == kL2      ? metric_pass<Op, NW, kL2>(acc, f, b)
             : metric == kCosine ? metric_pass<Op, NW, kCosine>(acc, f, b)
                                 : metric_pass<Op, NW, kIP>(acc, f, b);
    }
    sel_epilogue<NW>(S, pass, warp, lane, t0 + r_lo, bar_id, [&](int i) {
      return Op::score(acc[i], deferred);
    });
  }
  sel_finish(S, tw, bar_id);
}

// The deferred scale: out[e] *= scale over the [Q, k] scores (-inf stays).
__global__ void __launch_bounds__(256)
    scale_kernel(float* __restrict__ out, int64_t count, float scale) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (e < count) out[e] = __fmul_rn(out[e], scale);
}

template <class Op>
const void* kernel(int nw) {
  switch (nw) {
    case 16: return reinterpret_cast<const void*>(scan_kernel<Op, 16>);
    case 32: return reinterpret_cast<const void*>(scan_kernel<Op, 32>);
    case 64: return reinterpret_cast<const void*>(scan_kernel<Op, 64>);
    case 128: return reinterpret_cast<const void*>(scan_kernel<Op, 128>);
    default: return nullptr;
  }
}

Variant variant(int bf16, int nw, int nch, int stages, int resident, int k_smem) {
  return Variant{bf16 ? kernel<Bf16Op>(nw) : kernel<S8Op>(nw),
                 scan_smem(stage_bytes(2 * nw, resident), stages,
                           q_bytes(2 * nw, nch, resident), nw, k_smem)};
}

}  // namespace

extern "C" {

// Launch the scan, the merge and (defer, unless raw) the scale on `stream`.
// Returns the cudaError_t of the launches (0 on success). q is [nq][qstride]
// and db [n][ldb], int8 or (bf16) bf16, strides in values, of which the
// first d of a row are read; both base addresses and row strides are
// multiples of 16 bytes. `mask` and `bias` may be null; bf16 takes neither
// `bias` nor `scale` nor `defer`. The tile takes 2 nw queries (nw in 16, 32, 64, 128) and a ring of
// `stages` stages; `resident`: the tile's queries load once. With `big` the
// lists live in part_*, allocated as [nq, splits, list_len]; else in shared
// memory, part_* as [nq, splits, k] (list_len = k). With `tree` (always
// with big) part_* and tmp_* are as large as every level of the merge tree
// needs (ops/select.py::merge_scratch) and the tree folds the lists; else
// warp_merge_kernel does and tmp_* is unused. slots is [nq, splits] zeros (the
// group bars, select.cuh). out_* are [nq, k]. The seed and excl as for
// mvt_fused_topk (part_* then hold splits + nseed lists); in deferred mode
// its scores are raw dots, as the scan ranks them.
int mvt_fused_topk_int(int bf16, const void* q, int64_t qstride, const void* db,
                       int64_t ldb, const float* norms, const float* mask,
                       const float* bias, float scale, float bias_scale,
                       int defer, int64_t nq, int64_t n, int64_t d,
                       int64_t num_valid, int k, int metric, int nw, int stages,
                       int resident, int big, int splits, int64_t rows_per_split,
                       int list_len, int tree, float* part_s, int* part_i,
                       unsigned long long* slots, float* tmp_s, int* tmp_i,
                       float* out_s, int* out_i, const float* seed_s,
                       const int* seed_i, int kseed, int seed_mul, int nseed,
                       int excl, int raw, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int kl = big ? list_len : k;
  const int dims = bf16 ? Bf16Op::kDims : S8Op::kDims;  // a stage's values
  const int vb = kChunk / dims;                          // bytes a value
  int nch = static_cast<int>((d + dims - 1) / dims);
  const Variant v = variant(bf16, nw, nch, stages, resident, big ? 0 : kl);
  cudaError_t err = prepare(v);
  if (err != cudaSuccess) return err;
  const int qb = 2 * nw;
  const CUtensorMapDataType type = bf16 ? Bf16Op::kType : S8Op::kType;
  CUtensorMap qmap, rmap;
  err = tensor_map_2d(&qmap, type, q, d, nq, vb * qstride, dims, qb,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = tensor_map_2d(&rmap, type, db, d, n, vb * ldb, dims, kScanRows,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  int lists = splits + (seed_s != nullptr ? nseed : 0);
  err = seed_lists(seed_s, seed_i, kseed, seed_mul, nq, lists, splits, kl, part_s,
                   part_i, st);
  if (err != cudaSuccess) return err;
  void* args[] = {&qmap,  &rmap,     &norms,  &mask,   &bias,   &scale,
                  &bias_scale, &defer, &nq,   &n,      &nch,    &num_valid,
                  &kl,    &k,        &metric, &rows_per_split,  &splits, &lists,
                  &stages, &resident, &big,   &part_s, &part_i, &slots,
                  &seed_s, &seed_i,  &kseed, &seed_mul, &excl};
  const dim3 grid(static_cast<unsigned>((nq + qb - 1) / qb),
                  static_cast<unsigned>(splits));
  err = cudaLaunchKernel(v.fn, grid, dim3(kScanThreads), args, v.smem, st);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (big || tree) {
    err = merge_tree(part_s, part_i, tmp_s, tmp_i, nq, lists, kl, k, nullptr,
                     0, out_s, out_i, st);
  } else {
    err = warp_merge(part_s, part_i, nq, k, lists, out_s, out_i, st);
  }
  if (err != cudaSuccess || !defer || raw) return err;
  const int64_t count = nq * k;
  scale_kernel<<<static_cast<unsigned>((count + 255) / 256), 256, 0, st>>>(
      out_s, count, scale);
  return cudaGetLastError();
}

// Scan blocks of this shape that fit on one SM at once, written to
// *blocks_per_sm (k_smem: the lists' length, in shared memory unless big);
// returns the cudaError_t.
int mvt_fused_topk_int_occupancy(int bf16, int nw, int nch, int stages, int resident,
                                 int k_smem, int big, int* blocks_per_sm) {
  return occupancy(variant(bf16, nw, nch, stages, resident, big ? 0 : k_smem),
                   kScanThreads, blocks_per_sm);
}

// Dynamic shared memory of a scan block of this shape, either operand, for
// the wrapper's plan (ops/topk_kernel.py::_int_shape mirrors it).
long long mvt_fused_topk_int_smem(int nw, int nch, int stages, int resident,
                                  int k_smem) {
  return static_cast<long long>(variant(0, nw, nch, stages, resident, k_smem).smem);
}

}  // extern "C"
