// The IVF bucket-bias form of the ADC scan with a fused top-k, for Hopper
// (sm_90a): IVF-PQ's scan mode (metrovector_tpu/index/ivfpq.py::
// _masked_scan), which the Pallas kernel metrovector_tpu/ops/adc_kernel.py::
// fused_adc_topk computes with `group_bias` + `group_ids`. Per query q and
// row x of bucket b, with the LUT and the epilogue of adc_scan.cuh:
//
//   s(q, x) = (sum over j = 0..m-1, in that order, in f32, of
//              LUT[q, j*ksub + code_j(x)]) + bias[q, b]
//             -- the bias AFTER the m lookups, one f32 add, already rounded
//             as the LUT is;
//   bias <= -1e28 (an unprobed bucket) or s <= -1e28: the row scores -inf;
//   a bucket b >= ngroups (the row-order form's rows in no bucket) adds no
//   bias and is always probed (the -1e28 test on s still applies);
//   then the metric epilogue, rows >= num_valid and rows with mask == 0
//   never enter, and per query the k best by (score descending, original
//   row ascending); slots that stay -inf carry row -1.
//
// The rows come from a bucket layout: bucket b's slots start at starts[b]
// (or b * stride) and its first counts[b] slots hold its rows' codes, norms
// and original row ids (-1: padding or a tombstone, never scored; no ids:
// a slot is its own row). The IVF-PQ index keeps such a layout for its
// probe mode ([C', B] slots, fill counts); the row-order form is grouped
// into one on the device; the bucket-major form (`group_rows`: bucket =
// row / group_rows) is one as it stands, stride group_rows and no ids.
//
// What bounds it: a query probes a few percent of the buckets, so the
// design reads only those. Walking every row in original order and testing
// each row's bucket saves almost nothing under SIMT: nearly every warp of 32
// rows holds a probed row and runs its lookups, and the pass over a million
// rows costs 0.7-1.0 ms alone on an H100 (PERF.md). What is left is the
// selection of each query's k best among its probed rows (at k = 400 about
// half the time at batch 256) and launch latency at small batches. Here:
//
// * Grid (ceil(Q/QT), S), QT = 1 by default: a tile's union of probed
//   buckets grows with its queries, and each row costs its epilogue for
//   every query of the tile, so one query a block was the fastest at every
//   batch measured. A block stages its queries' LUT as the plain scan does,
//   then builds its tile's work list from the bias table: one
//   bit per bucket for "some query of the tile probes it" (a warp a word of
//   32 buckets) and, per word, the 32-slot chunks of its probed buckets,
//   prefix-summed. The list is those chunks in ascending bucket order; the
//   S splits of the query tile take contiguous shares of it. No bucket
//   outside the union is read, and nothing is sized from the data on the
//   host: the list lives in shared memory, 8 bytes a word of buckets.
// * A tile is 8 chunks, one a warp, so a warp's 32 rows are one bucket's:
//   whether query q probes them is the same in every lane. A warp finds its
//   chunk's bucket by a binary search over the word prefix and a warp scan
//   of the word's chunk counts, and keeps it while its next chunks stay in
//   that bucket. Lane l loads the bias of query l at the warp's bucket once
//   a tile; the lanes broadcast it by shuffle, and a group of GW queries
//   that share an 8-byte LUT entry skips its lookups when none of them
//   probes the bucket (a branch the whole warp takes alike).
// * A row's codes, norm, id and mask value are loaded a tile ahead.
//   Selection is select.cuh's, as in the plain scan: the bar test and vote
//   in the scoring threads, one warp per query over the tile's candidate
//   words, buffered merges into each split's list, the group bar shared by
//   the splits through slots [Q, S]; the row a candidate bit names is the
//   slot's original row id (kept per tile in shared memory). Rows arrive in
//   bucket order, not row order: rank_key orders (score, row) whatever the
//   order, the buffer and the lists hold distinct rows (a row sits in one
//   slot), and the group bar's argument needs only distinct rows across
//   splits, which disjoint chunks give.
// * Pass 2 merges the S lists with select.cuh's merge_kernel or, past 8
//   splits and for lists in device memory, its merge tree (the wrapper
//   picks; at small batches a wave of blocks means up to 128 splits).

#include "adc_scan.cuh"

namespace {

constexpr int kChunk = 32;  // slots of one bucket that a warp scores a tile
constexpr float kDeadBias = -1e28f;  // at or below: an unprobed bucket

// Shared memory of one block: the plain scan's, then each of the two tiles'
// row ids, the union's bits (gw words) and the chunk prefix (gw + 1).
__host__ __device__ constexpr size_t bucket_smem_bytes(int qt, int lsz, int mk,
                                                       int smem_k, int gw) {
  return scan_smem_bytes(qt, lsz, mk, smem_k) + 2 * 4 * kRows +
         4 * static_cast<size_t>(gw) + 4 * (static_cast<size_t>(gw) + 1);
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

template <int QT, bool PACKED, typename LT, bool GLOBAL, bool IDS>
__global__ void __launch_bounds__(kThreads)
    adc_bucket_kernel(const void* lut_raw, const uint8_t* __restrict__ codes,
                      int cols, const float* __restrict__ norms,
                      const int* __restrict__ ids,
                      const int64_t* __restrict__ starts, int64_t stride,
                      const int* __restrict__ counts, int nb,
                      const float* __restrict__ mask,
                      const float* __restrict__ gbias, int ngroups, int64_t nq,
                      int m, int ksub, int64_t num_valid, int k, int metric,
                      int vec, float* __restrict__ part_s,
                      int* __restrict__ part_i,
                      unsigned long long* __restrict__ slots) {
  // GLOBAL: each split's list (k entries) lives in part_* ([nq, splits, k])
  // instead of shared memory. slots ([nq, splits]): the group bars' keys.
  // IDS: the layout holds row ids (else ids is null and a slot is its own
  // row). A form of its own: a test on ids in every slot's load costs the
  // ids form enough registers to lose its fourth block per SM (PERF.md).
  constexpr int kEntry = 8 / static_cast<int>(sizeof(LT));
  constexpr int GW = QT < kEntry ? QT : kEntry;
  constexpr int G = QT / GW;
  constexpr unsigned kGroupBits = (1u << GW) - 1u;
  constexpr int kPerWarp = (QT + kWarps - 1) / kWarps;
  static_assert(QT <= 32, "lane qq holds query qq's bias");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int mk = m * ksub;
  const int ks = GLOBAL ? 0 : k;
  const int gw = (nb + 31) / 32;
  LT* ls = reinterpret_cast<LT*>(smem_raw);  // [G][mk][GW] the LUT
  auto* bar = reinterpret_cast<unsigned long long*>(
      smem_raw + lut_bytes(QT, sizeof(LT), mk));      // [QT] rank keys
  float* sc2 = reinterpret_cast<float*>(bar + QT);    // [2][QT][kRows] scores
  unsigned* cand2 = reinterpret_cast<unsigned*>(sc2 + 2 * QT * kRows);  // [2][QT][kWords]
  float* bs = reinterpret_cast<float*>(cand2 + 2 * QT * kWords);  // [QT][kBuf] buffer
  int* bi = reinterpret_cast<int*>(bs + QT * kBuf);          // [QT][kBuf]
  int* bc = bi + QT * kBuf;                                  // [QT] buffer fill
  float* cs = reinterpret_cast<float*>(bc + QT);             // [QT][k] lists
  int* ci = reinterpret_cast<int*>(cs + QT * ks);
  int* rows2 = ci + QT * ks;                                 // [2][kRows] row ids
  unsigned* ubits = reinterpret_cast<unsigned*>(rows2 + 2 * kRows);  // [gw]
  int* wpre = reinterpret_cast<int*>(ubits + gw);  // [gw + 1] chunks before word w

  const LT* lut = static_cast<const LT*>(lut_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * QT;
  const int split = blockIdx.y;
  const int splits = gridDim.y;

  stage_lut<QT, GW>(ls, lut, q0, nq, mk);
  // The tile's union of probed buckets, a warp a word of 32, and each
  // word's chunks of those buckets.
  for (int w = warp; w < gw; w += kWarps) {
    const int b = w * 32 + lane;
    bool probed = false;
    if (b < nb) {
      if (b >= ngroups) {
        probed = true;  // no bias: every query scans it
      } else {
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) {
          if (q0 + qq < nq) probed |= gbias[(q0 + qq) * ngroups + b] > kDeadBias;
        }
      }
    }
    const unsigned word = __ballot_sync(kFull, probed);
    int nch = probed ? (counts[b] + kChunk - 1) / kChunk : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) nch += __shfl_xor_sync(kFull, nch, o);
    if (lane == 0) {
      ubits[w] = word;
      wpre[w + 1] = nch;
    }
  }
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
  if (warp == 0) {  // wpre: the chunks before each word
    int carry = 0;
    for (int base = 0; base < gw; base += 32) {
      const int w = base + lane;
      const int v = warp_inclusive_sum(w < gw ? wpre[w + 1] : 0, lane);
      if (w < gw) wpre[w + 1] = carry + v;
      carry += __shfl_sync(kFull, v, 31);
    }
    if (lane == 0) wpre[0] = 0;
  }
  __syncthreads();

  // This split's share of the list: chunks [c_begin, c_end).
  const int64_t total = wpre[gw];
  const int64_t per = (total + splits - 1) / splits;
  const int64_t c_begin = split * per < total ? split * per : total;
  const int64_t c_end = c_begin + per < total ? c_begin + per : total;

  // The warp's bucket: chunks [cur_c0, cur_c1) of the list are bucket
  // cur_b's, whose slots start at cur_start and hold cur_cnt rows.
  int cur_b = -1, cur_cnt = 0;
  int64_t cur_c0 = 0, cur_c1 = 0, cur_start = 0;
  auto locate = [&](int64_t c) {  // c is the same in every lane
    if (c >= cur_c0 && c < cur_c1) return;
    int lo = 0, hi = gw;  // the word w with wpre[w] <= c < wpre[w + 1]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (wpre[mid] <= c) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    const int b = lo * 32 + lane;
    const int cnt = (ubits[lo] >> lane) & 1u ? counts[b] : 0;
    const int nch = (cnt + kChunk - 1) / kChunk;
    const int incl = warp_inclusive_sum(nch, lane);
    const int r = static_cast<int>(c - wpre[lo]);
    const int at = __ffs(__ballot_sync(kFull, incl > r)) - 1;
    cur_b = lo * 32 + at;
    cur_cnt = __shfl_sync(kFull, cnt, at);
    cur_c0 = wpre[lo] + __shfl_sync(kFull, incl - nch, at);
    cur_c1 = cur_c0 + (cur_cnt + kChunk - 1) / kChunk;
    cur_start = starts != nullptr ? starts[cur_b] : cur_b * stride;
  };

  // A thread's slot of the next tile is loaded a tile ahead: its first 16
  // bytes of codes, its norm, its row id and mask value, and (lane l) the
  // bias of query l at the warp's bucket. A slot past its bucket's count,
  // of id -1 or of a row >= num_valid is not in.
  struct Slot {
    uint4 cw;
    int64_t at;
    float nrm, keep, bias;
    int row, bucket;
    bool in;
  };
  auto fetch = [&](int64_t c, Slot& s) {
    s.in = false;
    s.bucket = -1;
    s.row = -1;
    s.bias = 0.f;
    s.nrm = 0.f;
    s.keep = 1.f;
    s.at = 0;
    s.cw = make_uint4(0, 0, 0, 0);
    if (c >= c_end) return;  // the same in every lane
    locate(c);
    s.bucket = cur_b;
    const int j = static_cast<int>(c - cur_c0) * kChunk + lane;
    if (j < cur_cnt) {
      s.at = cur_start + j;
      s.row = IDS ? ids[s.at] : static_cast<int>(s.at);
      s.in = s.row >= 0 && s.row < num_valid;
    }
    if (s.in) {
      s.cw = code_block(codes + s.at * cols, 0, cols, vec);
      s.nrm = norms[s.at];
      if (mask != nullptr) s.keep = mask[s.row];
    }
    if (lane < QT && q0 + lane < nq && cur_b < ngroups) {
      s.bias = gbias[(q0 + lane) * ngroups + cur_b];
    }
  };
  Slot next;
  fetch(c_begin + warp, next);

  const int place = bar_place(splits, k);
  for (int64_t t0 = c_begin; t0 < c_end; t0 += kWarps) {
    // Tiles alternate between two score tiles, sets of words and row ids,
    // as in the plain scan (adc_scan.cuh).
    const int par = static_cast<int>(((t0 - c_begin) / kWarps) & 1);
    float* sc = sc2 + par * QT * kRows;
    unsigned* cand = cand2 + par * QT * kWords;
    int* rows = rows2 + par * kRows;
    unsigned long long group[kPerWarp];
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int qq = warp + kWarps * j;
      group[j] = qq < QT && q0 + qq < nq
                     ? group_slot(slots, q0 + qq, split, splits, k, lane)
                     : ~0ull;
    }
    const Slot cur = next;
    fetch(t0 + kWarps + warp, next);
    const bool live = cur.in && cur.keep != 0.f;
    const bool biased = cur.bucket >= 0 && cur.bucket < ngroups;
    // Bit qq: query qq probes the warp's bucket (the same in every lane).
    const unsigned probes = __ballot_sync(
        kFull, lane < QT && (!biased || cur.bias > kDeadBias));
    float acc[QT];
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) acc[qq] = 0.f;
    if (live) {
      const uint8_t* rc = codes + cur.at * cols;
      for (int b = 0; b < cols; b += 16) {
        const uint4 cw = b == 0 ? cur.cw : code_block(rc, b, cols, vec);
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
              for (int g = 0; g < G; ++g) {
                if ((probes >> (g * GW)) & kGroupBits) {
                  lut_add<GW>(acc + GW * g, e + g * mk * GW);
                }
              }
            }
          }
        }
      }
    }
    rows[tid] = cur.row;
    const float inv = 1.0f / sqrtf(fmaxf(cur.nrm, 1e-30f));
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {
      const float b = __shfl_sync(kFull, cur.bias, qq);
      if (!((probes >> qq) & 1u)) {  // the whole warp: nothing to offer
        if (lane == 0) cand[qq * kWords + warp] = 0u;
        continue;
      }
      float s = acc[qq];
      bool ok;
      if (biased) {
        ok = b > kDeadBias;
        if (ok) s += b;  // after the lookups
        ok = ok && s > kDeadBias;
      } else {
        ok = s > kDeadBias;
      }
      if (metric == kL2) {
        s = 2.0f * s - cur.nrm;
      } else if (metric == kCosine) {
        s = s * inv;
      }
      float bs_q;  // a float compare; select_tile applies the exact rule
      int bi_q;
      unrank(bar[qq], bs_q, bi_q);
      const bool pass = live && ok && s >= bs_q;
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
                  [&](int b) { return rows[b]; }, list_s(qq), list_i(qq), k,
                  bs + qq * kBuf, bi + qq * kBuf, bc + qq, bar + qq, group[j],
                  slots == nullptr ? nullptr : slots + (q0 + qq) * splits + split,
                  place, lane);
    }
  }

  for (int j = 0; warp + kWarps * j < QT; ++j) {  // the buffers' last entries
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

// The default build has the query tile of 1, the fastest at every batch
// measured (PERF.md); -DMVT_K2B_ALL_TILES builds the others for
// tools/adc_group_sweep.py.
template <bool PACKED, typename LT, bool GLOBAL, bool IDS>
const void* pick_bucket_qt(int qt) {
  switch (qt) {
    case 1:
      return reinterpret_cast<const void*>(adc_bucket_kernel<1, PACKED, LT, GLOBAL, IDS>);
#ifdef MVT_K2B_ALL_TILES
    case 2:
      return reinterpret_cast<const void*>(adc_bucket_kernel<2, PACKED, LT, GLOBAL, IDS>);
    case 4:
      return reinterpret_cast<const void*>(adc_bucket_kernel<4, PACKED, LT, GLOBAL, IDS>);
    case 8:
      return reinterpret_cast<const void*>(adc_bucket_kernel<8, PACKED, LT, GLOBAL, IDS>);
    case 16:
      return reinterpret_cast<const void*>(adc_bucket_kernel<16, PACKED, LT, GLOBAL, IDS>);
    case 32:
      return reinterpret_cast<const void*>(adc_bucket_kernel<32, PACKED, LT, GLOBAL, IDS>);
#endif
    default:
      return nullptr;
  }
}

template <typename LT, bool IDS>
const void* pick_bucket_lt(int qt, int packed4, int global) {
  if (global) {
    return packed4 ? pick_bucket_qt<true, LT, true, IDS>(qt)
                   : pick_bucket_qt<false, LT, true, IDS>(qt);
  }
  return packed4 ? pick_bucket_qt<true, LT, false, IDS>(qt)
                 : pick_bucket_qt<false, LT, false, IDS>(qt);
}

template <typename LT>
const void* pick_bucket_ids(int qt, int packed4, int global, int ids) {
  return ids ? pick_bucket_lt<LT, true>(qt, packed4, global)
             : pick_bucket_lt<LT, false>(qt, packed4, global);
}

const void* pick_bucket(int qt, int packed4, int lut_dtype, int global, int ids) {
  if (lut_dtype == kLutF32) return pick_bucket_ids<float>(qt, packed4, global, ids);
  if (lut_dtype == kLutBF16) {
    return pick_bucket_ids<__nv_bfloat16>(qt, packed4, global, ids);
  }
  return nullptr;
}

size_t bucket_smem_for(int qt, int lut_dtype, int mk, int smem_k, int gw) {
  return bucket_smem_bytes(qt, lut_dtype == kLutF32 ? 4 : 2, mk, smem_k, gw);
}

cudaError_t prepare_bucket(const void* fn, size_t smem) {
  if (fn == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// Launch the bucket scan and the merge on `stream`; returns the cudaError_t
// of the launches (0 on success). `lut` is [nq, m*ksub] f32 (lut_dtype 0)
// or bf16 (1). The layout: `codes` [slots, cols] u8, `norms` and `ids`
// [slots] (ids null: slot s is row s); bucket b's first counts[b] slots
// start at starts[b] ([nb] int64), or at b * stride when starts is null. `gbias` is [nq, ngroups]
// f32 (ngroups <= nb; buckets past ngroups take no bias); `mask` [rows] by
// original row id, may be null. With lists_global each split's list (k
// entries) lives in part_*, else in shared memory (k <= 1024); part_*,
// tmp_*, tree, slots and out_* as for mvt_adc_topk (adc_kernel.cu).
int mvt_adc_bucket_topk(const void* lut, int lut_dtype, const uint8_t* codes,
                        int cols, int packed4, const float* norms,
                        const int* ids, const int64_t* starts, int64_t stride,
                        const int* counts, int nb, const float* mask,
                        const float* gbias, int ngroups, int64_t nq, int m,
                        int ksub, int64_t num_valid, int k, int metric, int qt,
                        int splits, int lists_global, int tree, float* part_s,
                        int* part_i, unsigned long long* slots, float* tmp_s,
                        int* tmp_i, float* out_s, int* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nb < 1 || ngroups < 1 || ngroups > nb) return cudaErrorInvalidValue;
  const void* fn = pick_bucket(qt, packed4, lut_dtype, lists_global, ids != nullptr);
  const int gw = (nb + 31) / 32;
  const size_t smem = bucket_smem_for(qt, lut_dtype, m * ksub, lists_global ? 0 : k, gw);
  cudaError_t err = prepare_bucket(fn, smem);
  if (err != cudaSuccess) return err;
  const uintptr_t at = reinterpret_cast<uintptr_t>(codes);
  int vec = cols % 16 == 0 && at % 16 == 0 ? 16 : (cols % 4 == 0 && at % 4 == 0 ? 4 : 0);
  void* args[] = {&lut,  &codes,   &cols,  &norms, &ids,       &starts, &stride,
                  &counts, &nb,    &mask,  &gbias, &ngroups,   &nq,     &m,
                  &ksub, &num_valid, &k,   &metric, &vec,      &part_s, &part_i,
                  &slots};
  const dim3 grid(static_cast<unsigned>((nq + qt - 1) / qt),
                  static_cast<unsigned>(splits));
  err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, smem, st);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge_splits(part_s, part_i, tmp_s, tmp_i, nq, splits, k, k,
                      lists_global || tree, out_s, out_i, st);
}

// Bucket-scan blocks that fit on one SM at once with lists of smem_k
// entries in shared memory (0: in device memory), gw words of bucket bits
// and a layout with row ids (ids) or without, written to *blocks_per_sm;
// returns the cudaError_t.
int mvt_adc_bucket_occupancy(int lut_dtype, int packed4, int qt, int m,
                             int ksub, int smem_k, int gw, int ids,
                             int* blocks_per_sm) {
  const void* fn = pick_bucket(qt, packed4, lut_dtype, smem_k == 0, ids);
  const size_t smem = bucket_smem_for(qt, lut_dtype, m * ksub, smem_k, gw);
  const cudaError_t err = prepare_bucket(fn, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                       kThreads, smem);
}

}  // extern "C"
