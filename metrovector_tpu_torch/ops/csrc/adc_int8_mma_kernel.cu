// K2's int8 LUT at ksub <= 16 (pq4, nibble-packed or not) for Hopper
// (sm_90a): the ADC sums as an exact int8 tensor-core product of the rows'
// one-hot codes and the LUT.
//
// Replaces the int8-LUT form of the Pallas kernel metrovector_tpu/ops/
// adc_kernel.py::fused_adc_topk (kernel :195-204, quantization :431-436)
// for ksub <= 16; adc_scan.cuh's lookup scan serves ksub > 16 (the routing:
// ops/adc_kernel.py::int8_lut_route). It computes adc_scan.cuh's contract
// for an int8 LUT:
//
//   s(q, x)     = f32(sum over j of LUT8[q, j*ksub + code_j(x)]) * sq[q]
//                 (the sum exact in int32, the product rounded once)
//   score(q, x) = L2:     2 s - |x^|^2
//                 cosine: s * 1/sqrt(max(|x^|^2, 1e-30))   (q pre-normalized)
//                 IP:     s
//   rows >= num_valid and rows with mask == 0 score exactly -inf; per query
//   the k best (score descending, row ascending); -inf slots carry row -1.
//
// Why a product: the int8 LUT's sum is an exact integer (|sum| <= 127 m)
// and int32 addition is associative, so any order of adds gives the lookup
// scan's sum bit for bit. At ksub <= 16 that sum is the int8 product of the
// row's one-hot codes (K = 16 m, one 1 in each subspace's 16 columns) with
// the query's LUT, which wgmma s8 computes exactly.
//
// What bounds it on an H100: 2 Q N 16 m operations at the 1,979 TOP/s dense
// int8 rate (sift1m-pq4, m = 32, batch 256 over 1M rows: 0.132 ms; the
// lookup scan's 2 Q N m adds at 67 T/s take 0.245 ms), against 16 MB of
// codes (0.005 ms). What takes the time is the k = 400 selection, then
// building the one-hot (tools/adc_int8_profile.py; PERF.md). The design
// (wgmma_scan.cuh has the pipeline):
//
// * One block per split of rows and tile of QB = 2 NW queries (NW in 16,
//   32, 64, 128). The plan (ops/adc_kernel.py::int8_mma_shape) keeps the
//   lists in shared memory up to k = 1024 where some tile allows it, then
//   takes the largest tile up to the batch's whose LUT, selection state and
//   a ring of at least two stages fit in 227 KB: at m = 32, 32 queries a
//   block at k = 400 (lists in device memory, at 128 queries a block, took
//   3.0-5.1 ms against 2.1-2.5) and 128 at k = 10.
// * B is the LUT of the tile's queries, [nq, 16 m] int8 K-major (each
//   subspace widened to 16 columns with zeros by the wrapper where ksub <
//   16), resident in shared memory: TMA loads it once per block in chunks
//   of 128 bytes (8 subspaces) with the 128-byte swizzle that wgmma reads,
//   a whole number of chunk pairs. The tensor map's inner extent is 16 m,
//   so columns past the last subspace (m not a multiple of 16) arrive as
//   zeros, as do queries past nq. Zero columns are exact: a one-hot selects
//   none of them.
// * A is the one-hot of 64 rows, built in registers and never stored:
//   wgmma.m64nNk32.s32.s8.s8 with A from registers (WgmmaS8RA). A k step
//   of 32 columns is two subspaces (one byte of a packed row). Lane (g, t)
//   = (lane / 4, lane % 4) of warp w holds rows 16 w + g (registers 0, 2)
//   and 16 w + g + 8 (1, 3), columns 4 t .. 4 t + 3 of subspace 2 s (0, 1)
//   and of 2 s + 1 (2, 3): register = 1 << 8 (code - 4 t) where code - 4 t
//   is in 0..3, else 0. Two integer instructions a register (prmt, shr)
//   after four for each four codes (shift_bytes); the thread reads a
//   chunk's code bytes of its two rows from the stage (4 bytes a row
//   packed, 8 unpacked). Bytes past a row's last subspace belong to the
//   next row, the stage's slack or its norms: they are padded subspaces,
//   whose LUT columns are zero.
// * A tile is row_blocks(NW) blocks of 64 rows (256 at NW <= 32, 128 at 64,
//   64 at 128), each with its own accumulators: the selection of a tile
//   (barriers, offers) costs about the same at 256 rows as at 64. One
//   producer thread streams each tile's stage by TMA's bulk copy: the
//   rows' codes (16 B a row at pq4, contiguous in the codes [N, cols]),
//   norms and mask values; the last tile's bytes past a multiple of 16 it
//   copies itself before its arrival. Two consumer warpgroups each own NW
//   of the block's queries (the wgmma N) and both build the same A. Each
//   issues the wgmma of two chunks (8 k steps) between one fence and one
//   wait, no wgmma under a branch (ptxas serializes those).
// * The epilogue: per accumulator element the contract's f32 steps, each
//   rounded as the lookup scan rounds them (__fmul_rn(__int2float_rn(acc),
//   sq[q]), then the metric), compared with the query's bar; then the
//   offers into wgmma_scan.cuh's per-query buffers, each thread's shared
//   atomics issued back to back (offer_pass), full buffers merged by their
//   warps (sel_flush_full), and select.cuh's merges in pass 2 (the merge
//   tree past 64 splits, else warp_merge_kernel up to k = 32 and
//   merge_kernel above). The group bar is read every kRefresh tiles, at
//   tiles 1, 2, 4 and 8 while the lists warm up, and after each round of
//   flushes, when the tile's remaining offers are held to the raised bars
//   (tile_epilogue). No int32 bar as K1's deferred form has (an IP score is
//   monotone in the raw dot, sq > 0): the main path is L2, whose score
//   depends on the row's norm as well, so the float compare stays for
//   every metric and IP would save two instructions an element.
//
// The wrapper hands over codes, norms and mask whose base addresses are
// 16-byte aligned (TMA's rule), copying them otherwise; row offsets are
// 64-bit. Limits: 1 <= k <= N < 2^31, S <= 512; codes < ksub <= 16; the
// Python wrapper checks them.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "scan_common.cuh"
#include "select.cuh"
#include "wgmma_scan.cuh"

namespace {

constexpr int kChunk = 128;  // bytes of K a chunk: 8 subspaces, 4 k steps

enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };  // DistanceMetric values

// Row blocks of 64 (one wgmma M each) a tile, for NW queries a warpgroup:
// as many as keep its accumulators at 64 registers and its pass bits in
// 64, at most 4. A tile's selection (two barriers, the offers) costs about
// the same for 64 rows as for 256.
__host__ __device__ constexpr int row_blocks(int nw) { return nw >= 128 ? 1 : (nw >= 64 ? 2 : 4); }
// A stage: a tile's rows' codes (cols bytes a row) and 32 bytes of slack
// for the last row's reads, then their norms and their mask values; a
// multiple of 1024 bytes, so that the resident LUT after the ring keeps the
// swizzle atoms' alignment.
__host__ __device__ constexpr int code_bytes(int cols, int rb) {
  return (rb * kScanRows * cols + 15) / 16 * 16 + 32;
}
__host__ __device__ constexpr int stage_bytes(int cols, int rb) {
  return (code_bytes(cols, rb) + 2 * 4 * rb * kScanRows + 1023) / 1024 * 1024;
}
// Chunks of the resident LUT: whole pairs, so that every wgmma group is
// eight k steps (a chunk past 16 m is zeros).
__host__ __device__ constexpr int lut_chunks(int m) { return (m + 15) / 16 * 2; }
// The resident LUT of QB queries (nch chunks) and their scales.
__host__ __device__ constexpr int q_bytes(int qb, int nch) {
  return nch * qb * kChunk + 4 * qb;
}

// The 4 bytes at `off` of the stage (any alignment; the stage's slack and
// the norms after it hold the words past the last row).
__device__ __forceinline__ unsigned ld4(const unsigned char* base, int off) {
  const unsigned* p = reinterpret_cast<const unsigned*>(base + (off & ~3));
  return __funnelshift_r(p[0], p[1], 8 * (off & 3));
}

// The A registers of four codes at once. c8 holds 8 c in each byte (c <
// 16); kt = (159 + 32 t) in each byte. (kt - c8) borrows in no byte (159 +
// 32 t - 8 c >= 39), and XOR 0x80 takes the 128 back out: byte = (31 + 32 t
// - 8 c) mod 256, the amount by which 0x80000000 >> amount = 1 << 8 (c -
// 4 t) where c - 4 t is in 0..3. Elsewhere the amount is 32 or more (a
// negative difference wraps to 167..255), and shr clamps it: 0.
__device__ __forceinline__ unsigned shift_bytes(unsigned c8, unsigned kt) {
  return (kt - c8) ^ 0x80808080u;
}
// The register of byte u of shift_bytes' word.
__device__ __forceinline__ unsigned onehot_reg(unsigned v, int u) {
  const unsigned amount = __byte_perm(v, 0, 0x4440 + u);
  unsigned r;
  asm("shr.b32 %0, %1, %2;" : "=r"(r) : "r"(0x80000000u), "r"(amount));
  return r;
}

// The A fragment of chunk c (k steps 4 c .. 4 c + 3, subspaces 8 c ..
// 8 c + 7) for the thread's rows at stage offsets off_a and off_b = its
// rows' first code bytes; kt = (159 + 32 t) in each byte.
template <bool PACKED>
__device__ __forceinline__ void onehot_chunk(unsigned (&a)[4][4], const unsigned char* st,
                                             int off_a, int off_b, int c, unsigned kt) {
  // even[r], odd[r]: shift_bytes of the chunk's subspaces 0, 2, 4, 6 and
  // 1, 3, 5, 7 of row r (a, b), one a byte.
  unsigned even[2], odd[2];
  if constexpr (PACKED) {
    const unsigned w[2] = {ld4(st, off_a + 4 * c), ld4(st, off_b + 4 * c)};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      even[r] = shift_bytes((w[r] << 3) & 0x78787878u, kt);  // low nibbles
      odd[r] = shift_bytes((w[r] >> 1) & 0x78787878u, kt);   // high nibbles
    }
  } else {
    const int off[2] = {off_a + 8 * c, off_b + 8 * c};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const unsigned lo = ld4(st, off[r]), hi = ld4(st, off[r] + 4);  // subspaces 0-3, 4-7
      // bytes 0, 2 of each word: the even subspaces; 1, 3: the odd
      even[r] = shift_bytes((__byte_perm(lo, hi, 0x6420) << 3) & 0x78787878u, kt);
      odd[r] = shift_bytes((__byte_perm(lo, hi, 0x7531) << 3) & 0x78787878u, kt);
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = onehot_reg(even[0], kk);
    a[kk][1] = onehot_reg(even[1], kk);
    a[kk][2] = onehot_reg(odd[0], kk);
    a[kk][3] = onehot_reg(odd[1], kk);
  }
}

// The compare pass: element i's score, each step rounded (f32(sum) *
// sq[q], the metric), replaces the sum in acc (as f32 bits); bit i where
// its row scores (live bit h) and it reaches its query's bar. sqw: the
// warpgroup's scales.
template <int NW, int METRIC>
__device__ __forceinline__ unsigned long long lut8_pass(int (&acc)[NW / 2], const float* thr,
                                                        const float* sqw, int lane,
                                                        unsigned live, const float (&nrm)[2],
                                                        const float (&inv)[2]) {
  unsigned long long pass = 0;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const float2 b2 = *reinterpret_cast<const float2*>(thr + 8 * j + 2 * (lane & 3));
    const float2 s2 = *reinterpret_cast<const float2*>(sqw + 8 * j + 2 * (lane & 3));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        float sv = __fmul_rn(__int2float_rn(acc[i]), e ? s2.y : s2.x);
        if (METRIC == kL2) {
          sv = __fsub_rn(__fmul_rn(2.0f, sv), nrm[h]);
        } else if (METRIC == kCosine) {
          sv = __fmul_rn(sv, inv[h]);
        }
        acc[i] = __float_as_int(sv);
        if ((live >> h) & 1u) {
          pass |= static_cast<unsigned long long>(sv >= (e ? b2.y : b2.x)) << i;
        }
      }
    }
  }
  return pass;
}

// The shared-memory atomicAdd of 1 at addr where p, else `none`: a
// predicated atom, so that a thread's offers issue back to back instead of
// one divergent branch (and one atomic's latency) after another.
__device__ __forceinline__ int atom_inc_if(int* addr, bool p, int none) {
  int r = none;
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %2, 0;\n@q atom.shared.add.u32 %0, [%1], 1;\n}\n"
      : "+r"(r)
      : "r"(smem_addr(addr)), "r"(static_cast<unsigned>(p))
      : "memory");
  return r;
}

// wgmma_scan.cuh's sel_offer_pass over RB row blocks, each thread's atomics
// issued 16 at a time and the buffer writes after them (sel_offer_pass's
// divergent offers, one atomic's latency after another, cost 1,500-3,000
// cycles a tile): element i of the accumulator fragments (block b = i /
// (NW / 2), its element e = i % (NW / 2): query 8 (e / 4) + 2 (lane % 4) +
// e % 2, row row_lo + 64 b + 8 (e / 2 % 2)) goes to its query's buffer
// where bit i of `todo` is set. Returns the bits offered; the rest found a
// full buffer.
template <int NW, int RB, typename ScoreOf>
__device__ __forceinline__ unsigned long long offer_pass(const WgSel& s,
                                                         unsigned long long todo, int lane,
                                                         int row_lo, ScoreOf score_of) {
  constexpr int E = NW / 2;
  constexpr int kStep = 16;  // atomics in flight at once
  unsigned long long done = 0;
#pragma unroll
  for (int i0 = 0; i0 < RB * E; i0 += kStep) {
    if (((todo >> i0) & 0xffffull) == 0) continue;
    int at[kStep];
#pragma unroll
    for (int d = 0; d < kStep; ++d) {
      const int e = (i0 + d) % E;
      const int c = 8 * (e / 4) + 2 * (lane & 3) + (e & 1);
      at[d] = atom_inc_if(s.bc + c, (todo >> (i0 + d)) & 1ull, kBuf);
    }
#pragma unroll
    for (int d = 0; d < kStep; ++d) {
      const int i = i0 + d;
      if (at[d] < kBuf) {
        const int e = i % E;
        const int c = 8 * (e / 4) + 2 * (lane & 3) + (e & 1);
        s.bs[c * kBuf + at[d]] = score_of(i);
        s.bi[c * kBuf + at[d]] = row_lo + kScanRows * (i / E) + 8 * ((e >> 1) & 1);
        done |= 1ull << i;
      }
    }
  }
  return done;
}

// The bits of `todo` whose scores still reach their queries' bars.
template <int NW, int RB, typename ScoreOf>
__device__ __forceinline__ unsigned long long still_pass(const WgSel& s,
                                                         unsigned long long todo, int lane,
                                                         ScoreOf score_of) {
  constexpr int E = NW / 2;
  unsigned long long keep = 0;
#pragma unroll
  for (int i = 0; i < RB * E; ++i) {
    const int e = i % E;
    const int c = 8 * (e / 4) + 2 * (lane & 3) + (e & 1);
    keep |= static_cast<unsigned long long>(((todo >> i) & 1ull) && score_of(i) >= s.thr[c])
            << i;
  }
  return keep;
}

// wgmma_scan.cuh's sel_epilogue with offer_pass, and after each round of
// flushes the group bar read again and the offers still to make compared
// with the raised bars: in a split's first tile every row passes (no list
// holds k rows yet), and by its first flush other splits may have
// published their slots.
template <int NW, int RB, typename ScoreOf>
__device__ __forceinline__ void tile_epilogue(const WgSel& s, unsigned long long pass,
                                              int warp, int lane, int row_lo, int id,
                                              ScoreOf score_of) {
  if (!wg_any(id, pass != 0)) return;
  for (;;) {
    if (pass != 0) pass &= ~offer_pass<NW, RB>(s, pass, lane, row_lo, score_of);
    if (!wg_any(id, pass != 0)) return;  // every offer of the tile is in
    sel_flush_full(s, warp, lane);
    sel_refresh(s, warp, lane);
    wg_sync(id);  // before the rest are offered again
    pass = still_pass<NW, RB>(s, pass, lane, score_of);
  }
}

// The producer's copy of `bytes` at src into the stage at dst (both 16-byte
// aligned): the bytes past the last multiple of 16 by this thread, now;
// returns the multiple of 16 that TMA's bulk copy is to bring.
__device__ __forceinline__ unsigned tail_copy(unsigned char* dst, const unsigned char* src,
                                              unsigned bytes) {
  const unsigned bulk = bytes & ~15u;
  for (unsigned b = bulk; b < bytes; ++b) dst[b] = src[b];
  return bulk;
}

template <int NW, bool PACKED>
__global__ void __launch_bounds__(kScanThreads, 1)
    int8_mma_kernel(const __grid_constant__ CUtensorMap lmap,
                    const float* __restrict__ lut_scale,
                    const uint8_t* __restrict__ codes, int cols,
                    const float* __restrict__ norms, const float* __restrict__ mask,
                    int64_t nq, int64_t n, int nch, int64_t num_valid, int k, int topk,
                    int metric, int64_t rows_per_split, int splits, int stages, int big,
                    float* __restrict__ part_s, int* __restrict__ part_i,
                    unsigned long long* __restrict__ slots) {
  // big: each split's list (length k) lives in part_*; topk is the k asked
  // for. slots ([nq, splits]) holds the group bars' keys (select.cuh).
  constexpr int QB = 2 * NW;
  constexpr int RB = row_blocks(NW);
  constexpr int kTileRows = RB * kScanRows;
  extern __shared__ unsigned char smem_raw[];
  const int sb = stage_bytes(cols, RB);
  const int cb = code_bytes(cols, RB);
  const ScanSmem sm = scan_layout(smem_raw, sb, stages, q_bytes(QB, nch), NW,
                                  big ? 0 : k);
  float* sqs = reinterpret_cast<float*>(sm.qres + nch * QB * kChunk);  // [QB]
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * QB;
  const int split = blockIdx.y;
  // Rows are below 2^31 (the wrapper checks N).
  const int row_begin = static_cast<int>(split * rows_per_split);
  const int row_end = static_cast<int>(min64(n, row_begin + rows_per_split));
  const int valid_end = static_cast<int>(min64(num_valid, row_end));
  const int tiles = (row_end - row_begin + kTileRows - 1) / kTileRows;
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
      mbar_expect_tx(sm.qbar, nch * QB * kChunk);
      for (int c = 0; c < nch; ++c) {
        tma_load_2d(sm.qres + c * QB * kChunk, &lmap, sm.qbar, c * kChunk,
                    static_cast<int>(q0));
      }
      const bool nrm_in = metric != kIP;
#pragma unroll 1
      for (int t = 0; t < tiles; ++t) {
        const int s = t % stages;
        mbar_wait(sm.empty + s, static_cast<unsigned>((t / stages) & 1) ^ 1u);
        unsigned char* st = sm.ring + static_cast<size_t>(s) * sb;
        const int t0 = row_begin + t * kTileRows;
        const unsigned rows = static_cast<unsigned>(min(kTileRows, row_end - t0));
        const unsigned char* c_src = codes + static_cast<int64_t>(t0) * cols;
        const unsigned char* n_src = reinterpret_cast<const unsigned char*>(norms + t0);
        const unsigned char* m_src = reinterpret_cast<const unsigned char*>(mask + t0);
        const unsigned c_bulk = tail_copy(st, c_src, rows * cols);
        const unsigned n_bulk = nrm_in ? tail_copy(st + cb, n_src, 4 * rows) : 0u;
        const unsigned m_bulk = mask != nullptr ? tail_copy(st + cb + 4 * kTileRows, m_src,
                                                            4 * rows)
                                                : 0u;
        mbar_expect_tx(sm.full + s, c_bulk + n_bulk + m_bulk);
        if (c_bulk) bulk_load(st, c_src, c_bulk, sm.full + s);
        if (n_bulk) bulk_load(st + cb, n_src, n_bulk, sm.full + s);
        if (m_bulk) bulk_load(st + cb + 4 * kTileRows, m_src, m_bulk, sm.full + s);
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
  S.lists = splits;
  S.place = bar_place(splits, topk);
  S.big = big;
  S.int_bar = 0;
  S.part_s = part_s;
  S.part_i = part_i;
  S.slots = slots;
  sel_init(S, tw);
  float* sqw = sqs + wg * NW;  // the warpgroup's scales
  for (int e = tw; e < NW; e += 128) sqw[e] = e < S.nq_w ? __ldg(lut_scale + S.q0 + e) : 0.f;
  mbar_wait(sm.qbar, 0);
  wg_sync(bar_id);

  // Lane (g, t) holds the sums of rows r_lo + 64 b = 16 warp + g + 64 b and
  // r_lo + 64 b + 8 of the tile with queries 8 j + 2 t + e: acc[b][4 j + 2
  // h + e].
  const int r_lo = 16 * warp + (lane >> 2);
  const unsigned kt = (159u + 32u * static_cast<unsigned>(lane & 3)) * 0x01010101u;
  const unsigned char* lut_s = sm.qres + wg * NW * kChunk;  // the warpgroup's queries
  int acc[RB][NW / 2];
  for (int t = 0; t < tiles; ++t) {
    const int t0 = row_begin + t * kTileRows;
    // The group bar every kRefresh tiles, and at tiles 1, 2, 4 and 8 while
    // the lists warm up.
    if (t > 0 && (t % kRefresh == 0 || (t < kRefresh && (t & (t - 1)) == 0))) {
      sel_refresh(S, warp, lane);
    }
    const int s = t % stages;
    mbar_wait(sm.full + s, static_cast<unsigned>((t / stages) & 1));
    const unsigned char* st = sm.ring + static_cast<size_t>(s) * sb;
    const float* snrm = reinterpret_cast<const float*>(st + cb);
    const float* smask = snrm + kTileRows;
    float nrm[RB][2];
    unsigned live = 0;  // bit 2 b + h: row r_lo + 64 b + 8 h of the tile scores
#pragma unroll
    for (int b = 0; b < RB; ++b) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_lo + kScanRows * b + 8 * h;
        const bool in = t0 + r < valid_end;
        nrm[b][h] = in && metric != kIP ? snrm[r] : 0.f;
        live |= static_cast<unsigned>(in && (mask == nullptr || smask[r] != 0.f))
                << (2 * b + h);
      }
    }
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int off_a = (r_lo + kScanRows * b) * cols;
      const int off_b = off_a + 8 * cols;
      for (int c = 0; c < nch; c += 2) {  // nch is even
        unsigned a0[4][4], a1[4][4];
        onehot_chunk<PACKED>(a0, st, off_a, off_b, c, kt);
        onehot_chunk<PACKED>(a1, st, off_a, off_b, c + 1, kt);
        const unsigned char* lb = lut_s + c * QB * kChunk;
        wgmma_fence();
        fence_regs(acc[b]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          WgmmaS8RA<NW>::mma(acc[b], a0[kk], smem_desc(lb + 32 * kk, kChunk), (c | kk) != 0);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          WgmmaS8RA<NW>::mma(acc[b], a1[kk], smem_desc(lb + QB * kChunk + 32 * kk, kChunk),
                             1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc[b]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty + s);  // this warp is done with it

    unsigned long long pass = 0;
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        inv[h] = metric == kCosine ? 1.0f / sqrtf(fmaxf(nrm[b][h], 1e-30f)) : 0.f;
      }
      const unsigned lv = (live >> (2 * b)) & 3u;
      const unsigned long long bits =
          metric == kL2 ? lut8_pass<NW, kL2>(acc[b], S.thr, sqw, lane, lv, nrm[b], inv)
          : metric == kCosine ? lut8_pass<NW, kCosine>(acc[b], S.thr, sqw, lane, lv, nrm[b], inv)
                              : lut8_pass<NW, kIP>(acc[b], S.thr, sqw, lane, lv, nrm[b], inv);
      pass |= bits << (b * (NW / 2));
    }
    tile_epilogue<NW, RB>(S, pass, warp, lane, t0 + r_lo, bar_id, [&](int i) {
      return __int_as_float(acc[i / (NW / 2)][i % (NW / 2)]);
    });
  }
  sel_finish(S, tw, bar_id);
}

template <bool PACKED>
const void* mma_kernel(int nw) {
  switch (nw) {
    case 16: return reinterpret_cast<const void*>(int8_mma_kernel<16, PACKED>);
    case 32: return reinterpret_cast<const void*>(int8_mma_kernel<32, PACKED>);
    case 64: return reinterpret_cast<const void*>(int8_mma_kernel<64, PACKED>);
    case 128: return reinterpret_cast<const void*>(int8_mma_kernel<128, PACKED>);
    default: return nullptr;
  }
}

Variant variant(int nw, int packed4, int nch, int cols, int stages, int k_smem) {
  return Variant{packed4 ? mma_kernel<true>(nw) : mma_kernel<false>(nw),
                 scan_smem(stage_bytes(cols, row_blocks(nw)), stages, q_bytes(2 * nw, nch),
                           nw, k_smem)};
}

}  // namespace

extern "C" {

// Launch the scan and the merge on `stream`. Returns the cudaError_t of the
// launches (0 on success). lut is [nq, 16 m] int8 (16 columns a subspace,
// zeros past ksub) with its per-query scale lut_scale [nq] f32; codes
// [n, cols] u8 (packed4: cols = ceil(m / 2)); `mask` may be null; codes,
// norms and mask 16-byte aligned. The tile takes 2 nw queries (nw in 16,
// 32, 64, 128) and a ring of `stages` stages. With `big` the lists live in
// part_*, allocated as [nq, splits, list_len]; else in shared memory,
// part_* as [nq, splits, k] (list_len = k). With `tree` (always with big)
// part_* and tmp_* are as large as every level of the merge tree needs
// (ops/select.py::merge_scratch) and the tree folds the lists; else
// warp_merge_kernel (k <= 32) or merge_kernel does and tmp_* is unused.
// slots is [nq, splits] zeros
// (the group bars, select.cuh). out_* are [nq, k].
int mvt_adc_int8_mma(const int8_t* lut, const float* lut_scale, const uint8_t* codes,
                     int cols, int packed4, const float* norms, const float* mask,
                     int64_t nq, int64_t n, int m, int64_t num_valid, int k, int metric,
                     int nw, int stages, int big, int splits, int64_t rows_per_split,
                     int list_len, int tree, float* part_s, int* part_i,
                     unsigned long long* slots, float* tmp_s, int* tmp_i, float* out_s,
                     int* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int kl = big ? list_len : k;
  int nch = lut_chunks(m);
  const Variant v = variant(nw, packed4, nch, cols, stages, big ? 0 : kl);
  cudaError_t err = prepare(v);
  if (err != cudaSuccess) return err;
  const int qb = 2 * nw;
  CUtensorMap lmap;
  err = tensor_map_2d(&lmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, lut, 16ull * m, nq, 16ull * m,
                      kChunk, qb, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  void* args[] = {&lmap,  &lut_scale, &codes, &cols,   &norms,  &mask,
                  &nq,    &n,         &nch,   &num_valid, &kl,  &k,
                  &metric, &rows_per_split, &splits, &stages, &big,
                  &part_s, &part_i,   &slots};
  const dim3 grid(static_cast<unsigned>((nq + qb - 1) / qb), static_cast<unsigned>(splits));
  err = cudaLaunchKernel(v.fn, grid, dim3(kScanThreads), args, v.smem, st);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (big || tree) {
    return merge_tree(part_s, part_i, tmp_s, tmp_i, nq, splits, kl, k, nullptr, 0, out_s,
                      out_i, st);
  }
  if (k <= 32) return warp_merge(part_s, part_i, nq, k, splits, out_s, out_i, st);
  merge_kernel<<<static_cast<unsigned>(nq), kMergeThreads, merge_smem_bytes(k), st>>>(
      part_s, part_i, nq, k, splits, out_s, out_i);
  return cudaGetLastError();
}

// Scan blocks of this shape that fit on one SM at once, written to
// *blocks_per_sm (k_smem: the lists' length, in shared memory unless big);
// returns the cudaError_t.
int mvt_adc_int8_mma_occupancy(int nw, int packed4, int m, int cols, int stages,
                               int k_smem, int big, int* blocks_per_sm) {
  return occupancy(variant(nw, packed4, lut_chunks(m), cols, stages, big ? 0 : k_smem),
                   kScanThreads, blocks_per_sm);
}

// Dynamic shared memory of a scan block of this shape, for the wrapper's
// plan (ops/adc_kernel.py::int8_mma_shape mirrors it).
long long mvt_adc_int8_mma_smem(int nw, int m, int cols, int stages, int k_smem) {
  return static_cast<long long>(variant(nw, 1, lut_chunks(m), cols, stages, k_smem).smem);
}

}  // extern "C"
