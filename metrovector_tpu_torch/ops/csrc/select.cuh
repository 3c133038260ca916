// Top-k selection pieces shared by the kernels of this directory: the
// ranking rule and its 64-bit rank key, a buffered merge into a sorted list
// of any length (the list in shared memory, or in global memory when k is
// too large for it), the merge of per-split partial lists in shared memory
// (k <= 1024), and a merge tree in global memory for lists of any length.
// Everything ranks by (score descending, key ascending); slots that stay
// -inf carry index -1 in the final output.
//
// What bounds a scan's selection is how many candidates reach a list: a
// split that warms its own list from empty admits about k (1 + ln(rows / k))
// rows, and S splits that run at once admit S times that. So the splits of
// a query share a bar, a 64-bit rank key (rank_key) that a row must beat to
// be a candidate. A row that does not beat it has k better rows in some
// lists and cannot be in the top k, so pruning it leaves the answer bit for
// bit the same; the race between splits changes only how much is pruned.
//
// * K4 (sparse_kernel.cu): kth_key[q], which each split raises with
//   atomicMax to its list's k-th entry once the list holds k rows.
// * K1 and K2 (select_tile): a group bar. The splits fall in groups of
//   G = bar_group(S, k) = min(S, 32, k); split s publishes to slot [q, s]
//   the key of its list's r-th entry, r = ceil(k / G), once the list holds
//   r rows. The G splits of a group then hold G r >= k distinct rows at or
//   above the least of their slots, and that least key is the bar. When all
//   splits run at once, each list's k-th entry is about the k-th best of
//   the t rows it has seen, so the best of those (kth_key) is not much
//   better than a split's own; the least r-th entry of G lists is about the
//   k-th best of G t rows.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// An unnamed namespace: every source that includes this gets its own copy,
// so the one shared library links without duplicate symbols.
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSentinel = 0x7fffffff;

// (s, i) ranks before (t, j): score descending, then key ascending.
__device__ __forceinline__ bool better(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// (s, row) as one 64-bit key that orders as better(): score first (-0 ranks
// as +0), then the lower row. 0 ranks below every key and stands for
// (-inf, kSentinel); NaN never gets a key (callers test s > -inf first,
// which NaN fails).
__device__ __forceinline__ unsigned long long rank_key(float s, int row) {
  unsigned u = __float_as_uint(s + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         (0xffffffffu - static_cast<unsigned>(row));
}

__device__ __forceinline__ void unrank(unsigned long long key, float& s,
                                       int& row) {
  if (key == 0) {
    s = -CUDART_INF_F;
    row = kSentinel;
    return;
  }
  const unsigned u = static_cast<unsigned>(key >> 32);
  s = __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
  row = static_cast<int>(0xffffffffu - static_cast<unsigned>(key));
}

// The key of a sorted list's entry (s, i) for a bar: 0 while the list holds
// fewer rows than that entry's place (the slot is still -inf).
__device__ __forceinline__ unsigned long long kth_rank(float s, int i) {
  return s > -CUDART_INF_F ? rank_key(s, i) : 0ull;
}

// The group bar (header): splits per group, the first split of split s's
// group, and the list place (r - 1) a split publishes.
__host__ __device__ __forceinline__ int bar_group(int splits, int k) {
  const int g = splits < 32 ? splits : 32;
  return g < k ? g : k;
}
__host__ __device__ __forceinline__ int bar_base(int split, int splits, int k) {
  const int g = bar_group(splits, k);
  const int b = split / g * g;
  return b + g <= splits ? b : splits - g;
}
__host__ __device__ __forceinline__ int bar_place(int splits, int k) {
  const int g = bar_group(splits, k);
  return (k + g - 1) / g - 1;
}

// A seed (K1's presampled scan): per query the exact top kseed of a subset
// of the rows that the scan leaves out, seed_s / seed_i [nq, kseed] best
// first, (-inf, any) where unfilled, a row's index times seed_mul. Its
// floor is the key of its k-th entry, 0 (prunes nothing) where it holds
// fewer than k finite entries. Every split's bar starts there: a row that
// does not beat the floor has k better rows in the seed, which enters the
// final fold as lists of its own (seed_lists_kernel), so pruning it leaves
// the answer bit for bit the same, as for the group bar.
__device__ __forceinline__ unsigned long long seed_floor(
    const float* seed_s, const int* seed_i, int kseed, int seed_mul, int64_t q,
    int k) {
  if (seed_s == nullptr || kseed < k) return 0ull;
  const int64_t e = q * kseed + k - 1;
  return kth_rank(seed_s[e], seed_i[e] * seed_mul);
}

// The seed as `count` more sorted lists of len of part ([nq, lists, len],
// lists `first` .. first + count - 1): list first + c holds seed entries
// [c len, (c + 1) len), indices times seed_mul, the rest (-inf, kSentinel).
__global__ void __launch_bounds__(256)
    seed_lists_kernel(const float* __restrict__ seed_s,
                      const int* __restrict__ seed_i, int kseed, int seed_mul,
                      int64_t nq, int lists, int first, int count, int len,
                      float* __restrict__ part_s, int* __restrict__ part_i) {
  const int64_t per_q = static_cast<int64_t>(count) * len;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= nq * per_q) return;
  const int64_t q = e / per_q;
  const int64_t j = e % per_q;  // the seed entry, c len + place
  float s = -CUDART_INF_F;
  int row = kSentinel;
  if (j < kseed) {
    const float v = seed_s[q * kseed + j];
    if (v > -CUDART_INF_F) {
      s = v;
      row = seed_i[q * kseed + j] * seed_mul;
    }
  }
  const int64_t o = (q * lists + first) * static_cast<int64_t>(len) + j;
  part_s[o] = s;
  part_i[o] = row;
}

inline cudaError_t seed_lists(const float* seed_s, const int* seed_i, int kseed,
                              int seed_mul, int64_t nq, int lists, int first,
                              int len, float* part_s, int* part_i,
                              cudaStream_t stream) {
  const int count = lists - first;
  if (seed_s == nullptr || count <= 0) return cudaSuccess;
  const int64_t total = nq * count * static_cast<int64_t>(len);
  seed_lists_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      seed_s, seed_i, kseed, seed_mul, nq, lists, first, count, len, part_s, part_i);
  return cudaGetLastError();
}

// Lane `lane`'s part of the group bar of query gq for split `split`: the
// slot of the group's lane-th split, ~0 past the group (keys never reach
// ~0). slots is [nq, splits], null for no group bar.
__device__ __forceinline__ unsigned long long group_slot(
    const unsigned long long* slots, int64_t gq, int split, int splits, int k,
    int lane) {
  if (slots == nullptr || lane >= bar_group(splits, k)) return ~0ull;
  return __ldcg(slots + gq * splits + bar_base(split, splits, k) + lane);
}

// A buffer of kBuf candidates that beat a list's k-th entry, merged into
// the list all at once (flush_buffer): one sort of 64 and one pass over
// the moved part of the list, instead of a warp-wide shift of the list for
// every candidate.
constexpr int kBuf = 64;

// Sort the kBuf entries (bs, bi) best first, in place: a bitonic network,
// two entries per lane, partners by shuffle. Called by a whole warp.
__device__ void warp_sort_buffer(float* bs, int* bi, int lane) {
  float v[2] = {bs[lane], bs[lane + 32]};
  int w[2] = {bi[lane], bi[lane + 32]};
#pragma unroll
  for (int size = 2; size <= kBuf; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // both partners in this lane (size == 64)
        if (better(v[1], w[1], v[0], w[0])) {
          const float ts = v[0];
          const int ti = w[0];
          v[0] = v[1];
          w[0] = w[1];
          v[1] = ts;
          w[1] = ti;
        }
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = lane + 32 * h;
        const float pv = __shfl_xor_sync(kFull, v[h], stride);
        const int pw = __shfl_xor_sync(kFull, w[h], stride);
        // i keeps the better of the pair when it is the lower index of an
        // ascending run, or the higher index of a descending one.
        const bool keep_better = ((i & stride) == 0) == ((i & size) == 0);
        const bool take = keep_better ? better(pv, pw, v[h], w[h])
                                      : better(v[h], w[h], pv, pw);
        if (take) {
          v[h] = pv;
          w[h] = pw;
        }
      }
    }
  }
  __syncwarp();
  bs[lane] = v[0];
  bs[lane + 32] = v[1];
  bi[lane] = w[0];
  bi[lane + 32] = w[1];
  __syncwarp();
}

// Merge the first `cnt` buffer entries into the sorted list (ls, li) of
// length k and keep the best k; empties the buffer. Called by a whole warp.
// Entry r of the sorted buffer lands at (list entries better than it) + r;
// list entry j moves up by the number of buffer entries better than it,
// 32 entries at a time from the end, so each is read before its slot is
// overwritten. Only the list's finite entries [0, fill) are searched or
// moved: the rest is (-inf, kSentinel), which no candidate ranks below and
// which stays in every slot the merge leaves. Keys must be unique between
// list and buffer.
__device__ void flush_buffer(float* ls, int* li, int k, float* bs, int* bi,
                             int cnt, int lane) {
  __syncwarp();
  for (int r = cnt + lane; r < kBuf; r += 32) {
    bs[r] = -CUDART_INF_F;
    bi[r] = kSentinel;
  }
  warp_sort_buffer(bs, bi, lane);
  int fill = ls[k - 1] > -CUDART_INF_F ? k : 0;  // a full list: one load
  for (int hi = k; fill < hi;) {  // the same in every lane
    const int mid = (fill + hi) >> 1;
    if (ls[mid] > -CUDART_INF_F) {
      fill = mid + 1;
    } else {
      hi = mid;
    }
  }
  float v[2];
  int w[2], dest[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane + 32 * h;
    v[h] = bs[r];
    w[h] = bi[r];
    int lo = 0, hi = fill;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (better(ls[mid], li[mid], v[h], w[h])) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    dest[h] = lo + r;
  }
  const int first = __shfl_sync(kFull, dest[0], 0);  // nothing above moves
  for (int base = fill > 0 ? ((fill - 1) / 32) * 32 : -32; base >= 0 && base + 31 >= first;
       base -= 32) {
    const int j = base + lane;
    float s = 0.f;
    int id = 0, nj = k;
    if (j < fill && j >= first) {
      s = ls[j];
      id = li[j];
      int lo = 0, hi = cnt;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (better(bs[mid], bi[mid], s, id)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      nj = j + lo;
    }
    __syncwarp();
    if (nj < k) {
      ls[nj] = s;
      li[nj] = id;
    }
    __syncwarp();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (dest[h] < k) {
      ls[dest[h]] = v[h];
      li[dest[h]] = w[h];
    }
  }
  __syncwarp();
}

// Entries of the sorted list (s, i)[0, len) that rank before (t, j).
__device__ __forceinline__ int count_better(const float* s, const int* i,
                                            int len, float t, int j) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(s[mid], i[mid], t, j)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

constexpr int kMergeThreads = 256;
constexpr int kMergePerThread = 4;  // k <= kMergeThreads * kMergePerThread

// Shared memory of merge_kernel: three lists of k (score, key) pairs.
__host__ __device__ constexpr size_t merge_smem_bytes(int k) {
  return static_cast<size_t>(k) * 24;
}

// One block per query folds the S sorted lists of k ([nq, S, k] in part_*)
// into a running top-k in shared memory, one list at a time, with the next
// list's loads in flight while the current one merges. Only the prefix of a
// list that beats the running k-th entry can enter; each entry of the
// running list and of that prefix finds its slot in the merged order by a
// binary search in the other. Keys are unique across the lists (row
// indices) except for the (-inf, kSentinel) fill, which never enters a
// prefix, so the slots are distinct and the first k are all written.
// Slots that stay -inf get index -1.
__global__ void __launch_bounds__(kMergeThreads)
    merge_kernel(const float* __restrict__ part_s,
                 const int* __restrict__ part_i, int64_t nq, int k,
                 int splits, float* __restrict__ out_s,
                 int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char merge_raw[];
  float* as = reinterpret_cast<float*>(merge_raw);  // the running top-k
  int* ai = reinterpret_cast<int*>(as + k);
  float* bs = reinterpret_cast<float*>(ai + k);  // the list being merged
  int* bi = reinterpret_cast<int*>(bs + k);
  float* cs = reinterpret_cast<float*>(bi + k);  // the merged top-k
  int* ci = reinterpret_cast<int*>(cs + k);
  const int tid = threadIdx.x;
  const int64_t q = blockIdx.x;
  const float* ps = part_s + q * splits * k;
  const int* pi = part_i + q * splits * k;

  for (int e = tid; e < k; e += kMergeThreads) {
    as[e] = ps[e];
    ai[e] = pi[e];
  }
  float ns[kMergePerThread];
  int ni[kMergePerThread];
#pragma unroll
  for (int r = 0; r < kMergePerThread; ++r) {
    const int e = tid + r * kMergeThreads;
    const bool in = splits > 1 && e < k;
    ns[r] = in ? ps[k + e] : -CUDART_INF_F;
    ni[r] = in ? pi[k + e] : kSentinel;
  }
  for (int sp = 1; sp < splits; ++sp) {
#pragma unroll
    for (int r = 0; r < kMergePerThread; ++r) {
      const int e = tid + r * kMergeThreads;
      if (e < k) {
        bs[e] = ns[r];
        bi[e] = ni[r];
      }
      const bool in = sp + 1 < splits && e < k;
      const int64_t g = static_cast<int64_t>(sp + 1) * k + e;
      ns[r] = in ? ps[g] : -CUDART_INF_F;
      ni[r] = in ? pi[g] : kSentinel;
    }
    __syncthreads();  // this list and the running list are complete
    const float ts = as[k - 1];
    const int ti = ai[k - 1];
    int len = 0;  // the list is sorted: its entries that beat the k-th
#pragma unroll
    for (int r = 0; r < kMergePerThread; ++r) {
      const int e = tid + r * kMergeThreads;
      len += __syncthreads_count(e < k && better(bs[e], bi[e], ts, ti));
    }
    if (len == 0) continue;  // the same for every thread
    for (int e = tid; e < k; e += kMergeThreads) {
      const int r = e + count_better(bs, bi, len, as[e], ai[e]);
      if (r < k) {
        cs[r] = as[e];
        ci[r] = ai[e];
      }
    }
    for (int e = tid; e < len; e += kMergeThreads) {
      const int r = e + count_better(as, ai, k, bs[e], bi[e]);
      if (r < k) {
        cs[r] = bs[e];
        ci[r] = bi[e];
      }
    }
    __syncthreads();  // the merged list is complete; it becomes the running
    float* ts_ptr = as;
    int* ti_ptr = ai;
    as = cs;
    ai = ci;
    cs = ts_ptr;
    ci = ti_ptr;
  }
  for (int e = tid; e < k; e += kMergeThreads) {
    const float sv = as[e];
    out_s[q * k + e] = sv;
    out_i[q * k + e] = sv > -CUDART_INF_F ? ai[e] : -1;
  }
}

// One warp's selection for one query of a scan block after a tile of rows
// was scored. The scoring threads have written the score of every row that
// beat the query's bar to sc (indexed by its bit) and set its bit in
// word_of(0 .. nwords - 1) (nwords <= 32; bit b of the words is sc[b] and
// row row_of(b)). The bar is the larger of *bar and the group bar, the least
// of the lanes' `group` (group_slot, loaded by the caller ahead of time).
// Rows that still beat it go to the query's buffer (bs, bi; fill *bc); a
// buffer that would overflow is merged into the sorted list (ls, li) of
// length k first (flush_buffer), after which the list's last entry raises
// the bar and the list's entry at `place` goes to *slot (when slot is not
// null and place < k) for the other splits' group bars. The bar goes back
// to *bar for the next tile's scoring threads. Called by the whole warp;
// a tile without candidates costs it one load and one vote.
template <typename WordOf, typename RowOf>
__device__ __forceinline__ void select_tile(
    const float* sc, WordOf word_of, int nwords, RowOf row_of,
    float* ls, int* li, int k, float* bs, int* bi, int* bc,
    unsigned long long* bar, unsigned long long group,
    unsigned long long* slot, int place, int lane) {
  const unsigned word = lane < nwords ? word_of(lane) : 0u;
  unsigned todo = __ballot_sync(kFull, word != 0);
  if (todo != 0) {  // else the bar stays as it is until rows reach it
    unsigned long long bk = *bar;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long h = __shfl_xor_sync(kFull, group, o);
      group = h < group ? h : group;
    }
    if (group != ~0ull && group > bk) bk = group;
    int cnt = *bc;
    do {
      const int wd = __ffs(todo) - 1;
      todo &= todo - 1;
      const unsigned bits = __shfl_sync(kFull, word, wd);
      const int idx = row_of(32 * wd + lane);
      const float s = (bits >> lane) & 1u ? sc[32 * wd + lane] : -CUDART_INF_F;
      bool pass = s > -CUDART_INF_F && rank_key(s, idx) > bk;
      unsigned vote = __ballot_sync(kFull, pass);
      if (vote == 0) continue;
      if (cnt + __popc(vote) > kBuf) {
        flush_buffer(ls, li, k, bs, bi, cnt, lane);
        cnt = 0;
        const unsigned long long own = kth_rank(ls[k - 1], li[k - 1]);
        if (own > bk) bk = own;
        if (slot != nullptr && place < k && lane == 0) {
          const unsigned long long mine = kth_rank(ls[place], li[place]);
          if (mine != 0) __stcg(slot, mine);
        }
        pass = s > -CUDART_INF_F && rank_key(s, idx) > bk;
        vote = __ballot_sync(kFull, pass);
      }
      if (pass) {
        const int at = cnt + __popc(vote & ((1u << lane) - 1u));
        bs[at] = s;
        bi[at] = idx;
      }
      cnt += __popc(vote);
    } while (todo != 0);
    __syncwarp();
    if (lane == 0) {
      *bc = cnt;
      *bar = bk;
    }
  }
}

// Entries of the sorted list (s, i)[0, len) that rank before (t, j) or tie
// with it exactly.
__device__ __forceinline__ int count_not_worse(const float* s, const int* i,
                                               int len, float t, int j) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!better(t, j, s[mid], i[mid])) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

constexpr int kTreeThreads = 256;
constexpr int64_t kTreeBlocks = 132 * 16;

// One level of the merge tree: src holds `lists` sorted lists of len_in
// per query ([nq, lists, len_in]); list 2p and 2p+1 merge into list p of
// dst ([nq, ceil(lists/2), len_out], len_out <= 2 len_in). Each entry
// finds its slot by a binary search in the other list: an entry of the
// first list lands after the second list's entries that beat it, an entry
// of the second after the first list's entries that beat it or tie with
// it. That is a stable merge, so the slots are distinct even where entries
// repeat (the -inf fill, or one row offered twice). A list without a
// partner is copied and its tail filled with (-inf, kSentinel).
__global__ void __launch_bounds__(kTreeThreads)
    merge_pairs_kernel(const float* __restrict__ src_s,
                       const int* __restrict__ src_i, int64_t nq, int lists,
                       int len_in, float* __restrict__ dst_s,
                       int* __restrict__ dst_i, int len_out) {
  const int pairs = (lists + 1) / 2;
  const int64_t total = nq * pairs * 2 * static_cast<int64_t>(len_in);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kTreeThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kTreeThreads + threadIdx.x;
       e < total; e += step) {
    const int pos = static_cast<int>(e % len_in);
    int64_t rest = e / len_in;
    const int side = static_cast<int>(rest & 1);
    rest >>= 1;
    const int p = static_cast<int>(rest % pairs);
    const int64_t q = rest / pairs;
    const int64_t a = (q * lists + 2 * p) * static_cast<int64_t>(len_in);
    const int64_t b = a + len_in;
    const bool has_b = 2 * p + 1 < lists;
    float v = -CUDART_INF_F;
    int key = kSentinel;
    int r;
    if (side == 0) {
      v = src_s[a + pos];
      key = src_i[a + pos];
      r = pos + (has_b ? count_better(src_s + b, src_i + b, len_in, v, key) : 0);
    } else if (has_b) {
      v = src_s[b + pos];
      key = src_i[b + pos];
      r = pos + count_not_worse(src_s + a, src_i + a, len_in, v, key);
    } else {
      r = len_in + pos;  // the fill of a list without a partner
    }
    if (r < len_out) {
      const int64_t o = (q * pairs + p) * static_cast<int64_t>(len_out) + r;
      dst_s[o] = v;
      dst_i[o] = key;
    }
  }
}

// The one list left ([nq, len]) -> out [nq, k]: -inf slots get index -1;
// with `cand` ([nq, r]) a key is a position in the query's candidate row
// and the output index is the candidate it names.
__global__ void __launch_bounds__(kTreeThreads)
    finish_kernel(const float* __restrict__ src_s,
                  const int* __restrict__ src_i, int64_t nq, int len, int k,
                  const int* __restrict__ cand, int64_t r,
                  float* __restrict__ out_s, int* __restrict__ out_i) {
  const int64_t total = nq * k;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kTreeThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kTreeThreads + threadIdx.x;
       e < total; e += step) {
    const int64_t q = e / k;
    const int j = static_cast<int>(e % k);
    const float s = j < len ? src_s[q * len + j] : -CUDART_INF_F;
    const int key = j < len ? src_i[q * len + j] : kSentinel;
    out_s[e] = s;
    out_i[e] = s > -CUDART_INF_F ? (cand != nullptr ? cand[q * r + key] : key)
                                 : -1;
  }
}

inline unsigned tree_blocks(int64_t total) {
  const int64_t want = (total + kTreeThreads - 1) / kTreeThreads;
  return static_cast<unsigned>(want < 1 ? 1 : (want < kTreeBlocks ? want : kTreeBlocks));
}

// Fold `lists` sorted lists of `len` per query (part [nq, lists, len]) into
// the top k of each query (out [nq, k]), one tree level per launch, the
// levels alternating between part and tmp. The caller sizes both for every
// level (ops/select.py::merge_scratch) and keeps their contents scratch.
inline cudaError_t merge_tree(float* part_s, int* part_i, float* tmp_s,
                              int* tmp_i, int64_t nq, int lists, int len,
                              int k, const int* cand, int64_t r, float* out_s,
                              int* out_i, cudaStream_t stream) {
  float* src_s = part_s;
  int* src_i = part_i;
  float* dst_s = tmp_s;
  int* dst_i = tmp_i;
  while (lists > 1) {
    const int len_out = static_cast<int>(
        2 * static_cast<int64_t>(len) < k ? 2 * static_cast<int64_t>(len) : k);
    const int pairs = (lists + 1) / 2;
    merge_pairs_kernel<<<tree_blocks(nq * pairs * 2 * static_cast<int64_t>(len)),
                         kTreeThreads, 0, stream>>>(src_s, src_i, nq, lists, len,
                                                    dst_s, dst_i, len_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    float* ts = src_s;
    int* ti = src_i;
    src_s = dst_s;
    src_i = dst_i;
    dst_s = ts;
    dst_i = ti;
    lists = pairs;
    len = len_out;
  }
  finish_kernel<<<tree_blocks(nq * k), kTreeThreads, 0, stream>>>(
      src_s, src_i, nq, len, k, cand, r, out_s, out_i);
  return cudaGetLastError();
}

}  // namespace
