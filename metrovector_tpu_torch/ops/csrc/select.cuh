// Top-k selection pieces shared by the kernels of this directory: the
// ranking rule, a buffered merge into a sorted list of any length (the
// list in shared memory, or in global memory when k is too large for it),
// the merge of per-split partial lists in shared memory (k <= 1024), and a
// merge tree in global memory for lists of any length. Everything ranks by
// (score descending, key ascending); slots that stay -inf carry index -1
// in the final output.

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
// overwritten. Keys must be unique between list and buffer.
__device__ void flush_buffer(float* ls, int* li, int k, float* bs, int* bi,
                             int cnt, int lane) {
  __syncwarp();
  for (int r = cnt + lane; r < kBuf; r += 32) {
    bs[r] = -CUDART_INF_F;
    bi[r] = kSentinel;
  }
  warp_sort_buffer(bs, bi, lane);
  float v[2];
  int w[2], dest[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane + 32 * h;
    v[h] = bs[r];
    w[h] = bi[r];
    int lo = 0, hi = k;
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
  for (int base = ((k - 1) / 32) * 32; base >= 0 && base + 31 >= first;
       base -= 32) {
    const int j = base + lane;
    float s = 0.f;
    int id = 0, nj = k;
    if (j < k && j >= first) {
      s = ls[j];
      id = li[j];
      int lo = 0, hi = kBuf;
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

// Offer one score per lane (key `idx`) to a query's sorted list (ls, li)
// of length k through its buffer (bs, bi) of kBuf entries: the lanes whose
// score beats the list's cached k-th entry (ts, ti) append to the buffer,
// and a buffer that would overflow is merged into the list first
// (flush_buffer), which refreshes (ts, ti). `cnt` is the buffer's fill.
// Called by the whole warp that owns the list; most calls cost one vote.
__device__ __forceinline__ void offer(float s, int idx, float* ls, int* li,
                                      int k, float* bs, int* bi, int& cnt,
                                      float& ts, int& ti, int lane) {
  bool pass = s > -CUDART_INF_F && better(s, idx, ts, ti);
  unsigned vote = __ballot_sync(kFull, pass);
  if (vote == 0) return;
  if (cnt + __popc(vote) > kBuf) {
    flush_buffer(ls, li, k, bs, bi, cnt, lane);
    cnt = 0;
    ts = ls[k - 1];
    ti = li[k - 1];
    pass = s > -CUDART_INF_F && better(s, idx, ts, ti);
    vote = __ballot_sync(kFull, pass);
  }
  if (pass) {
    const int at = cnt + __popc(vote & ((1u << lane) - 1u));
    bs[at] = s;
    bi[at] = idx;
  }
  cnt += __popc(vote);
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
