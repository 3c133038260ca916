// Native HNSW graph builder + searcher for metrovector_tpu_torch: the JAX
// package's metrovector_tpu/native/hnsw.cpp, ABI version 3, unchanged in
// behavior (the tests hold the two graphs equal at n_threads == 1).
//
// The Python twin (../index/hnsw.py) defines the behavior; this module is
// the performance path for the host-side graph work, which stays on the
// host (chained data-dependent tiny gathers). Build is incremental
// insertion (Malkov & Yashunin 2016, matching the Python twin); search is
// greedy upper-layer descent + layer-0 beam.
//
// Scores are the engine's greater-is-better convention:
//   use_norms=1 (L2):  s(q, x) = 2 q·x − ‖x‖²
//   use_norms=0 (IP / pre-normalized cosine):  s(q, x) = q·x
//
// Neighbor selection uses the diversifying heuristic (Malkov & Yashunin
// Algorithm 4 with keepPrunedConnections backfill): a candidate is kept
// only if it is closer to the base point than to every already-kept
// neighbor; leftover slots refill with the best pruned candidates (iid
// corpora regress without that). Plain closest-M selection
// (the round-3 first cut) fragments clustered corpora into per-cluster
// components — all M closest links stay inside a cluster whenever the
// cluster has more than M members — and recall stops rising with ef.
//
// The handle BORROWS rows/norms — the Python caller keeps them alive.
// Adjacency is exported in the Python frozen layout (ids sorted
// ascending, fixed-width rows, −1 padding), so persistence and the
// numpy fallback interoperate bit-for-bit with graphs built here.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <mutex>
#include <queue>
#include <random>
#include <utility>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__AVX512F__) || defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

// SIMD dot product (FMA, two accumulators for ILP). The beam spends
// ~all its time in candidate scoring; the strict-FP scalar loop cannot
// vectorize (additions would reorder), so this is explicit. Score *bits*
// may differ from the scalar/numpy twins (different summation order) —
// HNSW graphs are score-rank structures and the tests are recall-based,
// so cross-implementation bit-equality was never promised (the numpy
// twin's BLAS dot already ordered differently).
inline float dot_f32(const float* __restrict a, const float* __restrict b,
                     int32_t d) {
  int32_t i = 0;
  float dot = 0.f;
#if defined(__AVX512F__)
  __m512 acc0 = _mm512_setzero_ps(), acc1 = _mm512_setzero_ps();
  for (; i + 32 <= d; i += 32) {
    acc0 = _mm512_fmadd_ps(_mm512_loadu_ps(a + i), _mm512_loadu_ps(b + i),
                           acc0);
    acc1 = _mm512_fmadd_ps(_mm512_loadu_ps(a + i + 16),
                           _mm512_loadu_ps(b + i + 16), acc1);
  }
  for (; i + 16 <= d; i += 16)
    acc0 = _mm512_fmadd_ps(_mm512_loadu_ps(a + i), _mm512_loadu_ps(b + i),
                           acc0);
  dot = _mm512_reduce_add_ps(_mm512_add_ps(acc0, acc1));
#elif defined(__AVX2__) && defined(__FMA__)
  __m256 acc0 = _mm256_setzero_ps(), acc1 = _mm256_setzero_ps();
  for (; i + 16 <= d; i += 16) {
    acc0 = _mm256_fmadd_ps(_mm256_loadu_ps(a + i), _mm256_loadu_ps(b + i),
                           acc0);
    acc1 = _mm256_fmadd_ps(_mm256_loadu_ps(a + i + 8),
                           _mm256_loadu_ps(b + i + 8), acc1);
  }
  for (; i + 8 <= d; i += 8)
    acc0 = _mm256_fmadd_ps(_mm256_loadu_ps(a + i), _mm256_loadu_ps(b + i),
                           acc0);
  __m256 acc = _mm256_add_ps(acc0, acc1);
  __m128 lo = _mm256_castps256_ps128(acc);
  __m128 hi = _mm256_extractf128_ps(acc, 1);
  __m128 s = _mm_add_ps(lo, hi);
  s = _mm_add_ps(s, _mm_movehl_ps(s, s));
  s = _mm_add_ss(s, _mm_shuffle_ps(s, s, 1));
  dot = _mm_cvtss_f32(s);
#endif
  for (; i < d; ++i) dot += a[i] * b[i];
  return dot;
}

// Prefetch the leading cache lines of a row (beam neighbor rows are
// effectively random DRAM lines; prefetching the NEXT candidate's
// row while scoring the current one hides most of that latency).
inline void prefetch_row(const float* row, int32_t d) {
  __builtin_prefetch(row);
  if (d > 16) __builtin_prefetch(row + 16);
  if (d > 32) __builtin_prefetch(row + 32);
}

using ScoredNode = std::pair<float, int64_t>;

struct Layer {
  std::vector<int32_t> slot_of;  // node id -> slot (-1 absent); size n
  std::vector<int32_t> ids;      // slot -> node id
  std::vector<int32_t> cnt;      // neighbors in use per slot
  std::vector<int32_t> adj;      // [slots, width], -1 padded
  int32_t width = 0;

  int32_t* row(int64_t slot) { return adj.data() + slot * width; }
  const int32_t* row(int64_t slot) const {
    return adj.data() + slot * width;
  }
};

// Stamped visited set: O(1) clear between searches, O(n) memory once.
struct VisitedTable {
  std::vector<uint32_t> mark;
  uint32_t stamp = 0;
  void reset(int64_t n) {
    if ((int64_t)mark.size() != n) {
      mark.assign(n, 0);
      stamp = 0;
    }
    if (++stamp == 0) {
      std::fill(mark.begin(), mark.end(), 0u);
      stamp = 1;
    }
  }
  bool seen(int64_t v) {
    if (mark[v] == stamp) return true;
    mark[v] = stamp;
    return false;
  }
};

struct Index {
  const float* rows = nullptr;   // borrowed [n, d]
  const float* norms = nullptr;  // borrowed [n] (only if use_norms)
  int64_t n = 0;
  int32_t d = 0;
  int32_t use_norms = 0;
  int32_t m = 16;
  int32_t ef_c = 200;
  // Neighbor selection: 1 = diversifying heuristic (Alg. 4 + backfill,
  // the default — clustered corpora fragment without it), 0 = plain
  // closest-M (better on structureless iid corpora, in the JAX
  // package's measurements).
  int32_t heuristic = 1;
  // Atomic: during parallel builds the entry point is read by every
  // inserting thread and occasionally replaced (level promotion); a
  // stale read only lengthens one descent.
  std::atomic<int64_t> entry{-1};
  std::vector<Layer> layers;

  float score(const float* q, int64_t v) const {
    float dot = dot_f32(q, rows + v * (int64_t)d, d);
    return use_norms ? 2.f * dot - norms[v] : dot;
  }
};

// Max-heap of candidates (best on top) vs min-heap of results (worst on
// top) — the classic SEARCH-LAYER pair.
struct WorstOnTop {
  bool operator()(const ScoredNode& a, const ScoredNode& b) const {
    return a > b;
  }
};

// `locks`: per-NODE mutex array used during parallel builds — neighbor
// rows are copied out under the owning node's lock (writers in
// `connect` hold the same lock), so concurrent insertion never shows a
// torn row. Null for read-only (adopted / post-build) searches.
void search_layer(const Index& ix, const float* q, const int64_t* eps,
                  int64_t n_eps, int32_t ef, const Layer& L,
                  VisitedTable& vt, std::vector<ScoredNode>& out,
                  std::mutex* locks = nullptr) {
  vt.reset(ix.n);
  std::priority_queue<ScoredNode> cand;
  std::priority_queue<ScoredNode, std::vector<ScoredNode>, WorstOnTop> res;
  for (int64_t i = 0; i < n_eps; ++i) {
    int64_t v = eps[i];
    if (v < 0 || vt.seen(v)) continue;
    float s = ix.score(q, v);
    cand.emplace(s, v);
    res.emplace(s, v);
    if ((int32_t)res.size() > ef) res.pop();
  }
  std::vector<int32_t> nbbuf;
  std::vector<int32_t> unseen;
  while (!cand.empty()) {
    ScoredNode top = cand.top();
    cand.pop();
    if ((int32_t)res.size() >= ef && top.first < res.top().first) break;
    int32_t slot = L.slot_of[top.second];
    if (slot < 0) continue;
    const int32_t* nb;
    if (locks) {
      std::lock_guard<std::mutex> g(locks[top.second]);
      nbbuf.assign(L.row(slot), L.row(slot) + L.width);
      nb = nbbuf.data();
    } else {
      nb = L.row(slot);
    }
    // Batched candidate evaluation: dedup + issue row prefetches first,
    // then score with two-row lookahead — the heap/visited bookkeeping
    // comes off the DRAM load-latency path of the scattered row gathers.
    for (int32_t j = 0; j < L.width; ++j)
      if (nb[j] >= 0) __builtin_prefetch(&vt.mark[nb[j]]);
    unseen.clear();
    for (int32_t j = 0; j < L.width; ++j) {
      int32_t v = nb[j];
      if (v < 0 || vt.seen(v)) continue;
      prefetch_row(ix.rows + (int64_t)v * ix.d, ix.d);
      unseen.push_back(v);
    }
    for (size_t u = 0; u < unseen.size(); ++u) {
      int32_t v = unseen[u];
      if (u + 2 < unseen.size())
        prefetch_row(ix.rows + (int64_t)unseen[u + 2] * ix.d, ix.d);
      float s = ix.score(q, v);
      if ((int32_t)res.size() < ef) {
        res.emplace(s, v);
        cand.emplace(s, v);
      } else if (s > res.top().first) {
        res.pop();
        res.emplace(s, v);
        cand.emplace(s, v);
      }
    }
  }
  out.clear();
  out.reserve(res.size());
  while (!res.empty()) {
    out.push_back(res.top());
    res.pop();
  }
  std::reverse(out.begin(), out.end());  // best-first
}

// Diversifying neighbor selection (Malkov & Yashunin Alg. 4 with
// keepPrunedConnections). `cand` must be sorted best-first w.r.t.
// `base`; the diversity pass keeps e only when s_e(base) >= s_e(r) for
// every already-kept r, i.e. e is no farther from the base than from any
// selected neighbor (ties keep, favoring connectivity); remaining slots
// backfill with the best pruned candidates — without it, iid
// (structureless) corpora get graphs far sparser than cap and recall
// REGRESSES below even closest-M. Score asymmetry is fine:
// s_e(x) = -d(e,x)^2 + ||e||^2 in L2 mode, so comparisons at fixed e
// are distance comparisons.
void select_heuristic(const Index& ix, const std::vector<ScoredNode>& cand,
                      int64_t base, int32_t cap,
                      std::vector<ScoredNode>& out) {
  out.clear();
  if ((int32_t)cand.size() <= cap) {
    out = cand;
    return;
  }
  if (!ix.heuristic) {  // plain closest-M: best-first prefix
    out.assign(cand.begin(), cand.begin() + cap);
    return;
  }
  std::vector<ScoredNode> pruned;
  for (const ScoredNode& e : cand) {
    if ((int32_t)out.size() >= cap) break;
    const float* eq = ix.rows + e.second * (int64_t)ix.d;
    float s_e_base = ix.score(eq, base);
    bool keep = true;
    for (const ScoredNode& r : out) {
      if (ix.score(eq, r.second) > s_e_base) {
        keep = false;
        break;
      }
    }
    if (keep)
      out.push_back(e);
    else if ((int32_t)pruned.size() < cap)
      pruned.push_back(e);
  }
  for (const ScoredNode& e : pruned) {
    if ((int32_t)out.size() >= cap) break;
    out.push_back(e);
  }
}

// Link node <-> chosen (best-first), pruning over-full neighbor lists
// back to `cap` with the same diversifying heuristic — the Python
// _connect_build twin. `locks`: per-node mutexes (parallel build); at
// most one is held at a time, so there is no ordering to deadlock on.
// Slots are fully preallocated before insertion starts (no reallocation
// races; see mvt_hnsw_build).
void connect(Index& ix, Layer& L, int64_t node,
             const std::vector<ScoredNode>& chosen, int32_t cap,
             std::mutex* locks) {
  int32_t s = L.slot_of[node];
  {
    std::unique_lock<std::mutex> g;
    if (locks) g = std::unique_lock<std::mutex>(locks[node]);
    int32_t k = std::min<int32_t>(cap, (int32_t)chosen.size());
    int32_t* r = L.row(s);
    for (int32_t i = 0; i < k; ++i) r[i] = (int32_t)chosen[i].second;
    for (int32_t i = k; i < L.width; ++i) r[i] = -1;
    L.cnt[s] = k;
  }
  int32_t k = std::min<int32_t>(cap, (int32_t)chosen.size());
  for (int32_t i = 0; i < k; ++i) {
    int64_t v = chosen[i].second;
    std::unique_lock<std::mutex> g;
    if (locks) g = std::unique_lock<std::mutex>(locks[v]);
    int32_t vs = L.slot_of[v];
    int32_t* vr = L.row(vs);
    if (L.cnt[vs] < cap) {
      vr[L.cnt[vs]++] = (int32_t)node;
      continue;
    }
    const float* vq = ix.rows + v * (int64_t)ix.d;
    std::vector<ScoredNode> cs;
    cs.reserve(L.cnt[vs] + 1);
    for (int32_t j = 0; j < L.cnt[vs]; ++j)
      cs.emplace_back(ix.score(vq, vr[j]), vr[j]);
    cs.emplace_back(ix.score(vq, node), node);
    std::stable_sort(cs.begin(), cs.end(),
                     [](const ScoredNode& a, const ScoredNode& b) {
                       return a.first > b.first;
                     });
    std::vector<ScoredNode> kept;
    select_heuristic(ix, cs, v, cap, kept);
    int32_t nk = (int32_t)kept.size();
    for (int32_t j = 0; j < nk; ++j) vr[j] = (int32_t)kept[j].second;
    for (int32_t j = nk; j < L.width; ++j) vr[j] = -1;
    L.cnt[vs] = nk;
  }
}

void insert_node(Index& ix, int64_t node, int32_t lvl, int64_t ep,
                 std::vector<ScoredNode>& beam, VisitedTable& vt,
                 std::mutex* locks) {
  const float* q = ix.rows + node * (int64_t)ix.d;
  int32_t max_level = (int32_t)ix.layers.size() - 1;
  for (int32_t layer = max_level; layer > lvl; --layer) {
    search_layer(ix, q, &ep, 1, 1, ix.layers[layer], vt, beam, locks);
    if (!beam.empty()) ep = beam[0].second;
  }
  std::vector<int64_t> eps{ep};
  for (int32_t layer = std::min(lvl, max_level); layer >= 0; --layer) {
    Layer& L = ix.layers[layer];
    search_layer(ix, q, eps.data(), (int64_t)eps.size(), ix.ef_c, L,
                 vt, beam, locks);
    int32_t cap = L.width;
    std::vector<ScoredNode> filtered;
    filtered.reserve(beam.size());
    // Drop self and non-members: the beam's seed entry points can sit
    // ABOVE their own level (the global entry seeds every layer during
    // descent) and have no slot here — the lazy-slot build used to
    // silently promote them; preallocated slot tables must not link
    // them (heap overflow via slot −1 otherwise; caught by ASan).
    for (const ScoredNode& sn : beam)
      if (sn.second != node && L.slot_of[sn.second] >= 0)
        filtered.push_back(sn);
    std::vector<ScoredNode> chosen;
    select_heuristic(ix, filtered, node, cap, chosen);
    connect(ix, L, node, chosen, cap, locks);
    eps.clear();
    for (const ScoredNode& sn : beam) eps.push_back(sn.second);
    if (eps.empty()) eps.push_back(ep);
  }
}

int64_t greedy_descend(const Index& ix, const float* q, int64_t ep,
                       const Layer& L) {
  int64_t cur = ep;
  float cur_s = ix.score(q, cur);
  for (;;) {
    int32_t slot = L.slot_of[cur];
    if (slot < 0) return cur;
    const int32_t* nb = L.row(slot);
    for (int32_t j = 0; j < L.width; ++j)
      if (nb[j] >= 0) prefetch_row(ix.rows + (int64_t)nb[j] * ix.d, ix.d);
    int64_t best = -1;
    float best_s = cur_s;
    for (int32_t j = 0; j < L.width; ++j) {
      int32_t v = nb[j];
      if (v < 0) continue;
      float s = ix.score(q, v);
      if (s > best_s) {
        best_s = s;
        best = v;
      }
    }
    if (best < 0) return cur;
    cur = best;
    cur_s = best_s;
  }
}

}  // namespace

extern "C" {

int mvt_hnsw_abi_version() { return 3; }

// Parallel insertion build (hnswlib-style): every layer's slot table is
// fully preallocated from the pre-drawn levels (no reallocation during
// insertion), neighbor rows are guarded by one mutex per NODE (held one
// at a time — no ordering, no deadlock), and the entry point updates
// under a global mutex. `n_threads` ≤ 0 means the OpenMP default; the
// sequential result is reproduced exactly at n_threads == 1 (dynamic
// scheduling degenerates to loop order). Built single-threaded where
// OpenMP is unavailable.
void* mvt_hnsw_build(const float* rows, int64_t n, int32_t d,
                     const float* norms, int32_t use_norms, int32_t m,
                     int32_t ef_construction, uint64_t seed,
                     const int64_t* live, int64_t n_live,
                     int32_t n_threads, int32_t heuristic) {
  Index* ix = new Index;
  ix->rows = rows;
  ix->norms = norms;
  ix->n = n;
  ix->d = d;
  ix->use_norms = use_norms;
  ix->m = m;
  ix->ef_c = ef_construction;
  ix->heuristic = heuristic;
  if (n_live == 0) return ix;

  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> U(1e-12, 1.0);
  double ml = 1.0 / std::log((double)std::max<int32_t>(m, 2));
  std::vector<int32_t> levels(n, 0);
  for (int64_t i = 0; i < n; ++i)
    levels[i] =
        std::min<int32_t>(32, (int32_t)(-std::log(U(rng)) * ml));

  int32_t max_live_level = 0;
  for (int64_t i = 0; i < n_live; ++i)
    max_live_level = std::max(max_live_level, levels[live[i]]);

  ix->layers.resize(max_live_level + 1);
  for (size_t l = 0; l < ix->layers.size(); ++l) {
    Layer& L = ix->layers[l];
    L.width = (l == 0) ? 2 * m : m;
    L.slot_of.assign(n, -1);
    for (int64_t i = 0; i < n_live; ++i) {
      int64_t node = live[i];
      if (levels[node] >= (int32_t)l) {
        L.slot_of[node] = (int32_t)L.ids.size();
        L.ids.push_back((int32_t)node);
      }
    }
    L.cnt.assign(L.ids.size(), 0);
    L.adj.assign((int64_t)L.ids.size() * L.width, -1);
  }
  ix->entry = live[0];
  std::atomic<int32_t> entry_level{levels[live[0]]};
  std::vector<std::mutex> locks(n);
  std::mutex entry_mu;

#ifdef _OPENMP
  if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel
#endif
  {
    VisitedTable vt;
    std::vector<ScoredNode> beam;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
    for (int64_t i = 1; i < n_live; ++i) {
      int64_t node = live[i];
      int32_t lvl = levels[node];
      insert_node(*ix, node, lvl, ix->entry.load(), beam, vt,
                  locks.data());
      if (lvl > entry_level.load()) {
        std::lock_guard<std::mutex> g(entry_mu);
        if (lvl > entry_level.load()) {
          ix->entry = node;
          entry_level = lvl;
        }
      }
    }
  }
  return ix;
}

void* mvt_hnsw_new(const float* rows, int64_t n, int32_t d,
                   const float* norms, int32_t use_norms, int32_t m,
                   int32_t ef_construction) {
  Index* ix = new Index;
  ix->rows = rows;
  ix->norms = norms;
  ix->n = n;
  ix->d = d;
  ix->use_norms = use_norms;
  ix->m = m;
  ix->ef_c = ef_construction;
  return ix;
}

// Adopt one frozen layer (bottom-up call order): ids [n_ids] node ids,
// adj [n_ids, width] neighbor rows, −1 padded.
void mvt_hnsw_add_layer(void* h, const int32_t* ids, int64_t n_ids,
                        const int32_t* adj, int32_t width) {
  Index* ix = (Index*)h;
  ix->layers.emplace_back();
  Layer& L = ix->layers.back();
  L.width = width;
  L.slot_of.assign(ix->n, -1);
  L.ids.assign(ids, ids + n_ids);
  L.adj.assign(adj, adj + n_ids * (int64_t)width);
  L.cnt.resize(n_ids);
  for (int64_t s = 0; s < n_ids; ++s) {
    L.slot_of[ids[s]] = (int32_t)s;
    int32_t c = 0;
    const int32_t* r = L.row(s);
    for (int32_t j = 0; j < width; ++j)
      if (r[j] >= 0) ++c;
    L.cnt[s] = c;
  }
}

void mvt_hnsw_set_entry(void* h, int64_t entry) {
  ((Index*)h)->entry = entry;
}

int32_t mvt_hnsw_n_layers(void* h) {
  return (int32_t)((Index*)h)->layers.size();
}

int64_t mvt_hnsw_layer_size(void* h, int32_t l) {
  return (int64_t)((Index*)h)->layers[l].ids.size();
}

int32_t mvt_hnsw_layer_width(void* h, int32_t l) {
  return ((Index*)h)->layers[l].width;
}

int64_t mvt_hnsw_entry(void* h) { return ((Index*)h)->entry; }

// Export in the Python frozen layout: slots sorted by node id ascending.
void mvt_hnsw_export_layer(void* h, int32_t l, int32_t* ids_out,
                           int32_t* adj_out) {
  Index* ix = (Index*)h;
  Layer& L = ix->layers[l];
  int64_t sz = (int64_t)L.ids.size();
  std::vector<int32_t> order(sz);
  for (int64_t i = 0; i < sz; ++i) order[i] = (int32_t)i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return L.ids[a] < L.ids[b];
  });
  for (int64_t i = 0; i < sz; ++i) {
    int32_t s = order[i];
    ids_out[i] = L.ids[s];
    std::memcpy(adj_out + i * (int64_t)L.width, L.row(s),
                sizeof(int32_t) * L.width);
  }
}

// Batched beam search: per query, greedy descent through upper layers
// then a layer-0 beam of width ef. Outputs [nq, ef] best-first, padded
// with id −1 / score −inf. Thread-parallel over queries (read-only
// graph; per-thread visited tables).
void mvt_hnsw_search(void* h, const float* queries, int64_t nq, int32_t ef,
                     int32_t* out_ids, float* out_scores) {
  Index* ix = (Index*)h;
  const float NEG_INF = -std::numeric_limits<float>::infinity();
  if (ix->entry < 0 || ix->layers.empty()) {
    for (int64_t i = 0; i < nq * (int64_t)ef; ++i) {
      out_ids[i] = -1;
      out_scores[i] = NEG_INF;
    }
    return;
  }
#ifdef _OPENMP
#pragma omp parallel if (nq > 1)
#endif
  {
    VisitedTable vt;
    std::vector<ScoredNode> beam;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 1)
#endif
    for (int64_t qi = 0; qi < nq; ++qi) {
      const float* q = queries + qi * (int64_t)ix->d;
      int64_t ep = ix->entry;
      for (int32_t l = (int32_t)ix->layers.size() - 1; l >= 1; --l)
        ep = greedy_descend(*ix, q, ep, ix->layers[l]);
      search_layer(*ix, q, &ep, 1, ef, ix->layers[0], vt, beam);
      int32_t* oi = out_ids + qi * (int64_t)ef;
      float* os = out_scores + qi * (int64_t)ef;
      int32_t got = std::min<int32_t>(ef, (int32_t)beam.size());
      for (int32_t j = 0; j < got; ++j) {
        oi[j] = (int32_t)beam[j].second;
        os[j] = beam[j].first;
      }
      for (int32_t j = got; j < ef; ++j) {
        oi[j] = -1;
        os[j] = NEG_INF;
      }
    }
  }
}

void mvt_hnsw_free(void* h) { delete (Index*)h; }

}  // extern "C"
