"""HNSW: hierarchical navigable small-world graph index, on the host.

The counterpart of :mod:`metrovector_tpu.index.hnsw`, line for line (no
device code): greedy descent through sparse upper layers and a beam search
at layer 0 (Malkov & Yashunin 2016), with the diversifying neighbor
selection of the paper's Algorithm 4 (plain closest-M selection fragments
clustered corpora into per-cluster graph components).

Placement: graph traversal is a chain of tiny data-dependent gathers, so
HNSW runs on the host with numpy-vectorized candidate scoring, or through
the port's own copy of the native library (:mod:`..native`, built with
``g++`` into the git-ignored ``build/`` tree; ``MVT_NO_NATIVE=1`` or no
``g++`` keeps the numpy path). It is the low-latency single-query
complement to the device engines, with no device round trip.

Reproducibility: at ``threads=1`` the native build is the sequential
insertion order, so the graph depends only on the rows and the seed; with
more threads it depends on the schedule.

Persistence: per-layer compact adjacency (node-id list + fixed-width
neighbor rows) as ordinary CRC-checked MVT blocks via
``Builder.set_hnsw_index``; ``HNSWIndex.from_space`` reattaches without
rebuilding.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..format.constants import DistanceMetric

_SENTINEL = -1


def _prep(vectors: np.ndarray, metric: DistanceMetric):
    """Return (rows, sq_norms) in the space where ranking == score order.
    Cosine reduces to inner product on L2-normalized rows; L2 and IP use
    the rows as-is."""
    rows = np.ascontiguousarray(vectors, np.float32)
    if metric == DistanceMetric.COSINE:
        n = np.linalg.norm(rows, axis=1, keepdims=True)
        rows = rows / np.maximum(n, 1e-30)
    norms = np.einsum("ij,ij->i", rows, rows).astype(np.float32)
    return rows, norms


def _scores(q: np.ndarray, rows: np.ndarray, norms: np.ndarray, ids,
            metric: DistanceMetric) -> np.ndarray:
    """Greater-is-better scores of ``q`` against ``rows[ids]`` (the
    engine's convention: L2 → 2q·x − ‖x‖²)."""
    sub = rows[ids]
    dots = sub @ q
    if metric == DistanceMetric.L2:
        return 2.0 * dots - norms[ids]
    return dots  # IP, and cosine (pre-normalized rows and query)




def _beam_build(q, ep, ef, layer_adj, rows, norms, metric):
    """Best-first beam search over one build-time adjacency dict. Returns
    (ids, scores) of up to ``ef`` best, sorted best-first.

    Heap-based (O(log ef) per insert): ``cand`` is a max-heap by score
    (negated), ``res`` a min-heap whose root is the current worst keeper —
    the classic HNSW SEARCH-LAYER pair. The round-2 list/bisect version
    rebuilt a negated score list per insert (O(ef) each, O(ef²) per
    expansion) and crawled on large builds."""
    import heapq

    ep = np.unique(np.asarray(ep, np.int64))
    visited = set(ep.tolist())
    sc = _scores(q, rows, norms, ep, metric)
    cand = [(-float(s), int(v)) for v, s in zip(ep, sc)]
    heapq.heapify(cand)
    res = [(float(s), int(v)) for v, s in zip(ep, sc)]
    heapq.heapify(res)
    while len(res) > ef:
        heapq.heappop(res)
    while cand:
        c_negs, c = heapq.heappop(cand)
        if len(res) >= ef and -c_negs < res[0][0]:
            break
        nbrs = layer_adj.get(c)
        if nbrs is None or len(nbrs) == 0:
            continue
        new = [v for v in nbrs.tolist() if v >= 0 and v not in visited]
        if not new:
            continue
        visited.update(new)
        ns = _scores(q, rows, norms, np.asarray(new, np.int64), metric)
        for v, s_v in zip(new, ns):
            s_v = float(s_v)
            if len(res) < ef:
                heapq.heappush(res, (s_v, v))
                heapq.heappush(cand, (-s_v, v))
            elif s_v > res[0][0]:
                heapq.heapreplace(res, (s_v, v))
                heapq.heappush(cand, (-s_v, v))
    res.sort(key=lambda t: (-t[0], t[1]))
    return (
        np.asarray([v for _, v in res], np.int64),
        np.asarray([s for s, _ in res]),
    )


def _select_heuristic(base, cand_ids, cap, rows, norms, metric):
    """Diversifying neighbor selection (Malkov & Yashunin Algorithm 4
    with keepPrunedConnections): walk candidates best-first w.r.t.
    ``base`` and keep one only if it is no farther from the base than
    from every already-kept neighbor; then backfill remaining slots with
    the best pruned candidates (without backfill, structureless iid
    corpora get graphs far sparser than ``cap`` and recall regresses
    below even closest-M, in the JAX package's measurements). Score
    asymmetry is fine: at fixed candidate ``e``, ``s_e(x)`` comparisons
    are distance comparisons."""
    if len(cand_ids) <= cap:
        return [int(v) for v in cand_ids]
    out: list[int] = []
    pruned: list[int] = []
    for e in cand_ids:
        if len(out) >= cap:
            break
        e = int(e)
        sc = _scores(rows[e], rows, norms,
                     np.asarray([base] + out, np.int64), metric)
        if np.all(sc[1:] <= sc[0]):
            out.append(e)
        elif len(pruned) < cap:
            pruned.append(e)
    out += pruned[: cap - len(out)]
    return out


def _connect_build(node, neighbors, layer_adj, cap, rows, norms, metric,
                   heuristic=True):
    """Link ``node``↔``neighbors`` in a build-time adjacency dict, pruning
    over-full neighbor lists back to ``cap`` — with the diversifying
    heuristic, or plain closest-``cap`` when ``heuristic`` is False."""
    layer_adj[int(node)] = np.asarray(neighbors[:cap], np.int32)
    for v in neighbors[:cap]:
        cur = layer_adj.get(int(v))
        merged = (
            np.asarray([node], np.int32)
            if cur is None
            else np.append(cur, np.int32(node))
        )
        if len(merged) > cap:
            sc = _scores(rows[int(v)], rows, norms,
                         merged.astype(np.int64), metric)
            best_first = merged[np.argsort(-sc, kind="stable")]
            if heuristic:
                merged = np.asarray(
                    _select_heuristic(int(v), best_first.tolist(), cap,
                                      rows, norms, metric),
                    np.int32,
                )
            else:
                merged = best_first[:cap].astype(np.int32)
        layer_adj[int(v)] = merged


def _insert_nodes(adj, rows, norms, metric, nodes, levels, entry,
                  entry_level, m, ef_construction, heuristic=True):
    """Run HNSW insertion for ``nodes`` (id order) against existing
    adjacency dicts, extending ``adj`` with new top layers as needed.
    Returns the (possibly new) entry node."""
    width0, width = 2 * m, m
    for node in nodes:
        node = int(node)
        lvl = int(levels[node])
        while lvl >= len(adj):
            adj.append(dict())
        q = rows[node]
        max_level = len(adj) - 1
        ep = entry
        for layer in range(max_level, lvl, -1):
            ids, _ = _beam_build(q, [ep], 1, adj[layer], rows, norms, metric)
            if len(ids):
                ep = int(ids[0])
        eps = [ep]
        for layer in range(min(lvl, max_level), -1, -1):
            ids, _ = _beam_build(
                q, eps, ef_construction, adj[layer], rows, norms, metric
            )
            cap = width0 if layer == 0 else width
            cand = [int(v) for v in ids if int(v) != node]
            if heuristic:
                chosen = _select_heuristic(node, cand, cap, rows, norms,
                                           metric)
            else:
                chosen = cand[:cap]
            _connect_build(node, chosen, adj[layer], cap, rows, norms,
                           metric, heuristic=heuristic)
            eps = list(ids[: max(1, len(ids))])
        if lvl > entry_level:
            entry = node
            entry_level = lvl
    return entry, entry_level


def _freeze_adj(adj, entry, m):
    """Compact build-time adjacency dicts to per-layer (ids, adj) arrays.
    The entry node is guaranteed a layer-0 slot even when edgeless (a
    single-node graph otherwise froze to an empty layer and thawing it
    looked like an empty graph, orphaning the node — review finding r2)."""
    width0, width = 2 * m, m
    if entry != _SENTINEL and adj and int(entry) not in adj[0]:
        adj[0][int(entry)] = np.zeros(0, np.int32)
    layers_out = []
    for layer, lad in enumerate(adj):
        ids = np.asarray(sorted(lad), np.int32)
        cap = width0 if layer == 0 else width
        mat = np.full((len(ids), cap), _SENTINEL, np.int32)
        for r, nid in enumerate(ids):
            nb = lad[int(nid)][:cap]
            mat[r, : len(nb)] = nb
        layers_out.append((ids, mat))
    if not layers_out:
        layers_out = [(np.asarray([entry], np.int32),
                       np.full((1, width0), _SENTINEL, np.int32))]
    return layers_out


@dataclasses.dataclass
class HNSWIndex:
    """Host-side navigable small-world graph over one space.

    ``layers``: list (bottom-up) of ``(ids [N_L] i32, adj [N_L, width]
    i32)`` — ``adj`` rows are neighbor node ids (−1 padding) for the nodes
    in ``ids``; ``slot_of``: per-layer node-id → row lookup arrays.

    **Choosing m**: on *clustered* (real-embedding-like) corpora ``m=16``
    suffices; *structureless* iid corpora need more connectivity, and their
    recall falls with scale at any ``m``. If recall plateaus as you raise
    ``ef``, raise ``m`` (rebuild required); for a truly structureless
    corpus prefer the exact engine, which is exact at any size."""

    rows: np.ndarray
    norms: np.ndarray
    layers: list[tuple[np.ndarray, np.ndarray]]
    entry: int
    metric: DistanceMetric
    m: int
    ef_construction: int
    valid: np.ndarray | None = None  # False = tombstoned
    # Host-side stable u64 ID column (the format's ID column); node ids are row positions, translated through this at
    # result time so ids survive compaction.
    host_ids: np.ndarray | None = None
    # Neighbor selection strategy: "heuristic" (Alg. 4 + backfill — the
    # default; clustered corpora fragment without it) or "closest"
    # (plain closest-M — better on structureless iid corpora). Affects
    # build and add_rows, not search.
    selection: str = "heuristic"

    def __post_init__(self):
        n = self.rows.shape[0]
        self.slot_of = []
        for ids, _ in self.layers:
            lut = np.full(n, _SENTINEL, np.int32)
            lut[ids] = np.arange(len(ids), dtype=np.int32)
            self.slot_of.append(lut)
        # Cached native search handle (invalidated whenever the graph
        # changes — add_rows refreezes and re-runs __post_init__).
        self._native = None

    def _native_handle(self):
        """Borrow-adopt the frozen graph into the C++ searcher (cached).
        None when the native toolchain is unavailable or disabled."""
        if self._native is not None:
            return self._native
        from .. import native

        if not native.hnsw_available():
            return None
        self._native = native.NativeHNSW.adopt(
            self.rows, self.norms,
            1 if self.metric == DistanceMetric.L2 else 0,
            self.m, self.ef_construction, self.layers, self.entry,
        )
        return self._native

    # ------------------------------------------------------------- build --

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        metric: DistanceMetric,
        m: int = 16,
        ef_construction: int = 200,
        seed: int = 0,
        valid_mask: np.ndarray | None = None,
        ids: np.ndarray | None = None,
        threads: int = 0,
        selection: str = "heuristic",
    ) -> "HNSWIndex":
        """Incremental insertion build. ``m``: neighbors per node on upper
        layers (``2m`` at layer 0); ``ef_construction``: beam width during
        construction. Tombstoned rows (``valid_mask`` True) are excluded
        from the graph entirely. ``threads``: native-path parallel
        insertion workers (per-node locks, hnswlib-style; 0 = OpenMP
        default — all cores; 1 = deterministic sequential order). The
        graph structure is insertion-order dependent, so multithreaded
        builds are valid but not bit-reproducible. ``selection``:
        neighbor selection — "heuristic" (diversifying, the default) or
        "closest" (plain closest-M; better on structureless iid corpora,
        fragments clustered ones — see the dataclass field note)."""
        metric = DistanceMetric(metric)
        if selection not in ("heuristic", "closest"):
            raise ValueError(
                f"selection must be 'heuristic' or 'closest', got "
                f"{selection!r}"
            )
        heuristic = selection == "heuristic"
        host_ids = (
            np.ascontiguousarray(ids, np.uint64).reshape(-1)
            if ids is not None
            else None
        )
        rows, norms = _prep(vectors, metric)
        n = rows.shape[0]
        rng = np.random.default_rng(seed)
        live = np.arange(n)
        if valid_mask is not None:
            live = live[~np.asarray(valid_mask, dtype=bool)]
        if len(live) == 0:
            return cls(rows, norms, [], _SENTINEL, metric, m, ef_construction,
                       valid=None, host_ids=host_ids, selection=selection)

        from .. import native as _nat

        if _nat.hnsw_available():
            # C++ insertion path (~15× the Python twin; same algorithm,
            # its own level RNG). Exports the same frozen layout.
            nh = _nat.NativeHNSW.build(
                rows, norms, 1 if metric == DistanceMetric.L2 else 0,
                m, ef_construction, seed, live, threads=threads,
                heuristic=heuristic,
            )
            if nh is not None:
                valid = None
                if valid_mask is not None:
                    valid = ~np.asarray(valid_mask, dtype=bool)
                return cls(rows, norms, nh.export_layers(), nh.entry,
                           metric, m, ef_construction, valid=valid,
                           host_ids=host_ids, selection=selection)

        ml = 1.0 / np.log(max(m, 2))
        levels = np.minimum(
            (-np.log(rng.uniform(1e-12, 1.0, n)) * ml).astype(np.int32), 32
        )
        entry = int(live[0])
        adj: list[dict[int, np.ndarray]] = [
            dict() for _ in range(int(levels[live].max(initial=0)) + 1)
        ]
        entry, _ = _insert_nodes(
            adj, rows, norms, metric, live[1:], levels, entry,
            int(levels[entry]), m, ef_construction, heuristic=heuristic,
        )
        layers_out = _freeze_adj(adj, entry, m)
        valid = None
        if valid_mask is not None:
            valid = ~np.asarray(valid_mask, dtype=bool)
        return cls(rows, norms, layers_out, entry, metric, m,
                   ef_construction, valid=valid, host_ids=host_ids,
                   selection=selection)

    # -- online mutation ------------------------------------------------------

    def add_rows(
        self, vectors: np.ndarray, ids=None, seed: int | None = None
    ) -> None:
        """Incremental insertion: thaw the frozen per-layer arrays back to
        adjacency dicts, run the standard insert for each new node against
        the existing graph, refreeze. Appends must carry ``ids`` iff the
        index has an ID column (the ``DeviceSpace.add_rows`` contract).
        The insertions themselves cost
        O(n_new · ef_construction · log N); the thaw/refreeze wrapper adds
        an O(N) pass per CALL (not per row) — batch appends rather than
        looping row-by-row on large graphs."""
        from ..engine import merged_append_ids

        rows_new, norms_new = _prep(np.atleast_2d(vectors), self.metric)
        n_old = self.rows.shape[0]
        n_new = rows_new.shape[0]
        if n_new == 0:
            return
        merged_ids = merged_append_ids(self.host_ids, ids, n_new, n_old)
        rows = np.concatenate([self.rows, rows_new])
        norms = np.concatenate([self.norms, norms_new])

        adj: list[dict[int, np.ndarray]] = []
        for ids, mat in self.layers:
            lad: dict[int, np.ndarray] = {}
            for r, nid in enumerate(ids):
                nb = mat[r]
                lad[int(nid)] = nb[nb >= 0].astype(np.int32)
            adj.append(lad)

        rng = np.random.default_rng(n_old if seed is None else seed)
        ml = 1.0 / np.log(max(self.m, 2))
        levels = np.zeros(n_old + n_new, np.int32)
        levels[n_old:] = np.minimum(
            (-np.log(rng.uniform(1e-12, 1.0, n_new)) * ml).astype(np.int32),
            32,
        )
        new_nodes = list(range(n_old, n_old + n_new))

        entry = self.entry
        if entry == _SENTINEL or not adj or all(
            len(lad) == 0 for lad in adj
        ):
            # empty graph: seed it with the first new node, insert the rest
            entry = new_nodes[0]
            adj = [dict() for _ in range(int(levels[entry]) + 1)]
            adj[0][entry] = np.zeros(0, np.int32)
            new_nodes = new_nodes[1:]
        entry_level = 0
        for layer in range(len(self.slot_of) - 1, -1, -1):
            if (
                entry < len(self.slot_of[layer])
                and self.slot_of[layer][entry] != _SENTINEL
            ):
                entry_level = layer
                break
        entry_level = max(entry_level, int(levels[entry]))

        entry, _ = _insert_nodes(
            adj, rows, norms, self.metric, new_nodes, levels, entry,
            entry_level, self.m, self.ef_construction,
            heuristic=self.selection == "heuristic",
        )
        self.rows = rows
        self.norms = norms
        self.entry = entry
        self.layers = _freeze_adj(adj, entry, self.m)
        if merged_ids is not None:
            self.host_ids = merged_ids
        if self.valid is not None:
            self.valid = np.concatenate(
                [self.valid, np.ones(n_new, bool)]
            )
        self.__post_init__()  # rebuild the per-layer slot lookups

    def delete_rows(self, rows) -> None:
        """Tombstone nodes: they stay in the graph as routing waypoints
        (standard HNSW deletion practice — removing edges would sever
        paths) but can never appear in results."""
        from ..errors import IndexOutOfBoundsError

        n = self.rows.shape[0]
        idx = [int(r) for r in np.atleast_1d(rows)]
        for r in idx:
            if r < 0 or r >= n:
                raise IndexOutOfBoundsError(r, n)
        if self.valid is None:
            self.valid = np.ones(n, bool)
        else:
            self.valid = self.valid.copy()
        self.valid[np.asarray(idx, np.int64)] = False

    @classmethod
    def from_space(
        cls,
        space,
        m: int = 16,
        ef_construction: int = 200,
        seed: int = 0,
        selection: str = "heuristic",
    ) -> "HNSWIndex":
        """Reattach the persisted graph (``Builder.set_hnsw_index``) or
        build one from the space's rows. ``selection`` also applies on
        reattach: it sets the strategy later ``add_rows`` calls evolve the
        stored graph with."""
        if selection not in ("heuristic", "closest"):
            raise ValueError(
                f"selection must be 'heuristic' or 'closest', got "
                f"{selection!r}"
            )
        metric = DistanceMetric(space.metric)
        vectors = np.asarray(space.to_numpy(), np.float32)
        q = space.quantization
        if q is not None:
            vectors = (vectors - q.zero_point) * q.scale
        stored = space.hnsw_arrays()
        if stored is not None:
            layers, entry, sm, sef = stored
            rows, norms = _prep(vectors, metric)
            valid = None
            mask = space.tombstone_mask()
            if mask is not None:
                valid = ~mask
            return cls(rows, norms, layers, entry, metric, sm, sef,
                       valid=valid, host_ids=space.ids(),
                       selection=selection)
        return cls.build(
            vectors, metric, m=m, ef_construction=ef_construction, seed=seed,
            valid_mask=space.tombstone_mask(), ids=space.ids(),
            selection=selection,
        )

    @property
    def max_level(self) -> int:
        return len(self.layers) - 1

    # ------------------------------------------------------------ search --

    def search(self, queries: np.ndarray, k: int = 10, ef: int | None = None,
               filter_mask=None, max_ef: int | None = None):
        """Approximate top-k; ``ef`` (≥ k) is the layer-0 beam width —
        recall rises with it. Returns a ``SearchResult``.

        ``filter_mask``: optional ``[num_vectors]`` boolean/int row
        predicate composed with tombstones. Filtering is post-beam with an
        automatic **ef top-up**: non-passing nodes stay usable as routing
        waypoints (removing them would sever graph paths — the standard
        HNSW filtered-search design), and any query whose beam yields
        fewer than ``k`` passing rows is retried with a doubled beam until
        it fills or ``max_ef`` is reached (default
        ``min(N, max(1024, 16·ef))``). Expected beam cost under
        selectivity ``s`` is ~``ef/s``; for aggressive predicates
        (s ≲ k/max_ef) prefer the exact engine's in-kernel filter, which
        is selectivity-independent."""
        from ..engine import SearchResult
        from ..ops.distances import distances_np

        metric = self.metric
        q2 = np.ascontiguousarray(queries, np.float32)
        if q2.ndim == 1:
            q2 = q2[None]
        qn = np.einsum("ij,ij->i", q2, q2, dtype=np.float64).astype(np.float32)
        qs = q2
        if metric == DistanceMetric.COSINE:
            qs = q2 / np.maximum(np.sqrt(qn)[:, None], 1e-30)
        ef = max(k, ef if ef is not None else max(2 * k, 64))
        n_rows = int(self.rows.shape[0])

        keep_all = self.valid
        if filter_mask is not None:
            from ..utils.filters import padded_filter_plane

            fm = padded_filter_plane(
                filter_mask, n_rows, n_rows, dtype=bool
            )
            keep_all = fm if keep_all is None else (keep_all & fm)
        if max_ef is None:
            max_ef = (
                min(n_rows, max(1024, 16 * ef)) if filter_mask is not None
                else ef
            )
        max_ef = max(ef, int(max_ef))

        out_i = np.full((len(q2), k), _SENTINEL, np.int32)
        out_s = np.full((len(q2), k), -np.inf, np.float32)
        from ..engine import ids_for_rows

        if self.entry == _SENTINEL or not self.layers:
            dist = np.where(
                out_i >= 0, 0.0,
                np.inf if metric == DistanceMetric.L2 else -np.inf
            ).astype(np.float32)
            return SearchResult(out_i, out_s, dist, metric,
                                ids=ids_for_rows(self.host_ids, out_i))

        nh = self._native_handle()

        def one(q, ef_q):
            """One query's beam at width ``ef_q`` → (ids, scores) after
            the keep mask, best-first."""
            if nh is not None:
                bids, bsc = nh.search(q[None], ef_q)
                ids, sc = bids[0], bsc[0]
                sel = ids >= 0
                if keep_all is not None:
                    sel &= keep_all[np.clip(ids, 0, None)]
            else:
                ep = self.entry
                for layer in range(self.max_level, 0, -1):
                    ep = self._greedy(q, ep, layer)
                ids, sc = self._beam0(q, ep, ef_q)
                sel = (
                    keep_all[ids] if keep_all is not None
                    else np.ones(len(ids), bool)
                )
            return ids[sel], sc[sel]

        if nh is not None and (filter_mask is None or len(qs) > 1):
            # batched first pass through the native beam; per-query
            # top-ups below handle the stragglers
            bids, bsc = nh.search(qs, ef)  # [Q, ef] best-first, −1 padded
            first = []
            for qi in range(len(qs)):
                ids, sc = bids[qi], bsc[qi]
                sel = ids >= 0
                if keep_all is not None:
                    sel &= keep_all[np.clip(ids, 0, None)]
                first.append((ids[sel], sc[sel]))
        else:
            first = [one(q, ef) for q in qs]

        for qi, (ids, sc) in enumerate(first):
            ef_q = ef
            while len(ids) < k and ef_q < max_ef:
                ef_q = min(2 * ef_q, max_ef)
                ids, sc = one(qs[qi], ef_q)
            top = min(k, len(ids))
            out_i[qi, :top] = ids[:top]
            out_s[qi, :top] = sc[:top]
        if metric == DistanceMetric.COSINE:
            # scores were computed on normalized q: already cosine sim
            scores = out_s
        else:
            scores = out_s
        dist = distances_np(scores, metric, qn)
        bad = np.inf if metric == DistanceMetric.L2 else -np.inf
        dist = np.where(out_i >= 0, dist, bad)
        return SearchResult(out_i, scores, dist.astype(np.float32), metric,
                            ids=ids_for_rows(self.host_ids, out_i))

    def _greedy(self, q, ep: int, layer: int) -> int:
        lut, mat = self.slot_of[layer], self.layers[layer][1]
        cur = ep
        cur_s = float(_scores(q, self.rows, self.norms,
                              np.asarray([cur], np.int64), self.metric)[0])
        while True:
            slot = lut[cur]
            if slot < 0:
                return cur
            nbrs = mat[slot]
            nbrs = nbrs[nbrs >= 0]
            if len(nbrs) == 0:
                return cur
            sc = _scores(q, self.rows, self.norms, nbrs.astype(np.int64),
                         self.metric)
            j = int(np.argmax(sc))
            if sc[j] <= cur_s:
                return cur
            cur, cur_s = int(nbrs[j]), float(sc[j])

    def _beam0(self, q, ep: int, ef: int):
        """Layer-0 beam search; returns (ids, scores) best-first.
        Heap-based like :func:`_beam_build` (O(log ef) per insert)."""
        import heapq

        lut, mat = self.slot_of[0], self.layers[0][1]
        visited = {ep}
        s0 = float(_scores(q, self.rows, self.norms,
                           np.asarray([ep], np.int64), self.metric)[0])
        res = [(s0, ep)]
        cand = [(-s0, ep)]
        while cand:
            c_negs, c = heapq.heappop(cand)
            if len(res) >= ef and -c_negs < res[0][0]:
                break
            slot = lut[c]
            if slot < 0:
                continue
            nbrs = mat[slot]
            new = [v for v in nbrs.tolist() if v >= 0 and v not in visited]
            if not new:
                continue
            visited.update(new)
            ns = _scores(q, self.rows, self.norms,
                         np.asarray(new, np.int64), self.metric)
            for v, s_v in zip(new, ns):
                s_v = float(s_v)
                if len(res) < ef:
                    heapq.heappush(res, (s_v, v))
                    heapq.heappush(cand, (-s_v, v))
                elif s_v > res[0][0]:
                    heapq.heapreplace(res, (s_v, v))
                    heapq.heappush(cand, (-s_v, v))
        res.sort(key=lambda t: (-t[0], t[1]))
        return (
            np.asarray([v for _, v in res], np.int32),
            np.asarray([s for s, _ in res], np.float32),
        )
