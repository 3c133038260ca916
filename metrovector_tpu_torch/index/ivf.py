"""IVF (inverted file) on the device: k-means training, the bucket layout
and the coarse-quantized probe search of :mod:`metrovector_tpu.index.ivf`.

* **Training**: Lloyd's k-means with k-means++ seeding. The assignment step
  is a blocked ``argmax 2x·c − ‖c‖²`` matmul in full f32 (no TF32), ties to
  the first centroid; the update step is a segment sum (``index_add_``).
  The host-side seeding is the reference's code, and :func:`train_kmeans`
  makes the same ``np.random.Generator`` calls in the same order, so both
  packages start from the same seeds.
* **Layout** (:func:`bucket_layout`, host numpy, the reference's code):
  rows in cluster order, padded into uniform ``[C', bucket_rows, D]``
  buckets capped at twice the mean fill; an over-full cell splits into
  buckets that share its centroid.
* **Search** (:func:`_ivf_search`, plain PyTorch as the reference is plain
  XLA): coarse scores against every bucket's centroid, the ``nprobe`` best
  buckets per query (ties to the lowest bucket), then the probed buckets'
  rows scored and merged into a carried top-k in probe-rank order, with
  ties among equal scores kept by position as ``lax.top_k`` keeps them.

* **Mutation** (:meth:`IVFIndex.add_rows`, :meth:`IVFIndex.delete_rows`):
  appended rows go to their nearest trained centroid, into the tail slots
  of its buckets or new buckets (:func:`_plan_placements`); the changed
  tensors are published together, as one state that a search reads whole.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..errors import (
    DimensionMismatchError,
    IndexOutOfBoundsError,
    VectorIdNotFoundError,
)
from ..format.constants import DistanceMetric
from ..utils.filters import checked_prepared_mask, padded_filter_plane

from ..engine import (
    PreparedFilter,
    SearchResult,
    ids_for_rows,
    merged_append_ids,
    pinned,
    publish,
    resolve_device,
)
from ..ops.distances import carry_topk_ids, distances_np, full_f32_matmul


def _assign(data: torch.Tensor, centroids: torch.Tensor,
            c_norms: torch.Tensor, block_rows: int = 65536) -> torch.Tensor:
    """Nearest-centroid assignment, blocked over rows: int64 ``[N]``."""
    out = []
    for start in range(0, data.shape[0], block_rows):
        blk = data[start : start + block_rows]
        with full_f32_matmul():
            scores = 2.0 * (blk @ centroids.T) - c_norms[None, :]
        out.append(torch.argmax(scores, dim=1))  # the first maximum
    if not out:
        return torch.empty(0, dtype=torch.int64, device=data.device)
    return torch.cat(out)


def _update(data: torch.Tensor, assignments: torch.Tensor,
            num_clusters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sums ``[C, D]`` and counts ``[C]`` (f32)."""
    sums = torch.zeros((num_clusters, data.shape[1]), dtype=torch.float32,
                       device=data.device)
    sums.index_add_(0, assignments, data)
    counts = torch.zeros(num_clusters, dtype=torch.float32, device=data.device)
    counts.index_add_(0, assignments,
                      torch.ones(data.shape[0], dtype=torch.float32,
                                 device=data.device))
    return sums, counts


def _kmeanspp_init(
    train: np.ndarray, k: int, rng: np.random.Generator, cap: int = 65_536
) -> np.ndarray:
    """k-means++ seeding (D² sampling) on a capped subsample, on the host:
    the reference's ``_kmeanspp_init`` line for line."""
    pool = train
    cap = min(cap, max(8_192, (1 << 22) // max(k, 1)))
    if pool.shape[0] > cap:
        pool = pool[rng.choice(pool.shape[0], cap, replace=False)]
    n = pool.shape[0]
    centers = np.empty((k, pool.shape[1]), np.float32)
    centers[0] = pool[rng.integers(n)]
    d2 = ((pool - centers[0]) ** 2).sum(1)
    for i in range(1, k):
        total = float(d2.sum())
        if not np.isfinite(total) or total <= 0.0:
            # Degenerate pool: uniform sampling instead of D² weights.
            centers[i] = pool[rng.integers(n)]
        else:
            centers[i] = pool[rng.choice(n, p=d2 / total)]
        d2 = np.minimum(d2, ((pool - centers[i]) ** 2).sum(1))
    return centers


def _sq_norms(c: torch.Tensor) -> torch.Tensor:
    return (c * c).sum(1)


def train_kmeans(
    data: np.ndarray,
    num_clusters: int,
    iters: int = 10,
    seed: int = 0,
    sample: int | None = 262_144,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """k-means++-seeded Lloyd's k-means on ``device``. ``data``: host
    ``[N, D]`` f32. Training runs on a random row subsample of ``sample``
    rows when N is larger; the final assignment covers all rows. Returns
    ``(centroids [C, D] f32, assignments [N] int32)``."""
    dev = resolve_device(device)
    n, d = data.shape
    num_clusters = min(num_clusters, n)
    rng = np.random.default_rng(seed)
    train = data
    if sample is not None and n > sample:
        train = data[rng.choice(n, sample, replace=False)]
    train = np.ascontiguousarray(train, dtype=np.float32)
    train_dev = torch.from_numpy(train).to(dev)

    centroids = torch.from_numpy(_kmeanspp_init(train, num_clusters, rng)).to(dev)
    for _ in range(iters):
        assign = _assign(train_dev, centroids, _sq_norms(centroids))
        sums, counts = _update(train_dev, assign, num_clusters)
        sums, counts = sums.cpu().numpy(), counts.cpu().numpy()
        # Reseed empty clusters from random training rows.
        empty = counts == 0
        new_c = sums / np.maximum(counts[:, None], 1.0)
        if empty.any():
            new_c[empty] = train[rng.choice(train.shape[0], int(empty.sum()))]
        centroids = torch.from_numpy(new_c.astype(np.float32)).to(dev)

    full = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32)).to(dev)
    assignments = _assign(full, centroids, _sq_norms(centroids))
    return centroids.cpu().numpy(), assignments.to(torch.int32).cpu().numpy()


# ----------------------------------------------------------- the index ---

# Elements of one probe step's gathered block ([Q, probes, B, D] rows or
# [Q, probes, B, m] codes): several probe ranks go in one step while the
# block stays below this, so peak memory stays bounded whatever nprobe is.
_STEP_ELEMENTS = 1 << 25


def _plan_placements(cells, fill, bucket_rows: int, assign_new):
    """Plan (bucket, slot) placements for appended rows: tail slots of the
    target cluster's existing buckets first, new buckets (sharing the
    cluster's centroid, as in :func:`bucket_layout` splitting) only on
    overflow. The reference's code.

    Returns ``(b_idx [n] i32, s_idx [n] i32, new_cells [list], fill',
    fills_new)`` where bucket ids ≥ ``len(cells)`` index ``new_cells`` in
    order and ``fill'``/``fills_new`` are the post-append fills."""
    cells = np.asarray(cells)
    fill = np.asarray(fill, np.int64).copy()
    nb0 = len(cells)
    by_cluster: dict[int, list[int]] = {}
    for b, c in enumerate(cells):
        by_cluster.setdefault(int(c), []).append(b)
    new_cells: list[int] = []
    fills_new: list[int] = []
    open_new: dict[int, int] = {}  # cluster -> open new-bucket index
    cursor: dict[int, int] = {}  # cluster -> next existing bucket to try
    n = len(assign_new)
    b_idx = np.empty(n, np.int32)
    s_idx = np.empty(n, np.int32)
    for i, c in enumerate(assign_new):
        c = int(c)
        lst = by_cluster.get(c, ())
        p = cursor.get(c, 0)
        while p < len(lst) and fill[lst[p]] >= bucket_rows:
            p += 1
        cursor[c] = p
        if p < len(lst):
            b = lst[p]
            b_idx[i], s_idx[i] = b, fill[b]
            fill[b] += 1
            continue
        j = open_new.get(c, -1)
        if j < 0 or fills_new[j] >= bucket_rows:
            j = len(new_cells)
            new_cells.append(c)
            fills_new.append(0)
            open_new[c] = j
        b_idx[i], s_idx[i] = nb0 + j, fills_new[j]
        fills_new[j] += 1
    return b_idx, s_idx, new_cells, fill, np.asarray(fills_new, np.int64)


def bucket_layout(
    assignments: np.ndarray,
    keep: np.ndarray,
    num_clusters: int,
    cap_factor: float = 2.0,
) -> tuple[np.ndarray, list[np.ndarray], int]:
    """Fixed-size bucket layout with cluster splitting (the reference's
    code): buckets hold at most ``cap_factor ×`` the mean fill (a multiple
    of 8), and an over-full cell splits into several buckets that share
    its centroid, so their coarse scores tie. Returns ``(cell_of_bucket
    [C'] i32, per-bucket row-id arrays, bucket_rows)``. An empty cell keeps
    one empty bucket, so every centroid stays addressable."""
    order = np.argsort(assignments, kind="stable")
    order = order[keep[order]]
    fill = np.bincount(assignments[order], minlength=num_clusters)
    n_live = int(fill.sum())
    mean = max(1, -(-n_live // max(num_clusters, 1)))
    cap = max(8, -(-int(cap_factor * mean) // 8) * 8)
    bucket_rows = max(8, -(-min(cap, int(fill.max(initial=1))) // 8) * 8)
    starts = np.concatenate([[0], np.cumsum(fill)])
    cells: list[int] = []
    row_lists: list[np.ndarray] = []
    for c in range(num_clusters):
        rows = order[starts[c] : starts[c + 1]]
        if len(rows) == 0:
            cells.append(c)
            row_lists.append(rows)
            continue
        for off in range(0, len(rows), bucket_rows):
            cells.append(c)
            row_lists.append(rows[off : off + bucket_rows])
    return np.asarray(cells, np.int32), row_lists, bucket_rows


def fill_buckets(row_lists, bucket_rows: int, n: int, payload, norms):
    """Lay per-row ``payload [N, ...]`` and ``norms [N]`` out in buckets:
    ``(buckets [C', bucket_rows, ...], ids [C', bucket_rows] i32 with −1
    padding, bucket norms (0 padding), bucket of each row [N] and slot of
    each row [N], −1 for a row in no bucket)``."""
    nb = len(row_lists)
    buckets = np.zeros((nb, bucket_rows) + payload.shape[1:], payload.dtype)
    ids = np.full((nb, bucket_rows), -1, np.int32)
    bnorms = np.zeros((nb, bucket_rows), np.float32)
    b_of_row = np.full(n, -1, np.int32)
    s_of_row = np.full(n, -1, np.int32)
    for b, rows in enumerate(row_lists):
        buckets[b, : len(rows)] = payload[rows]
        ids[b, : len(rows)] = rows
        bnorms[b, : len(rows)] = norms[rows]
        b_of_row[rows] = b
        s_of_row[rows] = np.arange(len(rows), dtype=np.int32)
    return buckets, ids, bnorms, b_of_row, s_of_row


def coarse_scores(q: torch.Tensor, centroids: torch.Tensor, metric):
    """``(cdots, cscores)`` ``[Q, C']``: the queries' dots with every
    bucket's centroid in full f32, and the metric's score of them (L2
    ``2 q·c − ‖c‖²``, cosine ``q·c / ‖c‖``, IP ``q·c``)."""
    with full_f32_matmul():
        cdots = q @ centroids.T
    c_norms = (centroids * centroids).sum(1)
    metric = DistanceMetric(metric)
    if metric == DistanceMetric.L2:
        return cdots, 2.0 * cdots - c_norms[None, :]
    if metric == DistanceMetric.COSINE:
        return cdots, cdots * (1.0 / torch.sqrt(torch.clamp(c_norms, min=1e-30)))[None, :]
    return cdots, cdots


def probe_order(cscores: torch.Tensor, nprobe: int) -> torch.Tensor:
    """The ``nprobe`` best buckets per query ``[Q, nprobe]`` (int64), best
    first, ties to the lowest bucket (``lax.top_k``'s order)."""
    return torch.sort(-cscores, dim=1, stable=True).indices[:, :nprobe]


def probe_steps(nq: int, nprobe: int, per_probe: int) -> list[tuple[int, int]]:
    """Probe ranks ``[p0, p1)`` taken together in each step: as many as
    keep ``nq · ranks · per_probe`` gathered elements within
    :data:`_STEP_ELEMENTS`, at least one. The carried top-k is the same
    for any grouping: the candidates keep one order throughout (probe rank,
    then slot), which ``lax.top_k``'s positional ties also follow."""
    g = max(1, _STEP_ELEMENTS // max(1, nq * per_probe))
    return [(p0, min(nprobe, p0 + g)) for p0 in range(0, nprobe, g)]


def _assign_host(vectors: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Nearest centroid of each appended row, int32: L2 in float64 on the
    host, first minimum on ties (the reference's ``add_rows``)."""
    cn = np.einsum("ij,ij->i", centroids, centroids, dtype=np.float64)
    d2 = cn[None, :] - 2.0 * (
        vectors.astype(np.float64) @ centroids.T.astype(np.float64))
    return np.argmin(d2, axis=1).astype(np.int32)


def _grown_buckets(index, new_cells: list):
    """New copies of ``index``'s bucket tensors, ready for a scatter:
    ``(buckets, bucket_ids, bucket_norms, probe_centroids, cells)`` with
    one empty bucket appended per entry of ``new_cells`` (ids −1, zero rows
    and norms, the cell's centroid). Copies on the device, so a
    search that read the old tensors keeps them whole."""
    b, ids, nrm = index.buckets, index.bucket_ids, index.bucket_norms
    pc, cells = index.probe_centroids, index.cells
    if not new_cells:
        return b.clone(), ids.clone(), nrm.clone(), pc, cells
    nbn, bsz, dev = len(new_cells), b.shape[1], b.device
    nc = np.asarray(new_cells, np.int32)
    return (
        torch.cat([b, torch.zeros((nbn, bsz) + tuple(b.shape[2:]), dtype=b.dtype,
                                  device=dev)]),
        torch.cat([ids, torch.full((nbn, bsz), -1, dtype=ids.dtype, device=dev)]),
        torch.cat([nrm, torch.zeros((nbn, bsz), dtype=nrm.dtype, device=dev)]),
        torch.cat([pc, _to(index.centroids[nc], dev, np.float32)]),
        np.concatenate([cells, nc]),
    )


def _to(arr, dev, dtype) -> torch.Tensor:
    """A device tensor from a copy of ``arr`` (which may be a read-only
    view of the mapped file)."""
    return torch.from_numpy(np.array(arr, dtype=dtype)).to(dev)


@dataclasses.dataclass
class IVFIndex:
    """Bucketed inverted-file layout for one space, resident on
    ``buckets.device``.

    ``buckets``: ``[C', bucket_rows, D]`` bucket-grouped (zero-padded)
    rows; ``bucket_ids``: ``[C', bucket_rows]`` int32 row ids (−1 padding
    or tombstone); ``bucket_norms``: ``[C', bucket_rows]`` squared norms;
    ``centroids``: host ``[C, D]``; ``probe_centroids``: ``[C', D]`` per
    bucket (duplicated for split cells); ``cells``: host ``[C']`` bucket →
    cluster; ``fill``: host ``[C']`` rows per bucket; ``row_bucket`` /
    ``row_slot``: host ``[N]`` placement of each row (−1: none).

    Mutations publish every changed field at once (:func:`~..engine.publish`)
    and a search reads one published state (:func:`~..engine.pinned`)."""

    centroids: np.ndarray
    probe_centroids: torch.Tensor
    cells: np.ndarray
    buckets: torch.Tensor
    bucket_ids: torch.Tensor
    bucket_norms: torch.Tensor
    fill: np.ndarray
    metric: DistanceMetric
    dim: int
    host_ids: np.ndarray | None = None
    num_vectors: int = 0
    row_bucket: np.ndarray | None = None
    row_slot: np.ndarray | None = None

    def __post_init__(self):
        self._write_lock = threading.Lock()  # one writer at a time

    @property
    def device(self) -> torch.device:
        return self.buckets.device

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        norms: np.ndarray,
        metric: DistanceMetric,
        num_clusters: int,
        iters: int = 10,
        seed: int = 0,
        centroids: np.ndarray | None = None,
        assignments: np.ndarray | None = None,
        valid_mask: np.ndarray | None = None,
        ids: np.ndarray | None = None,
        device="cuda",
    ) -> "IVFIndex":
        """Train (or take precomputed) cluster structure and lay the rows
        out in uniform buckets on ``device``. ``valid_mask``: True marks a
        tombstoned row, which goes in no bucket."""
        dev = resolve_device(device)
        n, d = vectors.shape
        host_ids = (np.ascontiguousarray(ids, np.uint64).reshape(-1)
                    if ids is not None else None)
        data32 = np.ascontiguousarray(vectors, dtype=np.float32)
        if centroids is None or assignments is None:
            centroids, assignments = train_kmeans(data32, num_clusters,
                                                  iters=iters, seed=seed,
                                                  device=dev)
        num_clusters = centroids.shape[0]
        keep = ~valid_mask if valid_mask is not None else np.ones(n, bool)
        cells, row_lists, bucket_rows = bucket_layout(assignments, keep,
                                                      num_clusters)
        buckets, bids, bnorms, b_of_row, s_of_row = fill_buckets(
            row_lists, bucket_rows, n, data32, np.asarray(norms, np.float32))
        return cls(
            centroids=centroids,
            probe_centroids=_to(centroids[cells], dev, np.float32),
            cells=cells,
            buckets=_to(buckets, dev, np.float32),
            bucket_ids=_to(bids, dev, np.int32),
            bucket_norms=_to(bnorms, dev, np.float32),
            fill=np.asarray([len(r) for r in row_lists]),
            metric=DistanceMetric(metric),
            dim=d,
            host_ids=host_ids,
            num_vectors=n,
            row_bucket=b_of_row,
            row_slot=s_of_row,
        )

    @classmethod
    def from_space(
        cls,
        space,
        num_clusters: int | None = None,
        iters: int = 10,
        seed: int = 0,
        device="cuda",
    ) -> "IVFIndex":
        """The probe-ready index of a host
        :class:`~metrovector_tpu_torch.vectors.space.VectorSpace` on
        ``device``, reusing the centroids and assignments persisted in the
        file when present (no retraining); otherwise k-means runs on the
        fly. Tombstoned rows go in no bucket."""
        stored = space.ivf_arrays()
        centroids = assignments = None
        if stored is not None:
            centroids, assignments = stored
        if num_clusters is None:
            num_clusters = int(space.info.index.params.get(
                "num_clusters", max(1, int(np.sqrt(space.num_vectors)))))
        vectors = np.asarray(space.to_numpy(), dtype=np.float32)
        q = space.quantization
        if q is not None:
            vectors = (vectors - q.zero_point) * q.scale
        norms = np.asarray(space.norms()[: space.num_vectors], dtype=np.float32)
        return cls.build(
            vectors, norms, space.metric, num_clusters, iters=iters,
            seed=seed, centroids=centroids, assignments=assignments,
            valid_mask=space.tombstone_mask(), ids=space.ids(), device=device,
        )

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "IVFIndex":
        """Build from the host arrays of a reference ``IVFIndex`` (its
        fields by name: ``centroids``, ``probe_centroids``, ``cells``,
        ``buckets``, ``bucket_ids``, ``bucket_norms``, ``fill``,
        ``row_bucket``, ``row_slot`` and the optional ``host_ids``) and its
        scalars ``metric``, ``dim`` and ``num_vectors``, on ``device``."""
        dev = resolve_device(device)
        return cls(
            centroids=np.array(state["centroids"], np.float32),
            probe_centroids=_to(state["probe_centroids"], dev, np.float32),
            cells=np.array(state["cells"], np.int32),
            buckets=_to(state["buckets"], dev, np.float32),
            bucket_ids=_to(state["bucket_ids"], dev, np.int32),
            bucket_norms=_to(state["bucket_norms"], dev, np.float32),
            fill=np.array(state["fill"]),
            metric=DistanceMetric(int(state["metric"])),
            dim=int(state["dim"]),
            host_ids=state.get("host_ids"),
            num_vectors=int(state["num_vectors"]),
            row_bucket=np.array(state["row_bucket"], np.int32),
            row_slot=np.array(state["row_slot"], np.int32),
        )

    @property
    def num_clusters(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def num_buckets(self) -> int:
        return int(self.buckets.shape[0])

    @property
    def bucket_rows(self) -> int:
        return int(self.buckets.shape[1])

    # -- online mutation ------------------------------------------------------

    def add_rows(self, vectors, ids=None) -> None:
        """Append rows to the live index, the reference's
        ``IVFIndex.add_rows``: each row goes to its nearest trained
        centroid (L2 in float64 on the host, as at build; no retraining),
        into the tail slots of that cluster's buckets, or into new buckets
        (sharing the cluster's centroid) when they are full. Appends carry
        ``ids`` iff the index has an ID column. The bucket tensors are
        copied on the device (or grown by new buckets) before the scatter,
        so a search in flight keeps the ones it read; the new tensors,
        ``fill``, the row placements and the row count are published
        together."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None]
        if vectors.shape[1] != self.dim:
            raise DimensionMismatchError(expected=self.dim,
                                         actual=int(vectors.shape[1]))
        with self._write_lock:
            n_new = int(vectors.shape[0])
            if n_new == 0:
                return
            nv = self.num_vectors
            merged_ids = merged_append_ids(self.host_ids, ids, n_new, nv)
            assign_new = _assign_host(vectors, self.centroids)
            v64 = vectors.astype(np.float64)
            norms_new = np.einsum("ij,ij->i", v64, v64).astype(np.float32)
            b_idx, s_idx, new_cells, fill, fills_new = _plan_placements(
                self.cells, self.fill, self.bucket_rows, assign_new)
            dev = self.device
            buckets, bids, bnorms, pcents, cells = _grown_buckets(self, new_cells)
            bi = torch.from_numpy(b_idx.astype(np.int64)).to(dev)
            si = torch.from_numpy(s_idx.astype(np.int64)).to(dev)
            buckets[bi, si] = _to(vectors, dev, np.float32)
            bids[bi, si] = torch.arange(nv, nv + n_new, dtype=torch.int32, device=dev)
            bnorms[bi, si] = _to(norms_new, dev, np.float32)
            changes = dict(
                buckets=buckets, bucket_ids=bids, bucket_norms=bnorms,
                probe_centroids=pcents, cells=cells,
                fill=np.concatenate([fill, fills_new]),
                row_bucket=np.concatenate([self.row_bucket, b_idx]),
                row_slot=np.concatenate([self.row_slot, s_idx]),
                num_vectors=nv + n_new,
            )
            if merged_ids is not None:
                changes["host_ids"] = merged_ids
            publish(self, **changes)

    def delete_rows(self, rows=None, ids=None) -> None:
        """Tombstone rows (by position or stable ID): their bucket slots get
        id −1, so they never surface. Publishes a new ``bucket_ids`` with
        the placements; slots are not reclaimed."""
        with self._write_lock:
            idx = []
            if rows is not None:
                idx.extend(int(r) for r in np.atleast_1d(rows))
            if ids is not None:
                if self.host_ids is None:
                    idx.extend(int(i) for i in np.atleast_1d(ids))
                else:
                    lut = {int(v): i for i, v in enumerate(self.host_ids)}
                    for i in np.atleast_1d(ids):
                        try:
                            idx.append(lut[int(i)])
                        except KeyError:
                            raise VectorIdNotFoundError(int(i)) from None
            for r in idx:
                if r < 0 or r >= self.num_vectors:
                    raise IndexOutOfBoundsError(r, self.num_vectors)
            if not idx:
                return
            sel = np.asarray(idx, np.int64)
            placed = sel[self.row_bucket[sel] >= 0]
            changes = {}
            if placed.size:
                bids = self.bucket_ids.clone()
                bi = torch.from_numpy(self.row_bucket[placed].astype(np.int64))
                si = torch.from_numpy(self.row_slot[placed].astype(np.int64))
                bids[bi.to(self.device), si.to(self.device)] = -1
                changes["bucket_ids"] = bids
            row_bucket, row_slot = self.row_bucket.copy(), self.row_slot.copy()
            row_bucket[sel] = -1
            row_slot[sel] = -1
            publish(self, row_bucket=row_bucket, row_slot=row_slot, **changes)

    def prepare_filter(self, filter_mask) -> PreparedFilter:
        """Upload a ``[num_vectors]`` boolean/int row predicate once for
        many :meth:`search` calls; indexed by original row position (bucket
        row ids)."""
        nv = self.num_vectors
        full = padded_filter_plane(filter_mask, nv, nv)
        return PreparedFilter(mask=torch.from_numpy(full).to(self.device),
                              num_valid=nv)

    def _filter_device(self, filter_mask):
        """A raw array or PreparedFilter → the ``[num_vectors]`` device
        plane the probe gathers at each candidate's row id."""
        if filter_mask is None:
            return None
        if isinstance(filter_mask, PreparedFilter):
            return checked_prepared_mask(filter_mask, self.num_vectors)
        return self.prepare_filter(filter_mask).mask

    def search(self, queries: np.ndarray, k: int = 10, nprobe: int = 8,
               filter_mask=None) -> SearchResult:
        """Approximate top-k: probe the ``nprobe`` best-scoring buckets per
        query (split cells count one bucket each); ``nprobe ==
        num_buckets`` is exact search. ``filter_mask``: ``[num_vectors]``
        predicate or a :meth:`prepare_filter` result, applied inside the
        probe."""
        ix = pinned(self)  # one published state for the whole search
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        qnorms = np.einsum("ij,ij->i", q, q, dtype=np.float64).astype(np.float32)
        qn = q
        if ix.metric == DistanceMetric.COSINE:
            qn = q / np.maximum(np.sqrt(qnorms)[:, None], 1e-30)
        nprobe = min(nprobe, ix.num_buckets)
        s, i = _ivf_search(
            torch.from_numpy(np.ascontiguousarray(qn)).to(ix.device),
            ix.probe_centroids, ix.buckets, ix.bucket_ids,
            ix.bucket_norms, k=min(k, ix.bucket_rows * nprobe),
            nprobe=nprobe, metric=ix.metric,
            row_filter=ix._filter_device(filter_mask),
        )
        s, i = s.cpu().numpy(), i.cpu().numpy()
        bad_fill = np.inf if ix.metric == DistanceMetric.L2 else -np.inf
        dist = np.where(i >= 0, distances_np(s, ix.metric, qnorms), bad_fill)
        if s.shape[1] < k:
            pad = ((0, 0), (0, k - s.shape[1]))
            i = np.pad(i, pad, constant_values=-1)
            s = np.pad(s, pad, constant_values=-np.inf)
            dist = np.pad(dist, pad, constant_values=bad_fill)
        return SearchResult(indices=i, scores=s, distances=dist,
                            metric=ix.metric,
                            ids=ids_for_rows(ix.host_ids, i))


def _ivf_search(q, centroids, buckets, bucket_ids, bucket_norms, k: int,
                nprobe: int, metric, row_filter=None):
    """The IVF probe in plain PyTorch (the reference's ``lax.scan`` over
    probe ranks): coarse scores, the ``nprobe`` best buckets, then the
    probed buckets' rows scored in full f32 and merged into a carried
    top-k, a few probe ranks a step (:func:`probe_steps`). ``row_filter``:
    optional ``[N]`` plane (0 ⇒ excluded) gathered at each candidate's row
    id. Returns ``(scores [Q, k] f32, rows [Q, k] int32)``; a slot whose
    score is not finite carries −1."""
    metric = DistanceMetric(metric)
    nq = q.shape[0]
    _, cscores = coarse_scores(q, centroids, metric)
    probes = probe_order(cscores, nprobe)
    bsize, d = buckets.shape[1], buckets.shape[2]
    best = (torch.empty((nq, 0), dtype=torch.float32, device=q.device),
            torch.empty((nq, 0), dtype=torch.int64, device=q.device))
    for p0, p1 in probe_steps(nq, nprobe, bsize * d):
        cols = probes[:, p0:p1]  # [Q, g] buckets, in probe-rank order
        with full_f32_matmul():
            dots = torch.bmm(buckets[cols].reshape(nq, -1, d), q[:, :, None])[:, :, 0]
        gi = bucket_ids[cols].reshape(nq, -1).long()
        gn = bucket_norms[cols].reshape(nq, -1)
        if metric == DistanceMetric.L2:
            scores = 2.0 * dots - gn
        elif metric == DistanceMetric.COSINE:
            scores = dots * (1.0 / torch.sqrt(torch.clamp(gn, min=1e-30)))
        else:
            scores = dots
        live = gi >= 0
        if row_filter is not None:
            live &= row_filter[gi.clamp(min=0)] != 0
        scores = torch.where(live, scores, torch.tensor(float("-inf"), device=q.device))
        best = carry_topk_ids(best, scores, gi, k)
    s, idx = best
    idx = torch.where(torch.isfinite(s), idx, -1)
    return s, idx.to(torch.int32)
