"""IVF-PQ on one ``torch.device``: a coarse inverted-file quantizer with
product-quantized residuals, the counterpart of
:mod:`metrovector_tpu.index.ivfpq`.

* **Training** (:func:`train_ivfpq`): coarse k-means, then PQ codebooks of
  the residuals ``x − centroid`` (:mod:`.ivf`, :mod:`.pq`).
* **Scoring identity**: with ``x̂ = c + r̂``, ``q·x̂ = q·c + q·r̂``; the
  coarse term comes from centroid scoring and ``q·r̂`` from one LUT per
  query over the residual codebooks.
* **Two serving modes**, chosen per search (``mode="auto"`` by batch size,
  :attr:`IVFPQIndex.SCAN_CROSSOVER_BATCH`):

  - ``"scan"`` (:meth:`IVFPQIndex._masked_scan`): one launch of the ADC
    kernel with the bucket bias (``group_bias`` + ``group_ids``,
    :func:`~..ops.adc_kernel.fused_adc_topk`): ``q·c`` on the probed
    buckets, shifted by the per-query maximum for L2/IP and restored after
    the kernel, −1e30 elsewhere. Buckets whose coarse score ties the
    nprobe-th are all probed. On CUDA the kernel reads only the probed
    buckets, from the bucket layout (``buckets=``); on the CPU the plain
    version scans the codes in original row order.
  - ``"probe"`` (:func:`_ivfpq_search`): plain PyTorch, as the reference is
    plain XLA: exactly ``nprobe`` buckets (ties to the lowest), their codes
    gathered and looked up in an f32 LUT, merged into a carried top-k in
    probe-rank order (ties by position, as ``lax.top_k`` keeps them).

* **Re-rank**: ``rerank=R`` rescores the survivors exactly against the
  original rows through :func:`~..ops.gather_kernel.rescore_candidates`,
  ties to the candidate's position.

* **Mutation** (:meth:`IVFPQIndex.add_rows`): rows are coarse-assigned,
  their residuals encoded, and both layouts (the buckets, with the device
  fill ``bucket_fill`` that the scan's kernel reads, and the row-order
  planes) are published together, as one state that a search reads whole.

Files round-trip through the shared format (``Builder.set_ivf_index`` and
``set_pq_index(residual=True)``). :meth:`IVFPQIndex.autotune` times the
scan's launch grid (the bucket kernel's waves) and persists the winner in
the file's ``"ivfpq"`` hints, where :meth:`IVFPQIndex.from_space` adopts
it; the JAX package's ``block_rows`` there is a Mosaic tile and is not
read.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..errors import DimensionMismatchError, IndexOutOfBoundsError
from ..format.constants import DistanceMetric
from ..utils.filters import checked_prepared_mask, padded_filter_plane

from ..engine import (
    PreparedFilter,
    SearchResult,
    grow_rows,
    ids_for_rows,
    merged_append_ids,
    pinned,
    publish,
    resolve_device,
)
from ..ops.adc_kernel import adc_lut, fused_adc_topk, unpack_nibbles
from ..ops.distances import carry_topk_ids, distances_np
from ..ops.gather_kernel import rescore_candidates
from ..ops.grid import check_grid
from ..utils.transfer import put_chunked
from ..utils.tune import tune_grid, tuned_grid
from .ivf import (
    _assign_host,
    _grown_buckets,
    _plan_placements,
    _to,
    bucket_layout,
    coarse_scores,
    fill_buckets,
    probe_order,
    probe_steps,
    train_kmeans,
)
from .pq import (
    _sq_norms64,
    encode_pq,
    pack_codes4,
    reconstruct_pq,
    train_pq,
    unpack_codes4,
)

_MODES = ("auto", "scan", "probe")


def train_ivfpq(
    data: np.ndarray,
    num_clusters: int,
    m: int = 16,
    ksub: int = 256,
    iters: int = 10,
    seed: int = 0,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Train the IVF-PQ structure on host ``[N, D]`` f32 data on
    ``device``. Returns ``(centroids [C, D], assignments [N] i32,
    codebooks [m, ksub, dsub], codes [N, m] u8)``; the codes encode the
    residuals ``x − centroids[assignments]``."""
    dev = resolve_device(device)
    data = np.ascontiguousarray(data, dtype=np.float32)
    centroids, assignments = train_kmeans(data, num_clusters, iters=iters,
                                          seed=seed, device=dev)
    residuals = data - centroids[assignments]
    codebooks = train_pq(residuals, m=m, ksub=ksub, iters=iters, seed=seed + 1,
                         device=dev)
    codes = encode_pq(residuals, codebooks, device=dev)
    return centroids, assignments, codebooks, codes


def _ivfpq_search(q, centroids, buckets, bucket_ids, bucket_norms, books,
                  k: int, nprobe: int, metric, packed4: bool = False,
                  row_filter=None):
    """The IVF-PQ probe in plain PyTorch (the reference's ``lax.scan`` over
    probe ranks): coarse scores, the ``nprobe`` best buckets, and per step
    a few probe ranks' codes gathered, looked up in the f32 LUT (the m
    entries added in ascending j), ``q·c + q·r̂`` scored and merged into the
    carried top-k (:func:`.ivf.probe_steps`). Cosine multiplies by the
    query's inverse norm as well (the reference's probe does; its scan does
    not). ``row_filter``: optional ``[N]`` plane (0 ⇒ excluded) by row id.
    Returns ``(scores [Q, k] f32, rows [Q, k] int32)``; −inf slots carry
    −1."""
    metric = DistanceMetric(metric)
    nq = q.shape[0]
    m, ksub, _ = books.shape
    bsize, cols = buckets.shape[1], buckets.shape[2]
    cdots, cscores = coarse_scores(q, centroids, metric)
    probes = probe_order(cscores, nprobe)
    lut = adc_lut(q, books, exact_lut=True)  # [Q, m·ksub] f32
    qin = None
    if metric == DistanceMetric.COSINE:
        qin = 1.0 / torch.sqrt(torch.clamp((q * q).sum(1), min=1e-30))
    j_off = ksub * torch.arange(m, device=q.device)
    neg_inf = torch.tensor(float("-inf"), device=q.device)
    best = (torch.empty((nq, 0), dtype=torch.float32, device=q.device),
            torch.empty((nq, 0), dtype=torch.int64, device=q.device))
    for p0, p1 in probe_steps(nq, nprobe, bsize * m):
        pcols = probes[:, p0:p1]  # [Q, g] buckets, in probe-rank order
        gc = buckets[pcols].reshape(nq, -1, cols)  # [Q, g·B, cols]
        if packed4:
            gc = unpack_nibbles(gc.reshape(-1, cols), m).reshape(nq, -1, m)
        flat = (gc.long() + j_off).reshape(nq, -1)
        vals = torch.gather(lut, 1, flat).reshape(nq, -1, m)
        rdots = vals[:, :, 0]
        for j in range(1, m):  # ascending j, in f32
            rdots = rdots + vals[:, :, j]
        qc = torch.gather(cdots, 1, pcols)  # [Q, g]
        dots = (qc[:, :, None] + rdots.reshape(nq, -1, bsize)).reshape(nq, -1)
        gi = bucket_ids[pcols].reshape(nq, -1).long()
        gn = bucket_norms[pcols].reshape(nq, -1)
        if metric == DistanceMetric.L2:
            scores = 2.0 * dots - gn
        elif metric == DistanceMetric.COSINE:
            scores = (dots * (1.0 / torch.sqrt(torch.clamp(gn, min=1e-30)))
                      * qin[:, None])
        else:
            scores = dots
        live = gi >= 0
        if row_filter is not None:
            live &= row_filter[gi.clamp(min=0)] != 0
        best = carry_topk_ids(best, torch.where(live, scores, neg_inf), gi, k)
    s, idx = best
    idx = torch.where(s > float("-inf"), idx, -1)
    return s, idx.to(torch.int32)


@dataclasses.dataclass
class IVFPQIndex:
    """Probe-ready IVF-PQ structure for one space, resident on
    ``codes_row.device``.

    Bucket layout (the probe mode): ``buckets`` ``[C', B, m]`` uint8
    residual codes (``[C', B, ⌈m/2⌉]`` when ``packed4``), ``bucket_ids`` /
    ``bucket_norms`` ``[C', B]`` row ids (−1: padding or tombstone) and
    squared norms of the full reconstructions ``‖c + r̂‖²``;
    ``probe_centroids`` ``[C', D]`` per bucket. Row order (the scan mode):
    ``codes_row`` ``[N, m]``, ``rnorms_row`` ``[N]``, ``row_bucket`` ``[N]``
    int32 (−1: tombstoned) and ``row_valid`` ``[N]`` f32. Host:
    ``centroids`` ``[C, D]``, ``cells`` ``[C']`` bucket → cluster,
    ``codebooks`` ``[m, ksub, dsub]``, ``fill`` (and on the device
    ``bucket_fill``, int32, which the scan's kernel reads), and each row's
    ``row_bucket_host`` / ``row_slot_host``. ``db`` / ``db_norms``: the
    original rows, for re-ranking. The row-order planes may hold more rows
    than ``num_vectors`` (the capacity of :meth:`add_rows`); the rows past
    it are never read.

    Mutations publish every changed field at once (:func:`~..engine.publish`)
    and a search reads one published state (:func:`~..engine.pinned`)."""

    centroids: np.ndarray
    probe_centroids: torch.Tensor
    cells: np.ndarray
    codebooks: np.ndarray
    buckets: torch.Tensor
    bucket_ids: torch.Tensor
    bucket_norms: torch.Tensor
    fill: np.ndarray
    metric: DistanceMetric
    dim: int
    num_vectors: int
    db: torch.Tensor | None = None
    db_norms: torch.Tensor | None = None
    # The batch from which "auto" takes the scan: the reference's value,
    # measured on a TPU; PERF.md has the crossover on an H100.
    SCAN_CROSSOVER_BATCH = 32
    codes_row: torch.Tensor | None = None
    rnorms_row: torch.Tensor | None = None
    row_bucket: torch.Tensor | None = None
    row_valid: torch.Tensor | None = None
    host_ids: np.ndarray | None = None
    row_bucket_host: np.ndarray | None = None
    row_slot_host: np.ndarray | None = None
    packed4: bool = False
    grid: object = None  # the scan's launch grid (ops.grid.Grid); None: one wave
    bucket_fill: torch.Tensor | None = dataclasses.field(default=None, init=False)

    def __post_init__(self):
        self.codebooks = np.array(self.codebooks, np.float32)
        self._books = torch.from_numpy(self.codebooks).to(self.device)
        self.bucket_fill = _to(self.fill, self.device, np.int32)
        self.grid = check_grid(self.grid, (), "IVFPQIndex")
        self._host_space = None  # the file-backed origin, for persist
        self._write_lock = threading.Lock()  # one writer at a time

    @property
    def device(self) -> torch.device:
        return self.codes_row.device

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        metric: DistanceMetric,
        num_clusters: int,
        m: int = 16,
        ksub: int = 256,
        iters: int = 10,
        seed: int = 0,
        centroids: np.ndarray | None = None,
        assignments: np.ndarray | None = None,
        codebooks: np.ndarray | None = None,
        codes: np.ndarray | None = None,
        recon_norms: np.ndarray | None = None,
        keep_vectors: bool = True,
        valid_mask: np.ndarray | None = None,
        ids: np.ndarray | None = None,
        pack4: bool | None = None,
        device="cuda",
    ) -> "IVFPQIndex":
        """Train (or take precomputed) coarse and residual structure and
        lay the codes out on ``device``. With everything precomputed (as
        ``Builder.set_ivf_index`` + ``set_pq_index(residual=True)``
        persist it) nothing is trained, encoded or reconstructed.
        ``valid_mask``: True marks a tombstoned row, which goes in no
        bucket. ``pack4``: store the codes nibble-packed (``ksub ≤ 16``);
        by default the given codes keep their packing."""
        dev = resolve_device(device)
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        n, d = vectors.shape
        host_ids = (np.ascontiguousarray(ids, np.uint64).reshape(-1)
                    if ids is not None else None)
        if centroids is None or assignments is None:
            centroids, assignments = train_kmeans(vectors, num_clusters,
                                                  iters=iters, seed=seed,
                                                  device=dev)
        num_clusters = centroids.shape[0]
        if codebooks is None or codes is None:
            residuals = vectors - centroids[assignments]
            if codebooks is None:
                codebooks = train_pq(residuals, m=m, ksub=ksub, iters=iters,
                                     seed=seed + 1, device=dev)
            codebooks = np.ascontiguousarray(codebooks, dtype=np.float32)
            if codes is None:
                codes = encode_pq(residuals, codebooks, device=dev)
        codebooks = np.ascontiguousarray(codebooks, dtype=np.float32)
        m, ksub_eff = codebooks.shape[0], codebooks.shape[1]
        codes = np.asarray(codes, np.uint8)
        already_packed = codes.shape[1] == (m + 1) // 2 and codes.shape[1] != m
        if pack4 is None:
            pack4 = already_packed
        if pack4 and ksub_eff > 16:
            raise ValueError(f"pack4 requires ksub <= 16, got {ksub_eff}")
        if recon_norms is None:
            unpacked = unpack_codes4(codes, m) if already_packed else codes
            recon_norms = _sq_norms64(reconstruct_pq(unpacked, codebooks)
                                      + centroids[assignments])
        recon_norms = np.ascontiguousarray(recon_norms, dtype=np.float32)
        if pack4 and not already_packed:
            codes = pack_codes4(codes)
        elif already_packed and not pack4:
            codes = unpack_codes4(codes, m)
        keep = (np.ones(n, bool) if valid_mask is None
                else ~np.asarray(valid_mask, dtype=bool))
        cells, row_lists, bucket_rows = bucket_layout(assignments, keep,
                                                      num_clusters)
        bcodes, bids, bnorms, b_of_row, s_of_row = fill_buckets(
            row_lists, bucket_rows, n, codes, recon_norms)
        db = db_norms = None
        if keep_vectors:
            db = put_chunked(vectors, dev)
            db_norms = _to(_sq_norms64(vectors), dev, np.float32)
        return cls(
            centroids=centroids,
            probe_centroids=_to(centroids[cells], dev, np.float32),
            cells=cells,
            codebooks=codebooks,
            buckets=_to(bcodes, dev, np.uint8),
            bucket_ids=_to(bids, dev, np.int32),
            bucket_norms=_to(bnorms, dev, np.float32),
            fill=np.asarray([len(r) for r in row_lists]),
            metric=DistanceMetric(metric),
            dim=d,
            num_vectors=n,
            db=db,
            db_norms=db_norms,
            codes_row=_to(codes, dev, np.uint8),
            rnorms_row=_to(recon_norms, dev, np.float32),
            row_bucket=_to(b_of_row, dev, np.int32),
            row_valid=_to(b_of_row >= 0, dev, np.float32),
            host_ids=host_ids,
            row_bucket_host=b_of_row,
            row_slot_host=s_of_row,
            packed4=bool(pack4),
        )

    @classmethod
    def from_space(
        cls,
        space,
        num_clusters: int | None = None,
        m: int = 16,
        ksub: int = 256,
        iters: int = 10,
        seed: int = 0,
        keep_vectors: bool = True,
        pack4: bool | None = None,
        device="cuda",
    ) -> "IVFPQIndex":
        """The probe-ready index of a host
        :class:`~metrovector_tpu_torch.vectors.space.VectorSpace` on
        ``device``, reusing the persisted coarse quantizer (IVF blocks) and
        residual PQ sidecar when both are present: no retraining, no
        re-encoding. ``pack4`` defaults to the sidecar's packing. The grid
        persisted by :meth:`autotune` is adopted."""
        stored_ivf = space.ivf_arrays()
        centroids = assignments = codebooks = codes = recon_norms = None
        if stored_ivf is not None:
            centroids, assignments = stored_ivf
        stored_pq = space.pq_arrays()
        if stored_pq is not None and space.info.pq.residual and stored_ivf is not None:
            codebooks, codes, recon_norms = stored_pq
            if pack4 is None:
                pack4 = bool(space.info.pq.packed4)
        if num_clusters is None:
            num_clusters = int(space.info.index.params.get(
                "num_clusters", max(1, int(np.sqrt(space.num_vectors)))))
        vectors = np.asarray(space.to_numpy(), dtype=np.float32)
        q = space.quantization
        if q is not None:
            vectors = (vectors - q.zero_point) * q.scale
        idx = cls.build(
            vectors, space.metric, num_clusters, m=m, ksub=ksub, iters=iters,
            seed=seed, centroids=centroids, assignments=assignments,
            codebooks=codebooks, codes=codes, recon_norms=recon_norms,
            keep_vectors=keep_vectors, valid_mask=space.tombstone_mask(),
            ids=space.ids(), pack4=pack4, device=device,
        )
        idx._host_space = space
        idx.grid = check_grid(tuned_grid(space, "ivfpq"), (), "IVFPQIndex")
        return idx

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "IVFPQIndex":
        """Build from the host arrays of a reference ``IVFPQIndex`` (its
        fields by name: ``centroids``, ``probe_centroids``, ``cells``,
        ``codebooks``, ``buckets``, ``bucket_ids``, ``bucket_norms``,
        ``fill``, ``codes_row``, ``rnorms_row``, ``row_bucket``,
        ``row_valid``, ``row_bucket_host``, ``row_slot_host`` and the
        optional ``db``, ``db_norms``, ``host_ids``) and its scalars
        ``metric``, ``dim``, ``num_vectors`` and ``packed4``, on
        ``device``."""
        dev = resolve_device(device)

        def opt(name, dtype):
            v = state.get(name)
            return None if v is None else _to(v, dev, dtype)

        return cls(
            centroids=np.array(state["centroids"], np.float32),
            probe_centroids=_to(state["probe_centroids"], dev, np.float32),
            cells=np.array(state["cells"], np.int32),
            codebooks=state["codebooks"],
            buckets=_to(state["buckets"], dev, np.uint8),
            bucket_ids=_to(state["bucket_ids"], dev, np.int32),
            bucket_norms=_to(state["bucket_norms"], dev, np.float32),
            fill=np.array(state["fill"]),
            metric=DistanceMetric(int(state["metric"])),
            dim=int(state["dim"]),
            num_vectors=int(state["num_vectors"]),
            db=opt("db", np.float32),
            db_norms=opt("db_norms", np.float32),
            codes_row=_to(state["codes_row"], dev, np.uint8),
            rnorms_row=_to(state["rnorms_row"], dev, np.float32),
            row_bucket=_to(state["row_bucket"], dev, np.int32),
            row_valid=_to(state["row_valid"], dev, np.float32),
            host_ids=state.get("host_ids"),
            row_bucket_host=np.array(state["row_bucket_host"], np.int32),
            row_slot_host=np.array(state["row_slot_host"], np.int32),
            packed4=bool(state.get("packed4", False)),
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

    def _rebuild_layouts(self, codes_all, rnorms_all, cluster_of_row, keep):
        """Re-derive both serving layouts (buckets and row order) from
        per-row state, and publish them together. Row ids are positions in
        the row-order arrays and are never renumbered: a deleted row keeps
        its slot with ``row_valid = 0`` and drops out of the buckets."""
        dev = self.device
        n = codes_all.shape[0]
        cells, row_lists, bucket_rows = bucket_layout(
            np.where(cluster_of_row >= 0, cluster_of_row, 0),
            keep & (cluster_of_row >= 0), self.num_clusters)
        bcodes, bids, bnorms, b_of_row, s_of_row = fill_buckets(
            row_lists, bucket_rows, n, codes_all, rnorms_all)
        fill = np.asarray([len(r) for r in row_lists])
        publish(
            self,
            row_bucket_host=b_of_row,
            row_slot_host=s_of_row,
            cells=cells,
            fill=fill,
            bucket_fill=_to(fill, dev, np.int32),
            probe_centroids=_to(self.centroids[cells], dev, np.float32),
            buckets=_to(bcodes, dev, np.uint8),
            bucket_ids=_to(bids, dev, np.int32),
            bucket_norms=_to(bnorms, dev, np.float32),
            codes_row=_to(codes_all, dev, np.uint8),
            rnorms_row=_to(rnorms_all, dev, np.float32),
            row_bucket=_to(b_of_row, dev, np.int32),
            row_valid=_to(b_of_row >= 0, dev, np.float32),
            num_vectors=n,
        )

    def _host_row_state(self):
        """``(codes [N, cols], recon norms [N], cluster of each row [N]
        (−1: deleted), kept [N])`` read back from the device."""
        ix = pinned(self)
        codes_all = ix.codes_row[: ix.num_vectors].cpu().numpy()
        rnorms_all = ix.rnorms_row[: ix.num_vectors].cpu().numpy()
        rb = ix.row_bucket[: ix.num_vectors].cpu().numpy()
        cluster_of_row = np.where(rb >= 0, ix.cells[np.maximum(rb, 0)], -1)
        return codes_all, rnorms_all, cluster_of_row.astype(np.int32), rb >= 0

    def rebuild(self) -> None:
        """Re-derive both serving layouts from per-row state, reclaiming
        deleted slots and re-balancing the buckets (O(N) host work)."""
        with self._write_lock:
            self._rebuild_layouts(*self._host_row_state())

    def add_rows(self, vectors, ids=None, reserve: float = 1.5) -> None:
        """Append rows to the live index, the reference's
        ``IVFPQIndex.add_rows``: each row goes to its nearest trained
        centroid (L2 in float64 on the host), its residual is encoded with
        the trained codebooks on the device (no retraining), and it is
        scattered into the tail slots of its cluster's buckets, or new
        buckets when they are full. Appends carry ``ids`` iff the index
        has an ID column.

        Both layouts change. The bucket tensors are copied on the device
        (or grown by new buckets, which widen the scan's bias to the new
        bucket count) before the scatter; the row-order planes grow in
        capacity steps of 128 rows (:func:`~..engine.grow_rows`, in place
        within capacity). The buckets, ``fill`` and its device copy
        ``bucket_fill`` (each bucket's row count for the scan's kernel),
        the row-order planes and the row count are published together, so
        the scan and the probe see the same rows."""
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
            dev = self.device
            assign_new = _assign_host(vectors, self.centroids)
            residuals = vectors - self.centroids[assign_new]
            codes_new = encode_pq(residuals, self.codebooks, device=dev)
            rn_new = _sq_norms64(reconstruct_pq(codes_new, self.codebooks)
                                 + self.centroids[assign_new])
            if self.packed4:
                codes_new = pack_codes4(codes_new)
            b_idx, s_idx, new_cells, fill, fills_new = _plan_placements(
                self.cells, self.fill, self.bucket_rows, assign_new)
            buckets, bids, bnorms, pcents, cells = _grown_buckets(self, new_cells)
            bi = torch.from_numpy(b_idx.astype(np.int64)).to(dev)
            si = torch.from_numpy(s_idx.astype(np.int64)).to(dev)
            codes_dev = _to(codes_new, dev, np.uint8)
            rn_dev = _to(rn_new, dev, np.float32)
            b_dev = _to(b_idx, dev, np.int32)
            buckets[bi, si] = codes_dev
            bids[bi, si] = torch.arange(nv, nv + n_new, dtype=torch.int32, device=dev)
            bnorms[bi, si] = rn_dev
            fill = np.concatenate([fill, fills_new])
            total = nv + n_new
            cap = int(self.codes_row.shape[0])
            if total > cap:
                cap = max(-(-total // 128) * 128, -(-int(cap * reserve) // 128) * 128)
            changes = dict(
                buckets=buckets, bucket_ids=bids, bucket_norms=bnorms,
                probe_centroids=pcents, cells=cells, fill=fill,
                bucket_fill=_to(fill, dev, np.int32),
                codes_row=grow_rows(self.codes_row, nv, codes_dev, cap),
                rnorms_row=grow_rows(self.rnorms_row, nv, rn_dev, cap),
                row_bucket=grow_rows(self.row_bucket, nv, b_dev, cap, fill=-1),
                row_valid=grow_rows(self.row_valid, nv,
                                    torch.ones(n_new, dtype=torch.float32, device=dev),
                                    cap, fill=0.0),
                row_bucket_host=np.concatenate([self.row_bucket_host[:nv], b_idx]),
                row_slot_host=np.concatenate([self.row_slot_host[:nv], s_idx]),
                num_vectors=total,
            )
            if self.db is not None:
                changes["db"] = grow_rows(self.db, nv, _to(vectors, dev, np.float32), cap)
                changes["db_norms"] = grow_rows(
                    self.db_norms, nv, _to(_sq_norms64(vectors), dev, np.float32), cap)
            if merged_ids is not None:
                changes["host_ids"] = merged_ids
            publish(self, **changes)

    def autotune(self, queries=None, k: int = 10, batch: int = 128,
                 nprobe: int = 16, waves_candidates=None, iters: int = 3,
                 apply: bool = True, persist: bool = False,
                 **search_kw) -> list[dict]:
        """Time the scan mode's launch grid (the bucket kernel's waves; its
        library holds one query tile) with single-launch timings of
        ``search(mode="scan")``, which this knob alone serves, also at a
        batch below :attr:`SCAN_CROSSOVER_BATCH`. ``**search_kw`` reach
        :meth:`search` (``rerank=``, ``exact_lut=``). The report, ``apply``
        and ``persist`` (into ``hints["tuned"][space]["ivfpq"]["cuda"]``,
        for an index built by :meth:`from_space` on a file-backed space)
        follow :meth:`~..engine.SearchEngine.autotune`; on the CPU it
        raises ``ValueError``."""
        def run_with(q, grid):
            return lambda: self.search(q, k=k, nprobe=nprobe, mode="scan", grid=grid,
                                       **search_kw)

        return tune_grid(self, "ivfpq", run_with, queries=queries, batch=batch,
                         dim=self.dim, waves=waves_candidates, tiles=(None,),
                         iters=iters, apply=apply, persist=persist)

    def delete_rows(self, rows) -> None:
        """Tombstone rows by position: their bucket slots get id −1 and
        their row-order validity 0, published together as new tensors; row
        positions are never renumbered, slots not reclaimed
        (:meth:`rebuild` does)."""
        with self._write_lock:
            idx = [int(r) for r in np.atleast_1d(rows)]
            for r in idx:
                if r < 0 or r >= self.num_vectors:
                    raise IndexOutOfBoundsError(r, self.num_vectors)
            if not idx:
                return
            sel = np.asarray(idx, np.int64)
            placed = sel[self.row_bucket_host[sel] >= 0]
            dev = self.device
            changes = {}
            if placed.size:
                bids = self.bucket_ids.clone()
                bi = torch.from_numpy(self.row_bucket_host[placed].astype(np.int64))
                si = torch.from_numpy(self.row_slot_host[placed].astype(np.int64))
                bids[bi.to(dev), si.to(dev)] = -1
                changes["bucket_ids"] = bids
            seld = torch.from_numpy(sel).to(dev)
            row_bucket, row_valid = self.row_bucket.clone(), self.row_valid.clone()
            row_bucket[seld] = -1
            row_valid[seld] = 0.0
            row_bucket_host = self.row_bucket_host.copy()
            row_slot_host = self.row_slot_host.copy()
            row_bucket_host[sel] = -1
            row_slot_host[sel] = -1
            publish(self, row_bucket=row_bucket, row_valid=row_valid,
                    row_bucket_host=row_bucket_host, row_slot_host=row_slot_host,
                    **changes)

    def prepare_filter(self, filter_mask) -> PreparedFilter:
        """Upload a ``[num_vectors]`` boolean/int row predicate once for
        many :meth:`search` calls (both modes read it by original row
        id)."""
        ix = pinned(self)
        full = padded_filter_plane(filter_mask, ix.num_vectors,
                                   ix.codes_row.shape[0])
        return PreparedFilter(mask=torch.from_numpy(full).to(ix.device),
                              num_valid=ix.num_vectors)

    def _filter_device(self, filter_mask):
        """A raw array or PreparedFilter → the ``[N]`` f32 device plane
        both modes take (scan: times ``row_valid``; probe: gathered at
        candidate row ids)."""
        if filter_mask is None:
            return None
        if isinstance(filter_mask, PreparedFilter):
            return checked_prepared_mask(filter_mask, self.num_vectors,
                                         self.codes_row.shape[0])
        return self.prepare_filter(filter_mask).mask

    def _scan_bias(self, qdev, nprobe: int):
        """``(bias [Q, C'] f32, b0 [Q, 1] or None)`` of the scan mode: the
        bias is ``q·c`` on the probed buckets (every bucket whose coarse
        score reaches the nprobe-th best: ties are all probed), −1e30
        elsewhere (those rows score −inf). For L2/IP the probed biases are
        shifted by the per-query maximum ``b0``, so that the values a bf16
        LUT carries stay small; cosine keeps the raw ``q·c`` (the
        reference's f32 operations, in its order)."""
        cdots, cscores = coarse_scores(qdev, self.probe_centroids, self.metric)
        kth = torch.sort(cscores, dim=1, descending=True).values[:, nprobe - 1 : nprobe]
        sel = cscores >= kth
        if self.metric == DistanceMetric.COSINE:
            b0, shifted = None, cdots
        else:
            b0 = torch.where(sel, cdots, float("-inf")).amax(dim=1, keepdim=True)
            shifted = cdots - b0
        return torch.where(sel, shifted, -1e30), b0

    def _masked_scan(self, qdev, fetch: int, nprobe: int,
                     exact_lut: bool = False, row_filter=None, grid=None):
        """The scan mode: ADC with the bucket bias of :meth:`_scan_bias`,
        one launch of the ADC kernel's bucket form, which reads the probed
        buckets from the bucket layout (the plain version scans the rows in
        original order; the same answer); for L2/IP ``mult·b0`` is added
        back to the scores (mult 2 for L2, 1 for IP). ``grid``: the launch
        grid (default :attr:`grid`). No host synchronization."""
        bias, b0 = self._scan_bias(qdev, nprobe)
        n = self.num_vectors  # the logical rows, not the planes' capacity
        eff_valid = self.row_valid[:n]
        if row_filter is not None:
            eff_valid = eff_valid * row_filter[:n]
        s, i = fused_adc_topk(
            qdev, self.codes_row[:n], self._books, self.rnorms_row[:n],
            n, min(fetch, n), self.metric, valid_mask=eff_valid,
            exact_lut=exact_lut, packed4=self.packed4, group_bias=bias,
            group_ids=self.row_bucket[:n],
            buckets=(self.buckets, self.bucket_ids, self.bucket_norms, self.bucket_fill),
            grid=self.grid if grid is None else grid,
        )
        if fetch > n:  # more slots than rows: the rest stay unfilled
            pad = fetch - n
            s = torch.cat([s, torch.full((s.shape[0], pad), float("-inf"),
                                         device=s.device)], dim=1)
            i = torch.cat([i, torch.full((i.shape[0], pad), -1, dtype=i.dtype,
                                         device=i.device)], dim=1)
        if b0 is not None:
            mult = 2.0 if self.metric == DistanceMetric.L2 else 1.0
            s = s + mult * b0  # −inf slots stay −inf
        return s, i

    def recommended_rerank(self, k: int = 10, recall_target: float = 1.0) -> int:
        """Rerank depth expected to reach ``recall_target`` at this ``k``:
        the reference's rule (``rerank = 40·k`` reached recall 1.000 on
        both code widths of a 1M × 128 clustered corpus at nprobe = 16 in
        its measurements); 0 when the ADC scan alone is expected to meet
        the target."""
        if not 0.0 < recall_target <= 1.0:
            raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")
        raw = 0.63 if self.packed4 else 0.70  # conservative scan-only recall
        if recall_target <= raw:
            return 0
        if recall_target >= 0.99:
            factor = 40
        elif recall_target >= 0.9:
            factor = 20
        else:
            factor = 12 if self.packed4 else 10
        return factor * k

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        nprobe: int = 8,
        rerank: int = 0,
        mode: str = "auto",
        interpret: bool | None = None,
        exact_lut: bool = False,
        block_rows: int | None = None,
        filter_mask=None,
        grid=None,
    ) -> SearchResult:
        """Approximate top-k: ADC over the ``nprobe`` best-scoring buckets'
        residual codes (split cells count one bucket each); ``rerank=R``
        rescores the top-R survivors exactly against the original rows.

        ``mode``: ``"probe"`` walks the probed buckets in plain PyTorch,
        ``"scan"`` runs the ADC kernel with the bucket bias, ``"auto"`` takes
        the scan from ``SCAN_CROSSOVER_BATCH`` queries. ``exact_lut``: the
        scan's LUT (and bias) in f32, else bf16; the probe mode's LUT is
        f32. ``filter_mask``: ``[num_vectors]`` predicate or a
        :meth:`prepare_filter` result, composed with the tombstones before
        the re-rank. Cosine queries are normalized on the host first.
        ``interpret`` and ``block_rows`` are accepted and ignored (the
        tensors' device decides; the Mosaic tile has no counterpart).
        ``grid``: the scan's launch grid (default :attr:`grid`).

        On a CUDA device the scan is one launch of the ADC kernel's bucket
        form over the probed buckets, the probe plain PyTorch, and a
        re-rank one launch of the rescore kernel."""
        ix = pinned(self)  # one published state for the whole search
        q = np.ascontiguousarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != ix.dim:
            raise DimensionMismatchError(expected=ix.dim, actual=int(q.shape[1]))
        qnorms = np.einsum("ij,ij->i", q, q, dtype=np.float64).astype(np.float32)
        if ix.metric == DistanceMetric.COSINE:
            q = q / np.maximum(np.sqrt(qnorms)[:, None], 1e-30)
        nprobe = min(nprobe, ix.num_buckets)
        fetch = max(k, rerank) if rerank else k
        fetch = min(fetch, ix.bucket_rows * nprobe) or 1
        if mode not in _MODES:
            raise ValueError(
                f"unknown search mode {mode!r}; expected 'auto', 'scan' or 'probe'"
            )
        if mode == "auto":
            mode = "scan" if q.shape[0] >= ix.SCAN_CROSSOVER_BATCH else "probe"
        if rerank and ix.db is None:
            raise ValueError(
                "rerank requires the original vectors (build with keep_vectors=True)"
            )
        qdev = torch.from_numpy(np.ascontiguousarray(q)).to(ix.device)
        row_filter = ix._filter_device(filter_mask)
        if mode == "scan":
            s, i = ix._masked_scan(qdev, fetch, nprobe, exact_lut=exact_lut,
                                   row_filter=row_filter, grid=grid)
        else:
            s, i = _ivfpq_search(
                qdev, ix.probe_centroids, ix.buckets, ix.bucket_ids,
                ix.bucket_norms, ix._books, k=fetch, nprobe=nprobe,
                metric=ix.metric, packed4=ix.packed4, row_filter=row_filter,
            )
        if rerank:
            s, i = rescore_candidates(qdev, ix.db, ix.db_norms, i,
                                      min(k, fetch), ix.metric, tie="position")
        else:
            s, i = s[:, :k], i[:, :k]
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
