"""Sharded exact and PQ search: the counterpart of
:mod:`metrovector_tpu.parallel.sharded_search`.

Corpus rows are split over the mesh's shard axis (shard ``s`` holds the
global rows ``[s·per, (s+1)·per)``), queries go to every shard's device,
each shard runs the single-device kernel over its own rows (K1,
:func:`~..ops.topk_kernel.fused_topk`; for PQ K2 and K3), its ``[Q, k]``
list gets global row ids, and one exchange (:func:`.mesh.exchange_topk`)
merges the lists with the reference's tie rule. Every shard's launch is
issued under its own device without a synchronisation between shards, so
several cards scan at once; shards that share a card queue on its stream.

A shard scans only its logically valid rows, ``clip(num_valid − s·per,
0, per)`` of them, as the resident engine scans its ``num_valid`` rows;
a shard made only of padding launches nothing and gives unfilled slots.
The int8 inner product that ranks raw dots (:func:`~..ops.distances.
deferred_scale`) keeps them raw through the merge and scales the merged k,
as K1 scales its own k, so the answer is the resident engine's.

The other mappings: :func:`query_sharded_topk` splits the query batch and
repeats the corpus (no exchange), :func:`grid_sharded_topk` does both on a
``(query, shard)`` mesh (lists merge only along a query row's shards), and
:func:`dim_sharded_topk` splits the dimension: partial dots in full f32
(TF32 off, the reference's ``Precision.HIGHEST``) summed in shard order
(``all_reduce`` under a process group), then the epilogue and a stable
selection. That path reaches no TPU kernel in the reference, so it runs on
``torch.matmul``.

Each sharded argument is a list of this process's shards (what
:func:`.mesh.shard_rows` returns) or a whole array, which is split here;
each repeated one a :func:`.mesh.replicate` result or a whole array.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import (
    DeviceSpace,
    PreparedFilter,
    SearchResult,
    _check_supported,
    empty_result,
    host_result,
)
from ..errors import InvalidVectorTypeError
from ..format.constants import DataType, DistanceMetric, VectorType
from ..ops.adc_kernel import adc_tables, fused_adc_topk
from ..ops.distances import (
    carry_topk,
    deferred_scale,
    empty_topk,
    f32_scalar,
    finish_topk,
    full_f32_matmul,
    mask_scores,
)
from ..ops.gather_kernel import rescore_candidates
from ..ops.topk_kernel import fused_topk, kernel_precision
from ..utils.filters import checked_prepared_mask, padded_filter_plane
from .mesh import (
    QUERY_AXIS,
    SHARD_AXIS,
    Mesh,
    exchange_topk,
    on_devices,
    pad_list,
    rows_per_shard,
    split_rows,
    unfilled,
)


def local_valid(num_valid: int, shard: int, per: int) -> int:
    """Logically valid rows of ``shard`` (``per`` rows a shard)."""
    return int(min(max(int(num_valid) - shard * per, 0), per))


def _shard_devices(mesh: Mesh, axis: str) -> list[torch.device]:
    """The device of each of this process's shards along ``axis`` of a
    1-D mesh."""
    mesh.size(axis)
    if len(mesh.axis_names) != 1:
        raise ValueError(f"a 1-D mesh is needed, got axes {mesh.axis_names}")
    return list(mesh.devices)


def _rows_per(db, mesh: Mesh, axis: str) -> int:
    """Rows a shard: a sharded ``db``'s own, else the split of its rows."""
    if isinstance(db, (list, tuple)):
        return int(db[0].shape[0])
    return rows_per_shard(int(db.shape[0]), mesh.size(axis), 8)


def _dense_lists(queries, db, norms, num_valid, k, metric, devices, first, mask,
                 scale, bias_row, bias_scale, affine, defer, precision="highest"):
    """K1 over each shard's valid rows at ``precision``: ``[(s, i)]`` in
    shard order, each ``min(k, per)`` wide with global rows (raw dots where
    ``defer``)."""
    per = int(db[0].shape[0])
    kl = min(k, per)
    q_on = on_devices(queries, devices)
    nq = next(iter(q_on.values())).shape[0]
    lists = []
    for j, dev in enumerate(devices):
        s = first + j
        nv = local_valid(num_valid, s, per)
        if nv == 0:  # only padding: nothing to scan
            lists.append(unfilled(nq, kl, dev))
            continue
        sc, ix = fused_topk(
            q_on[dev], db[j][:nv], norms[j][:nv], nv, min(kl, nv), metric,
            valid_mask=None if mask is None else mask[j][:nv], scale=scale,
            bias_row=None if bias_row is None else bias_row[j][:nv],
            bias_scale=bias_scale, affine=affine, raw_scores=defer,
            precision=precision)
        lists.append(pad_list(sc, torch.where(ix >= 0, ix + s * per, ix), kl))
    return lists


def sharded_topk(queries, db, db_norms, num_valid: int, k: int, metric, mesh: Mesh,
                 valid_mask=None, axis: str = SHARD_AXIS, scale: float = 1.0,
                 bias_row=None, bias_scale: float = 0.0, affine=None,
                 precision: str = "highest"):
    """Exact global top-k of ``queries [Q, D]`` over a row-sharded corpus:
    ``db`` ``[S·per, D]`` (shards or a whole array), its squared norms
    ``db_norms`` and the optional ``valid_mask`` and ``bias_row`` (f32,
    sharded the same way), ``num_valid`` the global logical row count.
    ``scale``, ``bias_row``/``bias_scale`` and ``affine`` are K1's
    (:func:`~..ops.topk_kernel.fused_topk`): int8 queries over an int8
    corpus, the uint8 offset correction, the affine uint8 read; so is
    ``precision`` (``"default"``: a bf16 corpus scanned in one pass, as
    :func:`~..ops.topk_kernel.kernel_precision` gives a BFLOAT16 space). Returns
    ``(scores [Q, k] f32, rows [Q, k] int32)`` on the mesh's lead device,
    best first, ties to the lowest global row, unfilled slots (−inf, −1);
    under a process group every rank gets the whole answer."""
    metric = DistanceMetric(metric)
    devices = _shard_devices(mesh, axis)
    per = _rows_per(db, mesh, axis)
    db, db_norms = split_rows(db, mesh, axis, per), split_rows(db_norms, mesh, axis, per)
    mask = None if valid_mask is None else split_rows(valid_mask, mesh, axis, per)
    bias = None if bias_row is None else split_rows(bias_row, mesh, axis, per)
    q_dtype = queries.dtype if isinstance(queries, torch.Tensor) else None
    if isinstance(queries, dict):
        q_dtype = next(iter(queries.values())).dtype
    defer = q_dtype == torch.int8 and deferred_scale(db[0], metric, bias, scale)
    lists = _dense_lists(queries, db, db_norms, num_valid, k, metric, devices,
                         mesh.first_shard(), mask, scale, bias, bias_scale, affine,
                         defer, precision)
    s, i = exchange_topk(lists, k, mesh)
    if defer:  # the raw dots' order was kept; scale as K1's epilogue does
        s = s * f32_scalar(scale, s.device)
    return s, i


def _split_queries(queries, parts: int) -> list[torch.Tensor]:
    q = queries if isinstance(queries, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(queries))
    if q.shape[0] % parts:
        raise ValueError(f"{q.shape[0]} queries do not split into {parts} equal parts")
    return list(q.chunk(parts)) if q.shape[0] else [q] * parts


def query_sharded_topk(queries, db, db_norms, num_valid: int, k: int, metric,
                       mesh: Mesh, valid_mask=None, axis: str = QUERY_AXIS,
                       scale: float = 1.0, bias_row=None, bias_scale: float = 0.0,
                       affine=None):
    """Exact top-k with the query batch split over ``axis`` (``Q`` a
    multiple of its size) and the corpus repeated on every device (one
    copy per distinct device): each position runs K1 over the whole corpus
    for its queries; no exchange. K1's arguments as in
    :func:`sharded_topk`. Returns the ``[Q, k]`` answers in query order on
    the lead device. One process only."""
    metric = DistanceMetric(metric)
    devices = _shard_devices(mesh, axis)
    if mesh.group is not None:
        raise ValueError("query_sharded_topk runs in one process")
    pieces = _split_queries(queries, len(devices))
    db, db_norms = on_devices(db, devices), on_devices(db_norms, devices)
    mask = None if valid_mask is None else on_devices(valid_mask, devices)
    bias = None if bias_row is None else on_devices(bias_row, devices)
    nv = int(num_valid)
    out = []
    for dev, q in zip(devices, pieces):
        if nv == 0:
            out.append(unfilled(q.shape[0], k, mesh.lead))
            continue
        s, i = fused_topk(
            q.to(dev), db[dev][:nv], db_norms[dev][:nv], nv, min(k, nv), metric,
            valid_mask=None if mask is None else mask[dev][:nv], scale=scale,
            bias_row=None if bias is None else bias[dev][:nv], bias_scale=bias_scale,
            affine=affine)
        out.append(tuple(t.to(mesh.lead) for t in pad_list(s, i, k)))
    return torch.cat([s for s, _ in out]), torch.cat([i for _, i in out])


def grid_sharded_topk(queries, db, db_norms, num_valid: int, k: int, metric,
                      mesh: Mesh, valid_mask=None, query_axis: str = QUERY_AXIS,
                      shard_axis: str = SHARD_AXIS, scale: float = 1.0, bias_row=None,
                      bias_scale: float = 0.0, affine=None):
    """Exact top-k on a ``(query, shard)`` mesh (:func:`.mesh.make_mesh_2d`):
    the batch splits over the query axis, the rows over the shard axis
    (each row group on every device of its column: ``db`` as
    :func:`.mesh.shard_rows` gives it on this mesh, or a whole array), and
    each query row merges its own shards' lists. Returns the ``[Q, k]``
    answers in query order on the lead device."""
    metric = DistanceMetric(metric)
    if mesh.axis_names != (query_axis, shard_axis):
        raise ValueError(f"a ({query_axis!r}, {shard_axis!r}) mesh is needed, "
                         f"got axes {mesh.axis_names}")
    n_shard = mesh.size(shard_axis)
    per = (int(db[0][0].shape[0]) if isinstance(db, (list, tuple))
           else rows_per_shard(int(db.shape[0]), n_shard, 8))

    def rows(x):
        return None if x is None else split_rows(x, mesh, shard_axis, per)

    db, db_norms, mask, bias = rows(db), rows(db_norms), rows(valid_mask), rows(bias_row)
    pieces = _split_queries(queries, mesh.size(query_axis))
    defer = pieces[0].dtype == torch.int8 and deferred_scale(db[0][0], metric, bias_row,
                                                             scale)
    out_s, out_i = [], []
    for r, (devs, q) in enumerate(zip(mesh.devices, pieces)):
        lists = _dense_lists(q, db[r], db_norms[r], num_valid, k, metric, list(devs), 0,
                             None if mask is None else mask[r], scale,
                             None if bias is None else bias[r], bias_scale, affine,
                             defer)
        s, i = exchange_topk(lists, k)
        out_s.append(s.to(mesh.lead))
        out_i.append(i.to(mesh.lead))
    s, i = torch.cat(out_s), torch.cat(out_i)
    if defer:
        s = s * f32_scalar(scale, s.device)
    return s, i


def _column_blocks(x, devices, first: int, n_shards: int) -> list[torch.Tensor]:
    """This process's column blocks of ``x [rows, D]`` (D a multiple of
    the shard count), each on its device; a list is returned as it is."""
    if isinstance(x, (list, tuple)):
        return list(x)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if t.shape[1] % n_shards:
        raise ValueError(f"D={t.shape[1]} does not split into {n_shards} equal parts")
    w = t.shape[1] // n_shards
    return [t[:, (first + j) * w:(first + j + 1) * w].contiguous().to(dev)
            for j, dev in enumerate(devices)]


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (gloo through host memory)."""
    host = torch.distributed.get_backend(group) != "nccl" and t.device.type != "cpu"
    src = t.cpu() if host else t
    torch.distributed.all_reduce(src, op=torch.distributed.ReduceOp.SUM, group=group)
    return src.to(t.device) if host else src


def dim_sharded_topk(queries, db, db_norms, num_valid: int, k: int, metric,
                     mesh: Mesh, valid_mask=None, axis: str = SHARD_AXIS):
    """Exact top-k with the corpus split over the dimension: ``queries
    [Q, D]`` and ``db [N, D]`` in column blocks (lists, or whole arrays
    split here), ``db_norms`` and ``valid_mask`` ``[N]`` whole. Each
    shard's partial dots (f32, TF32 off) come to the lead device and are
    summed in shard order (then over the ranks of a process group); the
    metric epilogue (cosine takes queries normalized over the full
    dimension), the masks and a stable selection (ties to the lowest row)
    follow. Returns ``(scores [Q, k], rows [Q, k] int32)`` on the lead
    device."""
    metric = DistanceMetric(metric)
    devices = _shard_devices(mesh, axis)
    n_shards, first = mesh.size(axis), mesh.first_shard()
    qs = _column_blocks(queries, devices, first, n_shards)
    xs = _column_blocks(db, devices, first, n_shards)
    lead = mesh.lead
    dots = None
    for q, x in zip(qs, xs):
        with full_f32_matmul():
            part = (q.float() @ x.float().T).to(lead)
        dots = part if dots is None else dots + part
    if mesh.group is not None:
        dots = _all_reduce_sum(dots, mesh.group)
    norms = on_devices(db_norms, [lead])[lead]
    if metric == DistanceMetric.L2:
        scores = 2.0 * dots - norms[None, :]
    elif metric == DistanceMetric.COSINE:
        scores = dots * torch.rsqrt(torch.clamp(norms, min=1e-30))[None, :]
    else:
        scores = dots
    mask = None if valid_mask is None else on_devices(valid_mask, [lead])[lead]
    scores = mask_scores(scores, 0, int(num_valid), mask)
    return finish_topk(carry_topk(empty_topk(scores.shape[0], lead), scores, 0, k), k)


def sharded_pq_topk(queries, codes, codebooks, recon_norms, num_valid: int, k: int,
                    metric, mesh: Mesh, db=None, db_norms=None, rerank: int = 0,
                    valid_mask=None, axis: str = SHARD_AXIS, exact_lut: bool = False,
                    int8_lut: bool = False, packed4: bool = False):
    """Global PQ search over row-sharded codes (K2,
    :func:`~..ops.adc_kernel.fused_adc_topk`, on each shard): ``codes``
    ``[S·per, m]`` (or ``⌈m/2⌉`` nibble-packed columns with ``packed4``)
    and ``recon_norms`` sharded, ``codebooks [m, ksub, dsub]`` repeated
    (one copy per distinct device), ``queries`` pre-normalized for cosine.
    The LUT is built once per distinct device (:func:`~..ops.adc_kernel.
    adc_tables`). Each shard fetches ``min(max(k, rerank), per)`` candidates; with
    ``rerank`` it re-scores them exactly against its own rows of ``db``
    (sharded like the codes) by K3 (:func:`~..ops.gather_kernel.
    rescore_candidates`, ties by candidate position) and keeps
    ``min(k, fetch)``, so no row crosses between shards. The lists merge
    to ``min(k, S·kept)``. Returns them on the lead device."""
    metric = DistanceMetric(metric)
    devices = _shard_devices(mesh, axis)
    if rerank and db is None:
        raise ValueError("rerank needs db and db_norms: the shards' own rows")
    per = _rows_per(codes, mesh, axis)
    codes = split_rows(codes, mesh, axis, per)
    rnorms = split_rows(recon_norms, mesh, axis, per)
    mask = None if valid_mask is None else split_rows(valid_mask, mesh, axis, per)
    if rerank:
        db, db_norms = split_rows(db, mesh, axis, per), split_rows(db_norms, mesh, axis, per)
    books = on_devices(codebooks, devices)
    q_on = on_devices(queries, devices)
    nq = next(iter(q_on.values())).shape[0]
    exact_lut = exact_lut and not int8_lut
    luts = {dev: adc_tables(q_on[dev], books[dev], exact_lut, int8_lut) for dev in q_on}
    fetch = min(max(k, rerank) if rerank else k, per)
    kept = min(k, fetch)
    first = mesh.first_shard()
    lists = []
    for j, dev in enumerate(devices):
        s = first + j
        nv = local_valid(num_valid, s, per)
        if nv == 0:
            lists.append(unfilled(nq, kept, dev))
            continue
        sc, ix = fused_adc_topk(
            q_on[dev], codes[j][:nv], books[dev], rnorms[j][:nv], nv, min(fetch, nv),
            metric, valid_mask=None if mask is None else mask[j][:nv],
            exact_lut=exact_lut, packed4=packed4, int8_lut=int8_lut, lut=luts[dev])
        if rerank:
            sc, ix = pad_list(sc, ix, fetch)
            sc, ix = rescore_candidates(q_on[dev], db[j], db_norms[j], ix, kept, metric,
                                        tie="position")
        else:
            sc, ix = pad_list(sc[:, :kept], ix[:, :kept], kept)
        lists.append((sc, torch.where(ix >= 0, ix + s * per, ix)))
    return exchange_topk(lists, min(k, mesh.size(axis) * kept), mesh)


class ShardedDeviceSpace:
    """One dense space row-sharded over a mesh: the counterpart of the
    reference's ``ShardedDeviceSpace``. Shard ``s`` holds rows ``[s·per,
    (s+1)·per)`` of the file's padded block (``per`` =
    :func:`~.mesh.rows_per_shard` at the dtype's row multiple), read as a
    slice of the mapped file by :func:`.distributed.load_space_sharded`
    (under a process group, only this rank's shards). As the resident
    :class:`~..engine.DeviceSpace`: f32, f16 and bf16 rows as stored, int8
    codes, uint8 codes recentred to ``c − 128`` slice by slice with their
    per-row code sums (zero past ``num_valid``), tombstones as a validity
    plane. :meth:`search` runs :func:`sharded_topk` on K1's route for the
    dtype (FFMA; the one-pass bf16 kernel for BFLOAT16; the integer kernel
    with the offset sums; the affine load for uint8 cosine) and answers as
    the resident
    :class:`~..engine.SearchEngine` does."""

    def __init__(self, space, mesh: Mesh, axis: str = SHARD_AXIS):
        from .distributed import load_space_sharded

        if space.info.vector_type == VectorType.SPARSE:
            raise InvalidVectorTypeError(
                f"space {space.name!r} is sparse; use ShardedSparseSearchEngine")
        _check_supported(space.dtype, "highest")
        _shard_devices(mesh, axis)
        self.mesh = mesh
        self.axis = axis
        self.name = space.name
        self.dim = space.dim
        self.metric = DistanceMetric(space.metric)
        self.num_valid = space.num_vectors
        self.dtype = DataType(space.dtype)
        q = space.quantization
        self.scale = q.scale if q else 1.0
        self.zero_point = q.zero_point if q else 0.0
        self.padded_dim = int(space.padded_dim)
        self.host_ids = space.ids()
        (self.data, self.norms, self.valid_mask, self.rowsums,
         self.rows_per_shard) = load_space_sharded(
            space, mesh, axis, uint8_offset=self.dtype == DataType.UINT8)

    @property
    def capacity(self) -> int:
        """Rows over all shards, padding included."""
        return self.rows_per_shard * self.mesh.size(self.axis)

    def prepare_filter(self, filter_mask) -> PreparedFilter:
        """Split a ``[num_vectors]`` boolean/int row predicate over this
        process's shards once, for reuse across :meth:`search` calls."""
        full = padded_filter_plane(filter_mask, self.num_valid, self.capacity)
        return PreparedFilter(
            mask=split_rows(full, self.mesh, self.axis, self.rows_per_shard),
            num_valid=self.num_valid)

    def _effective_mask(self, filter_mask):
        """The predicate (raw or prepared here) times the tombstone plane,
        shard by shard."""
        if filter_mask is None:
            return self.valid_mask
        if isinstance(filter_mask, PreparedFilter):
            fmask = checked_prepared_mask(filter_mask, self.num_valid)
            if not isinstance(fmask, list) or len(fmask) != len(self.data):
                raise ValueError("the filter was prepared by another surface; use "
                                 "this space's prepare_filter")
        else:
            fmask = self.prepare_filter(filter_mask).mask
        if self.valid_mask is None:
            return fmask
        return [v * f for v, f in zip(self.valid_mask, fmask)]

    def search(self, queries, k: int = 10, filter_mask=None) -> SearchResult:
        """Batched exact top-k over every shard, merged once. ``filter_mask``:
        an optional ``[num_vectors]`` predicate or a :meth:`prepare_filter`
        result, applied inside each shard's scan with the tombstones. Where
        fewer than ``k`` rows qualify the tail holds ``-1``."""
        lead = self.mesh.lead
        helper = DeviceSpace(
            data=torch.empty((0, self.padded_dim), dtype=self.data[0].dtype, device=lead),
            norms=torch.empty(0, dtype=torch.float32, device=lead),
            num_valid=self.num_valid, dim=self.dim, metric=self.metric, dtype=self.dtype,
            scale=self.scale, zero_point=self.zero_point)
        prep = helper.prepare_queries(queries)
        nq = prep.qdev.shape[0]
        if self.num_valid == 0:
            return empty_result(nq, k, self.metric)
        k_eff = min(k, self.num_valid)
        mask = self._effective_mask(filter_mask)
        common = dict(valid_mask=mask, axis=self.axis)
        if self.dtype == DataType.UINT8 and self.metric == DistanceMetric.COSINE:
            s, i = sharded_topk(prep.qdev, self.data, self.norms, self.num_valid, k_eff,
                                self.metric, self.mesh,
                                affine=(128.0 - self.zero_point, self.scale), **common)
        elif self.dtype in (DataType.INT8, DataType.UINT8):
            d = self.dim  # the integer kernel reads the first dim bytes of a row
            s, i = sharded_topk(prep.qdev[:, :d], [x[:, :d] for x in self.data],
                                self.norms, self.num_valid, k_eff, self.metric,
                                self.mesh, scale=prep.dot_scale, bias_row=self.rowsums,
                                bias_scale=prep.bias_scale, **common)
        else:
            s, i = sharded_topk(prep.qdev, self.data, self.norms, self.num_valid, k_eff,
                                self.metric, self.mesh,
                                precision=kernel_precision(self.dtype, "highest"),
                                **common)
        return host_result(s.cpu().numpy(), i.cpu().numpy(), prep, k, self.metric,
                           self.host_ids)
