"""Query engine: load a space into device memory and search it.

The counterpart of :mod:`metrovector_tpu.engine`. A :class:`DeviceSpace`
holds the padded corpus resident on one ``torch.device`` and every search is
one launch of the fused distance + top-k kernel
(:func:`~.ops.topk_kernel.fused_topk`); on a CPU device the kernel's plain
PyTorch version runs instead. Asking for a CUDA device on a machine without
CUDA raises: nothing falls back to the CPU.

f32 spaces run at ``precision="highest"`` (exact f32, the FFMA kernel),
``"high"`` (the bf16x3 split on the tensor cores), ``"high_verified"``
(``"high"`` over-fetched, re-scored exactly and certified query by query,
the queries that fail re-run at ``"highest"``) and ``"default"`` (bf16 rows
and bf16-rounded queries on the device, the one-pass bf16 kernel on the
tensor cores). f16 spaces stay f16 on the device (f16 ⊂ f32, so results
equal the reference's f32 upcast;
``"high"`` and ``"high_verified"`` run ``"highest"`` there, as the
reference does), or bf16 at ``"default"`` with f32 queries, as the
reference keeps them, on the FFMA kernel. bf16 spaces go up as bf16 with
bf16-rounded queries and run the one-pass bf16 kernel at any precision.
:func:`~.ops.topk_kernel.kernel_precision` makes that choice for every
call site.
int8 spaces and uint8 spaces (recentred to int8 ``c − 128``, with per-row
code sums) run the integer kernel on quantized queries; uint8 cosine
spaces run the FFMA kernel over the codes dequantized as they are read.
For these three dtypes the precision changes nothing, as in the reference.
"""

from __future__ import annotations

import copy
import dataclasses
import threading

import numpy as np
import torch
from torch.autograd import profiler as _profiler

from .errors import (
    DimensionMismatchError,
    IndexOutOfBoundsError,
    InvalidVectorTypeError,
    VectorIdNotFoundError,
)
from .format.constants import (
    DataType,
    DistanceMetric,
    padded_rows_for,
    sublane_multiple,
)
from .format.reader import Reader
from .utils.filters import checked_prepared_mask, padded_filter_plane
from .vectors.space import VectorSpace

from .ops.distances import distances_np, rescore_topk
from .ops.grid import check_grid
from .ops.topk_kernel import fused_topk, kernel_precision
from .utils.timing import RECORDER
from .utils.transfer import Readback, put_chunked, upload
from .utils.tune import tune_grid, tuned_grid

PRECISIONS = ("highest", "high", "high_verified", "default")
_SUPPORTED_DTYPES = (DataType.FLOAT32, DataType.FLOAT16, DataType.BFLOAT16,
                     DataType.INT8, DataType.UINT8)
# The certificate of "high_verified" is this multiple of the raw bound that
# SearchEngine._verify_eps derives.
VERIFY_SAFETY = 2.0


def high_dot_bounds(dim: int) -> tuple[float, float]:
    """``(scan, rescore)``: bounds on |computed − exact| of one dot product
    of length ``dim``, in units of ``Σ_d |q_d x_d|`` (≤ ‖q‖‖x‖), for the
    ``"high"`` scan and for the exact f32 re-score. Derived in
    :meth:`SearchEngine._verify_eps`."""
    return (3 + 2.0**-6) * 2.0**-16 + high_sum_bounds(dim)[0], 1.01 * dim * 2.0**-24


def high_sum_bounds(dim: int) -> tuple[float, float]:
    """``(tensor cores, cpu)``: bounds on the error of summing the exact
    bf16x3 products of one dot of length ``dim``, in units of ``Σ_d |q_d
    x_d|``, on the kernel's route and on the plain version's (three f32
    matmuls). Derived in :meth:`SearchEngine._verify_eps`."""
    steps = -(-dim // 16)
    return (33 / 32 * (dim + 2 * steps + 1) * 2.0**-23,
            dim * 2.0**-24 * (1 + 2.0**-6) + 2.0**-23)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False"
        )
    return dev


def _check_supported(dtype: DataType, precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; one of {', '.join(PRECISIONS)}"
        )
    if dtype not in _SUPPORTED_DTYPES:
        raise InvalidVectorTypeError(
            f"{DataType(dtype).name} is not a vector dtype"
        )


@dataclasses.dataclass
class SearchResult:
    """Top-k results for a query batch.

    ``indices``: ``[Q, k]`` int32 row ids (−1 only where fewer than k rows
    qualify). ``scores``: ``[Q, k]`` f32 internal greater-is-better scores.
    ``distances``: Euclidean distance for L2 (ascending), similarity for
    cosine and dot product for IP (descending). ``ids``: ``[Q, k]`` u64
    stable IDs (row positions when the space has no ID column; 2**64−1 in
    unfilled slots)."""

    indices: np.ndarray
    scores: np.ndarray
    distances: np.ndarray
    metric: DistanceMetric
    ids: np.ndarray | None = None

    ID_SENTINEL = np.uint64(2**64 - 1)

    def __len__(self) -> int:
        return self.indices.shape[0]

    def top(self, query: int = 0) -> list[tuple[int, float]]:
        """(index, distance) pairs for one query, best first."""
        return [
            (int(i), float(d))
            for i, d in zip(self.indices[query], self.distances[query])
            if i >= 0
        ]


@dataclasses.dataclass
class RadiusResult:
    """Range-query results: per query, every row within the threshold,
    best first. ``truncated[q]`` is True when the capped candidate list
    filled up with rows that all met the threshold."""

    indices: list[np.ndarray]
    distances: list[np.ndarray]
    ids: list[np.ndarray] | None
    metric: DistanceMetric
    truncated: np.ndarray  # [Q] bool

    def __len__(self) -> int:
        return len(self.indices)


def radius_from_topk(res: SearchResult, radius: float,
                     max_results: int, num_valid: int | None = None) -> RadiusResult:
    """Cut a best-first top-``max_results`` result down to the rows within
    ``radius``: L2 keeps ``distance <= radius``, cosine/IP keep
    ``similarity >= radius``. ``truncated`` stays False when the list
    already covered all ``num_valid`` rows."""
    ascending = res.metric == DistanceMetric.L2
    idx, dist, ids = [], [], ([] if res.ids is not None else None)
    nq = res.indices.shape[0]
    truncated = np.zeros(nq, bool)
    capped = num_valid is None or max_results < num_valid
    for q in range(nq):
        live = res.indices[q] >= 0
        ok = live & (
            (res.distances[q] <= radius) if ascending
            else (res.distances[q] >= radius)
        )
        idx.append(res.indices[q][ok])
        dist.append(res.distances[q][ok])
        if ids is not None:
            ids.append(res.ids[q][ok])
        truncated[q] = capped and bool(ok.all()) and int(ok.sum()) == max_results
    return RadiusResult(indices=idx, distances=dist, ids=ids,
                        metric=res.metric, truncated=truncated)


def merged_append_ids(host_ids, ids, n_new: int, num_valid: int):
    """Validate and merge the ID column for an append of ``n_new`` rows:
    appends carry ``ids`` iff the structure has an ID column, and merged
    ids stay unique. Returns the new host ID column, or None."""
    if ids is not None:
        ids = np.ascontiguousarray(ids, dtype=np.uint64).reshape(-1)
        if ids.shape[0] != n_new:
            raise DimensionMismatchError(expected=n_new, actual=int(ids.shape[0]))
        if host_ids is None and num_valid > 0:
            raise InvalidVectorTypeError(
                "space has no ID column; appended rows cannot carry ids"
            )
    elif host_ids is not None:
        raise InvalidVectorTypeError(
            "space has an ID column; appended rows must carry ids"
        )
    else:
        return None
    old = host_ids if host_ids is not None else np.zeros(0, np.uint64)
    merged = np.concatenate([old[:num_valid], ids])
    if np.unique(merged).shape[0] != merged.shape[0]:
        raise InvalidVectorTypeError("appended ids collide")
    return merged


def ids_for_rows(host_ids, idx):
    """Result row positions → stable external IDs (the positions themselves
    without an ID column; the u64-max sentinel for unfilled slots)."""
    if host_ids is not None:
        ids = host_ids[np.clip(idx, 0, None)].astype(np.uint64)
    else:
        ids = idx.astype(np.int64).astype(np.uint64)
    ids[idx < 0] = SearchResult.ID_SENTINEL
    return ids


def empty_result(nq: int, k: int, metric: DistanceMetric) -> SearchResult:
    """The answer over an empty space: every slot unfilled."""
    return SearchResult(
        indices=np.full((nq, k), -1, np.int32),
        scores=np.full((nq, k), -np.inf, np.float32),
        distances=np.full((nq, k), np.inf if metric == DistanceMetric.L2 else -np.inf,
                          np.float32),
        metric=metric,
        ids=np.full((nq, k), SearchResult.ID_SENTINEL, np.uint64),
    )


def host_result(scores: np.ndarray, idx: np.ndarray, prep, k: int,
                metric: DistanceMetric, host_ids) -> SearchResult:
    """Read-back ``[Q, k_eff]`` scores and rows of a dense search → the
    user-facing result: the per-query constant ``C(q)`` of ``prep``
    restored, distances, sentinels out to ``k``, stable IDs."""
    if prep.const is not None:
        # restore the rank-neutral per-query constant C(q): scores and
        # distances are absolute, not just rank-correct
        mult = 2.0 if metric == DistanceMetric.L2 else 1.0
        scores = scores + mult * prep.const[:, None]
    dist = distances_np(scores, metric, prep.sq_norms)
    if idx.shape[1] < k:  # pad out to the requested k with sentinels
        pad = ((0, 0), (0, k - idx.shape[1]))
        idx = np.pad(idx, pad, constant_values=-1)
        scores = np.pad(scores, pad, constant_values=-np.inf)
        dist = np.pad(dist, pad, constant_values=np.inf
                      if metric == DistanceMetric.L2 else -np.inf)
    return SearchResult(indices=idx, scores=scores, distances=dist,
                        metric=metric, ids=ids_for_rows(host_ids, idx))


@dataclasses.dataclass
class PreparedFilter:
    """A row predicate uploaded once and reusable across searches (see
    :meth:`SearchEngine.prepare_filter`). ``mask`` is the padded
    ``[padded_rows]`` f32 plane (1.0 = searchable), composed with the
    space's live tombstones at launch time."""

    mask: torch.Tensor
    num_valid: int


@dataclasses.dataclass
class PreparedQueries:
    """A device-ready query batch and the host scalars needed to turn raw
    kernel scores into distances."""

    qdev: torch.Tensor
    sq_norms: np.ndarray  # ‖q‖² of the original float queries
    dot_scale: float = 1.0  # static multiplier on raw (integer) dots
    bias_scale: float = 0.0  # multiplier on the per-row code sums
    const: np.ndarray | None = None  # per-query additive dot constant C(q)


def grow_rows(old: torch.Tensor, num_valid: int, new: torch.Tensor,
              cap: int, fill=0) -> torch.Tensor:
    """``old`` with rows ``[num_valid, num_valid + len(new))`` set to
    ``new`` (a tensor on ``old``'s device), by copies on the current stream.
    Within ``old``'s rows the copy is in place and ``old`` itself comes
    back: a search in flight bounds its rows by its own, smaller row count,
    so it never reads them. Beyond, a new tensor of ``cap`` rows takes
    ``old[:num_valid]`` by a copy on the device, then ``new``, then
    ``fill``."""
    total = num_valid + int(new.shape[0])
    if total <= old.shape[0]:
        old[num_valid:total].copy_(new)
        return old
    out = torch.empty((cap,) + tuple(old.shape[1:]), dtype=old.dtype,
                      device=old.device)
    out[:num_valid].copy_(old[:num_valid])
    out[num_valid:total].copy_(new)
    out[total:].fill_(fill)
    return out


def publish(obj, **changes) -> None:
    """Give ``obj`` new attribute values in one assignment of a new
    ``__dict__``: a reader that took :func:`pinned` before sees none of
    ``changes``, one after sees all of them. The published dict is never
    changed in place."""
    obj.__dict__ = {**obj.__dict__, **changes}


def pinned(obj):
    """A shallow copy of ``obj`` as it was published last (its one
    ``__dict__``), for a reader that reads several attributes."""
    return copy.copy(obj)


@dataclasses.dataclass(frozen=True, eq=False)
class SpaceSnapshot:
    """What one search reads of a :class:`DeviceSpace`, published as one
    object: the padded block, its norms, the validity mask and uint8 code
    sums, the logical row count and the host ID column. Its fields never
    change once published (an append within capacity writes rows past its
    ``num_valid``, which a search of it never reads); ``norm_bounds`` and
    the ID → row map are cached on it."""

    data: torch.Tensor
    norms: torch.Tensor
    num_valid: int
    valid_mask: torch.Tensor | None = None
    rowsums: torch.Tensor | None = None
    host_ids: np.ndarray | None = None
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def padded_rows(self) -> int:
        return int(self.data.shape[0])

    def norm_bounds(self) -> tuple[float, float]:
        """(max, min) squared L2 norm over the logical rows."""
        if "norm_bounds" not in self._cache:
            nrm = self.norms[: self.num_valid]
            self._cache["norm_bounds"] = (float(nrm.max()), float(nrm.min()))
        return self._cache["norm_bounds"]

    def live(self):
        """``(data, norms, valid_mask, rowsums)`` cut to the ``num_valid``
        logical rows (views): a scan reads these, not the capacity an
        append left behind them."""
        nv = self.num_valid
        return (self.data[:nv], self.norms[:nv],
                None if self.valid_mask is None else self.valid_mask[:nv],
                None if self.rowsums is None else self.rowsums[:nv])

    def id_lut(self) -> dict:
        """Stable ID → row position (``host_ids`` is set)."""
        if "id_lut" not in self._cache:
            self._cache["id_lut"] = {int(v): i for i, v in enumerate(self.host_ids)}
        return self._cache["id_lut"]


class DeviceSpace:
    """One vector space resident on one device: the padded corpus block,
    its dequantized squared norms and an optional validity mask, as tensors
    ready for :func:`~.ops.topk_kernel.fused_topk`; for a quantized space
    its ``scale`` and ``zero_point``, and for uint8 the per-row sums of the
    recentred codes (``rowsums``, Σ(c − 128) over the logical dims).

    The tensors, the row count and the ID column live in one
    :class:`SpaceSnapshot` (:attr:`snapshot`); :meth:`add_rows` and
    :meth:`delete_rows` publish a new one in one assignment, and a search
    takes it once, so it never pairs one step's row count with another's
    tensors."""

    def __init__(
        self,
        data: torch.Tensor,
        norms: torch.Tensor,
        num_valid: int,
        dim: int,
        metric: DistanceMetric,
        valid_mask: torch.Tensor | None = None,
        dtype: DataType = DataType.FLOAT32,
        name: str = "",
        precision: str = "highest",
        host_ids: np.ndarray | None = None,
        scale: float = 1.0,
        zero_point: float = 0.0,
        rowsums: torch.Tensor | None = None,
    ):
        _check_supported(DataType(dtype), precision)
        self.dim = int(dim)
        self.metric = DistanceMetric(metric)
        self.scale = float(scale)
        self.zero_point = float(zero_point)
        self.dtype = DataType(dtype)
        self.name = name
        self.precision = precision
        # host_ids: the stable ID column (u64), only to translate result rows
        self._snap = SpaceSnapshot(data=data, norms=norms,
                                   num_valid=int(num_valid),
                                   valid_mask=valid_mask, rowsums=rowsums,
                                   host_ids=host_ids)
        self._write_lock = threading.Lock()  # one writer at a time

    @property
    def snapshot(self) -> SpaceSnapshot:
        """The state the next search reads."""
        return self._snap

    @property
    def data(self) -> torch.Tensor:
        return self._snap.data

    @property
    def norms(self) -> torch.Tensor:
        return self._snap.norms

    @property
    def num_valid(self) -> int:
        return self._snap.num_valid

    @property
    def valid_mask(self) -> torch.Tensor | None:
        return self._snap.valid_mask

    @property
    def rowsums(self) -> torch.Tensor | None:
        return self._snap.rowsums

    @property
    def host_ids(self) -> np.ndarray | None:
        return self._snap.host_ids

    @property
    def device(self) -> torch.device:
        return self._snap.data.device

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_space(
        cls,
        space: VectorSpace,
        device="cuda",
        include_tombstones: bool = True,
        precision: str = "highest",
    ) -> "DeviceSpace":
        """Upload a host :class:`VectorSpace` view to ``device``. The padded
        block goes up verbatim (an f32 or f16 space as bf16 for
        ``"default"``; a bf16 space as its bits); tombstones become a
        validity mask applied in the kernel epilogue. A uint8 space goes up
        recentred, ``c' = c − 128`` over the logical region with padding
        left 0, with its per-row code sums (the reference's upload)."""
        _check_supported(space.dtype, precision)
        dev = resolve_device(device)
        mask = None
        if include_tombstones:
            host_mask = space.tombstone_mask()
            if host_mask is not None:
                full = np.ones(space.padded_rows, dtype=np.float32)
                full[: space.num_vectors] = (~host_mask).astype(np.float32)
                mask = torch.from_numpy(full).to(dev)
        norms = np.array(space.norms(), dtype=np.float32)  # a writable copy
        block = space.padded_array()
        rowsums = None
        if space.dtype == DataType.BFLOAT16:  # uint16 bit patterns
            data = put_chunked(block.view(np.int16), dev).view(torch.bfloat16)
        elif space.dtype == DataType.UINT8:
            # c − 128 as int8 is c's byte with its top bit flipped.
            shifted = (block ^ np.uint8(0x80)).view(np.int8)
            shifted[:, space.dim:] = 0
            shifted[space.num_vectors:, :] = 0
            rowsums = torch.from_numpy(shifted[:, : space.dim].sum(
                axis=1, dtype=np.int32).astype(np.float32)).to(dev)
            data = put_chunked(shifted, dev)
        elif space.dtype == DataType.INT8:
            data = put_chunked(block, dev)
        else:
            target = torch.bfloat16 if precision == "default" else None
            data = put_chunked(block, dev, dtype=target)
        q = space.quantization
        return cls(
            data=data,
            norms=torch.from_numpy(norms).to(dev),
            num_valid=space.num_vectors,
            dim=space.dim,
            metric=space.metric,
            valid_mask=mask,
            scale=q.scale if q else 1.0,
            zero_point=q.zero_point if q else 0.0,
            dtype=space.dtype,
            name=space.name,
            rowsums=rowsums,
            precision=precision,
            host_ids=space.ids(),
        )

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "DeviceSpace":
        """Build from a dict of host arrays and scalars — what ``np.asarray``
        gives for a reference ``DeviceSpace``'s ``data``, ``norms``,
        ``valid_mask``, ``num_valid``, ``dim``, ``metric``, ``dtype``,
        ``scale``, ``zero_point``, ``rowsums``, ``precision`` and
        ``host_ids`` — on ``device``."""
        dev = resolve_device(device)
        data = np.array(state["data"])  # a writable, contiguous copy
        if data.dtype.name == "bfloat16":  # ml_dtypes' type, by its bits
            data_t = torch.from_numpy(data.view(np.uint16)).view(torch.bfloat16)
        else:
            data_t = torch.from_numpy(data)
        mask = state.get("valid_mask")
        rowsums = state.get("rowsums")
        return cls(
            data=data_t.to(dev),
            norms=torch.from_numpy(
                np.array(state["norms"], dtype=np.float32)
            ).to(dev),
            num_valid=int(state["num_valid"]),
            dim=int(state["dim"]),
            metric=DistanceMetric(int(state["metric"])),
            valid_mask=None if mask is None else torch.from_numpy(
                np.array(mask, dtype=np.float32)
            ).to(dev),
            scale=float(state.get("scale", 1.0)),
            zero_point=float(state.get("zero_point", 0.0)),
            dtype=DataType(int(state["dtype"])),
            rowsums=None if rowsums is None else torch.from_numpy(
                np.array(rowsums, dtype=np.float32)
            ).to(dev),
            precision=str(state.get("precision", "highest")),
            host_ids=state.get("host_ids"),
        )

    # -- online mutation ------------------------------------------------------

    def _encode_rows(self, rows: np.ndarray):
        """Appended rows as the block stores them: ``(rows [n, padded_dim]
        f32 or int8, squared norms [n] f32, code sums [n] f32 or None)``,
        on the host. The reference's arithmetic: float rows of an int8 or
        uint8 space are quantized with the stored calibration and their
        norms are those of the dequantized codes; a float space takes the
        norms of the f32 input, before it is rounded to the block's
        storage."""
        rows_f = rows.astype(np.float32)
        new_norms = np.einsum(
            "ij,ij->i", rows_f, rows_f, dtype=np.float64
        ).astype(np.float32)
        pad_d = self.padded_dim - self.dim
        new_bias = None
        if self.dtype == DataType.UINT8:
            if np.issubdtype(rows.dtype, np.floating):
                codes = np.clip(np.rint(rows_f / self.scale + self.zero_point), 0, 255)
            else:
                codes = rows_f
            deq = (codes - self.zero_point) * self.scale
            new_norms = np.einsum("ij,ij->i", deq, deq, dtype=np.float64).astype(np.float32)
            shifted = codes.astype(np.int16) - 128  # padding columns stay 0
            new_bias = shifted.sum(axis=1, dtype=np.int32).astype(np.float32)
            block = np.pad(shifted.astype(np.int8), ((0, 0), (0, pad_d)))
        elif self.dtype == DataType.INT8:
            if np.issubdtype(rows.dtype, np.floating):
                codes = np.clip(np.rint(rows_f / self.scale), -128, 127)
            else:
                codes = rows_f
            deq = codes * self.scale
            new_norms = np.einsum("ij,ij->i", deq, deq, dtype=np.float64).astype(np.float32)
            block = np.pad(codes.astype(np.int8), ((0, 0), (0, pad_d)))
        else:
            block = np.pad(rows_f, ((0, 0), (0, pad_d)))
        return block, new_norms, new_bias

    def add_rows(self, rows, ids=None, reserve: float = 1.5) -> None:
        """Append rows to the live device corpus without touching disk.

        Appends carry ``ids`` iff the space has an ID column
        (:func:`merged_append_ids`). Float rows of an int8 or uint8 space
        are quantized with the stored ``scale`` (and ``zero_point``); rows
        of a float space take the block's storage (bf16 for a bf16 space
        or at ``"default"``, f16 for an f16 space, rounded to nearest
        even), while their norms are those of the f32 input, as in the
        reference. An f16 space keeps its block in f16 where the reference
        holds f32, so rows that f16 cannot represent are rounded here and
        not there.

        Capacity is the reference's: when the rows no longer fit
        ``padded_rows``, it becomes ``max(padded_rows_for(total),
        ⌈padded_rows·reserve⌉)`` rounded to the dtype's row multiple.
        Within capacity the rows are copied into rows ``[num_valid,
        total)`` of the live tensors (``data.data_ptr()`` is unchanged);
        beyond, new tensors are filled by a copy on the device, so the
        corpus never goes through the host.

        Every copy runs on the current stream of the space's device, the
        stream the kernels launch on, so a search launched before the
        append has read the old rows before they are written or freed; no
        side stream is used. The new :class:`SpaceSnapshot` is published
        after the copies, in one assignment: a search sees the rows before
        or after the append, never a mix."""
        rows = np.asarray(rows)
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise DimensionMismatchError(expected=self.dim, actual=int(rows.shape[-1]))
        with self._write_lock:
            old = self._snap
            nv, n_new = old.num_valid, int(rows.shape[0])
            merged_ids = merged_append_ids(old.host_ids, ids, n_new, nv)
            if n_new == 0:
                return
            block, new_norms, new_bias = self._encode_rows(rows)
            total = nv + n_new
            cap = old.padded_rows
            if total > cap:
                sub = sublane_multiple(self.dtype)
                cap = max(padded_rows_for(total, self.dtype),
                          -(-int(cap * reserve) // sub) * sub)
            dev = self.device

            def put(host, like):
                return torch.from_numpy(np.ascontiguousarray(host)).to(dev).to(like.dtype)

            data = grow_rows(old.data, nv, put(block, old.data), cap)
            norms = grow_rows(old.norms, nv, put(new_norms, old.norms), cap)
            rowsums = old.rowsums
            if rowsums is not None:
                rowsums = grow_rows(rowsums, nv, put(new_bias, rowsums), cap)
            mask = old.valid_mask
            if mask is not None:
                mask = grow_rows(mask, nv, torch.ones(n_new, dtype=mask.dtype,
                                                      device=dev), cap, fill=1.0)
            self._snap = SpaceSnapshot(
                data=data, norms=norms, num_valid=total, valid_mask=mask,
                rowsums=rowsums,
                host_ids=merged_ids if merged_ids is not None else old.host_ids,
            )

    def delete_rows(self, rows=None, ids=None) -> None:
        """Tombstone rows on the live device corpus (by position or by
        stable ID). Deleted rows never surface in results. The mask is
        copied, changed and published with the rest of the snapshot."""
        with self._write_lock:
            old = self._snap
            nv = old.num_valid
            idx = []
            if rows is not None:
                for r in np.atleast_1d(rows):
                    r = int(r)
                    if r < 0 or r >= nv:
                        raise IndexOutOfBoundsError(r, nv)
                    idx.append(r)
            if ids is not None:
                if old.host_ids is None:
                    idx.extend(int(i) for i in np.atleast_1d(ids))
                    for r in idx:
                        if r < 0 or r >= nv:
                            raise IndexOutOfBoundsError(r, nv)
                else:
                    lut = old.id_lut()
                    for i in np.atleast_1d(ids):
                        try:
                            idx.append(lut[int(i)])
                        except KeyError:
                            raise VectorIdNotFoundError(int(i)) from None
            if not idx:
                return
            mask = (
                old.valid_mask.clone()
                if old.valid_mask is not None
                else torch.ones(old.padded_rows, dtype=torch.float32,
                                device=self.device)
            )
            mask[torch.as_tensor(idx, dtype=torch.int64, device=self.device)] = 0.0
            self._snap = dataclasses.replace(old, valid_mask=mask,
                                             _cache=dict(old._cache))

    def norm_bounds(self) -> tuple[float, float]:
        """(max, min) squared L2 norm over the logical rows, cached on the
        snapshot (so an append resets it; a delete keeps it, which stays
        a conservative bound)."""
        return self._snap.norm_bounds()

    @property
    def padded_rows(self) -> int:
        return self._snap.padded_rows

    @property
    def padded_dim(self) -> int:
        return int(self.data.shape[1])

    @property
    def nbytes(self) -> int:
        snap = self._snap
        n = snap.data.nbytes + snap.norms.nbytes
        for extra in (snap.valid_mask, snap.rowsums):
            if extra is not None:
                n += extra.nbytes
        return n

    # -- query preprocessing --------------------------------------------------

    def prepare_queries(self, queries) -> PreparedQueries:
        """Validate, pre-normalize (cosine), quantize (int8, uint8), pad to
        ``padded_dim`` and upload: int8 queries for the integer kernel,
        else f32. An f32 space at ``"default"`` and a bf16 space round them
        through bf16 as their corpus was; an f16 space at ``"default"``
        (bf16 on the device too) keeps them f32, as the reference does: it
        keys the rounding on the space's dtype, not on the device block's.

        The quantization is the reference's, in numpy on the host, bit for
        bit. int8: symmetric, ``q' = clip(rint(q / s_q))`` with ``s_q =
        max|q| / 127``, ``dot_scale = s_q·scale``. uint8 (not cosine), with
        codes ``c`` (``x = (c − zp)·s``), device codes ``c' = c − 128`` and
        ``q ≈ o_q + s_q·q'``::

            q·x = s·s_q·(q'·c') + s·o_q·Σc' + C(q)
            C(q) = s·s_q·(128 − zp)·Σq' + s·o_q·(128 − zp)·D

        so the kernel scores ``dot_scale·idot + bias_scale·Σc'`` and
        :meth:`SearchEngine._finalize` adds ``C(q)`` back. Integer queries
        in ``[o_q − 127, o_q + 127]`` quantize exactly; queries spanning
        0..255 do not (``o_q = 128`` leaves 128 on one side, so ``s_q =
        128/127``), as in the reference. uint8 cosine keeps f32 queries
        for the dequantizing scan.

        The copy to the device (:func:`~.utils.transfer.upload`; the span
        ``engine.upload`` while a profiler runs) goes through pinned memory
        without blocking on a CUDA device: it waits for no batch already
        queued on the card, and the caller's array is free once this
        returns."""
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise DimensionMismatchError(
                expected=self.dim, actual=int(q.shape[-1])
            )
        qnorms = np.einsum("ij,ij->i", q, q, dtype=np.float64).astype(np.float32)
        if self.metric == DistanceMetric.COSINE:
            q = q / np.maximum(np.sqrt(qnorms)[:, None], 1e-30)

        def send(arr):
            if self.padded_dim != self.dim:
                arr = np.pad(arr, ((0, 0), (0, self.padded_dim - self.dim)))
            tok = (RECORDER.begin("engine.upload")
                   if _profiler._is_profiler_enabled else None)
            out = upload(arr, self.device)
            if tok is not None:
                RECORDER.end(tok)
            return out

        if self.dtype == DataType.INT8:
            qscale = float(np.abs(q).max()) / 127.0 or 1.0
            qq = np.clip(np.rint(q / qscale), -128, 127).astype(np.int8)
            return PreparedQueries(qdev=send(qq), sq_norms=qnorms,
                                   dot_scale=qscale * self.scale)
        if self.dtype == DataType.UINT8 and self.metric != DistanceMetric.COSINE:
            o_q = float(np.round((q.min() + q.max()) / 2.0))
            amax = float(np.abs(q - o_q).max())
            integral = bool(np.all(q == np.rint(q)))
            if integral and amax <= 127.0:
                s_q = 1.0  # exact integer quantization
            else:
                s_q = amax / 127.0 if amax > 0 else 1.0
            qq = np.clip(np.rint((q - o_q) / s_q), -128, 127).astype(np.int8)
            qsum = qq.sum(axis=1, dtype=np.int64).astype(np.float64)
            s, zp, d = self.scale, self.zero_point, self.dim
            const = (
                s * s_q * (128.0 - zp) * qsum + s * o_q * (128.0 - zp) * d
            ).astype(np.float32)
            return PreparedQueries(qdev=send(qq), sq_norms=qnorms,
                                   dot_scale=s_q * s, bias_scale=s * o_q,
                                   const=const)
        qdev = send(q.astype(np.float32, copy=False))
        if self.dtype == DataType.BFLOAT16 or (
                self.dtype == DataType.FLOAT32 and self.precision == "default"):
            qdev = qdev.to(torch.bfloat16).float()
        return PreparedQueries(qdev=qdev, sq_norms=qnorms)


class SearchEngine:
    """Exact brute-force top-k search over one :class:`DeviceSpace`.

    >>> import numpy as np, tempfile, os
    >>> from metrovector_tpu_torch import Builder, SearchEngine
    >>> b = Builder()
    >>> _ = b.add_vector_space("e", dim=3)
    >>> b.add_vectors("e", np.eye(3, dtype=np.float32))
    >>> path = os.path.join(tempfile.mkdtemp(), "q.mvt")
    >>> b.build().save(path)
    >>> eng = SearchEngine.open(path, device="cpu")
    >>> eng.search(np.array([[0.9, 0.1, 0.0]], np.float32), k=1).indices.tolist()
    [[0]]
    """

    def __init__(self, space: VectorSpace | DeviceSpace, device="cuda",
                 precision: str = "highest", verify_margin: int = 8, grid=None):
        """``space``: a host :class:`VectorSpace` (uploaded to ``device`` at
        ``precision``) or a :class:`DeviceSpace` already resident.

        ``precision`` (f32 spaces): ``"highest"``, exact f32 dots (FFMA);
        ``"high"``, the bf16x3 split ``q_hi·x_hi + q_hi·x_lo + q_lo·x_hi`` on
        the tensor cores, f32-faithful to about 2⁻¹⁶ relative, so sub-ulp
        near-ties may swap; ``"high_verified"``, the ``"high"`` scan fetches
        ``k + verify_margin`` candidates, an exact f32 re-score of just those
        returns the top k, and a certificate (:meth:`_verify_eps`) proves
        each query's answer exact or the failing queries re-run at
        ``"highest"``; ``"default"``, bf16 storage. ``verify_stats`` counts
        certified queries and those that fell back.

        On a CUDA device each batch's answer is read back through pinned
        memory on an event of its own (:class:`~.utils.transfer.Readback`).
        ``readback_stats`` counts the read-backs after which the card still
        had work queued (``"overlapped"``: :meth:`search_pipelined`'s batch
        in flight) and those after which it was drained (``"drained"``).

        ``grid``: the kernels' launch grid (:class:`~.ops.grid.Grid` or a
        mapping with its ``waves``); None adopts the grid that
        :meth:`autotune` persisted in the file, if any, else one wave."""
        self._host_space = None  # the file-backed origin, for persist
        if not isinstance(space, DeviceSpace):
            self._host_space = space
            if grid is None:
                grid = tuned_grid(space, "dense")
            space = DeviceSpace.from_space(space, device=device,
                                           precision=precision)
        self.space = space
        self.grid = check_grid(grid, (), "SearchEngine")
        if verify_margin < 1:
            raise ValueError(f"verify_margin must be >= 1, got {verify_margin}")
        self.verify_margin = int(verify_margin)
        self.verify_stats = {"certified": 0, "fallbacks": 0}
        self.readback_stats = {"overlapped": 0, "drained": 0}
        self._stats_lock = threading.Lock()  # MicroBatcher finalizes on its own thread

    @classmethod
    def open(cls, path, space_name: str | None = None, **kw) -> "SearchEngine":
        """mmap the file and upload the named (or first) space."""
        r = Reader.open(path)
        name = space_name or r.vector_space_names[0]
        return cls(r.vector_space(name), **kw)

    def search(self, queries, k: int = 10, filter_mask=None) -> SearchResult:
        """Batched exact top-k. ``queries``: ``[Q, dim]`` or one vector.
        ``filter_mask``: optional ``[num_vectors]`` boolean/int predicate
        or a :class:`PreparedFilter`; rows with 0 are excluded exactly,
        together with tombstones. Where fewer than ``k`` rows qualify the
        tail holds ``-1``."""
        return self._finalize(self._launch(queries, k, filter_mask), k)

    def search_radius(self, queries, radius: float, max_results: int = 128,
                      filter_mask=None) -> RadiusResult:
        """Every row within ``radius`` (L2: distance ≤ radius; cosine/IP:
        similarity ≥ radius), best first, through a capped top-k pass;
        ``truncated`` flags queries that filled the cap."""
        snap = self.space.snapshot
        k = min(max_results, max(snap.num_valid, 1))
        res = self._finalize(self._launch(queries, k, filter_mask, snap=snap), k)
        return radius_from_topk(res, radius, k, snap.num_valid)

    def autotune(self, queries=None, k: int = 10, batch: int = 128,
                 waves_candidates=None, iters: int = 3, apply: bool = True,
                 persist: bool = False) -> list[dict]:
        """Time K1's launch grid for this space with single-launch
        timings (one search and its readback a measurement) and, with
        ``apply``, set the fastest as :attr:`grid`.

        ``queries``: the sample batch (``[batch, dim]`` drawn N(0, 1) if
        omitted). ``waves_candidates`` (default :data:`~.ops.grid.WAVES`):
        multiples of one wave of scan blocks; K1's library holds one block
        tile, so the tile is not a candidate. Returns a row
        ``{"waves", "tile", "ms"}`` for each candidate, fastest first
        (``ms`` the best of ``iters`` timings after a warm-up; a candidate
        that fails gets ``inf`` and an ``error``). ``persist=True`` also
        writes the winner into the file
        (``hints["tuned"][space]["dense"]["cuda"]``), where a later
        ``SearchEngine`` of the file adopts it; it needs an engine built from
        a file-backed ``VectorSpace`` and a finite winner. CUDA engines only:
        on the CPU the plain version runs and ``ValueError`` is raised."""
        def run_with(q, grid):
            return lambda: self._finalize(self._launch(q, k, grid=grid), k)

        return tune_grid(self, "dense", run_with, queries=queries, batch=batch,
                         dim=self.space.dim, waves=waves_candidates, tiles=(None,),
                         iters=iters, apply=apply, persist=persist)

    @property
    def device(self) -> torch.device:
        return self.space.device

    def prepare_filter(self, filter_mask) -> PreparedFilter:
        """Upload a ``[num_vectors]`` predicate once for many searches."""
        snap = self.space.snapshot
        full = padded_filter_plane(filter_mask, snap.num_valid, snap.padded_rows)
        return PreparedFilter(
            mask=torch.from_numpy(full).to(self.space.device),
            num_valid=snap.num_valid,
        )

    def search_pipelined(self, query_batches, k: int = 10):
        """Results of an iterable of batches in order, with one batch in
        flight: batch ``i+1`` is uploaded and launched before batch ``i`` is
        read back. On a CUDA device the read-back of batch ``i`` waits for
        batch ``i`` alone, so the card scans batch ``i+1`` while the host
        turns batch ``i`` into its result and readies batch ``i+2``."""
        pending = None
        for q in query_batches:
            launched = self._launch(q, k)
            if pending is not None:
                yield self._finalize(pending, k)
            pending = launched
        if pending is not None:
            yield self._finalize(pending, k)

    def _launch(self, queries, k: int, filter_mask=None, snap=None, grid=None):
        """Upload and launch without waiting for the device. Returns a
        pending tuple for :meth:`_finalize`, which carries the
        :class:`SpaceSnapshot` the launch read (taken once, here, unless
        given), so that the whole search reads one state of the space.
        ``grid``: the launch grid (default :attr:`grid`).

        On a CUDA device the launch ends with the answer's copies to pinned
        host memory and their event (:class:`~.utils.transfer.Readback`),
        enqueued right after the batch's last kernel and so before any later
        batch's upload and scan.

        Spans (while a profiler runs): ``engine.launch``, which gives the
        batch the id that the pending tuple carries to :meth:`_finalize`,
        around ``engine.prepare_queries`` (the upload inside it), the
        kernel's ``ops.fused_topk`` and, at ``high_verified``,
        ``engine.rescore`` (K3's enqueue)."""
        tok = (RECORDER.begin("engine.launch", RECORDER.new_batch())
               if _profiler._is_profiler_enabled else None)
        try:
            return self._launch_body(queries, k, filter_mask, snap, grid,
                                     None if tok is None else tok.batch)
        finally:
            if tok is not None:
                RECORDER.end(tok)

    def _launch_body(self, queries, k, filter_mask, snap, grid, batch):
        sp = self.space
        grid = self.grid if grid is None else grid
        if snap is None:
            snap = sp.snapshot
        if sp.metric == DistanceMetric.CUSTOM:
            raise InvalidVectorTypeError(
                "CUSTOM metric spaces need a user-provided score function; "
                "use ops.distances directly"
            )
        tok = (RECORDER.begin("engine.prepare_queries")
               if _profiler._is_profiler_enabled else None)
        prep = sp.prepare_queries(queries)
        if tok is not None:
            RECORDER.end(tok)
        nv = snap.num_valid
        if nv == 0:  # empty space: all-sentinel results
            return (None, None, prep, 0, None, snap, None, batch)
        k_eff = min(k, nv)
        data, norms, eff_mask, rowsums = snap.live()
        if filter_mask is not None:
            if isinstance(filter_mask, PreparedFilter):
                fdev = checked_prepared_mask(filter_mask, nv, snap.padded_rows)[:nv]
            else:
                fdev = torch.from_numpy(
                    padded_filter_plane(filter_mask, nv, nv)).to(sp.device)
            eff_mask = fdev if eff_mask is None else eff_mask * fdev
        if sp.dtype in (DataType.INT8, DataType.UINT8):
            if sp.dtype == DataType.UINT8 and sp.metric == DistanceMetric.COSINE:
                # f32 queries over the codes read as (c' + 128 − zp)·scale
                scores, idx = fused_topk(
                    prep.qdev, data, norms, nv, k_eff,
                    sp.metric, valid_mask=eff_mask,
                    affine=(128.0 - sp.zero_point, sp.scale), grid=grid,
                )
            else:
                # the integer kernel reads the first dim bytes of each
                # padded row
                d = sp.dim
                scores, idx = fused_topk(
                    prep.qdev[:, :d], data[:, :d], norms, nv, k_eff,
                    sp.metric, valid_mask=eff_mask, scale=prep.dot_scale,
                    bias_row=rowsums, bias_scale=prep.bias_scale, grid=grid,
                )
            return self._pending(scores, idx, prep, k_eff, None, snap, batch)
        # "high" and "high_verified" split f32 spaces only; bf16 rows with
        # bf16 queries run "default" (kernel_precision), f16 "highest".
        f32 = sp.dtype == DataType.FLOAT32
        verified = f32 and sp.precision == "high_verified"
        # high_verified: over-fetch a margin at bf16x3 cost, then re-score
        # just those candidates exactly (K3); _finalize certifies the result.
        k_fetch = min(k_eff + self.verify_margin, nv) if verified else k_eff
        scores, idx = fused_topk(
            prep.qdev, data, norms, nv, k_fetch, sp.metric,
            valid_mask=eff_mask, precision=kernel_precision(sp.dtype, sp.precision),
            grid=grid,
        )
        vcheck = None
        if verified:
            # The k_fetch-th "high" score: every row not fetched lost to it,
            # so its exact score is at most boundary + eps.
            boundary = scores[:, -1]
            tok = (RECORDER.begin("engine.rescore")
                   if _profiler._is_profiler_enabled else None)
            scores, idx = rescore_topk(prep.qdev, data, norms, idx,
                                       k_eff, sp.metric)
            if tok is not None:
                RECORDER.end(tok)
            if k_fetch < nv:  # else every valid row was re-scored
                vcheck = (boundary, self._verify_eps(prep, snap), eff_mask)
        return self._pending(scores, idx, prep, k_eff, vcheck, snap, batch)

    @staticmethod
    def _pending(scores, idx, prep, k_eff, vcheck, snap, batch):
        """The pending tuple of a launch. On a CUDA device the answer's
        read-back (with ``high_verified``'s boundary) is enqueued here, right
        after the batch's last kernel."""
        sent = None
        if scores.device.type == "cuda":
            sent = Readback(scores, idx, *(() if vcheck is None else vcheck[:1]))
        return (scores, idx, prep, k_eff, vcheck, snap, sent, batch)

    def _verify_eps(self, prep, snap: SpaceSnapshot | None = None) -> np.ndarray:
        """Per-query bound on |"high" score − exact f32 score| in the
        kernel's score space: the slack of ``high_verified``'s certificate.
        It bounds the port's arithmetic (``ops/csrc/topk_high_kernel.cu``
        against K3's re-score), not the TPU's. Units: ``S = Σ_d |q_d x_d|
        ≤ ‖q‖‖x‖`` (Cauchy–Schwarz), values in f32's normal range.

        - *The split.* ``v_hi = bf16(v)`` errs by ≤ 2⁻⁸|v| and ``v_lo =
          bf16(v − v_hi)`` (the difference is exact) by ≤ 2⁻¹⁶|v|. The
          dropped ``q_hi·e_x + q_lo·x_lo + q_lo·e_x + e_q·x`` (``e_v = v −
          v_hi − v_lo``) is ≤ (3 + 2⁻⁶)·2⁻¹⁶·S.
        - *The tensor cores* (``mma.sync`` m16n8k16, bf16 in, f32 out). The
          products are exact. An mma need not round to nearest: take the
          worst case, where the 16 addends and the accumulator are aligned
          to the largest exponent among them and each is truncated to 24
          bits there (< 2⁻²³ of the largest magnitude, which is ≤ S), then
          a partial sum is truncated once more and the result once when it
          is normalized. A step of m nonzero products thus loses
          < (m + 2)·2⁻²³·S; over ``n = ceil(D/16)`` steps (zero dims add
          nothing) < (D + 2n)·2⁻²³·(1 + 2⁻⁸)²·S for ``x_hi·q_hi``. The
          kernel sums ``x_lo·q_hi + x_hi·q_lo``, whose addends total
          ≤ 2⁻⁷(1 + 2⁻⁸)²·S, in registers of their own: twice the steps at
          that scale, which adds 2⁻⁶ of the big sum's bound. It adds the
          two at the end (one f32 rounding, 2⁻²⁴). Total ≤ (33/32)(D + 2n +
          1)·2⁻²³·S.
        - *The CPU route* (three IEEE f32 matmuls, two adds) errs by
          ≤ D·2⁻²⁴(1 + 2⁻⁶)·S + 2⁻²³·S, inside the same bound
          (:func:`high_sum_bounds` holds both routes' terms).
        - *The re-score* (K3: f32 ``fmaf``, round to nearest, any order; or
          its plain version): ≤ γ_D·S ≤ 1.01·D·2⁻²⁴·S.

        So ``C(D) = (3 + 2⁻⁶)·2⁻¹⁶ + (33/32)(D + 2n + 1)·2⁻²³ + 1.01·D·2⁻²⁴``
        (:func:`high_dot_bounds`) bounds the two dots' difference. Score
        space: IP ``C·‖q‖·max‖x‖``; L2 scores are ``2·dot − ‖x‖²`` with the
        same stored norm on both sides, so ``2·C·‖q‖·max‖x‖`` plus the two
        f32 roundings of the subtraction, ``2⁻²³(2‖q‖·max‖x‖ + max‖x‖²)``;
        cosine (unit queries, the same ``1/‖x‖`` factor on both sides) ``C``
        plus the re-score's query factor ``1/‖q‖`` (its f32 norm of a unit
        query, off by ≤ (D/2 + 3)·2⁻²⁴) and three roundings: ``C + (D + 12)
        ·2⁻²⁵``. The result is :data:`VERIFY_SAFETY` times that raw bound,
        which covers the (1 + 2⁻⁶) factors, stored norms a few ulps off and
        the model of the tensor cores' adds. ``max‖x‖`` is
        :meth:`DeviceSpace.norm_bounds`'s (conservative under deletes), of
        ``snap`` (default: the current snapshot)."""
        sp = self.space
        snap = snap or sp.snapshot
        c = sum(high_dot_bounds(sp.dim))
        if sp.metric == DistanceMetric.COSINE:
            raw = np.full(prep.sq_norms.shape, c + (sp.dim + 12) * 2.0**-25)
        else:
            qn = np.sqrt(prep.sq_norms.astype(np.float64))
            xmax = float(np.sqrt(max(snap.norm_bounds()[0], 0.0)))
            if sp.metric == DistanceMetric.L2:
                raw = (2 * c * qn * xmax
                       + 2.0**-23 * (2 * qn * xmax + xmax * xmax))
            else:
                raw = c * qn * xmax
        return (VERIFY_SAFETY * raw).astype(np.float32)

    def _finalize(self, pending, k: int) -> SearchResult:
        """Read back and convert to a user-facing result. For a
        ``high_verified`` launch, check the certificate of each query and
        re-run the queries that fail it (scores within the bf16x3 band across
        more than ``verify_margin`` rows at the boundary) at ``"highest"``, as
        one sub-batch gathered on the device, so the result is exact whatever
        the data; certified queries keep K3's re-scored answer. The re-run
        and the IDs read the snapshot that the launch read.

        On a CUDA device the read-back waits for the launch's own event, then
        copies the answer out of pinned memory into arrays of its own, and
        counts it in ``readback_stats``; the re-run of the failing queries
        reads back synchronously.

        Spans (while a profiler runs): ``engine.finalize``, of the launch's
        batch, around ``engine.readback`` (the host blocked until the answer
        is on the host and copied out, the certificate's boundary and any
        re-run among it; inside it, at ``high_verified``, ``engine.verify``
        around the certificate's check and ``engine.fallback`` around the
        ``"highest"`` re-run and its read-back) and ``engine.host_result``.
        ``verify_stats`` is updated under the lock that guards
        ``readback_stats``."""
        batch = pending[-1]
        tok = (RECORDER.begin("engine.finalize",
                              RECORDER.new_batch() if batch is None else batch)
               if _profiler._is_profiler_enabled else None)
        try:
            return self._finalize_body(pending, k)
        finally:
            if tok is not None:
                RECORDER.end(tok)

    def _finalize_body(self, pending, k: int) -> SearchResult:
        sp = self.space
        scores, idx, prep, k_eff, vcheck, snap, sent, _ = pending
        nq = prep.qdev.shape[0]
        if k_eff == 0:  # empty space
            return empty_result(nq, k, sp.metric)
        tok = (RECORDER.begin("engine.readback")
               if _profiler._is_profiler_enabled else None)
        if sent is None:  # the CPU: the answer is in host memory already
            answer = (scores, idx, *(() if vcheck is None else vcheck[:1]))
            host = [t.cpu().numpy() for t in answer]
        else:
            host, drained = sent.wait()
            with self._stats_lock:
                self.readback_stats["drained" if drained else "overlapped"] += 1
        scores, idx = host[:2]
        if vcheck is not None:
            # A row not fetched has an exact score ≤ b + eps; if the exact
            # k-th candidate clears that strictly, the top k is exact.
            _, eps, eff_mask = vcheck
            b = host[2]
            vtok = (RECORDER.begin("engine.verify")
                    if _profiler._is_profiler_enabled else None)
            ok = np.isneginf(b) | (scores[:, k_eff - 1] > b + eps)
            certified = int(ok.sum())
            with self._stats_lock:
                self.verify_stats["certified"] += certified
                self.verify_stats["fallbacks"] += len(ok) - certified
            if vtok is not None:
                RECORDER.end(vtok)
            if certified < len(ok):
                ftok = (RECORDER.begin("engine.fallback")
                        if _profiler._is_profiler_enabled else None)
                # vcheck comes with high_verified, which f32 spaces alone
                # run: f32 rows, so "highest" is the FFMA kernel's exact scan.
                # Only the failing queries re-run: each query's dots and its
                # selection do not depend on the others in its launch.
                fail = np.flatnonzero(~ok)
                data, norms, _, _ = snap.live()
                sub = prep.qdev.index_select(0, upload(fail, prep.qdev.device))
                fs, fi = fused_topk(
                    sub, data, norms, snap.num_valid, k_eff,
                    sp.metric, valid_mask=eff_mask, grid=self.grid,
                )
                scores[fail] = fs.cpu().numpy()
                idx[fail] = fi.cpu().numpy()
                if ftok is not None:
                    RECORDER.end(ftok)
        if tok is not None:
            RECORDER.end(tok)
        tok = (RECORDER.begin("engine.host_result")
               if _profiler._is_profiler_enabled else None)
        res = host_result(scores, idx, prep, k, sp.metric, snap.host_ids)
        if tok is not None:
            RECORDER.end(tok)
        return res
