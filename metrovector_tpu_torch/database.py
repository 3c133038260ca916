"""Multi-space serving facade: one open file, one engine per space.

The counterpart of :mod:`metrovector_tpu.database`: engines build lazily
per space (the first search uploads that space to the device), a space
with a persisted index sidecar is served through it (PQ, IVF-PQ, IVF on
the device, HNSW on the host), metadata columns turn into exact filter
masks, and results carry stable IDs. ``device`` takes the place of the
reference's ``backend`` and ``interpret``; ``hbm_budget`` and
:class:`~.errors.HBMBudgetExceededError` keep their names, and on a card
they mean its memory.
"""

from __future__ import annotations

import operator
import os
from typing import Any

import numpy as np
import torch

from .engine import SearchEngine, SearchResult
from .errors import HBMBudgetExceededError, MetadataColumnNotFoundError
from .format.constants import DataType, IndexKind, VectorType
from .format.reader import Reader
from .utils.log import get_logger

_log = get_logger("database")

_OPS = {
    "==": operator.eq,
    "!=": operator.ne,
    "<": operator.lt,
    "<=": operator.le,
    ">": operator.gt,
    ">=": operator.ge,
    "in": lambda col, vals: np.isin(col, list(vals)),
}


class IndexEngine:
    """A reattached index served through the engine interface
    (``search``/``prepare_filter``/``nbytes``/``dim``), so that a persisted
    sidecar drives the read path.

    ``kind``: ``"pq" | "ivfpq" | "ivf" | "hnsw"``. ``search_kwargs`` are
    the per-call defaults the facade chose at reattachment (``nprobe`` from
    the persisted index params); keyword arguments of :meth:`search`
    override them. PQ and IVF-PQ default ``rerank`` to
    ``index.recommended_rerank(k)`` unless it is given (``rerank=0`` for
    the ADC scan alone)."""

    def __init__(self, index, kind: str, search_kwargs: dict | None = None):
        self.index = index
        self.kind = kind
        self.search_kwargs = dict(search_kwargs or {})
        self.dim = int(getattr(index, "dim", 0) or index.rows.shape[1])  # HNSW
        # the row count, for callers that check [num_vectors] filter masks
        # up front (MicroBatcher.submit)
        nv = getattr(index, "num_vectors", None)
        self.num_vectors = int(nv if nv is not None else index.rows.shape[0])

    @property
    def nbytes(self) -> int:
        """Summed footprint of the index's tensors on its device (HNSW
        holds none: 0)."""
        return sum(v.nbytes for v in vars(self.index).values()
                   if isinstance(v, torch.Tensor))

    def prepare_filter(self, filter_mask):
        prep = getattr(self.index, "prepare_filter", None)
        # HNSW filters are host planes: the raw mask goes back
        return prep(filter_mask) if prep else filter_mask

    def search(self, queries, k: int = 10, filter_mask=None, **kw):
        merged = {**self.search_kwargs, **kw}
        if (self.kind in ("pq", "ivfpq") and "rerank" not in merged
                and self.index.db is not None):
            merged["rerank"] = self.index.recommended_rerank(k)
        return self.index.search(queries, k=k, filter_mask=filter_mask, **merged)


class Database:
    """Lazy per-space engines over one MVT file.

    >>> import numpy as np, tempfile, os
    >>> from metrovector_tpu_torch import Builder, Database
    >>> b = Builder()
    >>> _ = b.add_vector_space("docs", dim=4)
    >>> b.add_vectors("docs", np.eye(4, dtype=np.float32))
    >>> b.add_metadata_column("docs", "lang", ["en", "de", "en", "fr"])
    >>> path = os.path.join(tempfile.mkdtemp(), "db.mvt")
    >>> b.build().save(path)
    >>> db = Database.open(path, device="cpu")
    >>> res = db.search("docs", np.eye(4, dtype=np.float32)[:1], k=2,
    ...                 where=("lang", "==", "en"))
    >>> res.indices.tolist()
    [[0, 2]]
    """

    def __init__(self, reader: Reader, device="cuda",
                 hbm_budget: int | None = None,
                 engine_kwargs: dict | None = None):
        self._reader = reader
        self._device = device
        self._engine_kwargs = dict(engine_kwargs or {})
        # insertion order is LRU order (engines re-inserted on access)
        self._engines: dict[str, Any] = {}
        self.hbm_budget = hbm_budget
        self._kind_cache: dict[str, str | None] = {}
        self._routed_notice: set[str] = set()

    @classmethod
    def open(cls, path: str | os.PathLike, device="cuda",
             hbm_budget: int | None = None,
             engine_kwargs: dict | None = None) -> "Database":
        """Open ``path`` for serving on ``device``.

        ``hbm_budget``: optional cap (bytes) on the summed device footprint
        of the resident engines. When a new space would exceed it, the
        least recently searched engines are evicted first; a space larger
        than the whole budget raises
        :class:`~metrovector_tpu_torch.errors.HBMBudgetExceededError`.
        While a space uploads, one staging chunk (≤ 256 MB,
        :func:`~.utils.transfer.put_chunked`) rides on top of the admitted
        size: leave that much headroom below the card's memory.

        ``engine_kwargs``: keyword arguments for every dense
        :class:`~.engine.SearchEngine` the facade builds (``precision``,
        ``verify_margin``, ``grid``). Sparse spaces and indexes ignore them."""
        return cls(Reader.open(path), device=device, hbm_budget=hbm_budget,
                   engine_kwargs=engine_kwargs)

    @property
    def reader(self) -> Reader:
        return self._reader

    @property
    def space_names(self) -> list[str]:
        return self._reader.vector_space_names

    @property
    def resident_bytes(self) -> int:
        """Summed device footprint of the resident engines."""
        return sum(e.space.nbytes if hasattr(e, "space") else e.nbytes
                   for e in self._engines.values())

    def _estimate_nbytes(self, space: str, flavor: str = "exact") -> int:
        """Device footprint of a space before it is uploaded (the budget
        decision comes before the allocation), as the port lays it out:
        ``flavor="exact"`` mirrors ``DeviceSpace.from_space`` (f32 at 4
        bytes, f16 and bf16 at 2, ``"default"`` precision as bf16, int8 and
        uint8 at 1 byte and uint8's code sums) or the sparse engine's ELL
        or COO planes; the index flavors mirror what ``from_space``
        uploads (PQ and IVF-PQ with the original rows for re-ranking, the
        codebooks and, for IVF-PQ, both layouts; IVF's buckets). HNSW is
        host-resident: 0. It equals the engine's ``nbytes`` after the
        upload."""
        sp = self._reader.vector_space(space)
        if flavor == "hnsw":
            return 0
        n, d = sp.num_vectors, sp.dim
        tomb = sp.tombstone_mask() is not None
        if flavor in ("pq", "ivfpq"):
            books, codes, _ = sp.pq_arrays()
            m, ksub, dsub = books.shape
            cols = codes.shape[1]
            dense = n * d * 4 + n * 4 + m * ksub * dsub * 4  # db, db_norms, books
            if flavor == "pq":
                return dense + n * cols + n * 4 + (n * 4 if tomb else 0)
            cells, bucket_rows = self._bucket_shape(sp)
            nb = len(cells)
            layout = nb * bucket_rows * (cols + 4 + 4) + nb * d * 4 + nb * 4
            return dense + layout + n * (cols + 4 + 4 + 4)
        if flavor == "ivf":
            cells, bucket_rows = self._bucket_shape(sp)
            nb = len(cells)
            return nb * bucket_rows * (d * 4 + 4 + 4) + nb * d * 4
        if sp.info.vector_type == VectorType.SPARSE:
            from .sparse import ELL_ROW_PAD, choose_formulation, ell_width

            indptr, _, _ = sp.sparse_csr()
            counts = np.diff(indptr.astype(np.int64))
            nnz = int(counts.sum())
            if choose_formulation(counts, nnz) == "coo":
                return nnz * 12 + n * 4 + (n * 4 if tomb else 0)
            r_cap = ell_width(counts) if nnz else 1
            n_pad = max(ELL_ROW_PAD, -(-max(n, 1) // ELL_ROW_PAD) * ELL_ROW_PAD)
            n_ovf = int(np.maximum(counts - r_cap, 0).sum()) if nnz else 0
            return (n_pad * r_cap * 8 + (n_pad + 1) * 8 + n_ovf * 8
                    + n_pad * 4 + (n_pad * 4 if tomb else 0))
        rows, pdim = sp.padded_rows, sp.padded_dim
        precision = self._engine_kwargs.get("precision", "highest")
        if sp.dtype in (DataType.INT8, DataType.UINT8):
            elem = 1
        elif sp.dtype in (DataType.FLOAT16, DataType.BFLOAT16) or precision == "default":
            elem = 2
        else:
            elem = 4
        total = rows * pdim * elem + rows * 4  # block + norms
        if tomb:
            total += rows * 4
        if sp.dtype == DataType.UINT8:
            total += rows * 4  # per-row code sums
        return total

    @staticmethod
    def _bucket_shape(sp) -> tuple[np.ndarray, int]:
        """The bucket layout's ``(cells, bucket_rows)`` for a space's
        persisted IVF quantizer, as ``IVFIndex``/``IVFPQIndex.from_space``
        build it."""
        from .index.ivf import bucket_layout

        centroids, assignments = sp.ivf_arrays()
        mask = sp.tombstone_mask()
        keep = np.ones(sp.num_vectors, bool) if mask is None else ~mask
        cells, _, bucket_rows = bucket_layout(np.asarray(assignments), keep,
                                              int(centroids.shape[0]))
        return cells, bucket_rows

    def evict(self, space: str) -> bool:
        """Drop one space's engines (every routing flavor) and their device
        tensors. Returns True if any was resident. Online mutations not
        persisted (``add_rows``/``delete_rows`` on the live engine) are
        lost."""
        keys = [key for key in self._engines
                if key == space or key.startswith(space + "#")]
        for key in keys:
            del self._engines[key]
        return bool(keys)

    def _admit(self, space: str, flavor: str = "exact") -> None:
        """Evict least recently used engines until ``space`` fits the
        budget; raise if it never can."""
        if self.hbm_budget is None:
            return
        need = self._estimate_nbytes(space, flavor)
        if need > self.hbm_budget:
            raise HBMBudgetExceededError(space, need, self.hbm_budget)
        while self._engines and self.resident_bytes + need > self.hbm_budget:
            del self._engines[next(iter(self._engines))]  # the oldest

    def index_kind(self, space: str) -> str | None:
        """Which persisted index sidecar drives ``"auto"`` routing for this
        space: ``"ivfpq"``, ``"pq"``, ``"hnsw"``, ``"ivf"`` or None (the
        exact engine)."""
        if space not in self._kind_cache:
            self._kind_cache[space] = self._detect_index_kind(space)
        return self._kind_cache[space]

    def _detect_index_kind(self, space: str) -> str | None:
        sp = self._reader.vector_space(space)
        if sp.info.vector_type == VectorType.SPARSE:
            return None
        pq = sp.info.pq
        kind = sp.info.index.kind
        if pq is not None and pq.codes_block >= 0:
            if pq.residual and kind == IndexKind.IVF:
                return "ivfpq"
            if not pq.residual:
                return "pq"
        if kind == IndexKind.HNSW and sp.hnsw_arrays() is not None:
            return "hnsw"
        if kind == IndexKind.IVF and sp.ivf_arrays() is not None:
            return "ivf"
        return None

    def _build_index_engine(self, space: str, kind: str) -> IndexEngine:
        params = self._reader.vector_space(space).info.index.params
        if kind == "pq":
            return IndexEngine(self.pq_index(space), "pq")
        if kind == "ivfpq":
            return IndexEngine(self.ivfpq_index(space), "ivfpq",
                               {"nprobe": int(params.get("nprobe", 16))})
        if kind == "ivf":
            return IndexEngine(self.ivf_index(space), "ivf",
                               {"nprobe": int(params.get("nprobe", 16))})
        if kind == "hnsw":
            return IndexEngine(self.hnsw_index(space), "hnsw")
        raise ValueError(f"unknown index kind {kind!r}")

    def engine(self, space: str | None = None, mode: str = "auto"):
        """The (lazily built) engine for one space; with a one-space file
        the name may be omitted. Under an ``hbm_budget`` a new engine may
        evict the least recently used ones.

        ``mode``: ``"auto"`` serves through the space's persisted index
        sidecar when it has one (:meth:`index_kind`), else the exact
        engine; ``"exact"`` always the exact engine; ``"index"`` requires
        a sidecar. The exact and the index engine of one space are cached
        and budgeted apart."""
        if space is None:
            names = self.space_names
            if len(names) != 1:
                raise ValueError(f"file has {len(names)} spaces; name one of {names}")
            space = names[0]
        if mode not in ("auto", "exact", "index"):
            raise ValueError(f"unknown mode {mode!r}; expected 'auto', 'exact' or 'index'")
        kind = None
        if mode != "exact":
            kind = self.index_kind(space)
            if kind is not None and mode == "auto" and space not in self._routed_notice:
                self._routed_notice.add(space)
                _log.info(
                    "space %r: serving through its persisted %s sidecar "
                    "(mode='auto'); pass mode='exact' for exact results",
                    space, kind,
                )
            if kind is None and mode == "index":
                raise ValueError(
                    f"space {space!r} persists no index sidecar; build one "
                    "(Builder.set_pq_index/set_ivf_index/set_hnsw_index) or "
                    "use mode='exact'"
                )
        key = space if kind is None else f"{space}#{kind}"
        if key in self._engines:
            self._engines[key] = self._engines.pop(key)  # LRU touch
            return self._engines[key]
        self._admit(space, flavor=kind or "exact")
        if kind is not None:
            eng = self._build_index_engine(space, kind)
        else:
            sp = self._reader.vector_space(space)
            if sp.info.vector_type == VectorType.SPARSE:
                from .sparse import SparseSearchEngine

                eng = SparseSearchEngine(sp, device=self._device)
            else:
                eng = SearchEngine(sp, device=self._device, **self._engine_kwargs)
        self._engines[key] = eng
        return eng

    def _where_mask(self, space: str, where) -> np.ndarray | None:
        """AND of the ``(column, op, value)`` predicates, or None."""
        if where is None:
            return None
        mask = None
        for col, op, value in [where] if isinstance(where, tuple) else list(where):
            m = self.column_mask(space, col, op, value)
            mask = m if mask is None else (mask & m)
        return mask

    def batcher(self, space: str | None = None, k: int = 10,
                where: tuple | list[tuple] | None = None,
                mode: str = "auto", **kw):
        """A :class:`~.serving.MicroBatcher` over one space's engine: the
        request-coalescing front end for concurrent single-query callers.
        ``where`` predicates (as in :meth:`search`) become its shared
        prepared filter; ``mode`` routes as in :meth:`search`; other
        keyword arguments go to the batcher (``max_batch``,
        ``max_wait_ms``, ``pipeline``, ...). The caller owns its lifecycle
        (``with`` or ``close()``)."""
        from .serving import MicroBatcher

        eng = self.engine(space, mode=mode)
        name = space if space is not None else self.space_names[0]
        return MicroBatcher(eng, k=k, filter_mask=self._where_mask(name, where), **kw)

    def prepare_where(self, space: str | None = None,
                      where: tuple | list[tuple] | None = None,
                      mode: str = "auto"):
        """A metadata predicate prepared on the space's serving engine,
        for ``batcher.submit(q, filter_mask=prepared)`` (requests with one
        prepared predicate coalesce). ``where`` as in :meth:`search`;
        ``mode`` must match the batcher's routing."""
        if where is None:
            raise ValueError("prepare_where needs at least one predicate")
        eng = self.engine(space, mode=mode)
        name = space if space is not None else self.space_names[0]
        mask = self._where_mask(name, where)
        prep = getattr(eng, "prepare_filter", None)
        return prep(mask) if prep else mask

    def pq_index(self, space: str, **kw):
        """Reattach (or build) the space's PQ index on the facade's device."""
        from .index.pq import PQIndex

        return PQIndex.from_space(self._reader.vector_space(space),
                                  device=self._device, **kw)

    def ivf_index(self, space: str, **kw):
        """Reattach (or build) the space's IVF structure."""
        from .index.ivf import IVFIndex

        return IVFIndex.from_space(self._reader.vector_space(space),
                                   device=self._device, **kw)

    def ivfpq_index(self, space: str, **kw):
        """Reattach (or build) the space's residual IVF-PQ structure."""
        from .index.ivfpq import IVFPQIndex

        return IVFPQIndex.from_space(self._reader.vector_space(space),
                                     device=self._device, **kw)

    def hnsw_index(self, space: str, **kw):
        """Reattach (or build) the space's HNSW graph (host-resident)."""
        from .index.hnsw import HNSWIndex

        return HNSWIndex.from_space(self._reader.vector_space(space), **kw)

    def column_mask(self, space: str, column: str, op: str, value: Any) -> np.ndarray:
        """A boolean row mask from a metadata predicate, e.g.
        ``column_mask("docs", "lang", "==", "en")``, ``("price", "<",
        10.0)`` or ``("tag", "in", {"a", "b"})``."""
        if op not in _OPS:
            raise ValueError(f"unknown operator {op!r}; one of {list(_OPS)}")
        sp = self._reader.vector_space(space)
        if column not in sp.metadata_column_names():
            raise MetadataColumnNotFoundError(column)
        vals = sp.metadata_column(column)
        arr = np.asarray(vals, dtype=object) if isinstance(vals, list) else np.asarray(vals)
        return np.asarray(_OPS[op](arr, value), dtype=bool)

    def search(self, space: str | None, queries, k: int = 10,
               where: tuple | list[tuple] | None = None,
               filter_mask=None, mode: str = "auto",
               **search_kwargs) -> SearchResult:
        """Search one space, optionally restricted by metadata predicates.

        ``where``: a ``(column, op, value)`` predicate or a list of them
        (AND-combined), turned into the serving engine's exact filter and
        composed with ``filter_mask``; every routing target takes it.
        ``mode`` as in :meth:`engine`. Other keyword arguments reach the
        routed engine's ``search`` (``nprobe=32``, ``rerank=0``,
        ``ef=256``)."""
        eng = self.engine(space, mode=mode)
        name = space if space is not None else self.space_names[0]
        mask = self._where_mask(name, where)
        if filter_mask is not None:
            fm = np.asarray(filter_mask, dtype=bool)
            mask = fm if mask is None else (mask & fm)
        return eng.search(queries, k=k, filter_mask=mask, **search_kwargs)
