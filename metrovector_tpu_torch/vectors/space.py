"""Zero-copy host view over one vector space.

Parity with the reference ``VectorSpace``
(``src/vectors/vector_space.rs`` in thegenem0/metrovector): metadata
accessors (``:62-89``), bounds-checked single-vector access
(``get_vector``, ``:101-142``), range views (``map_vector_range``,
``:155-188``), planned batch access (``get_vectors_batch`` /
``get_vectors_with_pattern`` / ``prepare_access_pattern``, ``:210-241``),
chunked streaming (``stream_vectors``, ``:251-253``), columnar dimension
views (``get_dimension_slice``, ``:279-317``) and cheap concurrent clones
(``clone_concurrent``, ``:194-201``).

Additions over the reference: metadata column decoding (values, not raw
bytes), tombstone masks, quantization info, and the whole-block numpy view
that the TPU engine device-puts — the on-disk bytes ARE the
``[padded_rows, padded_dim]`` array, so this view is a reshape, not a parse.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from ..errors import (
    IndexOutOfBoundsError,
    MetadataColumnNotFoundError,
)
from ..format.constants import (
    DataType,
    DistanceMetric,
    IndexKind,
    TombstoneFormat,
    VectorType,
    bf16_bits_to_f32,
    element_size,
    numpy_dtype,
)
from ..format.manifest import ColumnInfo, SpaceInfo
from ..format.packing import StringHeap, unpack_block
from .access import AccessPattern
from .iterator import VectorChunkIterator
from .slices import DimensionSlice, VectorSlice
from .vector import Vector

if TYPE_CHECKING:
    from ..format.reader import Reader


class VectorSpace:
    """A borrowed, immutable view over one named space in an open Reader.

    >>> import numpy as np, tempfile, os
    >>> from metrovector_tpu_torch import Builder, Reader
    >>> b = Builder()
    >>> _ = b.add_vector_space("e", dim=2)
    >>> b.add_vectors("e", np.array([[1., 2.], [3., 4.]], np.float32))
    >>> path = os.path.join(tempfile.mkdtemp(), "s.mvt")
    >>> b.build().save(path)
    >>> sp = Reader.open(path).vector_space("e")
    >>> sp.get_vector(1).as_f32().tolist()
    [3.0, 4.0]
    >>> [float(v.as_f32()[0]) for chunk in sp.stream_vectors(0, 2) for v in chunk]
    [1.0, 3.0]
    """

    def __init__(self, reader: "Reader", info: SpaceInfo):
        self._reader = reader
        self._info = info
        if info.vector_type == VectorType.SPARSE:
            self._block = None
            sp = info.sparse
            self._sp_vals = np.frombuffer(
                reader.block_bytes(sp.values_block),
                dtype=numpy_dtype(info.dtype), count=sp.nnz,
            )
            self._sp_cols = np.frombuffer(
                reader.block_bytes(sp.cols_block), dtype="<u4", count=sp.nnz
            )
            self._sp_indptr = np.frombuffer(
                reader.block_bytes(sp.indptr_block), dtype="<u8",
                count=info.num_vectors + 1,
            )
        else:
            raw = reader.block_bytes(info.vectors_block)
            self._block = unpack_block(
                raw, info.padded_rows, info.padded_dim, info.dtype
            )

    # -- metadata accessors (reference :62-89) --------------------------------

    @property
    def name(self) -> str:
        return self._info.name

    @property
    def dim(self) -> int:
        return self._info.dim

    @property
    def padded_dim(self) -> int:
        return self._info.padded_dim

    @property
    def num_vectors(self) -> int:
        return self._info.num_vectors

    @property
    def padded_rows(self) -> int:
        return self._info.padded_rows

    @property
    def dtype(self) -> DataType:
        return self._info.dtype

    @property
    def metric(self) -> DistanceMetric:
        return self._info.metric

    @property
    def vector_type(self) -> VectorType:
        return self._info.vector_type

    @property
    def info(self) -> SpaceInfo:
        return self._info

    @property
    def reader(self) -> "Reader":
        """The owning reader (for manifest-level metadata like hints)."""
        return self._reader

    @property
    def quantization(self):
        return self._info.quantization

    # -- bulk views ------------------------------------------------------------

    def _require_dense(self):
        if self._block is None:
            from ..errors import InvalidVectorTypeError

            raise InvalidVectorTypeError(
                f"space {self.name!r} is sparse; use sparse_csr() / "
                "get_vector() / to_numpy()"
            )
        return self._block

    @property
    def is_sparse(self) -> bool:
        return self._info.vector_type == VectorType.SPARSE

    def sparse_csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Zero-copy CSR views ``(indptr [N+1] u64, cols [nnz] u32,
        values [nnz])`` of a SPARSE space."""
        if not self.is_sparse:
            from ..errors import InvalidVectorTypeError

            raise InvalidVectorTypeError(f"space {self.name!r} is dense")
        return self._sp_indptr, self._sp_cols, self._sp_vals

    def padded_array(self) -> np.ndarray:
        """The full tile-padded ``[padded_rows, padded_dim]`` block, zero-copy.
        This is the array the TPU engine uploads verbatim (dense spaces)."""
        return self._require_dense()

    def to_numpy(self) -> np.ndarray:
        """The logical ``[num_vectors, dim]`` view — zero-copy (strided) for
        dense spaces; a densified copy for sparse spaces. A BFLOAT16 space's
        values widen to an f32 copy (exact); :meth:`padded_array` keeps the
        stored bit patterns (uint16)."""
        if self.is_sparse:
            out = np.zeros((self.num_vectors, self.dim), dtype=np.float32)
            ip = self._sp_indptr.astype(np.int64)
            rows = np.repeat(
                np.arange(self.num_vectors), np.diff(ip)
            )
            out[rows, self._sp_cols.astype(np.int64)] = self._sp_vals
            return out
        view = self._block[: self.num_vectors, : self.dim]
        if self.dtype == DataType.BFLOAT16:  # bit patterns → f32 (a copy)
            return bf16_bits_to_f32(view)
        return view

    def norms(self) -> np.ndarray:
        """Precomputed squared L2 norms, f32 ``[padded_rows]``, zero-copy."""
        raw = self._reader.block_bytes(self._info.norms_block)
        return np.frombuffer(raw, dtype="<f4", count=self._info.padded_rows)

    # -- single access (reference get_vector, :101-142) ------------------------

    def get_vector(self, index: int):
        if index < 0 or index >= self.num_vectors:
            raise IndexOutOfBoundsError(index, self.num_vectors)
        if self.is_sparse:
            from .vector import SparseVector

            lo = int(self._sp_indptr[index])
            hi = int(self._sp_indptr[index + 1])
            return SparseVector(
                self._sp_cols[lo:hi], self._sp_vals[lo:hi], self.dim,
                self.dtype, index,
            )
        return Vector(self._block[index, : self.dim], self.dim, self.dtype, index)

    # -- range / batch access ---------------------------------------------------

    def map_vector_range(self, start: int, count: int) -> VectorSlice:
        """Strided batch view (reference ``map_vector_range``, ``:155-188``)."""
        self._require_dense()
        if start < 0 or count < 0 or start + count > self.num_vectors:
            raise IndexOutOfBoundsError(start + count, self.num_vectors)
        esz = element_size(self.dtype)
        return VectorSlice(
            self._block[start : start + count],
            stride=self.padded_dim * esz,
            count=count,
            dim=self.dim,
            dtype=self.dtype,
            start_index=start,
        )

    def prepare_access_pattern(self, indices) -> AccessPattern:
        return AccessPattern(indices)

    def get_vectors_with_pattern(self, pattern: AccessPattern) -> list[Vector]:
        """Fetch along a prepared plan (reference ``:210-221``)."""
        out = []
        for idx in pattern.indices:
            out.append(self.get_vector(int(idx)))
        return out

    def get_vectors_batch(self, indices) -> list[Vector]:
        """Sorted/deduplicated batch fetch (reference ``:230-241``; dedup
        semantics per test at ``src/vectors/vector_space.rs:400-414``)."""
        return self.get_vectors_with_pattern(self.prepare_access_pattern(indices))

    def stream_vectors(self, start: int = 0, chunk_size: int = 1024) -> VectorChunkIterator:
        """Chunked iteration (reference ``stream_vectors``, ``:251-253``)."""
        return VectorChunkIterator(self, start, chunk_size)

    def get_dimension_slice(self, dimension: int, start: int, count: int) -> DimensionSlice:
        """Columnar view of one dimension (reference ``:279-317``)."""
        self._require_dense()
        if dimension < 0 or dimension >= self.dim:
            raise IndexOutOfBoundsError(dimension, self.dim)
        if start < 0 or count < 0 or start + count > self.num_vectors:
            raise IndexOutOfBoundsError(start + count, self.num_vectors)
        return DimensionSlice(self._block, dimension, start, count, self.dtype)

    def clone_concurrent(self) -> "VectorSpace":
        """Cheap handle for another thread (reference ``clone_concurrent``,
        ``:194-201``). All state is immutable; this is a shallow copy."""
        return VectorSpace(self._reader, self._info)

    # -- metadata columns --------------------------------------------------------

    def metadata_column_names(self) -> list[str]:
        return [c.name for c in self._info.columns]

    def has_metadata(self) -> bool:
        return bool(self._info.columns)

    def _column_info(self, name: str) -> ColumnInfo:
        for c in self._info.columns:
            if c.name == name:
                return c
        raise MetadataColumnNotFoundError(name)

    def metadata_column(self, name: str):
        """Decoded column values: a numpy array for numeric columns, a list
        of ``str`` for string columns (the reference returns raw bytes and
        leaves decoding to callers; see ``I32Bytes``/``StringBytes`` fixtures
        at ``src/tests/test_utils.rs:25-50``)."""
        col = self._column_info(name)
        raw = self._reader.block_bytes(col.block)
        arr = np.frombuffer(raw, dtype=numpy_dtype(col.dtype), count=col.count)
        if col.dtype == DataType.STRING_REF:
            heap = bytes(self._reader.block_bytes(self._info.string_heap_block))
            return [StringHeap.read(heap, int(off)) for off in arr]
        return arr

    # -- stored index structures ---------------------------------------------------

    def ivf_arrays(self) -> tuple[np.ndarray, np.ndarray] | None:
        """Stored IVF structure ``(centroids [C, dim] f32, assignments [N]
        i32)`` if the builder persisted one (``Builder.set_ivf_index``),
        else None. Zero-copy views of the mmap."""
        idx = self._info.index
        cb = idx.params.get("centroids_block", -1)
        ab = idx.params.get("assignments_block", -1)
        if cb < 0 or ab < 0:
            return None
        c = int(idx.params.get("num_clusters", 0))
        cent = np.frombuffer(
            self._reader.block_bytes(cb), dtype="<f4", count=c * self.dim
        ).reshape(c, self.dim)
        assign = np.frombuffer(
            self._reader.block_bytes(ab), dtype="<i4", count=self.num_vectors
        )
        return cent, assign

    def pq_arrays(
        self,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
        """Stored product-quantization sidecar ``(codebooks [m, ksub, dsub]
        f32, codes [N, m] u8, recon_norms [N] f32)`` if the builder persisted
        one (``Builder.set_pq_index``), else None. Zero-copy views of the
        mmap (the reference declares PQ tables in ``schema/extensions.fbs``
        but can neither write nor read them). With ``info.pq.packed4`` the
        codes view is the nibble-packed ``[N, ⌈m/2⌉]`` block."""
        pq = self._info.pq
        if pq is None or pq.codebooks_block < 0:
            return None
        books = np.frombuffer(
            self._reader.block_bytes(pq.codebooks_block),
            dtype="<f4",
            count=pq.m * pq.ksub * pq.dsub,
        ).reshape(pq.m, pq.ksub, pq.dsub)
        code_cols = (pq.m + 1) // 2 if pq.packed4 else pq.m
        codes = np.frombuffer(
            self._reader.block_bytes(pq.codes_block),
            dtype=np.uint8,
            count=self.num_vectors * code_cols,
        ).reshape(self.num_vectors, code_cols)
        rnorms = np.frombuffer(
            self._reader.block_bytes(pq.recon_norms_block),
            dtype="<f4",
            count=self.num_vectors,
        )
        return books, codes, rnorms

    def hnsw_arrays(self):
        """Stored HNSW graph ``(layers [(ids, adj)], entry, m,
        ef_construction)`` if the builder persisted one
        (``Builder.set_hnsw_index``), else None. Zero-copy views of the
        mmap (the reference stores a TODO stub instead of a graph,
        ``src/builder.rs:459``)."""
        idx = self._info.index
        meta = idx.params.get("layers")
        if not meta or idx.kind != IndexKind.HNSW:
            return None
        layers = []
        for lm in meta:
            count, width = int(lm["count"]), int(lm["width"])
            ids = np.frombuffer(
                self._reader.block_bytes(int(lm["ids_block"])),
                dtype="<i4", count=count,
            )
            adj = np.frombuffer(
                self._reader.block_bytes(int(lm["adj_block"])),
                dtype="<i4", count=count * width,
            ).reshape(count, width)
            layers.append((ids, adj))
        return (
            layers,
            int(idx.params.get("entry", -1)),
            int(idx.params.get("m", 16)),
            int(idx.params.get("ef_construction", 200)),
        )

    # -- tombstones ----------------------------------------------------------------

    def ids(self) -> np.ndarray | None:
        """Stable external IDs ``[num_vectors]`` u64, or None when positions
        are the IDs (reference ``vector_ids_block_index`` semantics,
        ``schema/core.fbs:54``). Zero-copy view of the mapped block."""
        if self._info.ids_block < 0:
            return None
        raw = self._reader.block_bytes(self._info.ids_block)
        return np.frombuffer(raw, dtype="<u8", count=self.num_vectors)

    def id_for(self, index: int) -> int:
        """The stable ID of row ``index`` (the position itself when the
        space has no explicit ID column)."""
        if index < 0 or index >= self.num_vectors:
            raise IndexOutOfBoundsError(index, self.num_vectors)
        ids = self.ids()
        return int(ids[index]) if ids is not None else index

    def row_for_id(self, vector_id: int) -> int:
        """Inverse lookup: the current row position holding ``vector_id``.
        O(1) after the first call (lazy hash map); raises KeyError for
        unknown IDs."""
        ids = self.ids()
        if ids is None:
            if 0 <= vector_id < self.num_vectors:
                return int(vector_id)
            raise KeyError(vector_id)
        lut = getattr(self, "_id_lut", None)
        if lut is None:
            lut = {int(v): i for i, v in enumerate(ids)}
            self._id_lut = lut
        return lut[int(vector_id)]

    def tombstone_mask(self) -> np.ndarray | None:
        """Boolean ``[num_vectors]`` deleted-row mask, or None when the space
        has no tombstones (format per ``TombstoneInfo``)."""
        ts = self._info.tombstones
        if ts.format == TombstoneFormat.NONE or ts.block < 0:
            return None
        raw = np.frombuffer(self._reader.block_bytes(ts.block), dtype=np.uint8)
        if ts.format == TombstoneFormat.BITMAP:
            bits = np.unpackbits(raw, bitorder="little")[: self.num_vectors]
            return bits.astype(bool)
        # SORTED_LIST: u32 row ids
        ids = raw.view("<u4")
        mask = np.zeros(self.num_vectors, dtype=bool)
        mask[ids[ids < self.num_vectors]] = True
        return mask

    def is_deleted(self, index: int) -> bool:
        if index < 0 or index >= self.num_vectors:
            raise IndexOutOfBoundsError(index, self.num_vectors)
        mask = self.tombstone_mask()
        return bool(mask[index]) if mask is not None else False

    def __len__(self) -> int:
        return self.num_vectors

    def __repr__(self) -> str:
        return (
            f"VectorSpace(name={self.name!r}, n={self.num_vectors}, dim={self.dim}, "
            f"dtype={self.dtype.name}, metric={self.metric.name})"
        )
