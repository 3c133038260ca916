"""Strided and columnar views over a vector block.

Parity with the reference's ``VectorSlice`` (``src/vectors/mem.rs`` in
thegenem0/metrovector) and ``DimensionSlice`` (``src/vectors/dimension.rs``):
typed strided access over a contiguous region with construction-time
validation, plus a single-dimension columnar view. Because the MVT block is
already a 2-D numpy array, stride handling is expressed as array slicing —
the reference's manual ``read_unaligned`` pointer walks
(``src/vectors/mem.rs:129-149``) are unnecessary.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from ..errors import IndexOutOfBoundsError, InvalidVectorTypeError
from ..format.constants import DataType, element_size
from .vector import Vector


class VectorSlice:
    """A batch of ``count`` vectors with a fixed byte ``stride`` between row
    starts (reference ``VectorSlice``, ``src/vectors/mem.rs:24-68``). For
    tile-padded blocks the stride is ``padded_dim * itemsize`` while each
    logical row is ``dim`` elements."""

    def __init__(self, block: np.ndarray, stride: int, count: int, dim: int,
                 dtype: DataType, start_index: int = 0):
        esz = element_size(dtype)
        if stride % esz != 0:
            raise InvalidVectorTypeError(
                f"stride {stride} not aligned to element size {esz}"
            )
        if stride < dim * esz:
            raise InvalidVectorTypeError(
                f"stride {stride} smaller than row payload {dim * esz}"
            )
        needed_rows = count
        if block.ndim != 2 or block.shape[0] < needed_rows or block.shape[1] * esz < stride:
            raise InvalidVectorTypeError(
                f"buffer {block.shape} too small for {count} rows of stride {stride}"
            )
        self._block = block
        self.stride = stride
        self.count = count
        self.dim = dim
        self.dtype = DataType(dtype)
        self.start_index = start_index

    # -- element access -------------------------------------------------------

    def get(self, i: int) -> Vector:
        if i < 0 or i >= self.count:
            raise IndexOutOfBoundsError(i, self.count)
        return Vector(
            self._block[i, : self.dim], self.dim, self.dtype, self.start_index + i
        )

    def __getitem__(self, i: int) -> Vector:
        return self.get(i)

    def __len__(self) -> int:
        return self.count

    def __iter__(self) -> Iterator[Vector]:
        for i in range(self.count):
            yield self.get(i)

    # -- bulk views -----------------------------------------------------------

    def to_numpy(self) -> np.ndarray:
        """The logical ``[count, dim]`` view, zero-copy (strided)."""
        return self._block[: self.count, : self.dim]

    def as_aligned_slice(self) -> np.ndarray:
        """Flat 1-D element view — only valid when rows are tightly packed
        (reference ``as_aligned_slice``, ``src/vectors/mem.rs:89-121``)."""
        esz = element_size(self.dtype)
        if self.stride != self.dim * esz:
            raise InvalidVectorTypeError(
                "rows are not tightly packed; use to_numpy() for a strided view"
            )
        return self.to_numpy().reshape(-1)

    def iter_elements(self) -> Iterator:
        """Flat element iterator (reference ``iter_elements``,
        ``src/vectors/mem.rs:152-157``)."""
        for row in self.to_numpy():
            yield from row

    # -- SIMD-era helpers kept for API parity ---------------------------------

    def is_simd_aligned(self, width: int) -> bool:
        """Whether the logical row length divides into ``width``-element
        groups (reference ``is_simd_aligned``, ``src/vectors/mem.rs:163-166``)."""
        return self.dim % width == 0

    def chunk_size_for_simd(self, width: int) -> int:
        """Largest multiple of ``width`` not exceeding ``dim`` (reference
        ``chunk_size_for_simd``, ``src/vectors/mem.rs:172-175``)."""
        return (self.dim // width) * width

    def element_size(self) -> int:
        return element_size(self.dtype)

    def clone_concurrent(self) -> "VectorSlice":
        """Cheap handle for another thread (reference ``clone_concurrent``
        equivalence test, ``src/vectors/mem.rs:594-612``); all state is
        immutable, so this is a shallow copy."""
        return VectorSlice(
            self._block, self.stride, self.count, self.dim, self.dtype,
            self.start_index,
        )

    def __repr__(self) -> str:
        return (
            f"VectorSlice(count={self.count}, dim={self.dim}, "
            f"stride={self.stride}, dtype={self.dtype.name})"
        )


class DimensionSlice:
    """One dimension across a run of vectors — a columnar view (reference
    ``DimensionSlice``, ``src/vectors/dimension.rs:33-125``)."""

    def __init__(self, block: np.ndarray, dimension: int, start: int, count: int,
                 dtype: DataType):
        self._col = block[start : start + count, dimension]
        self.dimension = dimension
        self.start = start
        self.count = count
        self.dtype = DataType(dtype)

    def get_value(self, i: int) -> float:
        if i < 0 or i >= self.count:
            raise IndexOutOfBoundsError(i, self.count)
        return float(self._col[i])

    def iter_values(self) -> Iterator[float]:
        for v in self._col:
            yield float(v)

    def to_numpy(self) -> np.ndarray:
        """Zero-copy strided column view."""
        return self._col

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return (
            f"DimensionSlice(dim={self.dimension}, start={self.start}, "
            f"count={self.count}, dtype={self.dtype.name})"
        )
