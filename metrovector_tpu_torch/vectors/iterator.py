"""Chunked streaming iteration over a vector space.

Parity with the reference ``VectorChunkIterator``
(``src/vectors/iterator.rs:32-81`` in thegenem0/metrovector): yields lists
of :class:`~metrovector_tpu_torch.vectors.vector.Vector` of at most ``chunk_size``
from ``start`` to the end of the space.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Iterator

from .vector import Vector

if TYPE_CHECKING:
    from .space import VectorSpace


class VectorChunkIterator:
    def __init__(self, space: "VectorSpace", start: int, chunk_size: int):
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        self._space = space
        self._cursor = max(0, start)
        self._end = space.num_vectors
        self.chunk_size = chunk_size

    def __iter__(self) -> Iterator[list[Vector]]:
        return self

    def __next__(self) -> list[Vector]:
        if self._cursor >= self._end:
            raise StopIteration
        stop = min(self._cursor + self.chunk_size, self._end)
        chunk = [self._space.get_vector(i) for i in range(self._cursor, stop)]
        self._cursor = stop
        return chunk
