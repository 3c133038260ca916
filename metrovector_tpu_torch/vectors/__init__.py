"""Zero-copy host access layer over MVT vector spaces.

The port's own copy of the JAX package's layer of the same name: the
two read and write the same bytes.
"""

from .access import VECTORS_PER_BLOCK, AccessPattern
from .iterator import VectorChunkIterator
from .slices import DimensionSlice, VectorSlice
from .space import VectorSpace
from .vector import Vector

__all__ = [
    "VECTORS_PER_BLOCK",
    "AccessPattern",
    "DimensionSlice",
    "Vector",
    "VectorChunkIterator",
    "VectorSlice",
    "VectorSpace",
]
