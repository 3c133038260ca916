"""Single-vector zero-copy view.

Parity with the reference ``Vector`` (``src/vectors/vector.rs`` in
thegenem0/metrovector): a borrowed byte view plus interpretation metadata,
with a materializing ``as_f32`` decode (``src/vectors/vector.rs:71-92``),
checked zero-copy reinterpretation ``as_slice``/``cast_to``
(``src/vectors/vector.rs:104-147,183-206``) and conversion to a strided
slice view (``src/vectors/vector.rs:153-168``). Here the backing store is a
numpy view aliasing the reader's mmap, so "zero-copy" is structural, not a
promise enforced by unsafe code.
"""

from __future__ import annotations

import numpy as np

from ..errors import InvalidVectorTypeError
from ..format.constants import DataType, bf16_bits_to_f32, element_size


class Vector:
    """One logical vector: a 1-D numpy view of length ``dim`` over the mmap."""

    __slots__ = ("_view", "dim", "dtype", "index")

    def __init__(self, view: np.ndarray, dim: int, dtype: DataType, index: int = -1):
        self._view = view
        self.dim = dim
        self.dtype = DataType(dtype)
        self.index = index

    # -- decode --------------------------------------------------------------

    def as_f32(self) -> np.ndarray:
        """Materialize as float32 (reference ``as_f32``,
        ``src/vectors/vector.rs:71-92``). Works for any real-valued element
        type; integer (quantized) elements are returned as raw codes — use
        :meth:`dequantized` for calibrated values. bfloat16 elements are held
        as their bit patterns and widen exactly."""
        if self.dtype == DataType.BFLOAT16:
            return bf16_bits_to_f32(self._view)
        return np.asarray(self._view, dtype=np.float32)

    def dequantized(self, scale: float = 1.0, zero_point: float = 0.0) -> np.ndarray:
        """float32 values after applying the space's scalar quantization."""
        return (self.as_f32() - np.float32(zero_point)) * np.float32(scale)

    # -- zero-copy views ------------------------------------------------------

    def as_bytes(self) -> bytes:
        """Raw little-endian bytes (reference ``as_bytes``)."""
        return self._view.tobytes()

    def as_numpy(self) -> np.ndarray:
        """The backing view itself, no copy."""
        return self._view

    def as_slice(self, dtype) -> np.ndarray:
        """Reinterpret the raw bytes as another element type, requiring the
        byte length to divide evenly (reference ``as_slice``,
        ``src/vectors/vector.rs:104-119``)."""
        target = np.dtype(dtype)
        nbytes = self._view.nbytes
        if nbytes % target.itemsize != 0:
            raise InvalidVectorTypeError(
                f"{nbytes} bytes does not divide into {target} elements"
            )
        return self._view.view(np.uint8).view(target) if self._view.flags.c_contiguous \
            else np.frombuffer(self._view.tobytes(), dtype=target)

    def as_simd_slice(self, dtype, lanes: int = 8) -> np.ndarray:
        """Like :meth:`as_slice` but additionally requires the element count
        to be a multiple of ``lanes`` (reference ``as_simd_slice``,
        ``src/vectors/vector.rs:128-147`` — its alignment check becomes a
        lane-divisibility check, the constraint that matters for vectorized
        consumption)."""
        out = self.as_slice(dtype)
        if out.size % lanes != 0:
            raise InvalidVectorTypeError(
                f"{out.size} elements is not a multiple of {lanes} lanes"
            )
        return out

    def cast_to(self, dtype) -> np.ndarray:
        """Arbitrary checked reinterpretation (reference ``cast_to``,
        ``src/vectors/vector.rs:183-206``)."""
        return self.as_slice(dtype)

    def as_vector_slice(self):
        """View this vector as a 1-element strided slice (reference
        ``as_vector_slice``, ``src/vectors/vector.rs:153-168``)."""
        from .slices import VectorSlice

        esz = element_size(self.dtype)
        return VectorSlice(
            self._view.reshape(1, -1), stride=self.dim * esz, count=1,
            dim=self.dim, dtype=self.dtype,
        )

    # -- dunder ---------------------------------------------------------------

    def __len__(self) -> int:
        return self.dim

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._view, dtype=dtype)

    def __getitem__(self, i):
        return self._view[i]

    def __repr__(self) -> str:
        return f"Vector(index={self.index}, dim={self.dim}, dtype={self.dtype.name})"


class SparseVector:
    """One sparse vector: parallel ``cols``/``values`` views over the CSR
    blocks of a SPARSE space (which the reference declares but cannot
    materialize — ``schema/core.fbs:28-32`` vs ``src/builder.rs:175-192``)."""

    __slots__ = ("cols", "values", "dim", "dtype", "index")

    def __init__(self, cols: np.ndarray, values: np.ndarray, dim: int,
                 dtype: DataType, index: int = -1):
        self.cols = cols
        self.values = values
        self.dim = dim
        self.dtype = DataType(dtype)
        self.index = index

    @property
    def nnz(self) -> int:
        return int(self.cols.size)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.dim, dtype=np.float32)
        out[self.cols.astype(np.int64)] = self.values
        return out

    def as_f32(self) -> np.ndarray:
        """Dense float32 materialization (Vector.as_f32 analog)."""
        return self.to_dense()

    def __len__(self) -> int:
        return self.dim

    def __repr__(self) -> str:
        return (
            f"SparseVector(index={self.index}, dim={self.dim}, "
            f"nnz={self.nnz}, dtype={self.dtype.name})"
        )
