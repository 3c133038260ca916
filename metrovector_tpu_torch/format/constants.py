"""MVT file-format constants: magic, alignment, dtype/tile tables.

The MVT ("MetroVector-TPU") layout keeps the proven O(1)-open envelope of the
reference format (magic at both ends, trailing u32 footer length —
``schema/FORMAT.md:11-24`` in thegenem0/metrovector) but replaces the
FlatBuffers footer with a versioned JSON manifest and, crucially, stores
vector blocks **tile-padded for TPU**: rows padded to the dtype's sublane
multiple and dims optionally padded to the 128-lane boundary, so a block maps
byte-for-byte onto the in-HBM tiling of a `(padded_rows, padded_dim)` jax
array with no host-side reshuffle.
"""

from __future__ import annotations

import enum

import numpy as np

# File envelope -------------------------------------------------------------

MAGIC = b"MVT1"
MAGIC_LEN = len(MAGIC)
FOOTER_LEN_SIZE = 4  # trailing little-endian u32 footer length
# minimum possible file: magic + empty footer + len + magic
MIN_FILE_SIZE = MAGIC_LEN + FOOTER_LEN_SIZE + MAGIC_LEN
# Format evolution (the analog of the reference's ``format_version`` +
# ``compatibility_version`` pair, ``schema/mvf.fbs:13-14``): files carry
# both the writer's version and the *oldest reader version* able to open
# them. A reader accepts any file whose ``compat_version`` ≤ its own
# FORMAT_VERSION, so old files keep opening under new readers and new
# files degrade gracefully (unknown manifest keys are ignored) unless
# they use features the old reader can't interpret.
#   v1: round-1 layout (spaces, norms, indexes, tombstones, columns).
#   v2: adds the optional per-space stable vector-ID block (``ids_block``).
FORMAT_VERSION = 2

# Data blocks are aligned to this boundary inside the file so a block can be
# mapped / DMA'd with natural alignment (also friendly to O_DIRECT reads).
BLOCK_ALIGN = 512

# TPU tiling ---------------------------------------------------------------

LANES = 128  # last-dim tile width on TPU (MXU/VPU lane count)

# Minimum sublane multiple per element width (TPU tiling: f32→8, bf16/f16→16,
# int8/uint8→32). Rows of a vector block are padded to this multiple.
SUBLANES_BY_ITEMSIZE = {4: 8, 2: 16, 1: 32}


class DataType(enum.IntEnum):
    """Element types storable in an MVT vector block or metadata column.

    Mirrors the reference enum ``DataType`` (``schema/types.fbs:3-11``) plus
    BFLOAT16, the TPU-native 16-bit float.
    """

    FLOAT32 = 0
    FLOAT16 = 1
    INT8 = 2
    UINT8 = 3
    UINT32 = 4
    UINT64 = 5
    STRING_REF = 6  # index into the string heap (metadata columns only)
    BFLOAT16 = 7
    INT32 = 8
    INT64 = 9
    FLOAT64 = 10


class VectorType(enum.IntEnum):
    """Reference ``VectorType`` (``schema/types.fbs:14-17``)."""

    DENSE = 0
    SPARSE = 1


class DistanceMetric(enum.IntEnum):
    """Reference ``DistanceMetric`` (``schema/types.fbs:20-25``)."""

    L2 = 0
    INNER_PRODUCT = 1
    COSINE = 2
    CUSTOM = 3


class CompressionAlgorithm(enum.IntEnum):
    """Reference ``CompressionAlgorithm`` (``schema/types.fbs:28-32``).

    ZLIB is implemented natively (stdlib); LZ4/ZSTD are recognised but
    gated on optional codecs being importable.
    """

    NONE = 0
    LZ4 = 1
    ZSTD = 2
    ZLIB = 3


class TombstoneFormat(enum.IntEnum):
    """Reference ``TombstoneFormat`` (``schema/types.fbs:35-39``)."""

    NONE = 0
    BITMAP = 1
    SORTED_LIST = 2


class IndexKind(enum.IntEnum):
    """Reference ``Index`` union members (``schema/index.fbs:6-11``)."""

    NONE = 0
    FLAT = 1
    IVF = 2
    HNSW = 3
    CUSTOM = 4


# numpy dtype mapping -------------------------------------------------------

# numpy has no bfloat16 of its own. The JAX package takes one from
# ml_dtypes; the port imports no such package. It holds a BFLOAT16 block on
# the host as the values' 16-bit patterns in uint16 (storage_dtype), and
# numpy_dtype(BFLOAT16) raises TypeError: no numpy arithmetic on those bits
# means anything. f32_to_bf16_bits and bf16_bits_to_f32 convert.
_BF16_BITS = np.dtype("<u2")

_NP_BY_DTYPE = {
    DataType.FLOAT32: np.dtype("<f4"),
    DataType.FLOAT16: np.dtype("<f2"),
    DataType.INT8: np.dtype("i1"),
    DataType.UINT8: np.dtype("u1"),
    DataType.UINT32: np.dtype("<u4"),
    DataType.UINT64: np.dtype("<u8"),
    DataType.STRING_REF: np.dtype("<u4"),
    DataType.INT32: np.dtype("<i4"),
    DataType.INT64: np.dtype("<i8"),
    DataType.FLOAT64: np.dtype("<f8"),
}

# dtypes allowed for vector blocks (vs metadata columns)
VECTOR_DTYPES = frozenset(
    {
        DataType.FLOAT32,
        DataType.FLOAT16,
        DataType.BFLOAT16,
        DataType.INT8,
        DataType.UINT8,
    }
)


def numpy_dtype(dtype: DataType) -> np.dtype:
    """The little-endian numpy dtype backing an MVT ``DataType``."""
    try:
        return _NP_BY_DTYPE[DataType(dtype)]
    except KeyError as exc:  # BFLOAT16 without ml_dtypes
        raise TypeError(f"no numpy dtype for {dtype!r}") from exc


def storage_dtype(dtype: DataType) -> np.dtype:
    """The numpy dtype that holds a block's bytes on the host:
    :func:`numpy_dtype`, or uint16 bit patterns for BFLOAT16."""
    if DataType(dtype) == DataType.BFLOAT16:
        return _BF16_BITS
    return numpy_dtype(dtype)


def element_size(dtype: DataType) -> int:
    """Bytes per element (reference ``element_size`` maps, e.g.
    ``src/vectors/mem.rs:178-186``)."""
    return storage_dtype(dtype).itemsize


def f32_to_bf16_bits(x) -> np.ndarray:
    """bfloat16 bit patterns (uint16) of ``x`` rounded from f32 to nearest
    even, as ``ml_dtypes``' ``astype`` rounds: subnormals kept, infinities
    kept, a NaN becomes the quiet NaN 0x7FC0 with its sign."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    rounded = (u + (0x7FFF + ((u >> 16) & 1))) >> 16
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    out = np.where(nan, ((u >> 16) & 0x8000) | 0x7FC0, rounded)
    return out.astype(_BF16_BITS)


def bf16_bits_to_f32(bits) -> np.ndarray:
    """The f32 values of bfloat16 bit patterns (exact: ``bits << 16``)."""
    u = np.asarray(bits, dtype=_BF16_BITS).astype(np.uint32) << 16
    return u.view(np.float32)


def sublane_multiple(dtype: DataType) -> int:
    """Row-count padding multiple for a vector block of this dtype."""
    return SUBLANES_BY_ITEMSIZE.get(element_size(dtype), 8)


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def padded_rows_for(num_rows: int, dtype: DataType) -> int:
    """Physical row count of a tile-padded block (≥1 tile even when empty)."""
    return round_up(max(num_rows, 1), sublane_multiple(dtype))


def padded_dim_for(dim: int, pad_dims: bool) -> int:
    """Physical per-row element count; padded to the 128-lane boundary when
    ``pad_dims`` (the default for spaces intended for TPU search)."""
    if pad_dims:
        return round_up(max(dim, 1), LANES)
    return dim
