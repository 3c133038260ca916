"""MVT file format: tile-aligned columnar storage for vector collections.

The port's own copy of the JAX package's layer of the same name: the
two read and write the same bytes.
"""

from .builder import Builder, BuiltFile, VectorSpaceHandle, Writer, rewrite_hints
from .compact import builder_from_reader, compact
from .constants import (
    BLOCK_ALIGN,
    FORMAT_VERSION,
    LANES,
    MAGIC,
    CompressionAlgorithm,
    DataType,
    DistanceMetric,
    IndexKind,
    TombstoneFormat,
    VectorType,
)
from .manifest import (
    BlockInfo,
    ColumnInfo,
    IndexInfo,
    Manifest,
    QuantizationInfo,
    SpaceInfo,
    TombstoneInfo,
)
from .reader import Reader

__all__ = [
    "BLOCK_ALIGN",
    "FORMAT_VERSION",
    "LANES",
    "MAGIC",
    "BlockInfo",
    "Builder",
    "BuiltFile",
    "ColumnInfo",
    "CompressionAlgorithm",
    "DataType",
    "DistanceMetric",
    "IndexInfo",
    "IndexKind",
    "Manifest",
    "QuantizationInfo",
    "Reader",
    "SpaceInfo",
    "TombstoneFormat",
    "TombstoneInfo",
    "VectorSpaceHandle",
    "VectorType",
    "Writer",
    "builder_from_reader",
    "compact",
    "rewrite_hints",
]
