"""metrovector_tpu_torch — the PyTorch + CUDA port of metrovector_tpu.

The same MVT file format and host layers as :mod:`metrovector_tpu` (they
import no JAX and are shared, not copied), with every line of device code
owned here: the engine and the PQ index run on a ``torch.device`` and
their searches go through hand-written CUDA kernels for Hopper
(``ops/csrc``).

Module names mirror the JAX package, so each module's counterpart sits at
the same path. The compute-path names below import lazily, so
``import metrovector_tpu_torch`` loads neither torch nor any kernel.
"""

from metrovector_tpu import errors
from metrovector_tpu.errors import MvtError
from metrovector_tpu.format import (
    Builder,
    BuiltFile,
    CompressionAlgorithm,
    DataType,
    DistanceMetric,
    IndexKind,
    Reader,
    TombstoneFormat,
    VectorType,
    Writer,
    builder_from_reader,
    compact,
    rewrite_hints,
)
from metrovector_tpu.vectors import (
    AccessPattern,
    DimensionSlice,
    Vector,
    VectorChunkIterator,
    VectorSlice,
    VectorSpace,
)

_LAZY = {
    "SearchEngine": "metrovector_tpu_torch.engine",
    "DeviceSpace": "metrovector_tpu_torch.engine",
    "SearchResult": "metrovector_tpu_torch.engine",
    "PreparedFilter": "metrovector_tpu_torch.engine",
    "PreparedQueries": "metrovector_tpu_torch.engine",
    "RadiusResult": "metrovector_tpu_torch.engine",
    "PQIndex": "metrovector_tpu_torch.index.pq",
    "train_pq": "metrovector_tpu_torch.index.pq",
    "encode_pq": "metrovector_tpu_torch.index.pq",
    "pack_codes4": "metrovector_tpu_torch.index.pq",
    "unpack_codes4": "metrovector_tpu_torch.index.pq",
    "reconstruct_pq": "metrovector_tpu_torch.index.pq",
    # the shared batcher: duck-typed on the engine's _launch / _finalize /
    # prepare_filter / space.dim
    "MicroBatcher": "metrovector_tpu.serving",
    "BatcherStats": "metrovector_tpu.serving",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AccessPattern",
    "BatcherStats",
    "Builder",
    "BuiltFile",
    "CompressionAlgorithm",
    "DataType",
    "DeviceSpace",
    "DimensionSlice",
    "DistanceMetric",
    "IndexKind",
    "MicroBatcher",
    "MvtError",
    "PQIndex",
    "PreparedFilter",
    "PreparedQueries",
    "RadiusResult",
    "Reader",
    "SearchEngine",
    "SearchResult",
    "TombstoneFormat",
    "Vector",
    "VectorChunkIterator",
    "VectorSlice",
    "VectorSpace",
    "VectorType",
    "Writer",
    "builder_from_reader",
    "compact",
    "encode_pq",
    "errors",
    "pack_codes4",
    "reconstruct_pq",
    "rewrite_hints",
    "train_pq",
    "unpack_codes4",
]
