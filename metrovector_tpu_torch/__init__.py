"""metrovector_tpu_torch — the PyTorch + CUDA port of metrovector_tpu.

Self-contained: the port carries its own copy of every host layer it uses
(``errors``, ``format``, ``vectors``, ``utils``, the native codec and the
``MicroBatcher``) and imports nothing of :mod:`metrovector_tpu`. Both
packages read and write the same MVT bytes (``tests/test_torch_format.py``).
Every line of device code is owned here: the dense engine, the PQ, IVF and
IVF-PQ indexes and the sparse engine run on a ``torch.device`` and their searches go through
hand-written CUDA kernels for Hopper (``ops/csrc``); ``StreamingSearcher``
streams a host-resident corpus through the dense kernel; the ``parallel``
package shards the dense, PQ and sparse searches and the stream over a
mesh of devices and over ``torch.distributed`` processes; HNSW runs on the
host, and the ``Database`` facade opens a file and routes each space to one
of them.

Module names mirror the JAX package, so each module's counterpart sits at
the same path. The compute-path names below import lazily, so
``import metrovector_tpu_torch`` loads neither torch nor any kernel.
"""

from . import errors
from .errors import MvtError
from .format import (
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
from .vectors import (
    AccessPattern,
    DimensionSlice,
    Vector,
    VectorChunkIterator,
    VectorSlice,
    VectorSpace,
)

_LAZY = {
    "Database": "metrovector_tpu_torch.database",
    "HNSWIndex": "metrovector_tpu_torch.index.hnsw",
    "SearchEngine": "metrovector_tpu_torch.engine",
    "DeviceSpace": "metrovector_tpu_torch.engine",
    "SearchResult": "metrovector_tpu_torch.engine",
    "PreparedFilter": "metrovector_tpu_torch.engine",
    "PreparedQueries": "metrovector_tpu_torch.engine",
    "RadiusResult": "metrovector_tpu_torch.engine",
    "PQIndex": "metrovector_tpu_torch.index.pq",
    "IVFIndex": "metrovector_tpu_torch.index.ivf",
    "IVFPQIndex": "metrovector_tpu_torch.index.ivfpq",
    "train_ivfpq": "metrovector_tpu_torch.index.ivfpq",
    "bucket_layout": "metrovector_tpu_torch.index.ivf",
    "train_kmeans": "metrovector_tpu_torch.index.ivf",
    "train_pq": "metrovector_tpu_torch.index.pq",
    "encode_pq": "metrovector_tpu_torch.index.pq",
    "pack_codes4": "metrovector_tpu_torch.index.pq",
    "unpack_codes4": "metrovector_tpu_torch.index.pq",
    "reconstruct_pq": "metrovector_tpu_torch.index.pq",
    "SparseSearchEngine": "metrovector_tpu_torch.sparse",
    "StreamingSearcher": "metrovector_tpu_torch.parallel.streaming",
    "ShardedDeviceSpace": "metrovector_tpu_torch.parallel.sharded_search",
    "DistributedSearcher": "metrovector_tpu_torch.parallel.distributed",
    "make_mesh": "metrovector_tpu_torch.parallel.mesh",
    "sharded_topk": "metrovector_tpu_torch.parallel.sharded_search",
    # the batcher: duck-typed on the engine's _launch / _finalize /
    # prepare_filter / space.dim
    "MicroBatcher": "metrovector_tpu_torch.serving",
    "BatcherStats": "metrovector_tpu_torch.serving",
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
    "Database",
    "DeviceSpace",
    "DimensionSlice",
    "DistributedSearcher",
    "DistanceMetric",
    "HNSWIndex",
    "IVFIndex",
    "IVFPQIndex",
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
    "ShardedDeviceSpace",
    "SparseSearchEngine",
    "StreamingSearcher",
    "TombstoneFormat",
    "Vector",
    "VectorChunkIterator",
    "VectorSlice",
    "VectorSpace",
    "VectorType",
    "Writer",
    "bucket_layout",
    "builder_from_reader",
    "compact",
    "encode_pq",
    "errors",
    "make_mesh",
    "pack_codes4",
    "reconstruct_pq",
    "rewrite_hints",
    "sharded_topk",
    "train_ivfpq",
    "train_kmeans",
    "train_pq",
    "unpack_codes4",
]
