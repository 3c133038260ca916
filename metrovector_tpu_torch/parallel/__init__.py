"""Past one device: the mesh and row sharding (:mod:`.mesh`), sharded
exact, PQ and sparse search (:mod:`.sharded_search`,
:mod:`.sparse_sharded`), several processes on ``torch.distributed``
(:mod:`.distributed`), and search of a host-resident corpus streamed
through the card, on one device or sharded (:mod:`.streaming`). The
counterpart of :mod:`metrovector_tpu.parallel`; importing it starts no
process group and touches no card."""

from .distributed import DistributedSearcher, initialize, load_space_sharded
from .mesh import (
    QUERY_AXIS,
    SHARD_AXIS,
    make_mesh,
    make_mesh_2d,
    replicate,
    rows_per_shard,
    shard_rows,
)
from .sharded_search import (
    ShardedDeviceSpace,
    dim_sharded_topk,
    grid_sharded_topk,
    query_sharded_topk,
    sharded_pq_topk,
    sharded_topk,
)
from .sparse_sharded import ShardedSparseSearchEngine, sharded_sparse_topk
from .streaming import ShardedStreamingSearcher, StreamingSearcher

__all__ = [
    "QUERY_AXIS",
    "SHARD_AXIS",
    "DistributedSearcher",
    "ShardedDeviceSpace",
    "ShardedSparseSearchEngine",
    "ShardedStreamingSearcher",
    "StreamingSearcher",
    "dim_sharded_topk",
    "grid_sharded_topk",
    "initialize",
    "load_space_sharded",
    "make_mesh",
    "make_mesh_2d",
    "query_sharded_topk",
    "replicate",
    "rows_per_shard",
    "shard_rows",
    "sharded_pq_topk",
    "sharded_sparse_topk",
    "sharded_topk",
]
