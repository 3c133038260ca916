"""Subprocess entry point for ``tests/test_torch_distributed.py``: one rank
of a gloo process group over the port's CPU path. Imports no JAX.

Run as::

    python tests/_torch_mp_worker.py <coordinator> <num_processes> <rank> \
        <mvt_path> <out_json> <local_devices>

The rank holds ``local_devices`` CPU shards of the file's space ``v``,
read from its own rows only, checks that they are exactly those rows,
runs the same searches as every other rank (``DistributedSearcher``,
``ShardedStreamingSearcher`` and ``dim_sharded_topk`` over the group) and
writes its answers to ``out_json`` for the parent to compare across ranks
and with the oracle.
"""

import json
import os
import sys


def main() -> None:
    coord, nproc, rank, path, out, ndev = sys.argv[1:7]
    nproc, rank, ndev = int(nproc), int(rank), int(ndev)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import numpy as np
    import torch

    from metrovector_tpu_torch import Reader
    from metrovector_tpu_torch.parallel import ShardedStreamingSearcher, dim_sharded_topk
    from metrovector_tpu_torch.parallel import distributed as dist

    dist.initialize(coord, nproc, rank, backend="gloo")
    try:
        mesh = dist.global_mesh(devices=["cpu"] * ndev)
        assert mesh.world == nproc and mesh.rank == rank, (mesh.world, mesh.rank)
        sp = Reader.open(path).vector_space("v")
        searcher = dist.DistributedSearcher(sp, mesh)
        # Only this rank's shards, and exactly their rows of the file.
        per, block = searcher.rows_per_shard, sp.padded_array()
        owned = []
        for j, shard in enumerate(searcher.data):
            s = mesh.first_shard() + j
            rows = block[s * per:(s + 1) * per]
            assert np.array_equal(shard.numpy()[:len(rows)], rows), s
            assert not shard.numpy()[len(rows):].any(), s
            owned.append(s)
        queries = np.random.default_rng(7).standard_normal((5, 24)).astype(np.float32)
        res = searcher.search(queries, k=9)
        streamed = ShardedStreamingSearcher(sp, mesh, chunk_rows=64).search(queries, k=9)
        live = np.ones(sp.num_vectors, np.float32)
        live[sp.tombstone_mask()] = 0.0
        dim_s, dim_i = dim_sharded_topk(
            torch.from_numpy(queries), np.ascontiguousarray(sp.to_numpy()),
            torch.from_numpy(np.asarray(sp.norms()[:sp.num_vectors])), sp.num_vectors, 9,
            sp.metric, mesh, valid_mask=live)
        with open(out, "w") as f:
            json.dump({"rank": rank, "shards": owned, "indices": res.indices.tolist(),
                       "scores": res.scores.tolist(), "ids": res.ids.tolist(),
                       "streamed": streamed.indices.tolist(),
                       "streamed_scores": streamed.scores.tolist(),
                       "dim_indices": dim_i.tolist()}, f)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
