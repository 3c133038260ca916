"""Sharded search on a mesh of devices, on the PyTorch + CUDA port.

The counterpart of ``examples/sharded_search.py``, with the same data,
seed, assertions and printed lines: a 100,000 x 64 corpus row-sharded over
the mesh with one merge of the shards' top-k lists, the same corpus
streamed from host memory through the card, and a 2-D (query x shard)
grid. The mesh is one shard per visible card (``make_mesh()``), or
``--shards S`` shards all on ``--device`` (``make_mesh(devices=[device] *
S)``), so one card runs the 2-D grid with ``--shards 4``.

Run:  python examples/torch_sharded_search.py [--device cuda|cpu] [--shards S]
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import metrovector_tpu_torch as mvt
from metrovector_tpu_torch.engine import resolve_device
from metrovector_tpu_torch.parallel import (
    ShardedDeviceSpace,
    StreamingSearcher,
    grid_sharded_topk,
    make_mesh,
    make_mesh_2d,
    shard_rows as shard_rows_fn,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=None,
                    help="shards all on --device (default: one per visible card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if args.shards is None:
        mesh = make_mesh() if device.type == "cuda" else make_mesh(devices=[device])
    else:
        mesh = make_mesh(devices=[device] * args.shards)
    ndev = len(mesh.devices)
    print(f"devices: {ndev} x {mesh.devices[0].type}")

    rng = np.random.default_rng(0)
    data = rng.standard_normal((100_000, 64)).astype(np.float32)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        b = mvt.Builder()
        b.add_vector_space("corpus", dim=64)
        b.add_vectors("corpus", data)
        path = os.path.join(tmp, "corpus.mvt")
        b.build().save(path)

        space = mvt.Reader.open(path).vector_space("corpus")

        # ---- row-sharded over the mesh, one merge of the shards' lists ----
        sharded = ShardedDeviceSpace(space, mesh)
        queries = data[:4] + 0.05 * rng.standard_normal((4, 64)).astype(np.float32)
        res = sharded.search(queries, k=5)
        print("sharded top-1 per query:", res.indices[:, 0], "(expect 0..3)")
        shard_rows = sharded.rows_per_shard
        print(f"each device holds {shard_rows:,} rows "
              f"({shard_rows * 64 * 4 / 1e6:.1f} MB)")
        out["sharded"], out["sharded_scores"] = res.indices, res.scores

        # ---- host-DRAM streaming (corpora larger than the card) -----------
        stream = StreamingSearcher(space, chunk_rows=16_384, device=mesh.devices[0])
        res2 = stream.search(queries, k=5)
        if not np.array_equal(res.indices, res2.indices):
            raise AssertionError("the streamed result differs from the sharded one")
        print("streamed result identical to sharded result")
        out["streamed"] = res2.indices

        # ---- 2-D (query x shard) grid: the query batch split over the
        # query axis composed with row sharding --------------------------
        if ndev >= 4 and ndev % 2 == 0:
            mesh2 = make_mesh_2d(2, ndev // 2, devices=list(mesh.devices))
            norms = np.einsum("ij,ij->i", data, data, dtype=np.float64).astype(
                np.float32
            )
            big_batch = np.repeat(queries, 4, axis=0)  # 16 queries, 8 a query row
            s2, i2 = grid_sharded_topk(
                torch.from_numpy(big_batch),
                shard_rows_fn(data, mesh2, axis="shard"),
                shard_rows_fn(norms, mesh2, axis="shard"),
                data.shape[0], 5, mvt.DistanceMetric.L2, mesh2,
            )
            if not np.array_equal(i2.cpu().numpy()[::4], res.indices):
                raise AssertionError("the 2-D grid differs from the 1-D result")
            print("2-D query×shard grid matches the 1-D result")
            out["grid"] = i2.cpu().numpy()
    return out


if __name__ == "__main__":
    main()
