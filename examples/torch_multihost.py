"""Multi-process distributed search on the PyTorch + CUDA port: a
2-process ``torch.distributed`` group on one machine (each process
standing in for one host with its own shards).

The counterpart of ``examples/multihost.py``. On a cluster each host runs
the same program (one process per host, the same rendezvous); here the
two "hosts" are subprocesses of this script, so the whole flow runs
anywhere: the rendezvous, per-host slice loading (each process uploads
ONLY the rows of its own shards), one global search, the same answer on
every process.

The backend: NCCL where each rank has a card of its own; gloo where the
ranks share one card (NCCL refuses two ranks on one card) or run on the
CPU.

    python examples/torch_multihost.py [--device cuda|cpu]

Worker flow (``--worker``):
  1. ``parallel.distributed.initialize(coordinator, 2, rank, backend)``
  2. ``DistributedSearcher(space, global_mesh(...))``: loads this host's
     slice only
  3. ``searcher.search(queries, k)``: one global search; every process
     gets the same answer.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N, DIM, K, NDEV = 50_000, 64, 5, 2  # NDEV shards per "host"
WORKER_TIMEOUT = 300  # seconds: a hung rendezvous fails the run


def plan(device: str) -> tuple[str, list[str]]:
    """The backend and each rank's device: a card each under NCCL where
    there are two, else both ranks on ``device`` under gloo."""
    import torch

    from metrovector_tpu_torch.engine import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        return "nccl", ["cuda:0", "cuda:1"]
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return "gloo", [str(dev)] * 2


def worker(coord: str, pid: int, backend: str, device: str, path: str,
           out_path: str) -> None:
    import numpy as np
    import torch

    from metrovector_tpu_torch import Reader
    from metrovector_tpu_torch.parallel import distributed as dist

    dist.initialize(coord, 2, pid, backend=backend)
    try:
        mesh = dist.global_mesh(devices=[device] * NDEV)
        searcher = dist.DistributedSearcher(Reader.open(path).vector_space("corpus"), mesh)
        per = searcher.rows_per_shard
        owned = [(mesh.first_shard() + j) * per for j in range(len(searcher.data))]
        print(f"[host {torch.distributed.get_rank()}] {len(mesh.devices)} local "
              f"devices, shard row starts {owned}", flush=True)
        queries = np.random.default_rng(7).standard_normal((4, DIM)).astype(np.float32)
        res = searcher.search(queries, k=K)
        with open(out_path, "w") as f:
            json.dump(res.indices.tolist(), f)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    import metrovector_tpu_torch as mvt

    backend, devices = plan(args.device)
    rng = np.random.default_rng(0)
    data = rng.standard_normal((N, DIM)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        b = mvt.Builder()
        b.add_vector_space("corpus", dim=DIM)
        b.add_vectors("corpus", data)
        path = os.path.join(tmp, "corpus.mvt")
        b.build().save(path)
        print(f"built {N}x{DIM} corpus -> {path}")
        print(f"backend {backend}: rank 0 on {devices[0]}, rank 1 on {devices[1]}")

        # A file store: the rendezvous needs no port.
        coord = "file://" + os.path.join(tmp, "rendezvous")
        outs = [path + f".{i}.json" for i in range(2)]
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK")}
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 coord, str(i), backend, devices[i], path, outs[i]],
                env=env,
            )
            for i in range(2)
        ]
        try:
            for p in procs:
                if p.wait(timeout=WORKER_TIMEOUT) != 0:
                    raise AssertionError(f"worker exited {p.returncode}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = [json.load(open(o)) for o in outs]
    if results[0] != results[1]:
        raise AssertionError("hosts disagreed")
    queries = np.random.default_rng(7).standard_normal((4, DIM)).astype(np.float32)
    d2 = ((queries[:, None, :] - data[None, :, :]) ** 2).sum(-1)
    oracle = np.argsort(d2, axis=1, kind="stable")[:, :K]
    if not np.array_equal(np.asarray(results[0]), oracle):
        raise AssertionError("oracle mismatch")
    print(f"both hosts returned identical, oracle-exact top-{K} ids")
    print("first query's top ids:", results[0][0])
    return {"indices": np.asarray(results[0]), "backend": backend}


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6],
               sys.argv[7])
    else:
        main()
