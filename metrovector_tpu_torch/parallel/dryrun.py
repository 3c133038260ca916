"""The multi-device dry run: every sharded path of the port once, on tiny
shapes, each held to the float64 oracle's rule or to the resident search.

The counterpart of ``dryrun_multichip`` in the JAX package's driver entry
points. Seven checks over a mesh of ``n_devices`` shards:

1. sharded exact top-k (K1 on each shard, one merge of the lists);
2. the same with a row filter riding each shard's validity plane;
3. sharded PQ (K2 on each shard) with each shard's exact re-rank (K3);
4. the 2-D (query x shard) grid (``n_devices`` >= 4 and even);
5. the sharded stream, each shard streaming its rows from host memory;
6. sharded sparse search (K4) with one planted row wider than the ELL
   layout, which goes to its shard's overflow tail;
7. two gloo processes, each holding half the shards and reading only its
   own rows, spawned from this module (``--worker``).

The mesh is one shard per card where ``device`` is ``"cuda"`` and there are
``n_devices`` cards, else ``n_devices`` shards all on ``device`` (``cuda:0
x 4`` on one card; ``cpu x 8`` on the host). Run on the card unless asked
for the CPU::

    python -m metrovector_tpu_torch.parallel.dryrun N [--device cpu]

A check that fails raises, and the command exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..engine import resolve_device
from ..format import Builder, DistanceMetric, Reader, VectorType
from ..index.pq import encode_pq, reconstruct_pq, train_pq
from ..ops.distances import numpy_oracle
from .distributed import DistributedSearcher, global_mesh, initialize
from .mesh import make_mesh, make_mesh_2d, replicate, shard_rows
from .sharded_search import grid_sharded_topk, sharded_pq_topk, sharded_topk
from .sparse_sharded import ShardedSparseSearchEngine
from .streaming import ShardedStreamingSearcher

WORKER_TIMEOUT = 240  # seconds a rank of check 7 may take, start-up included
# The package's root, for the ranks' ``python -m``.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _mesh_devices(n: int, device) -> list[torch.device]:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        if torch.cuda.device_count() >= n:
            return list(make_mesh(n).devices)
        dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * n


def _check(ok: bool, what: str, n: int) -> None:
    if not ok:
        raise AssertionError(f"{what} diverged on {n} devices")
    print(f"dryrun_multichip({n}): {what} OK", flush=True)


def _rows(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _worker(argv: list[str]) -> None:
    """One rank of check 7: ``coordinator rank path out.json shards device``."""
    coord, rank, path, out, shards, device = argv
    initialize(coord, 2, int(rank), backend="gloo")
    try:
        mesh = global_mesh(devices=[device] * int(shards))
        res = DistributedSearcher(Reader.open(path).vector_space("v"), mesh).search(
            np.random.default_rng(7).standard_normal((5, 24)).astype(np.float32), k=9)
        with open(out, "w") as f:
            json.dump({"rank": torch.distributed.get_rank(),
                       "indices": res.indices.tolist()}, f)
    finally:
        torch.distributed.destroy_process_group()


def _two_processes(n: int, device: torch.device, rng, tmp: str) -> None:
    data = rng.standard_normal((900, 24)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=24)
    b.add_vectors("v", data)
    path = os.path.join(tmp, "dryrun_mp.mvt")
    b.build().save(path)
    coord = "file://" + os.path.join(tmp, "rendezvous")  # no port to race for
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "RANK")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "metrovector_tpu_torch.parallel.dryrun", "--worker", coord,
         str(r), path, outs[r], str(max(1, n // 2)), str(device)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"two-process check: rank {r} exited {p.returncode}:\n"
                                 f"{logs[r]}")
    got = [json.load(open(o)) for o in outs]
    mq = np.random.default_rng(7).standard_normal((5, 24)).astype(np.float32)
    _, want = numpy_oracle(mq, data, 9, DistanceMetric.L2)
    _check([g["rank"] for g in got] == [0, 1] and got[0]["indices"] == got[1]["indices"]
           and np.array_equal(np.asarray(got[0]["indices"]), want),
           "2-process gloo cluster", n)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the seven checks (module docstring) over ``n_devices`` shards on
    ``device``. Prints one line per check; raises on the first that
    fails. Returns the names of the checks that ran."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"n_devices must be >= 1, got {n}")
    devices = _mesh_devices(n, device)
    mesh = make_mesh(devices=devices)
    metric = DistanceMetric.L2
    ran = []

    rng = np.random.default_rng(0)
    rows, d, q, k = 64 * n, 128, 4, 5
    db = rng.standard_normal((rows, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    norms = (db.astype(np.float64) ** 2).sum(1).astype(np.float32)
    db_s, norms_s = shard_rows(db, mesh), shard_rows(norms, mesh)
    q_r = replicate(queries, mesh)

    _, idx = sharded_topk(q_r, db_s, norms_s, rows, k, metric, mesh)
    _, oi = numpy_oracle(queries, db, k, metric)
    _check(np.array_equal(_rows(idx), oi), "sharded exact top-k", n)
    ran.append("sharded exact")

    fmask = (rng.random(rows) < 0.5).astype(np.float32)
    fmask[:2] = [1.0, 0.0]
    _, fidx = sharded_topk(q_r, db_s, norms_s, rows, k, metric, mesh,
                           valid_mask=shard_rows(fmask, mesh))
    _, foi = numpy_oracle(queries, db, k, metric, valid_mask=fmask)
    _check(np.array_equal(_rows(fidx), foi), "filtered sharded search", n)
    ran.append("filtered sharded")

    books = train_pq(db, m=4, ksub=16, iters=3, device=devices[0])
    codes = encode_pq(db, books, device=devices[0])
    recon = reconstruct_pq(codes, books)
    rnorms = np.einsum("ij,ij->i", recon, recon).astype(np.float32)
    _, i2 = sharded_pq_topk(q_r, shard_rows(codes, mesh), replicate(books, mesh),
                            shard_rows(rnorms, mesh), rows, k, metric, mesh, db=db_s,
                            db_norms=norms_s, rerank=rows // n)
    _check(np.array_equal(_rows(i2), oi), "sharded PQ + rerank", n)
    ran.append("sharded PQ + rerank")

    if n >= 4 and n % 2 == 0:
        mesh2 = make_mesh_2d(2, n // 2, devices=devices)
        q2 = rng.standard_normal((8, d)).astype(np.float32)
        _, i3 = grid_sharded_topk(torch.from_numpy(q2), shard_rows(db, mesh2, axis="shard"),
                                  shard_rows(norms, mesh2, axis="shard"), rows, k, metric,
                                  mesh2)
        _, oi2 = numpy_oracle(q2, db, k, metric)
        _check(np.array_equal(_rows(i3), oi2), "2-D query×shard grid", n)
        ran.append("2-D grid")

    with tempfile.TemporaryDirectory() as tmp:
        b = Builder()
        b.add_vector_space("v", dim=d)
        b.add_vectors("v", db)
        path = os.path.join(tmp, "dryrun_stream.mvt")
        b.build().save(path)
        res = ShardedStreamingSearcher(Reader.open(path).vector_space("v"), mesh=mesh,
                                       chunk_rows=16).search(queries, k=k)
        _check(np.array_equal(res.indices, _rows(idx)), "sharded streamed search", n)
        ran.append("sharded streamed")

        sb = Builder()
        sb.add_vector_space("sp", dim=64, vector_type=VectorType.SPARSE)
        sprows = []
        for i in range(96):
            nz = 40 if i == 7 else 2 + int(rng.integers(0, 6))
            cols = rng.choice(64, size=nz, replace=False)
            sprows.append((cols, rng.standard_normal(nz).astype(np.float32)))
        sb.add_sparse_vectors("sp", sprows)
        spath = os.path.join(tmp, "dryrun_sparse.mvt")
        sb.build().save(spath)
        sq = rng.standard_normal((3, 64)).astype(np.float32)
        sres = ShardedSparseSearchEngine(Reader.open(spath).vector_space("sp"),
                                         mesh).search(sq, k=k)
        dense = np.zeros((96, 64), np.float32)
        for i, (c, v) in enumerate(sprows):
            dense[i, c] = v
        _, soi = numpy_oracle(sq, dense, k, metric)
        _check(np.array_equal(sres.indices, soi), "sharded sparse search", n)
        ran.append("sharded sparse")

        _two_processes(n, devices[0], rng, tmp)
        ran.append("2-process gloo")
    return {"checks": ran, "devices": [str(x) for x in devices]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        _worker(argv[1:])
        return 0
    ap = argparse.ArgumentParser(prog="python -m metrovector_tpu_torch.parallel.dryrun",
                                 description="the multi-device dry run")
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
