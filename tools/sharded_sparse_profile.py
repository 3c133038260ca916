#!/usr/bin/env python3
"""Where a sharded sparse search spends its time on one card, beside the
resident one: ``chip_smoke.py``'s ``sparse1m`` corpus (1M rows x 30,522
terms, 48 entries a row, IP; its seed and queries), 4 shards resident on
cuda:0, batch 256, k = 10.

    python3 tools/sharded_sparse_profile.py [--out FILE]

For ``SparseSearchEngine.search`` and ``ShardedSparseSearchEngine.search``
it prints the p50 of synchronized calls and, from ``torch.profiler`` over
three calls each, the CPU time by operator (self time, the top ten) and
the CUDA time by kernel, and the host time the search spends in each
step of ``ops/sparse_kernel.py``'s wrapper (timed by wrapping the step's
function). The last line is one JSON object of those numbers.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the smoke's corpus and queries)

RUNS = 7
SHARDS = 4


def _card() -> str:
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _p50(torch, fn, *args, **kw) -> float:
    fn(*args, **kw)
    walls = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def _steps(fn, *args, **kw) -> dict:
    """Host ms a call spends in each step of the K4 wrapper."""
    from metrovector_tpu_torch.ops import select, sparse_kernel

    spent: dict[str, float] = {}
    names = [(sparse_kernel, "_packed_postings"), (sparse_kernel, "_blocks_per_sm"),
             (sparse_kernel, "_check"), (select, "scratch"),
             (sparse_kernel, "_ell_topk_launch")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in names]

    def timed(label, real):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                spent[label] = spent.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
        return wrapper

    for mod, name, real in saved:
        setattr(mod, name, timed(name, real))
    try:
        t0 = time.perf_counter()
        fn(*args, **kw)
        spent["search"] = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)
    return spent


def _profile(torch, fn, *args, **kw) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn(*args, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn(*args, **kw)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    cpu = sorted(rows, key=lambda r: r.self_cpu_time_total, reverse=True)[:10]
    dev = [r for r in rows if getattr(r, "self_device_time_total", 0) > 0]
    dev = sorted(dev, key=lambda r: r.self_device_time_total, reverse=True)[:6]
    return {"cpu_ms": {r.key: r.self_cpu_time_total / 3e3 for r in cpu},
            "cuda_ms": {r.key: r.self_device_time_total / 3e3 for r in dev}}


def main() -> int:
    import torch

    out_path = None
    if len(sys.argv) == 3 and sys.argv[1] == "--out":
        out_path = sys.argv[2]
    elif len(sys.argv) != 1:
        print("usage: python3 tools/sharded_sparse_profile.py [--out FILE]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card")
    from metrovector_tpu_torch import (
        Builder, DistanceMetric, Reader, SparseSearchEngine, VectorType,
    )
    from metrovector_tpu_torch.ops._build import load
    from metrovector_tpu_torch.parallel import ShardedSparseSearchEngine, make_mesh

    card = _card()
    print(card, flush=True)
    load()
    rng = np.random.default_rng(12)  # the smoke's phase 11 corpus and queries
    cols, vals = cs._splade_corpus(rng)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sparse1m.mvt")
        b = Builder()
        b.add_vector_space("splade", dim=cs.SPARSE_DIM, vector_type=VectorType.SPARSE,
                           metric=DistanceMetric.INNER_PRODUCT)
        b.add_sparse_vectors("splade", zip(cols.reshape(cs.SPARSE_N, cs.SPARSE_NNZ),
                                           vals.reshape(cs.SPARSE_N, cs.SPARSE_NNZ)))
        b.build().save(path)
        del b, cols, vals
        space = Reader.open(path).vector_space("splade")
        mesh = make_mesh(devices=[torch.device("cuda", 0)] * SHARDS)
        engines = {"resident": SparseSearchEngine(space, device="cuda"),
                   "sharded": ShardedSparseSearchEngine(space, mesh)}
        q = cs._splade_queries(rng, 256)
        report = {"card": card}
        for name, eng in engines.items():
            row = {"p50_ms": _p50(torch, eng.search, q, k=10),
                   "host_steps_ms": _steps(eng.search, q, k=10),
                   **_profile(torch, eng.search, q, k=10)}
            report[name] = row
            print(f"{name}: p50 {row['p50_ms']:.4f} ms; host steps "
                  + ", ".join(f"{k} {v:.3f}" for k, v in row["host_steps_ms"].items())
                  + f" | {card}", flush=True)
            print(f"  CPU self ms a search: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in row["cpu_ms"].items()), flush=True)
            print(f"  CUDA ms a search: "
                  + ", ".join(f"{k[:60]} {v:.4f}" for k, v in row["cuda_ms"].items()),
                  flush=True)
    line = json.dumps(report)
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
