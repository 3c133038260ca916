"""Large-dataset generation + throughput measurement harness on the
PyTorch + CUDA port.

The counterpart of ``examples/large_dataset.py``: the same generator,
seed, options and printed lines (chunked build, file size and page
analysis, open latency, sequential and random read throughput), then the
upload to the card and the fused search through K1, each phase timed by
the port's :class:`~metrovector_tpu_torch.utils.PhaseTimer`. The upload
phase synchronizes the card, so it times the copy and not its enqueue.

Run:  python examples/torch_large_dataset.py --vectors 100000 --dimensions 256
      python examples/torch_large_dataset.py --size 2.5   # 873,813 x 768 f32
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import metrovector_tpu_torch as mvt
from metrovector_tpu_torch.utils import PhaseTimer


def _resolve_shape(args) -> tuple[int, int]:
    """The reference's GB-targeted sizing: with ``--size`` given and
    vectors/dimensions unset, derive them from the byte target (default
    dim 768, the common sentence-transformer width)."""
    n, d = args.vectors, args.dimensions
    if args.size is None:
        return n or 100_000, d or 256
    s = args.size.lower().removesuffix("gb")
    try:
        target_gb = float(s)
    except ValueError:
        target_gb = 2.5  # the reference's default
    target_bytes = int(target_gb * 1024**3)
    if not n and not d:
        d = 768
        n = target_bytes // (d * 4)
    elif not n:
        n = target_bytes // (d * 4)
    elif not d:
        d = target_bytes // (n * 4)
    return n, d


def _page_size_analysis(file_size: int) -> None:
    """OS page-size impact of the mmap."""
    print(f"  file size on disk: {file_size / 1024**3:.2f} GB")
    try:
        page = os.sysconf("SC_PAGESIZE")
    except (ValueError, OSError):
        page = 4096  # the reference's non-unix assumption
    print(f"  OS page size: {page // 1024} KB")
    print(f"  pages needed: {-(-file_size // page)}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vectors", type=int, default=0)
    ap.add_argument("--dimensions", type=int, default=0)
    ap.add_argument("--size", default=None, metavar="GB",
                    help="target file size, e.g. '2.5' or '2.5GB' "
                         "(derives --vectors/--dimensions when unset)")
    ap.add_argument("--chunk", type=int, default=10_000,
                    help="build chunk size (reference default 10k rows)")
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--path", default=None,
                    help="where to write the file (default: a temporary directory, "
                         "removed at the end)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.vectors, args.dimensions = _resolve_shape(args)
    device = torch.device(args.device)

    timer = PhaseTimer()
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        path = args.path or os.path.join(tmp, "large.mvt")

        # -- chunked build --------------------------------------------------
        with timer.phase("generate+build"):
            b = mvt.Builder()
            b.add_vector_space("vectors", dim=args.dimensions)
            for start in range(0, args.vectors, args.chunk):
                n = min(args.chunk, args.vectors - start)
                b.add_vectors(
                    "vectors",
                    rng.standard_normal((n, args.dimensions)).astype(np.float32)
                )
            built = b.build()
        with timer.phase("save"):
            built.save(path)
        del built, b
        size = os.path.getsize(path)
        print(f"file: {path}  {size / 1e6:,.1f} MB")
        _page_size_analysis(size)

        # -- open latency -----------------------------------------------------
        with timer.phase("open"):
            r = mvt.Reader.open(path)
        space = r.vector_space("vectors")

        # -- sequential read throughput ---------------------------------------
        n_seq = min(args.vectors, 200_000)
        checksum = 0.0  # anti-DCE, like the reference's running checksum
        t0 = time.perf_counter()
        for chunk in space.stream_vectors(0, 4096):
            for v in chunk[: len(chunk)]:
                checksum += float(v.as_numpy()[0])
            if chunk[-1].index >= n_seq - 1:
                break
        dt = time.perf_counter() - t0
        print(f"sequential (row views): {n_seq / dt:,.0f} vectors/s  "
              f"(checksum {checksum:.1f})")

        # bulk zero-copy path: what sequential access actually costs on MVT
        t0 = time.perf_counter()
        total = float(space.to_numpy()[:n_seq].sum(dtype=np.float64))
        dt = time.perf_counter() - t0
        print(f"sequential (bulk view): {n_seq / dt:,.0f} vectors/s  (sum {total:.1f})")

        # -- random access throughput -----------------------------------------
        idx = rng.integers(0, args.vectors, 50_000)
        t0 = time.perf_counter()
        acc = 0.0
        for i in idx:
            acc += float(space.get_vector(int(i)).as_numpy()[0])
        dt = time.perf_counter() - t0
        print(f"random access: {len(idx) / dt:,.0f} vectors/s")

        # -- device upload + search -------------------------------------------
        with timer.phase("device upload"):
            engine = mvt.SearchEngine(space, device=device)
            _sync(device)
        queries = rng.standard_normal((args.queries, args.dimensions)).astype(np.float32)
        with timer.phase("search warmup"):
            engine.search(queries, k=10)
        t0 = time.perf_counter()
        res = engine.search(queries, k=10)
        dt = time.perf_counter() - t0
        print(f"fused search: {args.queries} queries in {dt * 1e3:.1f} ms "
              f"-> {args.queries / dt:,.0f} QPS")

        print("\n" + timer.report())
    return {"indices": res.indices, "scores": res.scores, "queries": queries,
            "engine": engine, "timer": timer, "shape": (args.vectors, args.dimensions)}


if __name__ == "__main__":
    main()
