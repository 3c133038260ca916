#!/usr/bin/env python3
"""Time three ways to fill a pinned staging buffer from a mapped file, the
host's share of each chunk that ``StreamingSearcher`` streams.

    python3 tools/fill_rates.py [--out build/fill_rates.json]

Writes, under ``build/fill_rates/``, a file per shape of the streamed cases
(1M x 768 f16 N(0, 1) in chunks of 262,144 rows; 1M x 128 f32, 1M x 128
int8 and 10M x 96 int8, chunks of 131,072), opens it with ``Reader.open`` (the mapped
block ``StreamingSearcher`` reads), and copies every chunk of the corpus in
turn into one pinned buffer by: ``torch.Tensor.copy_`` from
``torch.from_numpy`` of the mapped rows (PyTorch's intra-op threads, what
``StreamingSearcher`` does), ``np.copyto`` (one thread), and a threaded
``memcpy`` in 1 MiB pieces over the OpenMP threads (:data:`THREADED_COPY`,
built here with ``g++``). The page cache is warmed by one pass first; the
methods then run in turns, ``--reps`` times each. Prints the GB/s of each
pass with the card's name and power limit, and the median of each method.
Needs a CUDA card (for the pinned buffer) and ``g++``; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CASES = (  # name, rows, dim, dtype, chunk rows
    ("f16 1M x 768", 1_000_000, 768, "float16", 262_144),
    ("f32 1M x 128", 1_000_000, 128, "float32", 131_072),
    ("int8 1M x 128", 1_000_000, 128, "int8", 131_072),
    ("int8 10M x 96 (deep10m's shape)", 10_000_000, 96, "int8", 131_072),
)


THREADED_COPY = r"""
#include <stddef.h>
#include <string.h>
extern "C" void threaded_copy(const unsigned char* src, unsigned char* dst, size_t n) {
    const size_t piece = (size_t)1 << 20;
    const long pieces = (long)((n + piece - 1) / piece);
#pragma omp parallel for schedule(static)
    for (long b = 0; b < pieces; b++) {
        const size_t lo = (size_t)b * piece;
        memcpy(dst + lo, src + lo, n - lo < piece ? n - lo : piece);
    }
}
"""


def _threaded_copy(work: str):
    """:data:`THREADED_COPY` built into ``work`` and loaded."""
    src, so = os.path.join(work, "threaded_copy.c"), os.path.join(work, "threaded_copy.so")
    with open(src, "w") as f:
        f.write(THREADED_COPY)
    subprocess.run(["g++", "-x", "c++", "-O3", "-fopenmp", "-fPIC", "-shared", src, "-o", so],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(so)
    lib.threaded_copy.restype = None
    lib.threaded_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    return lib


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def _write(path: str, n: int, d: int, dtype: str) -> None:
    from metrovector_tpu_torch import Builder, DataType

    rng = np.random.default_rng(0)
    if dtype == "int8":
        data = rng.integers(-128, 128, (n, d), dtype=np.int8)
        kind = DataType.INT8
    else:
        data = rng.standard_normal((n, d), dtype=np.float32).astype(dtype)
        kind = DataType.FLOAT16 if dtype == "float16" else DataType.FLOAT32
    b = Builder()
    b.add_vector_space("s", dim=d, dtype=kind)
    b.add_vectors("s", data)
    b.build().save(path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "fill_rates.json"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    from metrovector_tpu_torch import Reader

    if not torch.cuda.is_available():
        print("fill_rates: no CUDA card", file=sys.stderr)
        return 1
    card = _card()
    print(f"{card}; torch {torch.__version__}, {torch.get_num_threads()} intra-op "
          f"threads, {os.cpu_count()} cores")
    work = os.path.join(ROOT, "build", "fill_rates")
    os.makedirs(work, exist_ok=True)
    out = {"card": card, "cases": {}}
    try:
        lib = _threaded_copy(work)
        for name, n, d, dtype, chunk in CASES:
            path = os.path.join(work, "case.mvt")
            _write(path, n, d, dtype)
            block = Reader.open(path).vector_space("s").padded_array()
            buf = torch.empty((chunk, block.shape[1]),
                              dtype=torch.from_numpy(np.empty(0, block.dtype)).dtype,
                              pin_memory=True)
            dst = buf.numpy()
            bounds = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]

            def by_torch():
                for lo, hi in bounds:
                    buf[: hi - lo].copy_(torch.from_numpy(block[lo:hi]))

            def by_numpy():
                for lo, hi in bounds:
                    np.copyto(dst[: hi - lo], block[lo:hi])

            def by_threads():
                for lo, hi in bounds:
                    lib.threaded_copy(block[lo:hi].ctypes.data, dst.ctypes.data,
                                      block[lo:hi].nbytes)

            methods = {"torch copy_": by_torch, "np.copyto": by_numpy,
                       "threaded memcpy": by_threads}
            nbytes = block[:n].nbytes
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # from_numpy of a read-only map
                by_numpy()  # warm the page cache
                rates = {m: [] for m in methods}
                for rep in range(args.reps):
                    order = list(methods)[rep % 3:] + list(methods)[: rep % 3]
                    for m in order:
                        t0 = time.perf_counter()
                        methods[m]()
                        rates[m].append(nbytes / (time.perf_counter() - t0) / 1e9)
                if not np.array_equal(dst[: bounds[-1][1] - bounds[-1][0]],
                                      block[bounds[-1][0]:n]):
                    raise AssertionError(f"{name}: the last fill differs from the file")
            out["cases"][name] = {"bytes": nbytes, "chunk_rows": chunk, "gbps": rates}
            print(f"{name}, {nbytes / 1e6:.1f} MB in {len(bounds)} chunks of {chunk} rows: "
                  + "; ".join(f"{m} median {np.median(r):.2f} GB/s ("
                              + ", ".join(f"{x:.2f}" for x in r) + ")"
                              for m, r in rates.items()) + f" | {card}")
            del block, buf, dst
    finally:
        shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
