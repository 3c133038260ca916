#!/usr/bin/env python3
"""Time the sparse scan's build variants on one NVIDIA GPU.

    python3 tools/sparse_kernel_sweep.py [--out build/sparse_sweep.json]

Builds two variants of the port's kernels from this checkout, each in a
process of its own (the ``-D`` flags are part of the build directory's
hash, so each variant builds once):

* ``-DMVT_K4_ALL_TILES``: ``ell_topk`` with 16 and 32 rows a score tile at
  every query-group count (the default build has the shapes of
  ``ops/sparse_kernel.py::_tile_shape`` only);
* ``-DMVT_K4_SMEM_LIST_K=0``: lists of k <= 16 in device memory, through
  ``select.cuh``'s buffers, in place of the default's shared-memory lists.

On a ``sparse1m``-shaped ELL corpus made on the card (1M rows x 48 entries
over 30,522 terms, |N(0, 1)| values, seed 12) and queries of 256 nonzeros
it prints, with the card's name and power limit:

* ``ell_topk`` (k=10, inner product) at batches 256 and 32 for every
  built tile shape of the batch's query groups and of half as many (32·QG
  queries x ROWS rows), with the blocks an SM holds, each shape's answer
  identical to the default shape's;
* ``ell_topk`` k=10 at the default shape with lists in shared memory and
  in device memory, run in the order shared, device, device, shared;
* the default shape's ``ell_topk`` at k=100, ``ell_dots``, the postings
  build (device time), and ``ell_topk``'s device time by kernel name
  (``torch.profiler``).

CUDA-event times over back-to-back calls on distinct inputs, after one
warm-up call. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N, DIM, NNZ, QNNZ = 1_000_000, 30_522, 48, 256
VARIANTS = {"shared": ["-DMVT_K4_ALL_TILES"], "device": ["-DMVT_K4_SMEM_LIST_K=0"]}


def child(lists: str, full: bool) -> dict:
    """One variant's measurements (module docstring), in this process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops import _build, sparse_kernel as sk
    from metrovector_tpu_torch.utils.timing import cuda_ms, device_ms

    _build.NVCC_FLAGS.extend(VARIANTS[lists])
    _build.load()
    dev = torch.device("cuda", 0)
    ip = DistanceMetric.INNER_PRODUCT
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    n_pad = -(-N // 8192) * 8192
    cols = torch.zeros((n_pad, NNZ), dtype=torch.int32, device=dev)
    vals = torch.zeros((n_pad, NNZ), device=dev)
    cols[:N] = torch.randint(0, DIM, (N, NNZ), generator=g, device=dev,
                             dtype=torch.int32)
    vals[:N] = torch.randn((N, NNZ), generator=g, device=dev).abs()
    norms = (vals * vals).sum(1)

    def queries(nq):
        q = torch.zeros((nq, DIM), device=dev)
        q.scatter_(1, torch.randint(0, DIM, (nq, QNNZ), generator=g, device=dev),
                   torch.randn((nq, QNNZ), generator=g, device=dev).abs())
        return q.T.contiguous()

    def topk(qt, k=10, shape=None):
        if shape is None:
            return sk.ell_topk(qt, cols, vals, None, None, None, norms, N, k, ip)
        out = (torch.empty((qt.shape[1], k), device=dev),
               torch.empty((qt.shape[1], k), dtype=torch.int32, device=dev))
        sk._ell_topk_launch(qt, cols, vals, None, None, None, norms, N, k, ip,
                            None, shape, *out)
        return out

    result = {"lists": lists, "k10_ms": {}, "sweep": [], "default": {}}
    for bsz in (256, 32):
        qts = [queries(bsz) for _ in range(6)]
        want = topk(qts[0])
        result["k10_ms"][bsz] = cuda_ms(topk, qts, dev)
        if not full:
            continue
        qg0 = sk._tile_shape(bsz)[0]
        for qg in sorted({qg0, max(1, qg0 // 2)}):
            for rows in (16, 32):
                got = topk(qts[0], shape=(qg, rows))
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"QG={qg} rows={rows} differs")
                ms = cuda_ms(lambda qt: topk(qt, shape=(qg, rows)), qts, dev)
                per_sm = sk._blocks_per_sm(dev.index, qg, rows, 10)
                result["sweep"].append({"batch": bsz, "queries": 32 * qg,
                                        "rows": rows, "blocks_per_sm": per_sm,
                                        "ell_topk_ms": ms})
                print(f"  batch {bsz}: tile {32 * qg} queries x {rows} rows, "
                      f"{per_sm} blocks/SM: ell_topk {ms:.4f} ms", flush=True)
        qtile = 32 * qg0
        topk(qts[0], 100)
        sk.ell_dots(qts[0], cols, vals)
        torch.cuda.synchronize()
        row = {"tile": list(sk._tile_shape(bsz)),
               "ell_topk_k100_ms": cuda_ms(lambda qt: topk(qt, 100), qts, dev),
               "ell_dots_ms": cuda_ms(lambda qt: sk.ell_dots(qt, cols, vals), qts, dev),
               "postings_ms": device_ms(lambda qt: sk.query_postings(qt, qtile),
                                        qts, dev)}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for qt in qts:
                topk(qt)
            torch.cuda.synchronize()
        row["ell_topk_by_kernel_ms"] = {
            ev.key.replace("void ", "").replace("(anonymous namespace)::", "")
            .split("(")[0]: ev.device_time_total / 1e3 / len(qts)
            for ev in prof.key_averages() if ev.device_time_total > 0}
        result["default"][bsz] = row
        print(f"  batch {bsz} default {row['tile']}: " + json.dumps(
            {k: v for k, v in row.items() if k != "tile"}), flush=True)
        del qts
        torch.cuda.empty_cache()
    print(f"  lists in {lists} memory: ell_topk k=10 " + ", ".join(
        f"batch {b} {ms:.4f} ms" for b, ms in result["k10_ms"].items()), flush=True)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/sparse_sweep.json")
    ap.add_argument("--child", choices=sorted(VARIANTS), help=argparse.SUPPRESS)
    ap.add_argument("--full", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.full)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for lists, full in (("shared", True), ("device", False), ("device", False),
                        ("shared", False)):
        cmd = [sys.executable, os.path.abspath(__file__), "--child", lists]
        proc = subprocess.run(cmd + (["--full"] if full else []), cwd=ROOT,
                              stdout=subprocess.PIPE, text=True)
        lines = proc.stdout.rstrip().splitlines()
        print("\n".join(lines[:-1]), flush=True)
        if proc.returncode != 0:
            print(f"{lists} variant failed ({proc.returncode})", file=sys.stderr)
            return 1
        runs.append(json.loads(lines[-1]))
    result = {"card": card, "sweep": runs[0]["sweep"], "default": runs[0]["default"],
              "k10_lists_ms": {lists: {b: [r["k10_ms"][b] for r in runs
                                           if r["lists"] == lists]
                                       for b in ("256", "32")}
                               for lists in VARIANTS}}
    print("  ell_topk k=10 by lists' memory (runs in order): "
          + json.dumps(result["k10_lists_ms"])
          + f" | {card}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"ok": True, "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
