#!/usr/bin/env python3
"""Time K2's IVF bucket-bias variant against the plain scan at every query
tile, on one NVIDIA GPU.

    python3 tools/adc_group_sweep.py [--out build/adc_group_sweep.json]

Builds the port's kernels from this checkout and prints, with the card's
name and power limit, for ``sift1m-ivfpq4``'s and ``sift1m-ivfpq``'s shapes
(1M rows of random 4-bit m=32 packed or 8-bit m=16 codes, 1,163 buckets, a
batch of 256 queries each probing 16 random buckets), with f32 and bf16
LUTs at k = 10 and 400: ``fused_adc_topk`` through ``adc_kernel._launch``
at every query tile that fits, with the bucket bias and without it (the
scan of every row), and the default call with no bucket probed (the pass
over the rows alone). Times are CUDA events over back-to-back calls after a
warm-up. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N, G, Q, NPROBE, ITERS = 1_000_000, 1163, 256, 16, 10


def sweep(torch, lib, dev, cuda_ms) -> list[dict]:
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops import adc_kernel as ak

    l2 = DistanceMetric.L2
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    rows = []
    for name, m, ksub, packed in (("ivfpq4", 32, 16, True), ("ivfpq", 16, 256, False)):
        codes = torch.randint(0, ksub, (N, m), generator=g, device=dev, dtype=torch.uint8)
        stored = (codes[:, 0::2] | (codes[:, 1::2] << 4)).contiguous() if packed else codes
        books = torch.randint(0, 8, (m, ksub, 4), generator=g, device=dev).float()
        rn = torch.rand(N, generator=g, device=dev) * 1000
        gids = torch.randint(0, G, (N,), generator=g, device=dev, dtype=torch.int32)
        valid = torch.ones(N, device=dev)
        q = torch.randint(0, 8, (Q, m * 4), generator=g, device=dev).float()
        bias = torch.full((Q, G), -1e30, device=dev)
        for r in range(Q):
            probed = torch.randperm(G, generator=g, device=dev)[:NPROBE]
            bias[r, probed] = -torch.rand(NPROBE, generator=g, device=dev) * 100
        for exact in (False, True):
            lut = ak.adc_lut(q, books, exact)
            group = (ak.lut_bias(bias, exact), gids)
            for k in (10, 400):
                occ_group = dict(ak._occupancy(dev.index, int(not exact), int(packed), m,
                                               ksub, min(k, ak.SMEM_K + 1), True,
                                               ak._group_words(G)))
                occ_scan = dict(ak._occupancy(dev.index, int(not exact), int(packed), m,
                                              ksub, min(k, ak.SMEM_K + 1), True))
                for qt in sorted(occ_group):

                    def run(tile_lut, grouped=True):
                        out = (torch.empty((Q, k), device=dev),
                               torch.empty((Q, k), dtype=torch.int32, device=dev))
                        per_sm = occ_group[qt] if grouped else occ_scan.get(qt, 1)
                        ak._launch(lib, tile_lut, stored, rn, valid, N, k, l2, packed, m,
                                   ksub, qt, k <= ak.SMEM_K, per_sm, *out,
                                   group=group if grouped else None)
                        return out

                    run(lut)
                    run(lut, False)
                    row = {"config": name, "lut": "f32" if exact else "bf16", "k": k,
                           "qt": qt, "blocks_per_sm": occ_group[qt],
                           "default_qt": ak._query_tile(Q, occ_group),
                           "group_ms": cuda_ms(run, [lut] * ITERS, dev),
                           "scan_ms": cuda_ms(lambda x: run(x, False), [lut] * ITERS, dev)}
                    rows.append(row)
                    print(f"  {name} {row['lut']} LUT k={k} QT={qt} ({row['blocks_per_sm']}/SM, "
                          f"default {row['default_qt']}): bucket variant {row['group_ms']:.4f} "
                          f"ms, scan of every row {row['scan_ms']:.4f}", flush=True)
        dead = torch.full((Q, G), -1e30, device=dev)

        def none_probed(x):
            return ak.fused_adc_topk(x, stored, books, rn, N, 400, l2, valid, False,
                                     packed, dead, gids)

        none_probed(q)
        ms = cuda_ms(none_probed, [q] * ITERS, dev)
        rows.append({"config": name, "lut": "bf16", "k": 400, "none_probed_ms": ms})
        print(f"  {name} bf16 LUT k=400, no bucket probed: {ms:.4f} ms", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/adc_group_sweep.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from metrovector_tpu_torch.ops import _build
    from metrovector_tpu_torch.utils.timing import cuda_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    lib = _build.load()
    result = {"card": card, "rows": sweep(torch, lib, torch.device("cuda", 0), cuda_ms)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"ok": True, "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
