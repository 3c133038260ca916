#!/usr/bin/env python3
"""Time K2's IVF bucket kernel at every query tile, beside the scan of every
row and the call with no bucket probed, on one NVIDIA GPU.

    python3 tools/adc_group_sweep.py [--out build/adc_group_sweep.json]
        [--root DIR] [--default-only]

Builds the port's kernels from this checkout, the bucket kernel at every
query tile (``-DMVT_K2B_ALL_TILES``; the default build has the tile of 1
alone), and prints, with the card's
name and power limit, for ``sift1m-ivfpq4``'s and ``sift1m-ivfpq``'s shapes
(1M rows of random 4-bit m=32 packed or 8-bit m=16 codes in 1,163 buckets
of a [1163, B] bucket layout, each query probing 16 random buckets) at
batches 1, 8, 32 and 256, k = 400, f32 and bf16 LUTs: the bucket kernel
(``fused_adc_topk`` with ``buckets=``, through ``adc_kernel._launch_buckets``)
at every query tile that fits, and with a bf16 LUT its default tile at 1 to
256 splits, each merged by ``merge_kernel`` and by the merge tree (the
default marked), and the default call at
k = 10 (what the k = 400 selection costs); the plain scan of every row
without the bias; and the default call with no bucket probed (the fixed
cost of a launch). Times are device times
(``device_ms``: the device waits until the host has queued every call)
over distinct inputs after a warm-up. Each row carries the blocks per SM
the runtime's occupancy calculator gives its tile.

``--root`` names the checkout whose ``metrovector_tpu_torch`` is built and
timed (default: this one), so that two commits can be timed in one call on
one card, a process each. ``--default-only`` is the comparison of two
commits: the default build (the tile of 1) at ivfpq4's shape, batches 8
and 256, its default call alone beside the scan of every row and the call
with no bucket probed. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N, G, NPROBE, K, ITERS = 1_000_000, 1163, 16, 400, 10
BATCHES = (1, 8, 32, 256)
DEFAULT_ONLY_BATCHES = (8, 256)
SPLITS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _layout(torch, ak, stored, rn, gids, dev):
    """The rows in a [G, B] bucket layout on the device, as an IVF index
    holds them: (codes, ids, norms, fill)."""
    codes, ids, norms, starts, _, counts = ak._group_layout(stored, rn, gids, G)
    counts = counts[:G].long()
    bsize = int(counts.max())
    slot = torch.arange(N, device=dev) - starts[:G].repeat_interleave(counts)
    bucket = torch.arange(G, device=dev).repeat_interleave(counts)
    bc = torch.zeros((G, bsize, stored.shape[1]), dtype=torch.uint8, device=dev)
    bi = torch.full((G, bsize), -1, dtype=torch.int32, device=dev)
    bn = torch.zeros((G, bsize), device=dev)
    bc[bucket, slot], bi[bucket, slot], bn[bucket, slot] = codes, ids, norms
    return bc, bi, bn, counts.to(torch.int32).contiguous()


def sweep(torch, lib, dev, device_ms, default_only=False) -> list[dict]:
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops import adc_kernel as ak

    l2 = DistanceMetric.L2
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, m, ksub, packed in (("ivfpq4", 32, 16, True), ("ivfpq", 16, 256, False)):
        if default_only and name != "ivfpq4":
            continue
        codes = torch.randint(0, ksub, (N, m), generator=g, device=dev, dtype=torch.uint8)
        stored = (codes[:, 0::2] | (codes[:, 1::2] << 4)).contiguous() if packed else codes
        books = torch.randint(0, 8, (m, ksub, 4), generator=g, device=dev).float()
        rn = torch.rand(N, generator=g, device=dev) * 1000
        gids = torch.randint(0, G, (N,), generator=g, device=dev, dtype=torch.int32)
        valid = torch.ones(N, device=dev)
        buckets = _layout(torch, ak, stored, rn, gids, dev)
        layout = ak._bucket_layout(buckets)
        gw = ak._group_words(G)
        for nq in DEFAULT_ONLY_BATCHES if default_only else BATCHES:
            qs, biases = [], []
            for _ in range(ITERS):
                qs.append(torch.randint(0, 8, (nq, m * 4), generator=g, device=dev).float())
                bias = torch.full((nq, G), -1e30, device=dev)
                for r in range(nq):
                    probed = torch.randperm(G, generator=g, device=dev)[:NPROBE]
                    bias[r, probed] = -torch.rand(NPROBE, generator=g, device=dev) * 100
                biases.append(bias)
            for exact in (False, True):
                luts = [ak.adc_lut(q, books, exact) for q in qs]
                gbs = [ak.lut_bias(b, exact) for b in biases]
                tiles = (ak.BUCKET_QT,) if default_only else ak._QUERY_TILES
                occ = dict(ak._occupancy(dev.index, int(not exact), int(packed), m, ksub,
                                         K, True, gw, tiles))
                default_qt = ak.BUCKET_QT
                default_splits = ak.bucket_splits(nq, default_qt, sms * occ[default_qt],
                                                  K, True)
                default_tree = ak.bucket_merge_by_tree(default_splits, K, True)
                points = [(qt, s_, ak.bucket_merge_by_tree(s_, K, True)) for qt, s_ in (
                    (qt, ak.bucket_splits(nq, qt, sms * max(1, occ[qt]), K, True))
                    for qt in sorted(occ))]
                if default_only:
                    points = [(default_qt, default_splits, default_tree)]
                elif not exact:  # the default tile at other split counts, both merges
                    points += [(default_qt, s_, t_) for s_ in SPLITS for t_ in (False, True)
                               if (s_, t_) != (default_splits, default_tree)]
                for qt, splits, tree in points:

                    def run(i, qt=qt, splits=splits, tree=tree):
                        out = (torch.empty((nq, K), device=dev),
                               torch.empty((nq, K), dtype=torch.int32, device=dev))
                        ak._launch_buckets(lib, luts[i], gbs[i], layout, valid, N, K, l2,
                                           packed, m, ksub, qt, True, occ[qt], *out,
                                           splits=splits, tree=tree)
                        return out

                    run(0)
                    row = {"config": name, "lut": "f32" if exact else "bf16", "k": K,
                           "batch": nq, "qt": qt, "blocks_per_sm": occ[qt],
                           "splits": splits, "tree": tree,
                           "default": (qt, splits, tree) == (default_qt, default_splits,
                                                             default_tree),
                           "bucket_ms": device_ms(run, range(ITERS), dev)}
                    rows.append(row)
                    print(f"  {name} {row['lut']} LUT batch={nq} QT={qt} ({occ[qt]}/SM, "
                          f"{splits} splits, {'tree' if tree else 'merge_kernel'}"
                          f"{', default' if row['default'] else ''}): "
                          f"bucket kernel {row['bucket_ms']:.4f} ms", flush=True)

                if not exact and not default_only:  # the selection's share at k = 10
                    def k10(i):
                        return ak.fused_adc_topk(qs[i], stored, books, rn, N, 10, l2, valid,
                                                 exact, packed, biases[i], gids,
                                                 buckets=buckets)

                    k10(0)
                    rows.append({"config": name, "lut": "bf16", "k": 10, "batch": nq,
                                 "default_ms": device_ms(k10, range(ITERS), dev)})
                    print(f"  {name} bf16 LUT batch={nq} k=10, default tile and splits: "
                          f"{rows[-1]['default_ms']:.4f} ms", flush=True)

                def scan(i):  # the plain scan of every row, no bias
                    return ak.fused_adc_topk(qs[i], stored, books, rn, N, K, l2, valid,
                                             exact, packed)

                dead = torch.full((nq, G), -1e30, device=dev)

                def none_probed(i):
                    return ak.fused_adc_topk(qs[i], stored, books, rn, N, K, l2, valid,
                                             exact, packed, dead, gids, buckets=buckets)

                scan(0)
                none_probed(0)
                row = {"config": name, "lut": "f32" if exact else "bf16", "k": K,
                       "batch": nq, "scan_ms": device_ms(scan, range(ITERS), dev),
                       "none_probed_ms": device_ms(none_probed, range(ITERS), dev)}
                rows.append(row)
                print(f"  {name} {row['lut']} LUT batch={nq}: scan of every row "
                      f"{row['scan_ms']:.4f} ms; bucket kernel with no bucket probed "
                      f"{row['none_probed_ms']:.4f} ms", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/adc_group_sweep.json")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--default-only", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from metrovector_tpu_torch.ops import _build
    from metrovector_tpu_torch.utils.timing import device_ms

    if not _build.CSRC.is_relative_to(root):
        print(f"metrovector_tpu_torch came from {_build.CSRC}, not {root}", file=sys.stderr)
        return 1
    if not args.default_only:
        _build.NVCC_FLAGS.append("-DMVT_K2B_ALL_TILES")  # every query tile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    lib = _build.load()
    result = {"card": card, "root": root, "rows": sweep(
        torch, lib, torch.device("cuda", 0), device_ms, args.default_only)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"ok": True, "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
