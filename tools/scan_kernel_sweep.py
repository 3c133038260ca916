#!/usr/bin/env python3
"""Sweep the launch shapes of the scan-and-select kernels K1 and K2 on one
NVIDIA GPU.

    python3 tools/scan_kernel_sweep.py [--out build/scan_sweep.json]

Builds the port's kernels from this checkout and prints, with the card's
name and power limit:

* K2 (``fused_adc_topk`` through ``adc_kernel._launch``) at k=400, L2, f32
  LUT, over 1M random codes, 4-bit m=32 (nibble-packed) and 8-bit m=16,
  batches 256 and 32: every query tile that fits, the lists in shared and
  in device memory, and row splits of one wave of blocks, a half and a
  quarter of it;
* K1 (``fused_topk`` through ``topk_kernel._launch``) over 1M x 128
  integer-valued f32 rows, L2, at (batch, k) = (256, 10), (128, 10),
  (32, 10) and (32, 100): both block tiles, at the same splits (the
  kernels are built with ``-DMVT_K1_ALL_TILES``; the default build has
  the 32 x 256 tile only).

Each shape's answer must be identical to the wrapper's default; the time is
CUDA events over back-to-back calls on distinct inputs after a warm-up.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N, D, ITERS = 1_000_000, 128, 6
FRACTIONS = (1, 2, 4)  # splits: one wave of blocks, then a half, a quarter


def sweep_k2(torch, lib, dev, sms, cuda_ms) -> list[dict]:
    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops import adc_kernel as ak

    l2 = DistanceMetric.L2
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    rows, k = [], 400
    for name, m, ksub, packed in (("pq4", 32, 16, True), ("pq8", 16, 256, False)):
        books = torch.randn((m, ksub, D // m), generator=g, device=dev)
        codes = torch.randint(0, ksub, (N, m), generator=g, device=dev,
                              dtype=torch.uint8)
        recon = torch.cat([books[j][codes[:, j].long()] for j in range(m)], 1)
        rn = (recon.double() ** 2).sum(1).float()
        del recon
        stored = (codes[:, 0::2] | (codes[:, 1::2] << 4)).contiguous() if packed else codes
        for nq in (256, 32):
            qs = [torch.randn((nq, D), generator=g, device=dev) for _ in range(ITERS)]
            luts = [ak.adc_lut(q, books, True) for q in qs]
            want = ak.fused_adc_topk(qs[0], stored, books, rn, N, k, l2, None, True, packed)
            default = cuda_ms(lambda q: ak.fused_adc_topk(
                q, stored, books, rn, N, k, l2, None, True, packed), qs, dev)
            print(f"  K2 {name} batch={nq}: default {default:.4f} ms", flush=True)
            for smem_lists in (True, False):
                occ = dict(ak._occupancy(dev.index, 0, int(packed), m, ksub, k, smem_lists))
                for qt, per_sm in sorted(occ.items()):
                    if qt < 2 or qt > 2 * nq:
                        continue
                    wave = max(1, sms * max(1, per_sm) // -(-nq // qt))
                    for frac in FRACTIONS:
                        splits = max(1, wave // frac)

                        def run(lut):
                            out = (torch.empty((nq, k), device=dev),
                                   torch.empty((nq, k), dtype=torch.int32, device=dev))
                            ak._launch(lib, lut, stored, rn, None, N, k, l2, packed,
                                       m, ksub, qt, smem_lists, per_sm, *out,
                                       splits=splits)
                            return out

                        got = run(luts[0])
                        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                            raise AssertionError(f"K2 {name} QT={qt} lists smem={smem_lists} "
                                                 f"splits={splits} differs")
                        ms = cuda_ms(run, luts, dev)
                        rows.append({"kernel": "K2", "config": name, "batch": nq, "qt": qt,
                                     "lists": "shared" if smem_lists else "device",
                                     "blocks_per_sm": per_sm, "splits": splits,
                                     "ms": ms, "default_ms": default})
                        print(f"  K2 {name} batch={nq} QT={qt} lists "
                              f"{'shared' if smem_lists else 'device'} {per_sm} blocks/SM "
                              f"splits={splits}: {ms:.4f} ms", flush=True)
            del qs, luts
        del books, codes, stored, rn
        torch.cuda.empty_cache()
    return rows


def sweep_k1(torch, lib, dev, sms, cuda_ms) -> list[dict]:
    import ctypes

    from metrovector_tpu_torch import DistanceMetric
    from metrovector_tpu_torch.ops import topk_kernel as tk

    l2 = DistanceMetric.L2
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    db = torch.randint(0, 256, (N, D), generator=g, device=dev).float()
    norms = (db * db).sum(1)
    rows = []
    for nq, k in ((256, 10), (128, 10), (32, 10), (32, 100)):
        qs = [torch.randint(0, 256, (nq, D), generator=g, device=dev).float()
              for _ in range(ITERS)]
        want = tk.fused_topk(qs[0], db, norms, N, k, l2)
        default = cuda_ms(lambda q: tk.fused_topk(q, db, norms, N, k, l2), qs, dev)
        print(f"  K1 batch={nq} k={k}: default {default:.4f} ms", flush=True)
        for tile, (qb, rb) in tk._TILES.items():
            if tk._shared_bytes(k, tile) > tk.SMEM_LIMIT:
                continue
            per_sm = ctypes.c_int(0)
            if lib.mvt_fused_topk_occupancy(0, tile, min(k, tk.SMEM_K), int(k > tk.SMEM_K),
                                            ctypes.byref(per_sm)) != 0:
                continue
            wave = max(1, sms * max(1, per_sm.value) // -(-nq // qb))
            for frac in FRACTIONS:
                splits = max(1, wave // frac)

                def run(q):
                    out = (torch.empty((nq, k), device=dev),
                           torch.empty((nq, k), dtype=torch.int32, device=dev))
                    tk._launch(lib, q, db, norms, None, N, k, l2, tile, *out,
                               splits=splits)
                    return out

                got = run(qs[0])
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"K1 tile {qb}x{rb} splits={splits} differs")
                ms = cuda_ms(run, qs, dev)
                rows.append({"kernel": "K1", "batch": nq, "k": k, "tile": f"{qb}x{rb}",
                             "blocks_per_sm": per_sm.value, "splits": splits, "ms": ms,
                             "default_ms": default})
                print(f"  K1 batch={nq} k={k} tile {qb}x{rb} {per_sm.value} blocks/SM "
                      f"splits={splits}: {ms:.4f} ms", flush=True)
        del qs
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/scan_sweep.json")
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
    _build.NVCC_FLAGS.append("-DMVT_K1_ALL_TILES")
    lib = _build.load()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    result = {"card": card,
              "k2": sweep_k2(torch, lib, dev, sms, cuda_ms),
              "k1": sweep_k1(torch, lib, dev, sms, cuda_ms)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"ok": True, "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
