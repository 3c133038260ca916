#!/usr/bin/env python3
"""Phase 1 of K1's presampled scan at every count of row splits, on one
NVIDIA GPU.

    python3 tools/presampled_sweep.py [--out FILE]

``fused_topk_presampled``'s phase 1 is K1 over every 64th row: 1/64 of the
bytes and operations, but a wave of blocks splits those rows so finely that
each split warms its own k-entry list over a few hundred rows, and the
warm-up, not the scan, sets its time. This times phase 1 (``raw_scores``,
the subsample pre-sliced) at one wave of blocks (``wave``: what
``fused_topk`` plans) and at 64, 32, 16, 8, 4, 2 and 1 splits a tile of
queries, each held identical to the wave's answer, beside phase 2 (the
seeded scan) and plain ``fused_topk``, by CUDA events (a split count other
than the wave's is set by wrapping ``topk_kernel._plan``), on:

* 1M x 128 integer-valued f32 rows, L2 (``chip_smoke.py``'s phase 3
  corpus, drawn on the card): batch 256 at k 10, 100 and 1,000, batch 32
  at k 100 (the FFMA kernel);
* 10M x 96 random int8 codes in 128-byte rows, inner product, scale 0.02,
  batch 128, k 100 (deep10m's shape; the integer scan);
* 1M x 960 N(0, 1) rows, cosine, precision ``"high"``, batch 256, k 18 and
  100 (gist1m's shape; the bf16x3 scan).

Prints a line a point and, last, the JSON of every point; ``--out`` gets
the JSON too.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STRIDE = 64
SPLITS = (None, 64, 32, 16, 8, 4, 2, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from metrovector_tpu_torch import DistanceMetric as M
    from metrovector_tpu_torch.ops import _build
    from metrovector_tpu_torch.ops import topk_kernel
    from metrovector_tpu_torch.ops.topk_kernel import fused_topk
    from metrovector_tpu_torch.utils.timing import cuda_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    _build.load()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(13)
    s = STRIDE
    result = {"card": card, "points": []}
    plan, forced = topk_kernel._plan, [None]

    def forced_plan(dev, nq, n, k, smem_k, tile, occupancy, splits=None, seed_k=0):
        return plan(dev, nq, n, k, smem_k, tile, occupancy,
                    splits if forced[0] is None else forced[0], seed_k)

    topk_kernel._plan = forced_plan

    def sweep(label, qs, db, norms, k, metric, **kw):
        n = db.shape[0]
        sub_db = db[::s] if qs[0].dtype == torch.int8 or kw.get("precision") == "high" \
            else db[::s].contiguous()
        sub = (sub_db, norms[::s].contiguous())
        nv_sub, k1 = -(-n // s), min(k, -(-n // s))

        def phase1(q, splits=None):
            forced[0] = splits
            try:
                return fused_topk(q, *sub, nv_sub, k1, metric, raw_scores=True, **kw)
            finally:
                forced[0] = None

        seeds = [phase1(q) for q in qs]
        pairs = [(q, a, torch.where(b >= 0, b * s, b)) for q, (a, b) in zip(qs, seeds)]

        def phase2(t):
            return fused_topk(t[0], db, norms, n, k, metric, seed_s=t[1], seed_i=t[2],
                              exclude_stride=s, **kw)

        def plain(q):
            return fused_topk(q, db, norms, n, k, metric, **kw)

        plain(qs[0]), phase2(pairs[0])
        row = {"point": label, "k": k, "plain": [cuda_ms(plain, qs, dev)],
               "phase2": cuda_ms(phase2, pairs, dev), "phase1": {}}
        for splits in SPLITS:
            got = phase1(qs[0], splits)
            if not (torch.equal(got[0], seeds[0][0]) and torch.equal(got[1], seeds[0][1])):
                raise AssertionError(f"{label} k={k}: phase 1 at {splits} splits differs")
            row["phase1"][str(splits or "wave")] = cuda_ms(lambda q: phase1(q, splits), qs, dev)
        row["plain"].append(cuda_ms(plain, qs, dev))
        best = min(row["phase1"], key=row["phase1"].get)
        print(f"{label} k={k}: plain {row['plain'][0]:.4f} / {row['plain'][1]:.4f} ms | "
              f"phase 2 {row['phase2']:.4f} | phase 1 by splits: "
              + ", ".join(f"{sp} {v:.4f}" for sp, v in row["phase1"].items())
              + f" | fastest {best} | {card}", flush=True)
        result["points"].append(row)

    n = 1_000_000
    x = torch.randint(0, 256, (n, 128), generator=g, device=dev).float()
    xn = (x.double() ** 2).sum(1).float()
    for nq, ks in ((256, (10, 100, 1000)), (32, (100,))):
        qs = [torch.randint(0, 256, (nq, 128), generator=g, device=dev).float()
              for _ in range(5)]
        for k in ks:
            sweep(f"1M x 128 f32 L2 batch {nq}", qs, x, xn, k, M.L2)
    del x, xn
    rows = torch.randint(-128, 128, (10_000_000, 128), dtype=torch.int8, generator=g,
                         device=dev)
    c8, zn = rows[:, :96], torch.zeros(10_000_000, device=dev)
    qs = [torch.randint(-128, 128, (128, 96), dtype=torch.int8, generator=g, device=dev)
          for _ in range(5)]
    sweep("10M x 96 int8 IP batch 128", qs, c8, zn, 100, M.INNER_PRODUCT, scale=0.02)
    del rows, c8, zn
    xg = torch.randn((n, 960), generator=g, device=dev)
    gn = (xg.double() ** 2).sum(1).float()
    qs = [torch.randn((256, 960), generator=g, device=dev) for _ in range(3)]
    qs = [q / q.norm(dim=1, keepdim=True) for q in qs]
    for k in (18, 100):
        sweep("1M x 960 high cosine batch 256", qs, xg, gn, k, M.COSINE, precision="high")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
