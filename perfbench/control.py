"""The controls of the check that decides ``correct``, at a cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds 3 \
        [--precision exact|tf32|bf16|int8|int4]

For each seed, in one process, it runs the cell as ``run.py`` does for a
short window, with the plain reference put in the program's place and
computed at ``--precision``, or (without ``--precision``) the program
itself, and prints one JSON line a seed: ``correct`` and each number
compared beside its limit. The
benchmark's own runs never run this; it reads the two ends that each limit
is set between (``PERF.md``).
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Answer:
    indices: np.ndarray
    distances: np.ndarray


class ReferenceEngine:
    """The plain reference with the engine's two calls, over the rows the
    program would have been given, at a lower ``precision``."""

    def __init__(self, ref, cfg, rows, precision):
        self.ref, self.cfg, self.rows, self.precision = ref, cfg, rows, precision

    def search(self, queries, k=10):
        ids, dist = self.ref.answers(self.cfg, self.rows, [queries], k, self.precision)[0]
        return Answer(ids, dist)

    def search_pipelined(self, batches, k=10):
        for q in batches:
            yield self.search(q, k)


def readings(cell, seeds, seconds, precision=None, device="cuda"):
    """``[(seed, correct, {check: value})]`` of one short run a seed."""
    from perfbench import core

    build = None
    if precision is not None:
        ref = core.load_module(cell.root, "reference", cell.config["reference"])

        def build(cfg, rows, dev):
            return ReferenceEngine(ref, cfg, rows, precision)

    out = []
    for seed in seeds:
        r = core.run_cell(cell, seed, seconds, False, device=device, build=build)
        out.append((seed, r["correct"], {n: c["value"] for n, c in r["checks"].items()}))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--precision", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import core

    if not torch.cuda.is_available():
        print("perfbench control: no CUDA card", file=sys.stderr)
        return 2
    cell = core.load_cell(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, ok, checks in readings(cell, seeds, args.seconds, args.precision,
                                     device="cuda:0"):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": args.precision or "program",
                          "correct": ok, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
