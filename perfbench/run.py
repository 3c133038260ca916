"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the repository's root on a machine with as many CUDA cards as
the cell asks for. It makes the inputs on the card from ``--seed``, builds
the port's engine over them, warms up, measures for ``--seconds`` and checks
every answer of the window against the plain reference. The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number compared beside its limit); the numbers compared
are also the last lines of standard error. Without a card, or with fewer
than the cell asks for, it prints no result and exits with 2.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Build and kernel caches at fixed paths inside the checkout.
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "cuda_cache"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)  # the script's folder holds no top-level modules
    sys.path.insert(0, str(ROOT))
    import json

    import torch

    t_torch = time.perf_counter()
    from perfbench import core

    cell = core.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    result = core.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device="cuda:0", t0=T0, t_torch=t_torch)
    found = core.forbidden_modules()
    if found:
        print(f"perfbench: modules loaded that the run must not load: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
