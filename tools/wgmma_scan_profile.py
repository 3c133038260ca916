#!/usr/bin/env python3
"""Where the time of K1's tensor-core scans goes, on one NVIDIA GPU.

    python3 tools/wgmma_scan_profile.py [--out FILE] [--seed-counts]

Without a hardware profiler, this builds patched copies of the port under
``build/wgmma_profile/`` (git-ignored), all in parallel, and times each in
a process of its own, by device time per kernel name (``torch.profiler``):

* ``as_is``: the scans as they are;
* ``counters``: the integer scan with ``clock64()`` counters in its
  consumer loop, read back through an extra ``extern "C"`` entry: per
  block, consumer warpgroup 0's lane 0 sums the cycles of each phase of a
  tile (the group bar's refresh; the wait for the stage and the MMA; the
  compare pass; the offers, flushes and their barriers), the tiles that had
  offer work and its own passing scores;
* ``no_epilogue``: neither scan compares, offers or selects (the TMA ring
  and the MMA alone, each warpgroup still waiting for its group);
* ``tma_only``: no MMA either (the TMA ring alone).

With ``--seed-counts`` it builds one variant instead, ``seed_counts``:
device counters of the integer scan's offers (scores that reached their
bar) and flushes (buffer merges into a list, the last ones included), read
and reset through ``mvt_scan_counts``, at deep10m's shape (10M random int8
rows of 96 codes in 128-byte rows, inner product, deferred scale, batch
128, k = 100) for plain ``fused_topk`` and for ``fused_topk_presampled``
(stride 64) and its phase 1 alone. Only the sources its edits reach are
compiled; the rest of its library is this checkout's own objects.
``chip_smoke.py`` builds it beside the package in phase 1
(:func:`start_seed_counts`, :func:`link_seed_counts`) and runs it in phase
15 (:func:`seed_counts`).

The points are ``tools/scan_kernel_timing.py``'s ``k1v`` shapes: the
integer scan over 10M random int8 rows of 96 codes in 128-byte rows
(inner product, deferred scale) at batches 128 and 32 and over 1M rows of
128 codes in the uint8 offset form at batch 256; the bf16x3 scan over 1M x
960 N(0, 1) rows, cosine, k=18, at batches 256 and 64. The patches are text
edits of this checkout's sources: the script fails if a source no longer
holds the text it edits. The variants' answers are not checked (only
``as_is`` computes the contract). The last line of the output is JSON.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import signal
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "wgmma_profile")

INT, HIGH = "topk_int_kernel.cu", "topk_high_kernel.cu"
COUNTERS = [
    (INT, "namespace {\n\nconstexpr int kChunk = 128;",
     "__device__ long long g_prof[1024][8];\nnamespace {\n\nconstexpr int kChunk = 128;"),
    (INT, "  int64_t step = 0;\n  for (int t = 0; t < tiles; ++t) {\n"
          "    const int t0 = row_begin + t * kScanRows;\n"
          "    if (t > 0 && t % kRefresh == 0) sel_refresh(S, warp, lane);",
     "  int64_t step = 0;\n  long long P[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  const long long T0 = clock64();\n  for (int t = 0; t < tiles; ++t) {\n"
     "    const int t0 = row_begin + t * kScanRows;\n    long long ta = clock64();\n"
     "    if (t > 0 && t % kRefresh == 0) sel_refresh(S, warp, lane);\n"
     "    P[1] += clock64() - ta;\n    ta = clock64();"),
    (INT, "    // Epilogue and masks: the compare pass",
     "    P[2] += clock64() - ta;\n    ta = clock64();\n"
     "    // Epilogue and masks: the compare pass"),
    (INT, "    sel_epilogue<NW>(S, pass, warp, lane, t0 + r_lo, bar_id, [&](int i) {",
     "    P[3] += clock64() - ta;\n    ta = clock64();\n    P[6] += __popcll(pass);\n"
     "    sel_epilogue<NW>(S, pass, warp, lane, t0 + r_lo, bar_id, [&](int i) {"),
    (INT, "    });\n  }\n  sel_finish(S, tw, bar_id);",
     "    });\n    const long long d = clock64() - ta;\n    P[4] += d;\n    P[7] += d > 300;\n  }\n"
     "  P[0] = clock64() - T0;\n  if (tw == 0 && blockIdx.x * gridDim.y + blockIdx.y < 512) {\n"
     "    for (int i = 0; i < 8; ++i) g_prof[2 * (blockIdx.x * gridDim.y + blockIdx.y) + wg][i] = P[i];\n"
     "  }\n  sel_finish(S, tw, bar_id);"),
    (INT, 'extern "C" {\n',
     'extern "C" {\nint mvt_scan_profile(long long* out) {\n'
     "  return cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n}\n"),
]
COUNTER_FIELDS = ("cycles", "refresh", "stage wait + MMA", "compare pass",
                  "offers, flushes, barriers", "-", "own passing scores",
                  "tiles with offer work")
NO_EPILOGUE = [
    (INT, "    unsigned long long pass = 0;\n    bool deferred = false;\n"
          "    if constexpr (Op::kInt) {",
     "    unsigned long long pass = acc[0] == 0x7fffff01;\n    bool deferred = false;\n"
     "    if constexpr (false) {"),
    (INT, "    if (!deferred) {\n      float inv[2], badd[2];",
     "    if (false) {\n      float inv[2], badd[2];"),
    (HIGH, re.compile(r"    const unsigned long long pass =\n.*?;\n", re.S),
     "    const unsigned long long pass = acc[0] == 1234.5f && sml[0] == 3.25f;\n"),
]
TMA_ONLY = NO_EPILOGUE + [
    (INT, "      for (int kk = 0; kk < kChunk / 32; ++kk) {",
     "      for (int kk = 0; kk < 0; ++kk) {"),
    (HIGH, "      for (int kk = 0; kk < 2; ++kk) {\n        const int first",
     "      for (int kk = 0; kk < 0; ++kk) {\n        const int first"),
]
VARIANTS = {"as_is": [], "counters": COUNTERS, "no_epilogue": NO_EPILOGUE,
            "tma_only": TMA_ONLY}

WGMMA = "wgmma_scan.cuh"
SEED_COUNTS = [
    (WGMMA, "namespace {\n\nconstexpr int kScanRows",
     "namespace {\n\n__device__ unsigned long long g_counts[2];  // offers, flushes\n"
     "constexpr int kScanRows"),
    (WGMMA, "    flush_buffer(ls, li, s.k, s.bs + qq * kBuf, s.bi + qq * kBuf, kBuf, lane);\n"
            "    if (lane == 0) {\n",
     "    flush_buffer(ls, li, s.k, s.bs + qq * kBuf, s.bi + qq * kBuf, kBuf, lane);\n"
     "    if (lane == 0) {\n      atomicAdd(&g_counts[1], 1ull);\n"),
    (WGMMA, "                   s.bi + qq * kBuf, cnt, lane);\n",
     "                   s.bi + qq * kBuf, cnt, lane);\n"
     "      if (lane == 0) atomicAdd(&g_counts[1], 1ull);\n"),
    (INT, "    sel_epilogue<NW>(S, pass, warp, lane, t0 + r_lo, bar_id, [&](int i) {",
     "    {\n      const unsigned c = __reduce_add_sync(0xffffffffu,\n"
     "          static_cast<unsigned>(__popcll(pass)));\n"
     "      if (lane == 0 && c) atomicAdd(&g_counts[0], static_cast<unsigned long long>(c));\n"
     "    }\n"
     "    sel_epilogue<NW>(S, pass, warp, lane, t0 + r_lo, bar_id, [&](int i) {"),
    (INT, 'extern "C" {\n',
     'extern "C" {\nint mvt_scan_counts(unsigned long long* out) {\n'
     "  const unsigned long long zero[2] = {0, 0};\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(out, g_counts, sizeof(g_counts));\n"
     "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_counts, zero, sizeof(zero));\n"
     "  return e;\n}\n"),
]

SEED_POINTS = r'''
from metrovector_tpu_torch.ops.topk_kernel import fused_topk, fused_topk_presampled
n, s, k = 10_000_000, 64, 100
rows = torch.randint(-128, 128, (n, 128), dtype=torch.int8, device=dev, generator=g)
x, zn = rows[:, :96], torch.zeros(n, device=dev)
sub = (x[::s], zn[::s].contiguous())
qs = [torch.randint(-128, 128, (128, 96), dtype=torch.int8, device=dev, generator=g)
      for _ in range(4)]
ip = M.INNER_PRODUCT
fns = {"plain": lambda q: fused_topk(q, x, zn, n, k, ip, scale=0.02),
       "presampled": lambda q: fused_topk_presampled(q, x, zn, n, k, ip, scale=0.02,
                                                     stride=s, sub=sub),
       "phase 1": lambda q: fused_topk(q, *sub, -(-n // s), k, ip, scale=0.02,
                                       raw_scores=True)}
buf = (ctypes.c_ulonglong * 2)()
for name, fn in fns.items():
    point(name, fn, qs)
    counts = []
    for q in qs:
        torch.cuda.synchronize()
        lib.mvt_scan_counts(buf)
        fn(q)
        torch.cuda.synchronize()
        lib.mvt_scan_counts(buf)
        counts.append((buf[0], buf[1]))
    out[name]["offers"] = float(np.mean([c[0] for c in counts]))
    out[name]["flushes"] = float(np.mean([c[1] for c in counts]))
if not torch.equal(fns["plain"](qs[0])[1], fns["presampled"](qs[0])[1]):
    raise AssertionError("seed_counts: presampled differs from fused_topk")
'''

# The child process of every variant: loads (and so builds) the package at
# ROOT, then runs a profile's points, each through point(), and prints their
# JSON.
HARNESS = r'''
import ctypes, json, sys
sys.path.insert(0, ROOT)
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from metrovector_tpu_torch import DistanceMetric as M
from metrovector_tpu_torch.ops import _build
lib = _build.load()
if BUILD_ONLY:
    sys.exit(0)
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(4)
out = {}
def point(name, fn, inputs):
    fn(inputs[0]); torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x in inputs:
            fn(x)
        torch.cuda.synchronize()
    row = {}
    for ev in prof.key_averages():
        kernel = (ev.key.replace("void ", "").replace("(anonymous namespace)::", "")
                  .split("(")[0].split("<")[0])
        if ev.device_time_total > 0:
            row[kernel] = row.get(kernel, 0.0) + ev.device_time_total / 1e3 / len(inputs)
    if COUNTERS:
        buf = (ctypes.c_longlong * (1024 * 8))()
        fn(inputs[0]); torch.cuda.synchronize()
        lib.mvt_scan_profile(buf)
        a = np.frombuffer(buf, dtype=np.int64).reshape(1024, 8)
        live = a[a[:, 0] > 0]
        row["counters"] = [float(x) for x in live.mean(0)]
    out[name] = row
'''

POINTS = r'''
from metrovector_tpu_torch.ops.topk_kernel import fused_topk
ip, l2, cos = M.INNER_PRODUCT, M.L2, M.COSINE
n = 10_000_000
rows = torch.randint(-128, 128, (n, 128), dtype=torch.int8, device=dev, generator=g)
x, zn = rows[:, :96], torch.zeros(n, device=dev)
for nq in (128, 32):
    qs = [torch.randint(-128, 128, (nq, 96), dtype=torch.int8, device=dev, generator=g)
          for _ in range(4)]
    point(f"int8 deep10m {nq}", lambda q: fused_topk(q, x, zn, n, 10, ip, scale=0.02), qs)
del rows, x, zn
m = 1_000_000
u = torch.randint(-128, 128, (m, 128), dtype=torch.int8, device=dev, generator=g)
un = ((u.double() + 128) ** 2).sum(1).float()
bias = u.sum(1, dtype=torch.int32).float()
qs = [torch.randint(-128, 128, (256, 128), dtype=torch.int8, device=dev, generator=g)
      for _ in range(4)]
point("int8 sift1m-u8 256", lambda q: fused_topk(q, u, un, m, 10, l2, scale=128 / 127,
                                                 bias_row=bias, bias_scale=128.0), qs)
del u, un, bias
if not COUNTERS:
    xg = torch.randn((m, 960), generator=g, device=dev)
    gn = (xg.double() ** 2).sum(1).float()
    for nq in (256, 64):
        qs = [torch.randn((nq, 960), generator=g, device=dev) for _ in range(3)]
        qs = [q / q.norm(dim=1, keepdim=True) for q in qs]
        point(f"high gist1m {nq}", lambda q: fused_topk(q, xg, gn, m, 18, cos,
                                                        precision="high"), qs)
'''


def patched(name: str, edits) -> str:
    """A copy of this checkout's package under WORK/name with ``edits``."""
    dst = os.path.join(WORK, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "metrovector_tpu_torch"),
                    os.path.join(dst, "metrovector_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src, old, new in edits:
        path = os.path.join(dst, "metrovector_tpu_torch", "ops", "csrc", src)
        text = open(path).read()
        if isinstance(old, re.Pattern):
            text, hits = old.subn(new, text, count=1)
        else:
            hits = text.count(old)
            text = text.replace(old, new)
        if hits < 1:
            raise RuntimeError(f"{name}: {src} no longer holds the text this edits")
        open(path, "w").write(text)
    return dst


def child(root: str, counters: bool, build_only: bool, points: str) -> subprocess.Popen:
    code = (f"ROOT = {root!r}\nCOUNTERS = {counters!r}\nBUILD_ONLY = {build_only!r}\n"
            + HARNESS + points + "print(json.dumps(out))\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=root, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)


def _build_module(root: str):
    """The ``ops/_build.py`` of the package at ``root``, loaded under a
    name of its own (its build directory follows its own sources)."""
    path = os.path.join(root, "metrovector_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location(f"_build_of_{abs(hash(root))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def start_seed_counts() -> tuple[str, list]:
    """Patch the ``seed_counts`` variant and start compiling the ``.cu``
    files its edits reach (edited, or including an edited file), each in an
    ``nvcc`` of its own; returns its root and ``(stem, process)`` for each.
    :func:`link_seed_counts` takes every other object from this checkout's
    build."""
    root = patched("seed_counts", SEED_COUNTS)
    var = _build_module(root)
    here = os.path.join(ROOT, "metrovector_tpu_torch", "ops", "csrc")
    text = {p.name: p.read_text() for p in var._sources()}
    touched = {name for name, t in text.items()
               if t != open(os.path.join(here, name)).read()}
    while True:  # an include of a touched file touches the includer
        more = {name for name, t in text.items() if name not in touched
                and any(f'#include "{h}"' in t for h in touched)}
        if not more:
            break
        touched |= more
    out_dir = var.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in var._sources():
        if src.suffix == ".cu" and src.name in touched:
            cmd = [var._nvcc(), *var.NVCC_FLAGS, "-I", str(var.CSRC), "-c",
                   "-o", str(out_dir / (src.stem + ".o")), str(src)]
            jobs.append((src.stem, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                start_new_session=True)))
    return root, jobs


def link_seed_counts(started) -> None:
    """Wait for :func:`start_seed_counts`' compiles and link the variant's
    library from them and this checkout's other objects (its build must
    have run: ``_build.load()``)."""
    root, jobs = started
    for _, proc in jobs:
        out = proc.communicate(timeout=1200)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"seed_counts: nvcc failed ({proc.returncode})\n{out[-3000:]}")
    var, main = _build_module(root), _build_module(ROOT)
    out_dir, main_dir = var.build_dir(), main.build_dir()
    ours = {stem for stem, _ in jobs}
    objs = [str((out_dir if src.stem in ours else main_dir) / (src.stem + ".o"))
            for src in var._sources() if src.suffix == ".cu"]
    missing = [o for o in objs if not os.path.exists(o)]
    if missing:
        raise RuntimeError(f"seed_counts: no object {missing[0]}: build this checkout first")
    run = subprocess.run([var._nvcc(), "-shared", "-Xcompiler", "-fPIC", "-o",
                          str(out_dir / var.LIB_NAME), *objs], capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"seed_counts: link failed\n{run.stderr[-3000:]}")


def stop(started) -> None:
    """Kill :func:`start_seed_counts`' compiles that are still running."""
    for _, proc in started[1]:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def seed_counts(root: str | None = None) -> dict:
    """The ``seed_counts`` points (module docstring) of the variant built
    at ``root`` (:func:`start_seed_counts`, :func:`link_seed_counts`), else
    built now: per run, device ms by kernel name and the mean ``offers`` and
    ``flushes`` of one call."""
    if root is None:
        sys.path.insert(0, ROOT)
        from metrovector_tpu_torch.ops import _build

        _build.load()
        started = start_seed_counts()
        try:
            link_seed_counts(started)
        finally:
            stop(started)
        root = started[0]
    proc = child(root, False, False, SEED_POINTS)
    try:
        out, err = proc.communicate(timeout=900)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"seed_counts: run failed\n{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def profile(variants: dict, points: str, counter_fields, prefix: str = "",
            out_path: str | None = None) -> int:
    """Build every variant (``name: edits``) as a patched copy under
    ``WORK/prefix+name``, all in parallel, then run ``points`` (code for the
    child, after HARNESS) in each, one process at a time; the ``counters``
    variant's ``mvt_scan_profile`` entry is read after each point and
    printed by ``counter_fields`` ("-": not printed). Prints a line a point
    and, last, the JSON of every run; ``out_path`` gets it too."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    roots = {name: patched(prefix + name, edits) for name, edits in variants.items()}
    builds = {name: child(root, name == "counters", True, points)
              for name, root in roots.items()}
    for name, proc in builds.items():
        _, err = proc.communicate(timeout=1200)
        if proc.returncode != 0:
            print(f"{name}: build failed\n{err[-3000:]}", file=sys.stderr)
            return 1
    result = {"card": card}
    for name, root in roots.items():
        proc = child(root, name == "counters", False, points)
        out, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            print(f"{name}: run failed\n{err[-3000:]}", file=sys.stderr)
            return 1
        result[name] = json.loads(out.strip().splitlines()[-1])
        for point, row in result[name].items():
            times = ", ".join(f"{k} {v:.4f} ms" for k, v in row.items() if k != "counters")
            print(f"{name:12s} {point}: {times} | {card}", flush=True)
            if "counters" in row:
                print("             counters (cycles per block, warpgroup 0): " + ", ".join(
                    f"{f} {v:.0f}" for f, v in zip(counter_fields, row["counters"])
                    if f != "-"), flush=True)
    result["counter_fields"] = counter_fields
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--seed-counts", action="store_true")
    args = ap.parse_args()
    if args.seed_counts:
        result = seed_counts()
        for name, row in result.items():
            print(f"{name}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        print(json.dumps(result), flush=True)
        return 0
    return profile(VARIANTS, POINTS, COUNTER_FIELDS, out_path=args.out)


if __name__ == "__main__":
    sys.exit(main())
