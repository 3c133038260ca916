"""One run of one cell: set-up, warm-up, the measured window, the check of
every answer against the plain reference, and the result line.

:func:`load_cell` reads ``BENCHMARK.json`` and the cell's configuration and
traffic files; :func:`run_cell` runs it and returns the result as a dict
whose last key, ``checks``, holds each number compared beside its limit.
The command line, the look for a card and the check that no JAX module was
loaded are in ``run.py``.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib.util
import json
import os
import re
import shutil
import sys
import tempfile
import time
from contextlib import nullcontext
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
# Top-level module names that must not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "metrovector_tpu")
COUNTS = ("wrong_ids", "dup_ids")  # checks summed over the window; the others are widest gaps
clock = time.perf_counter


class SpecError(ValueError):
    """BENCHMARK.json, a configuration or a traffic file names something
    that is not there or not allowed."""


def load_module(root: Path, kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` under ``root``, loaded once."""
    if not NAME.match(name):
        raise SpecError(f"{kind} name {name!r} is not a plain name")
    path = (Path(root) / "perfbench" / kind / f"{name}.py").resolve()
    if not path.is_file():
        raise SpecError(f"no {kind} named {name!r} ({path})")
    key = "perfbench_" + hashlib.sha1(str(path).encode()).hexdigest()[:12]
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` in ``root/BENCHMARK.json``, with its
    configuration, its traffic and the metrics it reports."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SpecError(f"no workload named {workload!r} in BENCHMARK.json")
    conf = next((c for c in bench["configs"] if c["name"] == entry["config"]), None)
    if conf is None:
        raise SpecError(f"workload {workload!r} names no known config")
    if not NAME.match(entry["traffic"]):
        raise SpecError(f"traffic name {entry['traffic']!r} is not a plain name")
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "perfbench" / "traffic" / f"{entry['traffic']}.json").read_text())

    def mine(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return Cell(name=workload, chips=int(entry["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)],
                root=root)


@dataclasses.dataclass
class Window:
    """What a loop saw: for each batch it sent, in order, the host clock
    when the engine took it, when its host result was ready, the pool batch
    it was and the answer (row ids, distances). ``serial``: each call waited
    for its answer before the next began, so every piece of the card's work
    lies inside a call."""

    serial: bool = False
    taken: list = dataclasses.field(default_factory=list)
    ready: list = dataclasses.field(default_factory=list)
    pool: list = dataclasses.field(default_factory=list)
    answers: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RunData:
    """What a metric reader reads: the run's set-up time, its window, the
    cell's traffic and roofline, and the reduced trace of a ``--trace 1``
    run (None otherwise)."""

    cell: Cell
    setup_s: float
    start: float
    seconds: float
    window: Window
    roofline: dict
    trace: object = None

    @property
    def batch(self) -> int:
        return int(self.cell.traffic["batch"])

    def done(self) -> list[int]:
        """Positions whose answer was ready within the window."""
        end = self.start + self.seconds
        return [i for i, t in enumerate(self.window.ready) if t <= end]

    def latencies_s(self) -> np.ndarray:
        w = self.window
        return np.array([w.ready[i] - w.taken[i] for i in self.done()])


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(device):
    """CUDA activity alone on a card (the host pays little for it); host
    operations where there is no card, whose trace then holds no device
    event."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    return profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])


def _reduce_profile(prof, window_us: float):
    """The profiler's Chrome trace, written into a new directory under
    ``TMPDIR`` and removed once read."""
    from perfbench import tracing

    tmp = tempfile.mkdtemp(prefix="perfbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return tracing.reduce(events, window_us)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float | None = None, build=None, wrap=None,
             t_torch: float | None = None) -> dict:
    """One run of ``cell``. ``t0``: the host clock at process start (set-up
    is counted from it); ``t_torch``: when torch had been imported, which
    splits set-up's first phase. ``build(config, rows, device)`` replaces the
    program's engine (the controls put the reference in its place);
    ``wrap(engine)`` wraps it (the tests plant faults with it)."""
    import torch

    t0 = clock() if t0 is None else t0
    dev = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    if traffic.get("filter") is not None or int(traffic.get("clients", 1)) != 1:
        raise SpecError("the loops take one client and no filter")
    batch, k, npool = int(traffic["batch"]), int(traffic["k"]), int(traffic["pool_batches"])
    gen = load_module(cell.root, "gen", cfg["generator"])
    program = load_module(cell.root, "program", cfg["program"])
    loop = load_module(cell.root, "loops", traffic["loop"])
    roofline = load_module(cell.root, "roofline", cfg["roofline"]).per_batch(cfg, traffic)

    marks = [("torch_s", t_torch)] if t_torch is not None else []
    marks.append(("start_s", clock()))
    built = not program.library_ready()
    if dev.type == "cuda":
        torch.cuda.init()  # the allocator's statistics exist once CUDA is up
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
    marks.append(("cuda_s", clock()))
    rows_alloc, width = program.layout(cfg)
    rows, queries = gen.make(cfg, seed, dev, npool * batch, rows_alloc, width)
    pool = [np.ascontiguousarray(queries[i * batch:(i + 1) * batch]) for i in range(npool)]
    _sync(dev)
    marks.append(("inputs_s", clock()))
    engine = (build or program.build)(cfg, rows, dev)
    del rows
    if wrap is not None:
        engine = wrap(engine)
    _sync(dev)
    marks.append(("engine_s", clock()))
    warm = int(traffic["warmup_batches"])
    loop.run(engine, pool, k, lambda i, now: i >= warm, clock)
    _sync(dev)
    gc.collect()
    marks.append(("warmup_s", clock()))
    phases = {"built": built}
    last = t0
    for name, t in marks:
        phases[name] = t - last
        last = t
    gc.freeze()  # set-up's objects are not scanned by the window's collections

    prof = _profile(dev) if trace else None
    with prof if prof is not None else nullcontext():
        start = clock()
        win = loop.run(engine, pool, k, lambda i, now: now >= start + seconds, clock)
        _sync(dev)
        end = clock()
    setup_s = start - t0
    gc.unfreeze()
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reduced = _reduce_profile(prof, (end - start) * 1e6) if prof is not None else None

    data = RunData(cell=cell, setup_s=setup_s, start=start, seconds=float(seconds),
                   window=win, roofline=roofline, trace=reduced)
    t_check = clock()
    checks, failed = check_answers(cell, seed, win, dev, gen)
    correct = all(v <= lim for v, lim in checks.values())
    phases["check_s"] = clock() - t_check

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module(cell.root, "metrics", m["name"]).read(data)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": cell.chips, "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": cell.chips,
                "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(win.taken) * batch,
              "failed": int(failed), "metrics": metrics, "device": info}
    if reduced is not None:
        info["busy_s"] = reduced.busy_us * 1e-6
        info["window_s"] = reduced.window_us * 1e-6
        result["breakdown"] = reduced.breakdown()
    result["setup"] = phases
    result["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
    return result


def check_answers(cell: Cell, seed: int, win: Window, dev, gen):
    """Every answer of the window against the plain reference, which
    draws its own copy of the inputs from the seed: ``({name: (reading,
    limit)}, queries failed)``. The configuration's ``limits`` name the
    checks (see the reference's ``compare``); counts are summed over the
    window, gaps are its widest. A batch taken and never answered counts
    under ``missing``. An answer met again (the same batch, rows and
    distances) is judged once and counted each time."""
    cfg, traffic = cell.config, cell.traffic
    batch, k, npool = int(traffic["batch"]), int(traffic["k"]), int(traffic["pool_batches"])
    ref = load_module(cell.root, "reference", cfg["reference"])
    rows, queries = gen.make(cfg, seed, dev, npool * batch, int(cfg["rows"]), int(cfg["dim"]))
    used = sorted(set(win.pool))
    asked = {j: queries[j * batch:(j + 1) * batch] for j in used}
    expect = dict(zip(used, ref.answers(cfg, rows, [asked[j] for j in used], k)))
    limits = cfg["limits"]
    reading = {n: 0 for n in limits}
    judged, bad = {}, 0
    for j, (ids, dist) in zip(win.pool, win.answers):
        ids, dist = np.asarray(ids), np.asarray(dist)
        key = (j, ids.shape, ids.tobytes(), dist.shape, dist.tobytes())
        if key not in judged:
            if ids.shape != (batch, k) or dist.shape != (batch, k):
                judged[key] = ({n: float("inf") for n in limits}, batch)
            else:
                ref_ids, ref_dist = expect[j]
                exact = ref.distances_of(cfg, rows, asked[j], ids)
                per = ref.compare(cfg, ids, dist, ref_ids, ref_dist, exact)
                over = np.zeros(batch, dtype=bool)
                for n, lim in limits.items():
                    over |= ~(per[n] <= lim)
                judged[key] = ({n: per[n].sum() if n in COUNTS else per[n].max()
                                for n in limits}, int(over.sum()))
        got, b = judged[key]
        for n in limits:
            reading[n] = reading[n] + got[n] if n in COUNTS else max(reading[n], got[n])
        bad += b
    del rows
    missing = (len(win.taken) - len(win.answers)) * batch
    checks = {n: (int(v) if n in COUNTS and np.isfinite(v) else float(v), limits[n])
              for n, v in reading.items()}
    checks["missing"] = (missing, 0)
    return checks, bad + missing


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
