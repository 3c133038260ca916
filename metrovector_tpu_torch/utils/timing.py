"""Timing and tracing on the card.

The counterpart of :mod:`metrovector_tpu.utils.timing`: a phase timer for
harnesses (:class:`PhaseTimer`) and a profiler trace around a block
(:func:`device_trace`, on ``torch.profiler``). PyTorch returns before the
device finishes, so a host clock measures the enqueue unless the device is
synchronized: :func:`sync_time` synchronizes, and :func:`cuda_ms` times
device work with CUDA events.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class PhaseTimer:
    """Accumulates named wall-clock phases; prints a compact report. A
    phase that launches device work must end in a synchronize of its own
    to time that work."""

    phases: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.phases.values()) or 1.0
        lines = [f"{'phase':<24}{'total':>10}{'calls':>8}{'share':>8}"]
        for name, t in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:<24}{t * 1e3:>8.1f}ms{self.counts[name]:>8}"
                f"{100 * t / total:>7.1f}%"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir, device=None):
    """Record a ``torch.profiler`` trace of the block: host activity, and
    the card's kernels and copies when ``device`` is a CUDA device. Yields
    the path of the Chrome trace (``chrome://tracing``, Perfetto) that is
    written into ``log_dir`` when the block ends. Raises where the trace
    cannot be taken (CUDA asked for and absent, a profiler already
    running), never runs the block untraced."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device_trace on {device}: torch.cuda.is_available() is False")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def _sync(device: torch.device | None) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sync_time(fn, *args, device: torch.device | None = None, reps: int = 1,
              **kw) -> tuple[float, object]:
    """Host wall time of ``fn`` per call, ``device`` synchronized before and
    after; returns (seconds, last result)."""
    _sync(device)
    t0 = time.perf_counter()
    out = None
    for _ in range(reps):
        out = fn(*args, **kw)
    _sync(device)
    return (time.perf_counter() - t0) / reps, out


def cuda_ms(fn, inputs, device: torch.device) -> float:
    """Device milliseconds per call of ``fn(x)`` over ``inputs``, launched
    back to back between two CUDA events with one trailing synchronize.
    Warm ``fn`` up before calling this."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream(device)
    start.record(stream)
    for x in inputs:
        fn(x)
    stop.record(stream)
    stop.synchronize()
    return start.elapsed_time(stop) / len(inputs)


def device_ms(fn, inputs, device: torch.device) -> float:
    """Device milliseconds per call of ``fn(x)`` over ``inputs`` for work
    shorter than its launch on the host: the device first sleeps, so the
    host has queued every call before the start event is reached and the
    events time the device alone. Warm ``fn`` up before calling this."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream(device)
    with torch.cuda.device(device):
        torch.cuda._sleep(50_000_000)  # about 25 ms at 2 GHz
    start.record(stream)
    for x in inputs:
        fn(x)
    stop.record(stream)
    stop.synchronize()
    return start.elapsed_time(stop) / len(inputs)
