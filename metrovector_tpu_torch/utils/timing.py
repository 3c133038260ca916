"""Timing on the card.

The counterpart of :mod:`metrovector_tpu.utils.timing`. PyTorch returns
before the device finishes, so a host clock measures the enqueue unless the
device is synchronized: :func:`sync_time` synchronizes, and :func:`cuda_ms`
times device work with CUDA events.
"""

from __future__ import annotations

import time

import torch


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
