"""Reduce a ``torch.profiler`` Chrome trace to what the per-layer metrics
read: the card's busy time in the window (the union of its kernels, copies
and sets), the operations that took the card longest and the longest idle
stretches of the card by what the host was doing.

The profiler records CUDA activity alone (kernels, copies and the CUDA
runtime calls), not every host operation, so that the host pays little for
the trace. The window is the host clock's: its length is given, and every
device event of the trace lies in it, since the profiler starts after the
warm-up has finished on the card and stops once the window's work has. All
times in the trace, host and device alike, are microseconds on one
clock."""

from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cuda_runtime", "cuda_driver"}
TOP = 10
NAME_CHARS = 160
IDLE_NO_HOST_EVENT = "host: between traced calls"
IDLE_OUTSIDE = "host: before the first or after the last device operation"


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, disjoint ``(start, end)`` covering the same time."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


@dataclasses.dataclass
class Trace:
    window_us: float
    busy_us: float
    device_ops: list
    idle_gaps: list

    def breakdown(self) -> dict:
        return {"device_ops": [[n, us * 1e-6] for n, us in self.device_ops],
                "idle_gaps": [[n, us * 1e-6] for n, us in self.idle_gaps]}


def _cat(e) -> str:
    return str(e.get("cat", "")).lower()


def reduce(events, window_us: float) -> Trace:
    """The :class:`Trace` of the complete events (``"ph": "X"``) of a Chrome
    trace over a window of ``window_us`` on the host clock."""
    spans = [e for e in events if e.get("ph") == "X"]
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
            str(e.get("name", "?"))[:NAME_CHARS]) for e in spans if _cat(e) in DEVICE_CATS]
    if not dev:
        return Trace(float(window_us), 0.0, [], [])
    w0, w1 = min(a for a, _, _ in dev), max(b for _, b, _ in dev)
    by_name = defaultdict(float)
    for a, b, n in dev:
        by_name[n] += b - a
    busy = union((a, b) for a, b, _ in dev)
    busy_us = sum(b - a for a, b in busy)

    # The card's idle stretches, each put down to the innermost host event
    # of the main thread (the one with most host events) running at its
    # middle; the window's time outside [w0, w1] to neither.
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    hosts = [e for e in spans if _cat(e) in HOST_CATS]
    main = Counter(e.get("tid") for e in hosts).most_common(1)
    host = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), str(e.get("name", "?")))
         for e in hosts if main and e.get("tid") == main[0][0]),
        key=lambda h: (h[0], -h[1]))
    idle, stack, j = defaultdict(float), [], 0
    for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (g0 + g1) / 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2][:NAME_CHARS] if stack else IDLE_NO_HOST_EVENT
        idle[name] += g1 - g0
    outside = window_us - (w1 - w0)
    if outside > 0:
        idle[IDLE_OUTSIDE] += outside

    def top(d):
        return sorted(d.items(), key=lambda kv: -kv[1])[:TOP]

    return Trace(window_us=float(window_us), busy_us=busy_us,
                 device_ops=top(by_name), idle_gaps=top(idle))
