"""Timing and tracing on the card.

The counterpart of :mod:`metrovector_tpu.utils.timing`: a phase timer for
harnesses (:class:`PhaseTimer`) and a profiler trace around a block
(:func:`device_trace`, on ``torch.profiler``). PyTorch returns before the
device finishes, so a host clock measures the enqueue unless the device is
synchronized: :func:`sync_time` synchronizes, and :func:`cuda_ms` times
device work with CUDA events.

The program's own spans (:class:`SpanRecorder`, :data:`RECORDER`) mark its
host path while a ``torch.profiler`` session runs, and :func:`device_trace`
writes them into its Chrome trace beside the card's kernels and copies.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

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


SPAN_CAP = 1 << 20  # spans kept; a 51-s window of 32-query calls makes ~350k
SPAN_CAT = "mvt_span"  # the category of the program's spans in a Chrome trace


class Span(NamedTuple):
    """One span of the program: ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns``; ``parent`` the id of the span open around it
    on its thread (None at the top); ``thread`` the OS id of that thread;
    ``batch`` the search batch it serves (None outside one)."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    thread: int
    batch: int | None


class _Open:
    """A span begun and not yet ended."""

    __slots__ = ("id", "name", "start_ns", "parent", "batch", "thread")


class SpanRecorder:
    """The program's spans, kept in memory, at most ``cap`` of them; spans
    past the cap are counted in :attr:`dropped`. A span is recorded only
    while a ``torch.profiler`` session runs, and the call site reads the
    profiler's flag itself, so that without one a span costs a flag read
    and a branch, with no object made and no clock read::

        tok = (RECORDER.begin("engine.launch", RECORDER.new_batch())
               if _profiler._is_profiler_enabled else None)
        try:
            ...
        finally:
            if tok is not None:
                RECORDER.end(tok)

    (``_profiler`` is ``torch.autograd.profiler``). A span's parent is the
    span open around it on its thread; it serves its parent's batch unless
    given one. :meth:`end` closes the span and any left open inside it, so
    a span whose code raised before its end drops out, and only spans that
    may be the outermost need the ``finally``.

    :func:`device_trace` empties the recorder as its block starts, and takes
    the block's spans and empties it again as the block ends. A caller that
    runs ``torch.profiler`` itself reads :meth:`spans` and calls
    :meth:`clear` between its sessions; otherwise the spans of every session
    stay, up to the cap."""

    def __init__(self, cap: int = SPAN_CAP):
        self.cap = int(cap)
        self.dropped = 0
        self._kept: list[tuple] = []
        self._ids = itertools.count(1)
        self._batches = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def new_batch(self) -> int:
        """A new batch id."""
        return next(self._batches)

    def begin(self, name: str, batch: int | None = None) -> _Open:
        """Open the span ``name`` on this thread; its clock starts last."""
        local = self._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.thread = threading.get_native_id()
        tok = _Open()
        tok.id, tok.name, tok.thread = next(self._ids), name, local.thread
        if stack:
            up = stack[-1]
            tok.parent, tok.batch = up.id, up.batch if batch is None else batch
        else:
            tok.parent, tok.batch = None, batch
        stack.append(tok)
        tok.start_ns = time.perf_counter_ns()
        return tok

    def end(self, tok: _Open) -> None:
        """Close ``tok`` (and whatever was left open inside it) and keep it,
        or count it as dropped past the cap; its clock stops first."""
        end = time.perf_counter_ns()
        stack = getattr(self._local, "stack", None)
        if stack is not None and tok in stack:
            while stack.pop() is not tok:
                pass
        span = (tok.id, tok.name, tok.start_ns, end, tok.parent, tok.thread,
                tok.batch)
        with self._lock:
            if len(self._kept) < self.cap:
                self._kept.append(span)
            else:
                self.dropped += 1

    def spans(self) -> list[Span]:
        """The spans kept, by start."""
        with self._lock:
            kept = list(self._kept)
        return sorted(map(Span._make, kept), key=lambda s: (s.start_ns, s.id))

    def clear(self) -> None:
        """Forget every span kept and the count dropped."""
        with self._lock:
            self._kept.clear()
            self.dropped = 0


RECORDER = SpanRecorder()  # the process's spans, as the profiler is the process's


def spans() -> list[Span]:
    """The spans :data:`RECORDER` kept, by start."""
    return RECORDER.spans()


def clear_spans() -> None:
    """Forget :data:`RECORDER`'s spans."""
    RECORDER.clear()


def _clock_pair() -> tuple[int, int]:
    """``(perf_counter_ns, time_ns)`` read together."""
    a = time.perf_counter_ns()
    unix = time.time_ns()
    b = time.perf_counter_ns()
    return (a + b) // 2, unix


def _chrome_events(kept: list[Span], base_ns: int, pairs) -> list[dict]:
    """``kept`` as Chrome complete events (``"ph": "X"``, category
    :data:`SPAN_CAT`) on a trace whose events lie at ``base_ns`` + ``ts``
    µs in Unix ns, as ``torch.profiler`` writes them. ``pairs``: two
    ``(perf_counter_ns, time_ns)`` readings, before and after the spans;
    the clocks' offset is taken on the line between them."""
    (p0, u0), (p1, u1) = pairs
    slope = (u1 - u0) / (p1 - p0) if p1 > p0 else 1.0

    def us(t):
        return (u0 + (t - p0) * slope - base_ns) / 1e3

    pid = os.getpid()
    return [{"ph": "X", "cat": SPAN_CAT, "name": s.name, "pid": pid, "tid": s.thread,
             "ts": us(s.start_ns), "dur": (s.end_ns - s.start_ns) * slope / 1e3,
             "args": {"id": s.id, "parent": s.parent, "batch": s.batch}}
            for s in kept]


@contextlib.contextmanager
def device_trace(log_dir, device=None):
    """Record a ``torch.profiler`` trace of the block: host activity, and
    the card's kernels and copies when ``device`` is a CUDA device. Yields
    the path of the Chrome trace (``chrome://tracing``, Perfetto) that is
    written into ``log_dir`` when the block ends, with the program's spans
    of the block (:data:`RECORDER`, emptied as the block starts and once
    its spans are taken) as events of category :data:`SPAN_CAT` on the
    trace's own time base, and the count of spans dropped past the cap as
    the trace's ``mvtSpansDropped``. Raises where the trace
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
    RECORDER.clear()
    first = _clock_pair()
    with profile(activities=activities) as prof:
        yield path
    last = _clock_pair()
    kept, dropped = RECORDER.spans(), RECORDER.dropped
    RECORDER.clear()
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(
        _chrome_events(kept, int(doc.get("baseTimeNanoseconds", 0)), (first, last)))
    doc["mvtSpansDropped"] = dropped
    with open(path, "w") as f:
        json.dump(doc, f)


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
