"""The benchmark's readers of the program's spans (``perfbench/metrics/``:
``prepare_ms``, ``upload_ms``, ``enqueue_ms``, ``readback_ms``,
``result_ms``, ``host_gap_ms``) on synthetic spans and a synthetic run: each
mean a batch, the pairing of a read-back with the next enqueue in the
online and the pipelined loop, the window, and nothing where there is
nothing to read; then on the spans of the CPU engine itself."""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from metrovector_tpu_torch.engine import DeviceSpace, SearchEngine
from metrovector_tpu_torch.format.constants import DataType, DistanceMetric
from metrovector_tpu_torch.utils import timing
from perfbench import core, tracing

ROOT = Path(__file__).resolve().parents[1]
READERS = ("prepare_ms", "upload_ms", "enqueue_ms", "readback_ms", "result_ms",
           "host_gap_ms")
US = 1000  # ns
START_S = 100.0  # the window: [100 s, 101 s] on the perf_counter clock
T0 = int(START_S * 1e9)


def _reader(name):
    return core.load_module(ROOT, "metrics", name)


def _run(busy_us=5e5, trace=True, start=START_S, seconds=1.0):
    cell = core.Cell(name="synthetic", chips=1, config={}, traffic={"batch": 8},
                     end_to_end=[], per_layer=[], root=ROOT)
    tr = tracing.Trace(seconds * 1e6, busy_us, [], []) if trace else None
    return core.RunData(cell=cell, setup_s=0.0, start=start, seconds=seconds,
                        window=core.Window(), roofline={}, trace=tr)


class _Spans:
    """Spans laid out as the engine makes them, times in us from ``T0``."""

    def __init__(self):
        self.out, self.ids = [], iter(range(1, 10**6))

    def add(self, name, a, b, parent=None, batch=None):
        sid = next(self.ids)
        self.out.append(timing.Span(sid, name, T0 + a * US, T0 + b * US, parent, 1,
                                    batch))
        return sid

    def launch(self, batch, t):
        """prepare 30 us (upload 10 of it), enqueue 40 us; ends at t + 100."""
        top = self.add("engine.launch", t, t + 100, None, batch)
        prep = self.add("engine.prepare_queries", t + 10, t + 40, top, batch)
        self.add("engine.upload", t + 20, t + 30, prep, batch)
        self.add("ops.fused_topk", t + 50, t + 90, top, batch)

    def finalize(self, batch, t):
        """read-back 390 us, ending at t + 400; result 80 us; ends at t + 500."""
        top = self.add("engine.finalize", t, t + 500, None, batch)
        self.add("engine.readback", t + 10, t + 400, top, batch)
        self.add("engine.host_result", t + 410, t + 490, top, batch)


def _online(n=4, t=1000, period=1000):
    sp = _Spans()
    for b in range(n):
        sp.launch(b, t + b * period)
        sp.finalize(b, t + b * period + 100)
    return sp


def _pipelined(n=5, t=1000, period=1000):
    """launch 0, then each turn launch b + 1 and finalize b, as
    ``search_pipelined`` does."""
    sp = _Spans()
    sp.launch(0, t)
    for b in range(n):
        base = t + 100 + b * period
        if b + 1 < n:
            sp.launch(b + 1, base)
        sp.finalize(b, base + 100)
    return sp


@pytest.fixture
def spans_of(monkeypatch):
    def put(sp):
        out = sorted(sp.out, key=lambda s: s.start_ns)
        monkeypatch.setattr(timing, "spans", lambda: out)
    return put


@pytest.mark.parametrize("layout", [_online, _pipelined])
def test_each_reader_gives_its_mean_a_batch(spans_of, layout):
    spans_of(layout())
    got = {n: _reader(n).read(_run()) for n in READERS[:5]}
    assert got == pytest.approx({"prepare_ms": 0.020, "upload_ms": 0.010,
                                 "enqueue_ms": 0.040, "readback_ms": 0.390,
                                 "result_ms": 0.080}, abs=1e-12)


def test_host_gap_pairs_a_readback_with_the_next_enqueue_online(spans_of):
    # read-back b ends at 1000b + 1500; batch b + 1's enqueue at 1000b + 2090
    spans_of(_online(n=4))
    assert _reader("host_gap_ms").read(_run()) == pytest.approx(0.590, abs=1e-12)


def test_host_gap_pairs_a_readback_with_the_next_enqueue_pipelined(spans_of):
    # read-back b ends at 1000b + 1600, after batch b + 1's launch; the next
    # enqueue is batch b + 2's, ending at 1000b + 2190: three pairs of five
    sp = _pipelined(n=5)
    spans_of(sp)
    reads = [s for s in sp.out if s.name == "engine.readback"]
    assert len(reads) == 5
    assert _reader("host_gap_ms").read(_run()) == pytest.approx(0.590, abs=1e-12)
    # a batch's re-run inside its read-back is not the next enqueue
    top = next(s for s in sp.out if s.name == "engine.finalize" and s.batch == 0)
    sp.add("ops.fused_topk", 1300, 1350, top.id, 0)
    spans_of(sp)
    assert _reader("host_gap_ms").read(_run()) == pytest.approx(0.590, abs=1e-12)


def test_spans_outside_the_window_are_left_out(spans_of):
    sp = _online(n=4)
    # a batch wholly before the window, one across its end, and spans of no
    # batch inside it: none of them counts
    sp.launch(90, -5000)
    sp.finalize(90, -4900)
    sp.launch(91, 999_990)
    sp.add("ops.fused_topk", 600, 900)
    sp.add("engine.readback", 5000, 5005)
    spans_of(sp)
    run = _run()
    assert _reader("prepare_ms").read(run) == pytest.approx(0.020, abs=1e-12)
    assert _reader("enqueue_ms").read(run) == pytest.approx(0.040, abs=1e-12)
    assert _reader("host_gap_ms").read(run) == pytest.approx(0.590, abs=1e-12)
    later = _run(start=START_S + 2.0)
    assert all(_reader(n).read(later) is None for n in READERS)


def test_nothing_to_read_gives_none(spans_of, monkeypatch):
    spans_of(_Spans())
    assert all(_reader(n).read(_run()) is None for n in READERS)
    spans_of(_online(n=1))  # one batch: no next enqueue
    assert _reader("host_gap_ms").read(_run()) is None
    assert _reader("readback_ms").read(_run()) == pytest.approx(0.390, abs=1e-12)
    # no trace, or a trace that saw no work on the card
    assert all(_reader(n).read(_run(trace=False)) is None for n in READERS)
    assert all(_reader(n).read(_run(busy_us=0.0)) is None for n in READERS)
    # a recorder that dropped spans past its cap: the window is not whole
    monkeypatch.setattr(timing.RECORDER, "dropped", 1)
    assert all(_reader(n).read(_run()) is None for n in READERS)
    monkeypatch.setattr(timing.RECORDER, "dropped", 0)
    # a program that records no spans (the parent of this reader)
    monkeypatch.delattr(timing, "spans")
    assert all(_reader(n).read(_run()) is None for n in READERS)


def test_readers_on_the_cpu_engine_spans():
    """The engine's own spans, in a window that holds them: every reader
    reads, and a pipelined pass of n batches pairs n - 2 read-backs."""
    rng = np.random.default_rng(2)
    data = torch.from_numpy(rng.standard_normal((500, 32)).astype(np.float32))
    space = DeviceSpace(data=data, norms=(data * data).sum(1), num_valid=500, dim=32,
                        metric=DistanceMetric.L2, dtype=DataType.FLOAT32, name="s")
    eng = SearchEngine(space, device="cpu")
    qs = [rng.standard_normal((8, 32)).astype(np.float32) for _ in range(6)]
    list(eng.search_pipelined(qs[:2], k=4))  # warm
    timing.clear_spans()
    import time

    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        list(eng.search_pipelined(qs, k=4))
    run = _run(start=start, seconds=time.perf_counter() - start + 1e-3)
    got = {n: _reader(n).read(run) for n in READERS}
    assert all(v is not None and v > 0 for v in got.values()), got
    kept = timing.spans()
    ends = sorted(s.end_ns for s in kept if s.name == "engine.readback")
    enq = sorted((s.start_ns, s.end_ns) for s in kept if s.name == "ops.fused_topk")
    gaps = [next(b for a, b in enq if a >= r) - r for r in ends[:4]]
    assert got["host_gap_ms"] == pytest.approx(sum(gaps) / 4 / 1e6, rel=1e-12)
    timing.clear_spans()
