"""The port's timing and tracing utilities (``metrovector_tpu_torch.utils``)
on the CPU: ``PhaseTimer`` accumulates as the JAX package's does and
prints the same report, ``device_trace`` writes a ``torch.profiler``
Chrome trace that holds the block's ``record_function`` span and raises
where it cannot trace, and ``sync_time`` returns the call's result. The
program's spans (``timing.RECORDER``): recorded only under a profiler, the
engine's names, parents and batch ids in ``search`` and
``search_pipelined``, ``high_verified``'s re-score, certificate and fallback
spans and its ``verify_stats`` under two finalizing threads, the cap, and
their place on the Chrome trace's clock."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from metrovector_tpu.utils import PhaseTimer as JaxPhaseTimer
from metrovector_tpu_torch.engine import DeviceSpace, SearchEngine
from metrovector_tpu_torch.format.constants import DataType, DistanceMetric
from metrovector_tpu_torch.utils import PhaseTimer, device_trace, sync_time, timing


def test_phase_timer_accumulates():
    t = PhaseTimer()
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    assert t.counts == {"a": 2, "b": 1}
    assert t.phases["a"] >= 0.01
    rep = t.report()
    assert "a" in rep and "b" in rep and "share" in rep


def test_phase_timer_report_matches_the_jax_one():
    phases = {"generate+build": 1.25, "device upload": 0.0625, "open": 0.0001,
              "search warmup": 0.5}
    counts = {"generate+build": 1, "device upload": 2, "open": 1, "search warmup": 3}
    port, ref = PhaseTimer(dict(phases), dict(counts)), JaxPhaseTimer(dict(phases),
                                                                      dict(counts))
    assert port.report() == ref.report()
    assert PhaseTimer().report() == JaxPhaseTimer().report()


def test_device_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    with device_trace(tmp_path / "trace", device="cpu") as path:
        with torch.profiler.record_function("mvt_test_span"):
            torch.ones(64, 64).sum()
    assert str(path).startswith(str(tmp_path / "trace"))
    events = json.loads(open(path).read())["traceEvents"]
    assert any(e.get("name") == "mvt_test_span" for e in events)


def test_device_trace_raises_where_it_cannot_trace(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: a CUDA trace can be taken")
    with pytest.raises(RuntimeError, match="cuda"):
        with device_trace(tmp_path, device="cuda"):
            pass
    assert not list(tmp_path.iterdir())  # no empty trace left behind


def test_sync_time_returns_result():
    dt, out = sync_time(lambda x: (x * 2).sum(), torch.ones(8), reps=2)
    assert dt >= 0 and float(out) == 16.0


# -- the program's spans ----------------------------------------------------

LAUNCH = ("engine.launch", [("engine.prepare_queries", [("engine.upload", [])]),
                            ("ops.fused_topk", [])])
FINALIZE = ("engine.finalize", [("engine.readback", []), ("engine.host_result", [])])


def _cpu_engine(rows=300, dim=24):
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.standard_normal((rows, dim)).astype(np.float32))
    space = DeviceSpace(data=data, norms=(data * data).sum(1), num_valid=rows, dim=dim,
                        metric=DistanceMetric.L2, dtype=DataType.FLOAT32, name="s")
    return SearchEngine(space, device="cpu"), rng


def _traced(fn):
    timing.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, timing.spans()


def _tree(spans, top):
    """``top``'s subtree as nested ``(name, [children])``, children by start."""
    kids = sorted((s for s in spans if s.parent == top.id), key=lambda s: s.start_ns)
    for c in kids:  # inside the parent, on its thread and batch
        assert top.start_ns <= c.start_ns <= c.end_ns <= top.end_ns
        assert (c.thread, c.batch) == (top.thread, top.batch)
    return (top.name, [_tree(spans, c) for c in kids])


def test_no_span_without_a_profiler(monkeypatch):
    eng, rng = _cpu_engine()
    q = rng.standard_normal((3, 24)).astype(np.float32)
    timing.clear_spans()

    def never(*a, **k):
        raise AssertionError("a span was begun with no profiler running")

    monkeypatch.setattr(timing.RECORDER, "begin", never)
    eng.search(q, k=5)
    list(eng.search_pipelined([q, q], k=5))
    monkeypatch.undo()
    assert timing.spans() == [] and timing.RECORDER.dropped == 0
    _, kept = _traced(lambda: eng.search(q, k=5))
    assert len(kept) == 7


def test_search_spans_names_parents_and_batch():
    eng, rng = _cpu_engine()
    q = rng.standard_normal((4, 24)).astype(np.float32)
    res, kept = _traced(lambda: eng.search(q, k=5))
    np.testing.assert_array_equal(res.indices, eng.search(q, k=5).indices)
    tops = [s for s in kept if s.parent is None]
    assert [_tree(kept, t) for t in tops] == [LAUNCH, FINALIZE]
    assert len({s.batch for s in kept}) == 1 and kept[0].batch is not None
    assert tops[0].end_ns <= tops[1].start_ns


def test_pipelined_spans_pair_each_launch_with_its_finalize():
    eng, rng = _cpu_engine()
    qs = [rng.standard_normal((n, 24)).astype(np.float32) for n in (2, 3, 4)]
    res, kept = _traced(lambda: list(eng.search_pipelined(qs, k=6)))
    assert [r.indices.shape[0] for r in res] == [2, 3, 4]
    tops = [s for s in kept if s.parent is None]
    assert [(t.name, t.batch) for t in tops] == [
        ("engine.launch", tops[0].batch), ("engine.launch", tops[0].batch + 1),
        ("engine.finalize", tops[0].batch), ("engine.launch", tops[0].batch + 2),
        ("engine.finalize", tops[0].batch + 1), ("engine.finalize", tops[0].batch + 2)]
    for t in tops:
        assert _tree(kept, t) == (LAUNCH if t.name == "engine.launch" else FINALIZE)
    assert all(a.end_ns <= b.start_ns for a, b in zip(tops, tops[1:]))


VERIFIED_LAUNCH = ("engine.launch", [("engine.prepare_queries", [("engine.upload", [])]),
                                     ("ops.fused_topk", []), ("engine.rescore", [])])


def _verified_finalize(fell):
    """The finalize tree at ``high_verified``: the certificate's check and,
    where it failed, the ``"highest"`` re-run, both inside the read-back."""
    inside = [("engine.verify", [])]
    if fell:
        inside.append(("engine.fallback", [("ops.fused_topk", [])]))
    return ("engine.finalize", [("engine.readback", inside), ("engine.host_result", [])])


def _verified_engine(dim=24):
    """A CPU engine at ``high_verified`` over N(0, 1) rows (the certificate
    holds) with 40 copies of one row (a query on them cannot be
    certified), and one query of each kind."""
    rng = np.random.default_rng(11)
    data = rng.standard_normal((300, dim)).astype(np.float32)
    data[100:140] = data[7]
    space = DeviceSpace(data=torch.from_numpy(data),
                        norms=torch.from_numpy((data * data).sum(1)), num_valid=300,
                        dim=dim, metric=DistanceMetric.L2, dtype=DataType.FLOAT32,
                        name="s", precision="high_verified")
    eng = SearchEngine(space, device="cpu", precision="high_verified")
    certified = rng.standard_normal((1, dim)).astype(np.float32)
    tied = (data[7] + 1e-4 * rng.standard_normal(dim)).astype(np.float32)[None]
    return eng, certified, tied


def test_verified_spans_nest_in_launch_and_readback():
    eng, certified, tied = _verified_engine()
    for q, fell in ((certified, False), (tied, True)):
        before = dict(eng.verify_stats)
        res, kept = _traced(lambda: eng.search(q, k=5))
        np.testing.assert_array_equal(res.indices, eng.search(q, k=5).indices)
        assert eng.verify_stats["fallbacks"] - before["fallbacks"] == 2 * fell
        tops = [s for s in kept if s.parent is None]
        assert [_tree(kept, t) for t in tops] == [VERIFIED_LAUNCH, _verified_finalize(fell)]
    # pipelined: each batch's spans under its own launch and finalize
    res, kept = _traced(lambda: list(eng.search_pipelined([certified, tied, certified], k=5)))
    tops = [s for s in kept if s.parent is None]
    fin = [t for t in tops if t.name == "engine.finalize"]
    assert [_tree(kept, t) for t in fin] == [_verified_finalize(f) for f in (False, True, False)]
    assert all(_tree(kept, t) == VERIFIED_LAUNCH for t in tops if t.name == "engine.launch")
    assert len({t.batch for t in fin}) == 3


def test_verified_spans_need_a_profiler(monkeypatch):
    eng, certified, tied = _verified_engine()
    timing.clear_spans()

    def never(*a, **k):
        raise AssertionError("a span was begun with no profiler running")

    monkeypatch.setattr(timing.RECORDER, "begin", never)
    eng.search(np.concatenate([certified, tied]), k=5)
    list(eng.search_pipelined([certified, tied], k=5))
    monkeypatch.undo()
    assert timing.spans() == [] and timing.RECORDER.dropped == 0
    assert eng.verify_stats == {"certified": 2, "fallbacks": 2}


def test_verify_stats_count_every_query_with_two_finalizing_threads():
    """Two threads finalize at once, with the interpreter switching threads
    as often as it can: no count is lost."""
    eng, certified, tied = _verified_engine()
    both = np.concatenate([certified, tied])
    rounds, errors = 60, []

    def work():
        try:
            for _ in range(rounds):
                eng.search(both, k=5)
        except Exception as e:  # noqa: BLE001 - reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    # each search: the N(0, 1) query certified, the tied one not
    assert eng.verify_stats == {"certified": 2 * rounds, "fallbacks": 2 * rounds}


def test_span_cap_drops_and_counts():
    rec = timing.SpanRecorder(cap=3)
    for i in range(5):
        rec.end(rec.begin(f"s{i}", batch=i))
    assert [(s.name, s.batch) for s in rec.spans()] == [("s0", 0), ("s1", 1), ("s2", 2)]
    assert rec.dropped == 2
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0


def test_a_span_left_open_by_a_raise_drops_out():
    rec = timing.SpanRecorder()
    top = rec.begin("top", batch=7)
    rec.begin("raised")  # its code raised before its end
    rec.end(top)
    after = rec.begin("after")
    rec.end(after)
    assert [(s.name, s.parent, s.batch) for s in rec.spans()] == [
        ("top", None, 7), ("after", None, None)]


def test_device_trace_puts_the_spans_on_the_trace_clock(tmp_path):
    """Ranges of ``record_function`` nested both ways in program spans lie
    where the spans say, within 50 us, on the Chrome trace's clock."""
    rec = timing.RECORDER
    rec.clear()
    with device_trace(tmp_path, device="cpu") as path:
        for i in range(3):
            outer = rec.begin("engine.launch", batch=100 + i)
            with torch.profiler.record_function(f"inside_{i}"):
                time.sleep(0.002)
            rec.end(outer)
            with torch.profiler.record_function(f"around_{i}"):
                inner = rec.begin("engine.finalize", batch=100 + i)
                time.sleep(0.002)
                rec.end(inner)
            time.sleep(0.001)
    events = json.loads(open(path).read())["traceEvents"]
    mine = [e for e in events if e.get("cat") == timing.SPAN_CAT]
    assert [(e["name"], e["args"]["batch"]) for e in mine] == [
        (n, 100 + i) for i in range(3) for n in ("engine.launch", "engine.finalize")]
    rf = {e["name"]: e for e in events if e.get("cat") != timing.SPAN_CAT}
    for i in range(3):
        span, inside = mine[2 * i], rf[f"inside_{i}"]
        assert span["ts"] - 50 <= inside["ts"]
        assert inside["ts"] + inside["dur"] <= span["ts"] + span["dur"] + 50
        span, around = mine[2 * i + 1], rf[f"around_{i}"]
        assert around["ts"] - 50 <= span["ts"]
        assert span["ts"] + span["dur"] <= around["ts"] + around["dur"] + 50
        assert span["dur"] >= 2000
    rec.clear()


def test_device_trace_takes_its_spans_and_empties_the_recorder(tmp_path):
    """Spans kept before the block are forgotten as it starts; the block's
    go into its trace and leave the recorder empty; the count dropped past
    the cap is the trace's ``mvtSpansDropped``."""
    rec = timing.RECORDER
    rec.clear()
    rec.end(rec.begin("before", batch=1))  # as a profiler session of a caller's left it
    cap = rec.cap
    try:
        rec.cap = 2
        with device_trace(tmp_path, device="cpu") as path:
            for i in range(3):
                rec.end(rec.begin("engine.launch", batch=10 + i))
    finally:
        rec.cap = cap
    doc = json.loads(open(path).read())
    mine = [e for e in doc["traceEvents"] if e.get("cat") == timing.SPAN_CAT]
    assert [(e["name"], e["args"]["batch"]) for e in mine] == [
        ("engine.launch", 10), ("engine.launch", 11)]
    assert doc["mvtSpansDropped"] == 1
    assert rec.spans() == [] and rec.dropped == 0
    with device_trace(tmp_path, device="cpu") as path:
        rec.end(rec.begin("engine.finalize", batch=20))
    doc = json.loads(open(path).read())
    assert [e["args"]["batch"] for e in doc["traceEvents"]
            if e.get("cat") == timing.SPAN_CAT] == [20]
    assert doc["mvtSpansDropped"] == 0
