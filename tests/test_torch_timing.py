"""The port's timing and tracing utilities (``metrovector_tpu_torch.utils``)
on the CPU: ``PhaseTimer`` accumulates as the JAX package's does and
prints the same report, ``device_trace`` writes a ``torch.profiler``
Chrome trace that holds the block's ``record_function`` span and raises
where it cannot trace, and ``sync_time`` returns the call's result."""

import json
import time

import pytest
import torch

from metrovector_tpu.utils import PhaseTimer as JaxPhaseTimer
from metrovector_tpu_torch.utils import PhaseTimer, device_trace, sync_time


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
