"""The dense engine's transfers on the card: the upload of a batch's queries
through pinned memory without blocking, and the read-back of its answer on
an event of its own (``utils/transfer.py``'s ``upload`` and ``Readback``),
over the f32, int8, bf16 and ``high_verified`` routes. Marked ``cuda``:
these run on a CUDA device only and skip elsewhere (the CPU keeps plain
copies, which ``tests/test_torch_engine.py`` covers). No JAX here: each
answer is held against the port's own ``search``."""

import copy
import sys
import threading

import numpy as np
import pytest
import torch

from metrovector_tpu_torch import Builder, MicroBatcher, SearchEngine
from metrovector_tpu_torch.engine import DeviceSpace
from metrovector_tpu_torch.format.constants import (
    DataType,
    DistanceMetric,
    padded_rows_for,
)

pytestmark = pytest.mark.cuda

D = 128
ROUTES = {  # route: (dtype, precision)
    "f32": (DataType.FLOAT32, "highest"),
    "int8": (DataType.INT8, "highest"),
    "bf16": (DataType.BFLOAT16, "highest"),
    "high_verified": (DataType.FLOAT32, "high_verified"),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned read-backs and uploads run on the card only")
    return torch.device("cuda")


def _engine(tmp_path, route, n=50_000):
    """A ``SearchEngine`` on the card over ``n`` rows of the route's dtype,
    through a file, and a generator for its queries."""
    dtype, precision = ROUTES[route]
    rng = np.random.default_rng(11)
    b = Builder()
    sp = b.add_vector_space("s", dim=D, dtype=dtype, metric=DistanceMetric.L2)
    if dtype == DataType.INT8:
        sp.with_quantization(scale=1.0, zero_point=0.0)
        b.add_vectors("s", rng.integers(-127, 128, (n, D)).astype(np.int8))
    else:
        b.add_vectors("s", rng.standard_normal((n, D)).astype(np.float32))
    path = tmp_path / f"{route}.mvt"
    b.build().save(path)
    return SearchEngine.open(path, precision=precision), rng


def _queries(rng, route, rows):
    if ROUTES[route][0] == DataType.INT8:
        return rng.integers(-127, 128, (rows, D)).astype(np.float32)
    return rng.standard_normal((rows, D)).astype(np.float32)


def _assert_same(a, b):
    for name in ("indices", "scores", "distances", "ids"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def _pinned(arr) -> bool:
    assert arr.flags.c_contiguous
    return torch.from_numpy(arr.view(np.uint8)).is_pinned()


@pytest.mark.parametrize("route", list(ROUTES))
def test_pipelined_equals_search(card, tmp_path, route):
    eng, rng = _engine(tmp_path, route)
    batches = [_queries(rng, route, 64) for _ in range(6)]
    got = list(eng.search_pipelined(iter(batches), k=10))
    assert len(got) == len(batches)
    for batch, res in zip(batches, got):
        _assert_same(res, eng.search(batch, k=10))


@pytest.mark.parametrize("route", list(ROUTES))
def test_held_answers_unchanged_and_not_pinned(card, tmp_path, route):
    """Answers kept from the first two batches read the same after 8 more
    batches went through, and no array of any answer lies in pinned
    memory."""
    eng, rng = _engine(tmp_path, route)
    batches = [_queries(rng, route, 64) for _ in range(10)]
    held, kept = [], []
    for i, res in enumerate(eng.search_pipelined(iter(batches), k=10)):
        held.append(res)
        if i < 2:
            kept.append(copy.deepcopy(res))
    for res, was in zip(held, kept):
        _assert_same(res, was)
    for res in held:
        for name in ("indices", "scores", "distances", "ids"):
            assert not _pinned(getattr(res, name)), name


@pytest.mark.parametrize("route", list(ROUTES))
def test_caller_buffer_free_after_launch(card, tmp_path, route):
    """Overwriting the caller's query array right after the launch leaves
    its answer as it was: the upload staged its own copy."""
    eng, rng = _engine(tmp_path, route)
    q = _queries(rng, route, 64)
    want = eng.search(q.copy(), k=10)
    pending = eng._launch(q, 10)
    q[:] = q[::-1] * 3.0
    _assert_same(eng._finalize(pending, 10), want)


@pytest.mark.parametrize("route", list(ROUTES))
def test_microbatcher_pipeline_equals_search(card, tmp_path, route):
    """``MicroBatcher(pipeline=True)`` finalizes on its own thread; each
    request fills a batch by itself, so its answer is ``search``'s."""
    eng, rng = _engine(tmp_path, route)
    groups = [_queries(rng, route, 32) for _ in range(8)]
    with MicroBatcher(eng, k=10, max_batch=32, max_wait_ms=1.0, pipeline=True) as mb:
        futs = [mb.submit(g) for g in groups]
        got = [f.result(timeout=120) for f in futs]
    for g, res in zip(groups, got):
        _assert_same(res, eng.search(g, k=10))


def test_readback_stats_count_overlap(card):
    """A 16-batch pipelined run of 256 queries over 1M rows finds the card
    still busy with the next batch after all but at most two read-backs;
    after every ``search`` the card is drained."""
    n = 1_000_000
    gen = torch.Generator(device=card).manual_seed(5)
    rows = torch.zeros((padded_rows_for(n, DataType.FLOAT32), D), device=card)
    rows[:n] = torch.randn((n, D), device=card, generator=gen)
    space = DeviceSpace(data=rows, norms=(rows * rows).sum(1), num_valid=n, dim=D,
                        metric=DistanceMetric.L2)
    eng = SearchEngine(space)
    rng = np.random.default_rng(3)
    batches = [rng.standard_normal((256, D)).astype(np.float32) for _ in range(16)]
    list(eng.search_pipelined(iter(batches[:2]), k=10))  # warm-up
    eng.readback_stats.update(overlapped=0, drained=0)
    assert len(list(eng.search_pipelined(iter(batches), k=10))) == 16
    assert eng.readback_stats["overlapped"] >= 14, eng.readback_stats
    assert sum(eng.readback_stats.values()) == 16
    before = dict(eng.readback_stats)
    for q in batches[:5]:
        eng.search(q, k=10)
    assert eng.readback_stats == {"overlapped": before["overlapped"],
                                  "drained": before["drained"] + 5}


def test_readback_stats_under_threads(card, tmp_path):
    """Callers on more threads than cores, with a short switch interval,
    lose no count."""
    eng, rng = _engine(tmp_path, "f32", n=4096)
    q = _queries(rng, "f32", 8)
    threads, calls = 32, 20
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [eng.search(q, k=5) for _ in range(calls)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
            assert not w.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert sum(eng.readback_stats.values()) == threads * calls
