"""``high_verified``'s fallback re-runs only the queries that fail the
certificate: on a batch that mixes certified queries with queries on a
planted run of identical rows, the port's engine launches ``"highest"`` on
exactly the failing rows of the uploaded queries, keeps K3's re-scored
answer for the rest, and answers as the f64 oracle and the JAX engine (which
re-runs the whole batch) do, through ``search``, ``search_pipelined`` and
``MicroBatcher``."""

import numpy as np
import pytest
import torch

import metrovector_tpu_torch.engine as eng_mod
from metrovector_tpu.engine import SearchEngine as JaxEngine
from metrovector_tpu.format.builder import Builder
from metrovector_tpu.format.constants import DistanceMetric
from metrovector_tpu.ops.distances import numpy_oracle
from metrovector_tpu_torch import MicroBatcher, SearchEngine

METRICS = [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT]
K = 10
FAIL = [1, 4, 5]  # rows of the mixed batch that sit on the planted run
CERT = [0, 2, 3, 6, 7]


class _Spy:
    """Records the queries and the precision of every ``fused_topk`` call the
    engine makes."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = eng_mod.fused_topk

        def spy(queries, *args, **kw):
            self.calls.append((queries.clone(), kw.get("precision", "highest")))
            return real(queries, *args, **kw)

        monkeypatch.setattr(eng_mod, "fused_topk", spy)

    def fallbacks(self):
        return [q for q, p in self.calls if p == "highest"]


def _mixed(tmp_path, metric, name="v"):
    """A file of N(0, 1) rows with 40 copies of one row (three times as long,
    to lead for IP too), and a batch of 8 queries: N(0, 1) ones, which the
    certificate holds (each turned away from the copies), at ``CERT``, and queries on the copies, which it
    cannot certify (the fetch boundary ties the exact k-th score), at
    ``FAIL``."""
    rng = np.random.default_rng(5)
    data = rng.standard_normal((300, 32)).astype(np.float32)
    dup = rng.choice(300, 40, replace=False)
    data[dup] = 3 * data[dup[0]]
    keep = np.arange(300) % 3 != 0  # a filter: a third of the rows out,
    keep[dup] = True                # the planted run kept
    q = rng.standard_normal((8, 32)).astype(np.float32)
    q *= -np.sign(q @ data[dup[0]])[:, None]  # the copies far from the others
    q[FAIL] = data[dup[0]] + 1e-3 * rng.standard_normal((len(FAIL), 32))
    b = Builder()
    b.add_vector_space(name, dim=32, metric=metric)
    b.add_vectors(name, data)
    path = tmp_path / f"{name}.mvt"
    b.build().save(path)
    return path, data, q, keep


def _same(a, b, rows=slice(None)):
    """``a``'s ``rows`` equal ``b`` bit for bit."""
    np.testing.assert_array_equal(a.indices[rows], b.indices)
    np.testing.assert_array_equal(a.scores[rows], b.scores)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_search_reruns_only_the_failing_queries(tmp_path, monkeypatch, metric, filtered):
    path, data, q, keep = _mixed(tmp_path, metric)
    fm = keep if filtered else None
    port = SearchEngine.open(path, device="cpu", precision="high_verified")
    spy = _Spy(monkeypatch)
    res = port.search(q, k=K, filter_mask=fm)
    assert port.verify_stats == {"certified": len(CERT), "fallbacks": len(FAIL)}
    # one "high" launch of the whole batch, one "highest" of the failing rows
    assert [p for _, p in spy.calls] == ["high", "highest"]
    want = port.space.prepare_queries(q).qdev[FAIL]
    (sub,) = spy.fallbacks()
    assert sub.shape == (len(FAIL), port.space.padded_dim)
    assert torch.equal(sub, want)
    # certified rows: K3's answer, as for those queries searched alone
    alone = port.search(q[CERT], k=K, filter_mask=fm)
    assert port.verify_stats == {"certified": 2 * len(CERT), "fallbacks": len(FAIL)}
    assert len(spy.fallbacks()) == 1
    _same(res, alone, CERT)
    # failing rows: a "highest" engine's answer for those queries
    hi = SearchEngine.open(path, device="cpu")
    _same(res, hi.search(q[FAIL], k=K, filter_mask=fm), FAIL)
    _, oi = numpy_oracle(q, data, K, metric, valid_mask=fm)
    np.testing.assert_array_equal(res.indices, oi)
    ref = JaxEngine.open(path, backend="pallas", precision="high_verified")
    np.testing.assert_array_equal(res.indices, ref.search(q, k=K, filter_mask=fm).indices)
    assert ref.verify_stats == {"certified": len(CERT), "fallbacks": len(FAIL)}


@pytest.mark.parametrize("mode", ["pipelined", "batcher", "batcher_pipeline"])
def test_serving_paths_rerun_only_the_failing_queries(tmp_path, monkeypatch, mode):
    """Three mixed batches (the middle one all certified) through
    ``search_pipelined`` or one ``MicroBatcher`` request a batch: each answer
    is ``search``'s, and each fallback launch holds that batch's failing rows
    alone."""
    path, _, q, _ = _mixed(tmp_path, DistanceMetric.L2)
    port = SearchEngine.open(path, device="cpu", precision="high_verified")
    batches = [q, q[CERT[:4]], q[::-1].copy()]  # on the batcher's rungs: no pad row
    want = [port.search(b, k=K) for b in batches]
    stats = dict(port.verify_stats)
    assert stats == {"certified": 2 * len(CERT) + 4, "fallbacks": 2 * len(FAIL)}
    spy = _Spy(monkeypatch)
    if mode == "pipelined":
        got = list(port.search_pipelined(iter(batches), k=K))
    else:
        with MicroBatcher(port, k=K, max_batch=8, max_wait_ms=1.0,
                          pipeline=mode == "batcher_pipeline") as mb:
            got = []
            for b in batches:  # one at a time: each request is its own batch
                got.append(mb.submit(b).result(timeout=120))
    for a, b in zip(got, want):
        _same(a, b)
    assert port.verify_stats == {k: 2 * v for k, v in stats.items()}
    padded = port.space.padded_dim
    subs = spy.fallbacks()
    assert [s.shape for s in subs] == [(len(FAIL), padded)] * 2
    qdev = [port.space.prepare_queries(b).qdev for b in batches]
    assert torch.equal(subs[0], qdev[0][FAIL])
    assert torch.equal(subs[1], qdev[2][sorted(7 - i for i in FAIL)])
