"""``precision="high_verified"`` of the port's engine on the CPU against the
JAX engine (``backend="pallas"``, interpreted) and the f64 oracle: every
case of ``tests/test_verified_high.py``, with ``verify_stats`` held to the
JAX engine's on the same corpora, plus a planted corpus where the
certificate fails and the ``"highest"`` re-run gives the oracle's answer,
the longer pending tuple through ``search_pipelined``, and
``_verify_eps``'s bound against the errors it bounds."""

import numpy as np
import pytest
import torch

from metrovector_tpu.engine import SearchEngine as JaxEngine
from metrovector_tpu.format.builder import Builder
from metrovector_tpu.format.constants import DistanceMetric
from metrovector_tpu.ops.distances import numpy_oracle
from metrovector_tpu_torch import MicroBatcher, SearchEngine
from metrovector_tpu_torch.engine import VERIFY_SAFETY, high_dot_bounds
from metrovector_tpu_torch.ops.distances import rescore_topk
from metrovector_tpu_torch.ops.topk_kernel import fused_topk

METRICS = [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT]


def _path(tmp_path, data, metric=DistanceMetric.L2, name="v"):
    b = Builder()
    b.add_vector_space(name, dim=data.shape[1], metric=metric)
    b.add_vectors(name, data)
    path = tmp_path / f"{name}.mvt"
    b.build().save(path)
    return path


def _engines(tmp_path, data, metric=DistanceMetric.L2, name="v", **kw):
    """(port, JAX) engines at high_verified over one file."""
    path = _path(tmp_path, data, metric, name)
    port = SearchEngine.open(path, device="cpu", precision="high_verified", **kw)
    ref = JaxEngine.open(path, backend="pallas", precision="high_verified", **kw)
    return port, ref


@pytest.mark.parametrize("metric", METRICS)
def test_verified_high_matches_oracle(tmp_path, rng, metric):
    data = rng.standard_normal((500, 64)).astype(np.float32)
    port, ref = _engines(tmp_path, data, metric)
    q = rng.standard_normal((7, 64)).astype(np.float32)
    res = port.search(q, k=10)
    _, oi = numpy_oracle(q, data, 10, metric)
    np.testing.assert_array_equal(res.indices, oi)
    np.testing.assert_array_equal(res.indices, ref.search(q, k=10).indices)
    # well-separated data: the certificate holds, no "highest" re-run
    assert port.verify_stats == ref.verify_stats == {"certified": 7, "fallbacks": 0}


def test_verified_high_matches_highest_on_near_ties(tmp_path, rng):
    """high_verified == highest bit for rank on data dense with near-ties
    (a cluster far from the origin, score gaps a few f32 ulps); the
    guarantee comes from the fallback, as in the reference."""
    base = np.full(32, 100.0, np.float32)
    data = (base + 0.1 * rng.standard_normal((300, 32))).astype(np.float32)
    q = (base + 0.1 * rng.standard_normal((9, 32))).astype(np.float32)
    port, ref = _engines(tmp_path, data)
    res_v = port.search(q, k=10)
    hi = SearchEngine.open(_path(tmp_path, data, name="hx"), device="cpu")
    res_h = hi.search(q, k=10)
    np.testing.assert_array_equal(res_v.indices, res_h.indices)
    np.testing.assert_allclose(res_v.scores, res_h.scores, rtol=1e-6)
    np.testing.assert_array_equal(res_v.indices, ref.search(q, k=10).indices)
    assert port.verify_stats["fallbacks"] > 0
    assert port.verify_stats == ref.verify_stats


def test_verified_high_exact_ties_break_low_index(tmp_path, rng):
    row = rng.standard_normal(32).astype(np.float32)
    data = rng.standard_normal((100, 32)).astype(np.float32) * 10
    for i in (3, 17, 42, 77):  # plant 4 identical rows
        data[i] = row
    port, ref = _engines(tmp_path, data)
    res = port.search(row[None, :], k=4)
    np.testing.assert_array_equal(res.indices, [[3, 17, 42, 77]])
    np.testing.assert_array_equal(ref.search(row[None, :], k=4).indices,
                                  res.indices)
    assert port.verify_stats == ref.verify_stats


def test_verified_high_composes_with_filters(tmp_path, rng):
    data = rng.standard_normal((400, 48)).astype(np.float32)
    port, ref = _engines(tmp_path, data)
    q = rng.standard_normal((5, 48)).astype(np.float32)
    fm = (np.arange(400) % 3 == 0)
    res = port.search(q, k=10, filter_mask=fm)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2, valid_mask=fm)
    np.testing.assert_array_equal(res.indices, oi)
    np.testing.assert_array_equal(
        res.indices, ref.search(q, k=10, filter_mask=fm).indices)
    assert port.verify_stats == ref.verify_stats


def test_verified_high_sparse_filter_sentinels(tmp_path, rng):
    """Fewer passing rows than k: -1 in the tail, the passing rows exact."""
    data = rng.standard_normal((200, 32)).astype(np.float32)
    port, ref = _engines(tmp_path, data)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    fm = np.zeros(200, bool)
    fm[[5, 50, 150]] = True
    res = port.search(q, k=8, filter_mask=fm)
    _, oi = numpy_oracle(q, data, 8, DistanceMetric.L2, valid_mask=fm)
    np.testing.assert_array_equal(res.indices[:, :3], oi[:, :3])
    assert (res.indices[:, 3:] == -1).all()
    np.testing.assert_array_equal(
        res.indices, ref.search(q, k=8, filter_mask=fm).indices)
    assert port.verify_stats == ref.verify_stats


def test_verified_high_margin_clamps_to_corpus(tmp_path, rng):
    """k + margin past num_valid clamps; every row is then re-scored and
    the batch is certified by construction (no statistics)."""
    data = rng.standard_normal((12, 32)).astype(np.float32)
    port, ref = _engines(tmp_path, data, verify_margin=64)
    q = rng.standard_normal((2, 32)).astype(np.float32)
    res = port.search(q, k=10)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)
    np.testing.assert_array_equal(res.indices, oi)
    ref.search(q, k=10)
    assert port.verify_stats == ref.verify_stats == {"certified": 0, "fallbacks": 0}


def test_verify_margin_validation(tmp_path, rng):
    data = rng.standard_normal((20, 32)).astype(np.float32)
    path = _path(tmp_path, data)
    with pytest.raises(ValueError, match="verify_margin"):
        SearchEngine.open(path, device="cpu", precision="high_verified",
                          verify_margin=0)
    with pytest.raises(ValueError, match="unknown precision"):
        SearchEngine.open(path, device="cpu", precision="bogus")


def test_rescore_topk_unit(rng):
    """The repair primitive on its own: candidates in the wrong order, a -1
    slot and an exact tie."""
    db = rng.standard_normal((50, 16)).astype(np.float32)
    db[7] = db[31]  # exact tie pair
    norms = np.einsum("ij,ij->i", db, db).astype(np.float32)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    cand = np.array([[31, 4, 7, 2, -1], [10, 11, 12, 13, 14]], np.int32)
    s, i = rescore_topk(torch.from_numpy(q), torch.from_numpy(db),
                        torch.from_numpy(norms), torch.from_numpy(cand), 3,
                        DistanceMetric.L2)
    i = i.numpy()
    for r in range(2):
        valid = cand[r][cand[r] >= 0]
        exact = {int(c): 2.0 * float(np.dot(q[r], db[c])) - float(norms[c])
                 for c in valid}
        want = sorted(exact, key=lambda c: (-exact[c], c))[:3]
        assert list(i[r]) == want
    r0 = list(i[0])
    if 7 in r0 and 31 in r0:
        assert r0.index(7) < r0.index(31)


def test_rescore_topk_all_invalid():
    db = np.eye(4, 16, dtype=np.float32)
    cand = np.full((1, 3), -1, np.int32)
    s, i = rescore_topk(torch.zeros((1, 16)), torch.from_numpy(db),
                        torch.ones(4), torch.from_numpy(cand), 2,
                        DistanceMetric.L2)
    assert (i == -1).all() and torch.isneginf(s).all()


@pytest.mark.parametrize("metric", METRICS)
def test_verified_high_serving_pad_rows_certify(tmp_path, rng, metric):
    """MicroBatcher pads off-rung batches by repeating a real query, so a
    pad row certifies like the query it copies (a zero row would fail the
    certificate, 0 > 0 + eps, and re-run every padded batch at highest)."""
    data = rng.standard_normal((500, 64)).astype(np.float32)
    port, _ = _engines(tmp_path, data, metric)
    q = rng.standard_normal((3, 64)).astype(np.float32)  # pads 3 -> 4
    with MicroBatcher(port, k=5, max_wait_ms=20.0) as mb:
        futs = [mb.submit(q[i]) for i in range(3)]
        got = [f.result(timeout=300) for f in futs]
    _, oi = numpy_oracle(q, data, 5, metric)
    for i in range(3):
        np.testing.assert_array_equal(got[i].indices[0], oi[i])
    assert port.verify_stats["fallbacks"] == 0
    assert port.verify_stats["certified"] >= 4  # the pad row too


def test_certificate_fails_and_highest_rerun_is_exact(tmp_path, rng):
    """40 copies of one row, a query on it: the fetch boundary (rank 18)
    ties the exact k-th score, so no query can be certified; the batch
    re-runs at "highest" and returns the oracle's answer, lowest rows
    first, as the JAX engine does."""
    data = rng.standard_normal((300, 32)).astype(np.float32)
    dup = rng.choice(300, 40, replace=False)
    data[dup] = 3 * data[dup[0]]  # long enough to lead for IP too
    q = np.stack([data[dup[0]] + 1e-3 * rng.standard_normal(32),
                  data[dup[0]]]).astype(np.float32)
    for metric in METRICS:
        port, ref = _engines(tmp_path, data, metric, name=metric.name)
        res = port.search(q, k=10)
        _, oi = numpy_oracle(q, data, 10, metric)
        np.testing.assert_array_equal(res.indices, oi)
        np.testing.assert_array_equal(res.indices, np.sort(dup)[None, :10].repeat(2, 0))
        assert port.verify_stats == {"certified": 0, "fallbacks": 2}
        np.testing.assert_array_equal(res.indices, ref.search(q, k=10).indices)
        assert port.verify_stats == ref.verify_stats


def test_pipelined_and_batcher_carry_the_certificate(tmp_path, rng):
    """search_pipelined and the pipelined MicroBatcher hand the longer
    pending tuple from _launch to _finalize: the same results and the same
    counts as search()."""
    data = rng.standard_normal((400, 40)).astype(np.float32)
    port, _ = _engines(tmp_path, data)
    batches = [rng.standard_normal((n, 40)).astype(np.float32) for n in (3, 5, 2)]
    want = [port.search(b, k=6) for b in batches]
    stats = dict(port.verify_stats)
    got = list(port.search_pipelined(batches, k=6))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.scores, b.scores)
    assert port.verify_stats["certified"] == 2 * stats["certified"] == 20
    with MicroBatcher(port, k=6, max_batch=4, max_wait_ms=1.0, pipeline=True) as mb:
        futs = [mb.submit(v) for v in batches[1]]
        res = [f.result(timeout=60) for f in futs]
    for r, row in zip(res, want[1].indices):
        np.testing.assert_array_equal(r.indices[0], row)


@pytest.mark.parametrize("metric", METRICS)
def test_verify_eps_bounds_high_against_rescore(tmp_path, metric):
    """On data built to stress the sums (all-positive rows, so nothing
    cancels, and N(0, 1) rows), |"high" score − re-scored f32 score| of the
    fetched candidates stays within the raw bound (eps / VERIFY_SAFETY), and
    eps is the documented C(D) in score space."""
    rng = np.random.default_rng(8)
    for j, data in enumerate((rng.random((300, 200)).astype(np.float32),
                              rng.standard_normal((300, 200)).astype(np.float32))):
        port, _ = _engines(tmp_path, data, metric, name=f"d{j}")
        q = (rng.random((6, 200)) if data.min() >= 0
             else rng.standard_normal((6, 200))).astype(np.float32)
        sp = port.space
        prep = sp.prepare_queries(q)
        s_h, i_h = fused_topk(prep.qdev, sp.data, sp.norms, sp.num_valid, 18,
                              sp.metric, precision="high")
        s_r, i_r = rescore_topk(prep.qdev, sp.data, sp.norms, i_h, 18, sp.metric)
        raw = port._verify_eps(prep).astype(np.float64) / VERIFY_SAFETY
        s_h, i_h, s_r, i_r = (t.numpy() for t in (s_h, i_h, s_r, i_r))
        for r in range(6):
            exact = dict(zip(i_r[r], s_r[r].astype(np.float64)))
            err = max(abs(float(s) - exact[i]) for s, i in zip(s_h[r], i_h[r]))
            assert err <= raw[r]
        c = sum(high_dot_bounds(200))
        if metric == DistanceMetric.COSINE:
            np.testing.assert_allclose(raw, c + 212 * 2.0**-25, rtol=1e-6)
