"""``high_verified``'s re-run of the failing queries on the card: in a batch
of 256 over a few thousand rows with a planted run of identical rows, the
queries on the run (and any other the certificate cannot hold) fail it and
re-run at ``"highest"`` as one sub-batch, whose scores and rows equal, bit
for bit, those that a whole-batch ``"highest"`` launch gives them; the
certified queries keep K3's re-score of the ``"high"`` scan's candidates. Marked ``cuda``: the
kernels run on a CUDA device only and these skip elsewhere
(``tests/test_torch_verified_rerun.py`` holds the same on the CPU). No JAX
here."""

import numpy as np
import pytest
import torch

import metrovector_tpu_torch.engine as eng_mod
from metrovector_tpu_torch import Builder, MicroBatcher, SearchEngine
from metrovector_tpu_torch.format.constants import DistanceMetric
from metrovector_tpu_torch.ops.distances import rescore_topk
from metrovector_tpu_torch.ops.topk_kernel import fused_topk

pytestmark = pytest.mark.cuda

K = 10
PLANTED = np.arange(7, 256, 25)  # 10 of 256 queries on the run of copies


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernels run on the card only")
    return torch.device("cuda")


def _planted(tmp_path, metric, dim, n=4096):
    """A ``high_verified`` engine on the card over ``n`` N(0, 1) rows with
    64 copies of one row (three times as long), and a batch of 256 queries:
    those at :data:`PLANTED` on the copies, the rest turned away from
    them."""
    rng = np.random.default_rng(23)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    dup = rng.choice(n, 64, replace=False)
    data[dup] = 3 * data[dup[0]]
    q = rng.standard_normal((256, dim)).astype(np.float32)
    q *= -np.sign(q @ data[dup[0]])[:, None]
    q[PLANTED] = data[dup[0]] + 1e-3 * rng.standard_normal((len(PLANTED), dim))
    b = Builder()
    b.add_vector_space("s", dim=dim, metric=metric)
    b.add_vectors("s", data)
    path = tmp_path / f"{metric.name}_{dim}.mvt"
    b.build().save(path)
    return SearchEngine.open(path, precision="high_verified"), q


@pytest.mark.parametrize("dim", [128, 960])
@pytest.mark.parametrize("metric", [DistanceMetric.L2, DistanceMetric.INNER_PRODUCT,
                                    DistanceMetric.COSINE])
def test_rerun_equals_whole_batch_highest(card, tmp_path, monkeypatch, metric, dim):
    eng, q = _planted(tmp_path, metric, dim)
    subs = []
    real = eng_mod.fused_topk

    def spy(queries, *args, **kw):
        if kw.get("precision", "highest") == "highest":
            subs.append(queries.clone())
        return real(queries, *args, **kw)

    monkeypatch.setattr(eng_mod, "fused_topk", spy)
    res = eng.search(q, k=K)
    monkeypatch.undo()
    sp = eng.space
    prep = sp.prepare_queries(q)
    # the certificate, query by query: K3's re-score of the "high" scan's
    # candidates against the scan's last fetched score
    hs, cand = fused_topk(prep.qdev, sp.data, sp.norms, sp.num_valid,
                          K + eng.verify_margin, sp.metric, precision="high")
    ks, ki = (t.cpu().numpy() for t in rescore_topk(prep.qdev, sp.data, sp.norms,
                                                    cand, K, sp.metric))
    b = hs[:, -1].cpu().numpy()
    ok = np.isneginf(b) | (ks[:, K - 1] > b + eng._verify_eps(prep))
    fail, cert = np.flatnonzero(~ok), np.flatnonzero(ok)
    assert set(PLANTED) <= set(fail) and len(fail) < 32
    assert eng.verify_stats == {"certified": len(cert), "fallbacks": len(fail)}
    assert len(subs) == 1 and torch.equal(subs[0], prep.qdev[fail])
    # the failing queries: as a whole-batch "highest" launch gives them
    s, i = fused_topk(prep.qdev, sp.data, sp.norms, sp.num_valid, K, sp.metric)
    np.testing.assert_array_equal(res.scores[fail], s.cpu().numpy()[fail])
    np.testing.assert_array_equal(res.indices[fail], i.cpu().numpy()[fail])
    # the certified ones: K3's answer
    np.testing.assert_array_equal(res.scores[cert], ks[cert])
    np.testing.assert_array_equal(res.indices[cert], ki[cert])


def test_pipelined_and_batcher_rerun_equal_search(card, tmp_path):
    """Planted batches through ``search_pipelined`` and the pipelined
    ``MicroBatcher``: each answer is ``search``'s, bit for bit."""
    eng, q = _planted(tmp_path, DistanceMetric.L2, 128)
    batches = [q, q[::-1].copy(), q[:128].copy()]
    want = [eng.search(b, k=K) for b in batches]
    got = list(eng.search_pipelined(iter(batches), k=K))
    with MicroBatcher(eng, k=K, max_batch=256, max_wait_ms=1.0, pipeline=True) as mb:
        got += [mb.submit(b).result(timeout=120) for b in batches]
    for a, b in zip(got, want + want):
        for name in ("indices", "scores", "distances", "ids"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
