"""The port's IVF against the JAX package on the CPU: ``bucket_layout`` and
``_plan_placements`` (host numpy copies), a JAX ``IVFIndex`` carried across
by ``IVFIndex.from_state`` and searched by both, the cases of
``tests/test_ivf.py``, the IVF cases of ``tests/test_index_filters.py`` and
``tests/test_index_ids.py`` through ``from_space`` on the port's own files,
and the port's ``delete_rows``.

Tolerance. Parity searches use integer-valued rows, queries and centroids
(trained centroids rounded), so every coarse score and every exact L2/IP
score is an exact f32 integer: there indices, scores and ids must be
identical. Cosine normalizes, so it is held to the f32 band of
``_torch_parity`` against float64 scores.
"""

import dataclasses

import numpy as np
import pytest

from metrovector_tpu import DistanceMetric
from metrovector_tpu.index import ivf as jax_ivf
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu_torch import Builder, Reader
from metrovector_tpu_torch.errors import DimensionMismatchError
from metrovector_tpu_torch.format.compact import compact
from metrovector_tpu_torch.index import ivf
from metrovector_tpu_torch.index.ivf import IVFIndex

from _torch_parity import METRICS, assert_topk_match, exact_scores, tolerance


def state_of(ref) -> dict:
    """A reference index's fields as host arrays and scalars (what
    ``from_state`` takes)."""
    out = {}
    for f in dataclasses.fields(ref):
        v = getattr(ref, f.name)
        out[f.name] = np.asarray(v) if hasattr(v, "shape") else v
    out["metric"] = int(ref.metric)
    return out


def _clustered(rng, n_clusters=8, per=100, d=16, spread=0.05):
    """``tests/test_ivf.py``'s float data."""
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 3
    return np.concatenate(
        [c + spread * rng.standard_normal((per, d)).astype(np.float32)
         for c in centers])


def _integer_clusters(seed, n=600, d=16, c=10, skew=False):
    """Integer-valued rows around integer centers (with ``skew`` one center
    holds most rows, so its cell splits into tied buckets)."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 8, (c, d)).astype(np.float32) * 30
    which = rng.integers(0, c, n)
    if skew:
        which[: n * 2 // 3] = 0
    rows = centers[which] + rng.integers(-3, 4, (n, d))
    return rows.astype(np.float32), rng


def _sq(x):
    return (np.asarray(x, np.float64) ** 2).sum(1).astype(np.float32)


def _ref_index(metric, seed=3, skew=False, num_clusters=8, ids=None,
               valid_mask=None):
    """A JAX IVFIndex over integer rows with integer centroids."""
    data, rng = _integer_clusters(seed, skew=skew)
    cents, assign = jax_ivf.train_kmeans(data, num_clusters, iters=4, seed=seed)
    cents = np.rint(cents).astype(np.float32)
    d2 = _sq(cents)[None, :] - 2.0 * (data.astype(np.float64) @ cents.T)
    assign = np.argmin(d2, axis=1).astype(np.int32)
    ref = jax_ivf.IVFIndex.build(data, _sq(data), metric, num_clusters,
                                 centroids=cents, assignments=assign,
                                 valid_mask=valid_mask, ids=ids)
    q = (data[rng.integers(0, len(data), 7)]
         + rng.integers(-9, 10, (7, data.shape[1]))).astype(np.float32)
    return ref, data, q, rng


def _same(a, b, metric, q, data, live=None):
    if metric == DistanceMetric.COSINE:
        assert_topk_match((a.scores, a.indices), (b.scores, b.indices),
                          exact=False, tol=tolerance(q, data, metric),
                          scores64=exact_scores(q, data, metric, live))
        return
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_allclose(a.distances, b.distances, rtol=1e-6)


# ------------------------------------------------------------- layout ---


@pytest.mark.parametrize("skew", [False, True])
def test_bucket_layout_matches_reference(skew):
    data, rng = _integer_clusters(1, n=1000, skew=skew)
    assign = rng.integers(0, 10, len(data)).astype(np.int32)
    if skew:
        assign[:900] = 0
    keep = rng.random(len(data)) > 0.1
    got = ivf.bucket_layout(assign, keep, 12)
    want = jax_ivf.bucket_layout(assign, keep, 12)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2] == want[2] and len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    if skew:
        assert (got[0] == 0).sum() > 1  # the heavy cell split


def test_plan_placements_matches_reference():
    rng = np.random.default_rng(2)
    cells = np.array([0, 0, 1, 2, 3], np.int32)
    fill = np.array([16, 9, 3, 16, 0])
    new = rng.integers(0, 5, 60)
    got = ivf._plan_placements(cells, fill, 16, new)
    want = jax_ivf._plan_placements(cells, fill, 16, new)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------ the reference ---


@pytest.mark.parametrize("nprobe", [1, 3, 100])
@pytest.mark.parametrize("skew", [False, True], ids=["even", "split"])
@pytest.mark.parametrize("metric", METRICS)
def test_from_state_search_matches_reference(metric, skew, nprobe):
    """Filters (raw and prepared), tombstones (file and ``delete_rows``),
    ids, and cells split into buckets whose coarse scores tie."""
    tomb = np.zeros(600, bool)
    tomb[[4, 50]] = True
    ids = np.arange(600, dtype=np.uint64)[::-1] * np.uint64(7) + np.uint64(3)
    ref, data, q, rng = _ref_index(metric, skew=skew, ids=ids.copy(),
                                   valid_mask=tomb)
    if skew:
        assert ref.num_buckets > ref.num_clusters
    port = IVFIndex.from_state(state_of(ref), device="cpu")
    assert (port.num_buckets, port.bucket_rows, port.num_clusters) == (
        ref.num_buckets, ref.bucket_rows, ref.num_clusters)
    mask = rng.random(len(data)) < 0.6
    live = mask & ~tomb
    for fm, ref_fm in ((None, None), (mask, mask),
                       (port.prepare_filter(mask), ref.prepare_filter(mask))):
        a = port.search(q, k=10, nprobe=nprobe, filter_mask=fm)
        b = ref.search(q, k=10, nprobe=nprobe, filter_mask=ref_fm)
        _same(a, b, metric, q, data, live if fm is not None else ~tomb)
    victims = port.search(q, k=1, nprobe=nprobe).indices[:, 0]
    port.delete_rows(victims[:3])
    ref.delete_rows(victims[:3])
    port.delete_rows(ids=ids[victims[3:]])
    ref.delete_rows(ids=ids[victims[3:]])
    a = port.search(q, k=10, nprobe=nprobe)
    b = ref.search(q, k=10, nprobe=nprobe)
    assert not np.isin(a.indices, [4, 50, *victims]).any()
    dead = tomb.copy()
    dead[victims] = True
    _same(a, b, metric, q, data, ~dead)


def test_delete_rows_errors_match_reference():
    ref, *_ = _ref_index(DistanceMetric.L2, ids=np.arange(600, dtype=np.uint64) + 5)
    port = IVFIndex.from_state(state_of(ref), device="cpu")
    from metrovector_tpu_torch.errors import (DimensionMismatchError,
                                              IndexOutOfBoundsError,
                                              VectorIdNotFoundError)
    with pytest.raises(IndexOutOfBoundsError):
        port.delete_rows([600])
    with pytest.raises(VectorIdNotFoundError):
        port.delete_rows(ids=[1])
    port.delete_rows([])  # nothing to do
    with pytest.raises(DimensionMismatchError):  # add_rows serves now
        port.add_rows(np.zeros((1, 8), np.float32))


# ------------------------------------------------ tests/test_ivf.py ---


def test_kmeans_recovers_clusters(rng):
    data = _clustered(rng)
    cents, assign = ivf.train_kmeans(data, 8, iters=15, seed=1, device="cpu")
    ref_c, ref_a = jax_ivf.train_kmeans(data, 8, iters=15, seed=1)
    np.testing.assert_allclose(cents, ref_c, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(assign, ref_a)
    groups = assign.reshape(8, 100)
    assert all(len(np.unique(g)) == 1 for g in groups)
    assert len({int(g[0]) for g in groups}) == 8


def test_kmeans_more_clusters_than_rows(rng):
    data = rng.standard_normal((5, 4)).astype(np.float32)
    cents, _ = ivf.train_kmeans(data, 16, iters=3, device="cpu")
    assert cents.shape[0] == 5


@pytest.mark.parametrize("metric", METRICS)
def test_ivf_full_probe_is_exact(rng, metric):
    data = _clustered(rng)
    idx = IVFIndex.build(data, _sq(data), metric, num_clusters=8, iters=10,
                         device="cpu")
    q = rng.standard_normal((5, 16)).astype(np.float32)
    res = idx.search(q, k=10, nprobe=8)
    _, oi = numpy_oracle(q, data, 10, metric)
    assert np.array_equal(res.indices, oi)


def test_ivf_high_recall_on_clustered_data(rng):
    data = _clustered(rng, n_clusters=16, per=200)
    idx = IVFIndex.build(data, _sq(data), DistanceMetric.L2, num_clusters=16,
                         iters=10, device="cpu")
    q = data[rng.choice(len(data), 20)] + 0.01 * rng.standard_normal(
        (20, 16)).astype(np.float32)
    res = idx.search(q, k=10, nprobe=2)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)
    recall = np.mean([len(set(res.indices[r]) & set(oi[r])) / 10 for r in range(20)])
    assert recall >= 0.9


def test_ivf_persistence_roundtrip(tmp_path, rng):
    data = _clustered(rng)
    cents, assign = ivf.train_kmeans(data, 8, iters=10, seed=2, device="cpu")
    b = Builder()
    b.add_vector_space("v", dim=16)
    b.add_vectors("v", data)
    b.set_ivf_index("v", cents, assign, nprobe=3)
    path = tmp_path / "ivf.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("v")
    idx = IVFIndex.from_space(sp, device="cpu")  # no retraining
    np.testing.assert_array_equal(idx.centroids, cents)
    assert idx.num_clusters == 8
    q = rng.standard_normal((4, 16)).astype(np.float32)
    res = idx.search(q, k=5, nprobe=8)
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2)
    assert np.array_equal(res.indices, oi)
    ref = jax_ivf.IVFIndex.build(data, _sq(data), DistanceMetric.L2, 8,
                                 centroids=cents, assignments=assign)
    want = ref.search(q, k=5, nprobe=3)
    got = idx.search(q, k=5, nprobe=3)
    np.testing.assert_array_equal(got.indices, want.indices)


def test_ivf_excludes_tombstones(tmp_path, rng):
    data = _clustered(rng)
    b = Builder()
    b.add_vector_space("v", dim=16)
    b.add_vectors("v", data)
    b.delete_vector("v", 50)
    path = tmp_path / "t.mvt"
    b.build().save(path)
    sp = Reader.open(path).vector_space("v")
    idx = IVFIndex.from_space(sp, num_clusters=8, iters=5, device="cpu")
    res = idx.search(data[50], k=5, nprobe=8)
    assert 50 not in res.indices


def test_ivf_k_exceeds_probed_rows(rng):
    data = _clustered(rng, n_clusters=4, per=10)
    idx = IVFIndex.build(data, _sq(data), DistanceMetric.L2, num_clusters=4,
                         iters=5, device="cpu")
    res = idx.search(data[0], k=30, nprobe=1)
    assert res.indices.shape == (1, 30)
    valid = res.indices[0][res.indices[0] >= 0]
    assert len(valid) >= 10
    assert res.indices[0, -1] == -1


# ----------------------------- tests/test_index_filters.py, IVF part ---


def _filter_data(rng, n=384, d=16, ncenters=12, spread=0.15):
    centers = rng.standard_normal((ncenters, d)).astype(np.float32)
    rows = centers[rng.integers(0, ncenters, n)]
    rows += spread * rng.standard_normal((n, d)).astype(np.float32)
    return rows.astype(np.float32)


def _mask(rng, n, sel=0.5):
    m = rng.random(n) < sel
    m[:2] = [True, False]
    return m


def test_ivf_full_probe_filter_equals_masked_oracle(rng):
    data = _filter_data(rng)
    idx = IVFIndex.build(data, _sq(data), DistanceMetric.L2, num_clusters=8,
                         iters=4, device="cpu")
    q = data[rng.integers(0, len(data), 6)] + 0.01
    mask = _mask(rng, len(data))
    res = idx.search(q, k=10, nprobe=idx.num_buckets, filter_mask=mask)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2, valid_mask=mask)
    assert np.array_equal(res.indices, oi)


def test_ivf_partial_probe_filter_never_leaks(rng):
    data = _filter_data(rng)
    idx = IVFIndex.build(data, _sq(data), DistanceMetric.L2, num_clusters=8,
                         iters=4, device="cpu")
    mask = _mask(rng, len(data), sel=0.25)
    res = idx.search(data[:4], k=8, nprobe=2, filter_mask=mask)
    assert mask[res.indices[res.indices >= 0]].all()
    again = idx.search(data[:4], k=8, nprobe=2, filter_mask=idx.prepare_filter(mask))
    assert np.array_equal(res.indices, again.indices)


def test_ivf_filter_shape_error(rng):
    data = _filter_data(rng, n=64)
    idx = IVFIndex.build(data, _sq(data), DistanceMetric.L2, num_clusters=4,
                         iters=2, device="cpu")
    with pytest.raises(DimensionMismatchError):
        idx.search(data[:1], k=3, filter_mask=np.ones(63, bool))
    stale = IVFIndex.build(data[:60], _sq(data[:60]), DistanceMetric.L2,
                           num_clusters=4, iters=2, device="cpu")
    with pytest.raises(DimensionMismatchError):  # prepared for another index
        idx.search(data[:1], k=3, filter_mask=stale.prepare_filter(np.ones(60, bool)))


# --------------------------------- tests/test_index_ids.py, IVF part ---


N_IDS, D_IDS = 96, 16


def _file_with_ids(tmp_path, rng, deleted=(), with_ids=True):
    data = rng.standard_normal((N_IDS, D_IDS)).astype(np.float32)
    ids = np.arange(N_IDS, dtype=np.uint64) * 13 + 500
    b = Builder()
    b.add_vector_space("e", dim=D_IDS)
    b.add_vectors("e", data, ids=ids if with_ids else None)
    for i in deleted:
        b.delete_vector("e", i)
    path = tmp_path / "idx_ids.mvt"
    b.build().save(path)
    return path, data, ids


def _check_ids(res, host_ids):
    assert res.ids is not None
    valid = res.indices >= 0
    assert np.array_equal(res.ids[valid], host_ids[res.indices[valid]])
    assert (res.ids[~valid] == np.uint64(2**64 - 1)).all()


def test_ivf_returns_ids(tmp_path, rng):
    path, _, ids = _file_with_ids(tmp_path, rng)
    idx = IVFIndex.from_space(Reader.open(path).vector_space("e"),
                              num_clusters=4, device="cpu")
    _check_ids(idx.search(rng.standard_normal((3, D_IDS)).astype(np.float32), k=5), ids)


def test_ivf_ids_default_positions(tmp_path, rng):
    path, data, _ = _file_with_ids(tmp_path, rng, with_ids=False)
    idx = IVFIndex.from_space(Reader.open(path).vector_space("e"),
                              num_clusters=4, device="cpu")
    res = idx.search(data[:2], k=4)
    valid = res.indices >= 0
    assert np.array_equal(res.ids[valid], res.indices[valid].astype(np.uint64))


def test_ivf_ids_survive_compaction(tmp_path, rng):
    deleted = (0, 5, 41)
    path, data, ids = _file_with_ids(tmp_path, rng, deleted=deleted)
    p2 = tmp_path / "compacted.mvt"
    compact(Reader.open(path), p2)
    sp = Reader.open(p2).vector_space("e")
    keep = np.ones(N_IDS, bool)
    keep[list(deleted)] = False
    q = data[keep][:2]
    idx = IVFIndex.from_space(sp, num_clusters=4, device="cpu")
    _check_ids(idx.search(q, k=3), ids[keep])
    res = idx.search(q, k=1, nprobe=idx.num_buckets)
    assert int(res.ids[0, 0]) == int(ids[keep][0]) == int(ids[1])


def test_cuda_request_without_cuda_raises(rng):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    data = _filter_data(rng, n=64)
    with pytest.raises(RuntimeError, match="cuda"):
        IVFIndex.build(data, _sq(data), DistanceMetric.L2, num_clusters=4, iters=2)
