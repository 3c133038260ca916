"""The port's IVF-PQ against the JAX package on the CPU: a JAX
``IVFPQIndex`` carried across by ``IVFPQIndex.from_state`` and searched by
both in both serving modes (the JAX scan runs its Pallas kernel in
interpret mode, as its own tests run it), over 3 metrics × uint8/packed4
codes × rerank 0/R × f32/bf16 LUT, with filters, tombstones, ids, and
cells split into buckets whose coarse scores tie; then the cases of
``tests/test_ivfpq.py`` (its ``add_rows`` steps against the reference are in
``tests/test_torch_mutation.py``), and the IVF-PQ cases of
``tests/test_index_filters.py`` and ``tests/test_index_ids.py`` on the
port's own files.

Tolerance. Parity searches use integer-valued rows, queries, centroids
(trained ones rounded) and codebooks, every intermediate below 2^24: every
coarse dot, LUT entry (also once rounded to bf16, which maps an integer to
an integer), bucket bias, ADC sum and exact L2/IP score is an exact f32
integer, so indices, scores and ids must be identical. Cosine normalizes,
so it is held to the f32 band of ``_torch_parity`` against float64 scores
of the rows it ranks (the reconstructions without a re-rank, the original
rows with one).
"""

import dataclasses
import functools

import numpy as np
import pytest

from metrovector_tpu import DistanceMetric
from metrovector_tpu.index import ivf as jax_ivf
from metrovector_tpu.index import ivfpq as jax_ivfpq
from metrovector_tpu.index import pq as jax_pq
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu_torch import Builder, Reader
from metrovector_tpu_torch.errors import (
    BuildError,
    DimensionMismatchError,
    InvalidVectorTypeError,
)
from metrovector_tpu_torch.format.compact import compact
from metrovector_tpu_torch.index import ivf, pq
from metrovector_tpu_torch.index.ivfpq import IVFPQIndex, train_ivfpq
from metrovector_tpu_torch.index.pq import PQIndex, reconstruct_pq
from metrovector_tpu_torch.ops.adc_kernel import fused_adc_topk

from _torch_parity import METRICS, assert_topk_match, exact_scores, tolerance

M, KSUB, D = 4, 16, 16


def state_of(ref) -> dict:
    """A reference index's fields as host arrays and scalars (what
    ``from_state`` takes)."""
    out = {}
    for f in dataclasses.fields(ref):
        if f.name.startswith("_"):
            continue
        v = getattr(ref, f.name)
        out[f.name] = np.asarray(v) if hasattr(v, "shape") else v
    out["metric"] = int(ref.metric)
    return out


@functools.lru_cache(maxsize=None)
def _integer_structure(seed=3, n=500, c=8):
    """Integer rows where one center holds most rows (its cell splits into
    buckets with tied coarse scores), integer centroids and codebooks, and
    the assignments and codes that go with them."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 8, (c, D)).astype(np.float32) * 30
    which = rng.integers(0, c, n)
    which[: n // 2] = 0
    data = (centers[which] + rng.integers(-3, 4, (n, D))).astype(np.float32)
    cents, _ = jax_ivf.train_kmeans(data, c, iters=4, seed=seed)
    cents = np.rint(cents).astype(np.float32)
    d2 = (cents.astype(np.float64) ** 2).sum(1)[None, :] - 2.0 * (
        data.astype(np.float64) @ cents.T)
    assign = np.argmin(d2, axis=1).astype(np.int32)
    res = data - cents[assign]
    books = np.rint(jax_pq.train_pq(res, m=M, ksub=KSUB, iters=3, seed=seed))
    books = books.astype(np.float32)
    codes = jax_pq.encode_pq(res, books)
    return data, cents, assign, books, codes


def _ref_index(metric, packed4, tomb=(4, 60)):
    data, cents, assign, books, codes = _integer_structure()
    rng = np.random.default_rng(11)
    dead = np.zeros(len(data), bool)
    dead[list(tomb)] = True
    ids = np.arange(len(data), dtype=np.uint64)[::-1] * np.uint64(5) + np.uint64(9)
    ref = jax_ivfpq.IVFPQIndex.build(
        data, metric, len(cents), centroids=cents, assignments=assign,
        codebooks=books, codes=codes, pack4=packed4, valid_mask=dead,
        ids=ids.copy())
    q = (data[rng.integers(0, len(data), 6)]
         + rng.integers(-9, 10, (6, D))).astype(np.float32)
    return ref, data, q, rng, dead


def _recon():
    """The full reconstructions ``c + r̂`` of every row, by row."""
    _, cents, assign, books, codes = _integer_structure()
    return (reconstruct_pq(codes, books) + cents[assign]).astype(np.float32)


def _same(a, b, metric, q, rows, live):
    if metric == DistanceMetric.COSINE:
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        assert_topk_match((a.scores, a.indices), (b.scores, b.indices),
                          exact=False, tol=2 * tolerance(qn, rows, metric),
                          scores64=exact_scores(qn, rows, metric, live))
        return
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_allclose(a.distances, b.distances, rtol=1e-6)


# ------------------------------------------------------ the reference ---


@pytest.mark.parametrize("exact_lut", [True, False], ids=["f32_lut", "bf16_lut"])
@pytest.mark.parametrize("rerank", [0, 40])
@pytest.mark.parametrize("packed4", [False, True], ids=["u8", "packed4"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("mode", ["scan", "probe"])
def test_from_state_search_matches_reference(mode, metric, packed4, rerank,
                                             exact_lut):
    """nprobe 2 cuts through the heavy cell's tied buckets (scan probes
    them all, probe exactly 2); filters raw and prepared; tombstones from
    the build and from ``delete_rows``."""
    ref, data, q, rng, dead = _ref_index(metric, packed4)
    assert ref.num_buckets > ref.num_clusters  # split cells
    port = IVFPQIndex.from_state(state_of(ref), device="cpu")
    assert port.packed4 == packed4
    rows = data if rerank else _recon()
    mask = rng.random(len(data)) < 0.7
    kw = dict(k=10, nprobe=2, rerank=rerank, mode=mode, exact_lut=exact_lut)
    for fm, ref_fm in ((None, None), (mask, mask),
                       (port.prepare_filter(mask), ref.prepare_filter(mask))):
        a = port.search(q, filter_mask=fm, **kw)
        b = ref.search(q, filter_mask=ref_fm, **kw)
        live = ~dead & (mask if fm is not None else True)
        _same(a, b, metric, q, rows, live)
    victims = port.search(q, k=1, nprobe=2, mode=mode).indices[:, 0]
    port.delete_rows(victims)
    ref.delete_rows(victims)
    dead[victims] = True
    a, b = port.search(q, **kw), ref.search(q, **kw)
    assert not np.isin(a.indices, np.flatnonzero(dead)).any()
    _same(a, b, metric, q, rows, ~dead)


def test_bf16_bias_rounding_shows_and_matches_reference():
    """The bucket bias rides the LUT's type: with a bf16 LUT the shifted
    coarse dots (integers far above 256 here) are rounded to bf16 before
    the add, in the port as in the reference, so the bf16 scan's scores
    differ from the f32 scan's while both match the reference exactly."""
    ref, data, q, _, _ = _ref_index(DistanceMetric.L2, False)
    port = IVFPQIndex.from_state(state_of(ref), device="cpu")
    kw = dict(k=10, nprobe=4, mode="scan")
    f32 = port.search(q, exact_lut=True, **kw)
    bf16 = port.search(q, exact_lut=False, **kw)
    np.testing.assert_array_equal(
        bf16.scores, ref.search(q, exact_lut=False, **kw).scores)
    np.testing.assert_array_equal(
        f32.scores, ref.search(q, exact_lut=True, **kw).scores)
    assert not np.array_equal(f32.scores, bf16.scores)


def test_rebuild_matches_reference():
    ref, data, q, _, _ = _ref_index(DistanceMetric.L2, True)
    port = IVFPQIndex.from_state(state_of(ref), device="cpu")
    for idx in (port, ref):
        idx.delete_rows(np.arange(0, 200, 3))
        idx.rebuild()
    assert port.num_buckets == ref.num_buckets
    np.testing.assert_array_equal(port.cells, ref.cells)
    np.testing.assert_array_equal(port.bucket_ids.numpy(), np.asarray(ref.bucket_ids))
    np.testing.assert_array_equal(port.buckets.numpy(), np.asarray(ref.buckets))
    np.testing.assert_array_equal(port.row_valid.numpy(), np.asarray(ref.row_valid))
    for mode in ("scan", "probe"):
        a = port.search(q, k=10, nprobe=3, mode=mode)
        b = ref.search(q, k=10, nprobe=3, mode=mode)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.scores, b.scores)


def test_fetch_above_rows_and_full_rerank():
    """A fetch above the corpus (bucket_rows · nprobe > N) pads with
    unfilled slots; a re-rank of every probed row is exact search."""
    ref, data, q, _, dead = _ref_index(DistanceMetric.L2, False)
    port = IVFPQIndex.from_state(state_of(ref), device="cpu")
    for mode in ("scan", "probe"):
        a = port.search(q, k=700, nprobe=port.num_buckets, mode=mode)
        b = ref.search(q, k=700, nprobe=ref.num_buckets, mode=mode)
        np.testing.assert_array_equal(a.indices, b.indices)
        assert (a.indices[:, -1] == -1).all()
        full = port.search(q, k=10, nprobe=port.num_buckets, rerank=700, mode=mode)
        want = ref.search(q, k=10, nprobe=ref.num_buckets, rerank=700, mode=mode)
        np.testing.assert_array_equal(full.indices, want.indices)
        # exact search, up to the order of exact ties (duplicate rows)
        os_, _ = numpy_oracle(q, data, 10, DistanceMetric.L2, valid_mask=~dead)
        np.testing.assert_allclose(full.scores, os_, rtol=1e-6)


def test_search_errors_and_unported():
    ref, data, q, _, _ = _ref_index(DistanceMetric.L2, False)
    port = IVFPQIndex.from_state(state_of(ref), device="cpu")
    with pytest.raises(ValueError, match="mode"):
        port.search(q, mode="traverse")
    with pytest.raises(DimensionMismatchError):
        port.search(q[:, :8])
    with pytest.raises(DimensionMismatchError):
        port.search(q, filter_mask=np.ones(3, bool))
    with pytest.raises(DimensionMismatchError):  # add_rows serves now
        port.add_rows(q[:, :8])
    with pytest.raises(ValueError, match="CUDA kernels"):  # the CPU has no grid
        port.autotune()
    bare = IVFPQIndex.build(data, DistanceMetric.L2, 8, m=M, ksub=KSUB, iters=2,
                            keep_vectors=False, device="cpu")
    with pytest.raises(ValueError, match="rerank"):
        bare.search(q, rerank=20)
    assert bare.SCAN_CROSSOVER_BATCH == jax_ivfpq.IVFPQIndex.SCAN_CROSSOVER_BATCH


def test_scan_is_one_adc_launch_and_probe_none():
    """On CPU tensors no kernel launches; the scan reaches the ADC wrapper
    with the bucket bias and the probe mode does not call it."""
    ref, data, q, _, _ = _ref_index(DistanceMetric.L2, False)
    port = IVFPQIndex.from_state(state_of(ref), device="cpu")
    calls = []
    import metrovector_tpu_torch.index.ivfpq as mod

    def spy(*a, **kw):
        calls.append(kw.get("group_bias") is not None and kw.get("group_ids") is not None)
        return fused_adc_topk(*a, **kw)

    mod.fused_adc_topk, saved = spy, mod.fused_adc_topk
    try:
        port.search(q, k=5, nprobe=2, mode="scan")
        assert calls == [True]
        port.search(q, k=5, nprobe=2, mode="probe")
        assert calls == [True]
    finally:
        mod.fused_adc_topk = saved


# --------------------------------------------- tests/test_ivfpq.py ---


def _clustered(rng, n_clusters=8, per=100, d=16, spread=0.05):
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 3
    return np.concatenate(
        [c + spread * rng.standard_normal((per, d)).astype(np.float32)
         for c in centers])


def test_train_ivfpq_shapes(rng):
    data = _clustered(rng)
    cents, assign, books, codes = train_ivfpq(data, 8, m=4, ksub=16, iters=5,
                                              device="cpu")
    ref_c, ref_a, _, _ = jax_ivfpq.train_ivfpq(data, 8, m=4, ksub=16, iters=5)
    np.testing.assert_allclose(cents, ref_c, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(assign, ref_a)
    assert books.shape == (4, 16, 4) and codes.shape == (800, 4)
    recon = reconstruct_pq(codes, books) + cents[assign]
    assert ((data - recon) ** 2).sum() < 0.6 * ((data - cents[assign]) ** 2).sum()


@pytest.mark.parametrize("metric", METRICS)
def test_full_probe_adc_matches_reconstructed_bruteforce(rng, metric):
    data = _clustered(rng, n_clusters=4, per=50)
    idx = IVFPQIndex.build(data, metric, num_clusters=4, m=4, ksub=16, iters=6,
                           device="cpu")
    ids = idx.bucket_ids.numpy().reshape(-1)
    codes = idx.buckets.numpy().reshape(-1, 4)
    live = ids >= 0
    recon = np.zeros_like(data)
    cent_of = np.repeat(idx.cells, idx.bucket_rows)
    recon[ids[live]] = (reconstruct_pq(codes[live], idx.codebooks)
                        + idx.centroids[cent_of[live]])
    q = rng.standard_normal((6, 16)).astype(np.float32)
    _, oi = numpy_oracle(q, recon, 10, metric)
    for mode in ("probe", "scan"):
        res = idx.search(q, k=10, nprobe=4, mode=mode, exact_lut=True)
        assert np.array_equal(res.indices, oi), mode


def test_rerank_recovers_exact_on_clustered(rng):
    data = _clustered(rng, n_clusters=16, per=100, d=32)
    idx = IVFPQIndex.build(data, DistanceMetric.L2, num_clusters=16, m=8,
                           ksub=16, iters=8, device="cpu")
    q = data[rng.choice(len(data), 20)] + 0.01 * rng.standard_normal(
        (20, 32)).astype(np.float32)
    res = idx.search(q, k=10, nprobe=4, rerank=100)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)
    hits = sum(len(set(res.indices[i]) & set(oi[i])) for i in range(20))
    assert hits / 200 >= 0.95


def test_nprobe_monotone_recall(rng):
    data = _clustered(rng, n_clusters=8, per=80)
    idx = IVFPQIndex.build(data, DistanceMetric.L2, num_clusters=8, m=4,
                           ksub=16, device="cpu")
    q = rng.standard_normal((15, 16)).astype(np.float32)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)

    def recall(nprobe):
        res = idx.search(q, k=10, nprobe=nprobe, rerank=60)
        return sum(len(set(res.indices[i]) & set(oi[i])) for i in range(15))

    assert recall(1) <= recall(4) <= recall(8)


def test_probe_widening_crosses_cells(rng):
    a = np.zeros((40, 16), np.float32)
    a[:, 0] = 5 + 0.1 * rng.standard_normal(40)
    b = np.zeros((40, 16), np.float32)
    b[:, 0] = -5 + 0.1 * rng.standard_normal(40)
    idx = IVFPQIndex.build(np.concatenate([a, b]), DistanceMetric.L2,
                           num_clusters=2, m=4, ksub=16, iters=10, device="cpu")
    q = np.zeros((1, 16), np.float32)
    side1 = set(idx.search(q, k=20, nprobe=1).indices[0] // 40)
    side2 = set(idx.search(q, k=20, nprobe=2).indices[0] // 40)
    assert side1 in ({0}, {1})
    assert side2 == {0, 1}


def test_skewed_fills_split_into_capped_buckets(rng):
    blob_centers = rng.standard_normal((4, 16)).astype(np.float32) * 8
    data = np.concatenate([
        blob_centers[i] + 0.1 * rng.standard_normal((sz, 16)).astype(np.float32)
        for i, sz in enumerate([850, 50, 50, 50])])
    idx = IVFPQIndex.build(data, DistanceMetric.L2, num_clusters=4, m=4,
                           ksub=16, iters=6, device="cpu")
    assert idx.num_buckets > idx.num_clusters
    q = rng.standard_normal((5, 16)).astype(np.float32)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)
    for mode in ("probe", "scan"):
        res = idx.search(q, k=10, nprobe=idx.num_buckets, rerank=1000, mode=mode)
        assert np.array_equal(res.indices, oi), mode


def test_kmeans_on_constant_data():
    data = np.ones((50, 8), np.float32) * 3.0
    cents, assign = ivf.train_kmeans(data, 4, iters=3, device="cpu")
    np.testing.assert_allclose(cents[assign], data, atol=1e-6)


def _ivfpq_file(tmp_path, data, cents, assign, books, codes, packed4=False):
    b = Builder()
    b.add_vector_space("s", dim=data.shape[1])
    b.add_vectors("s", data)
    b.set_ivf_index("s", cents, assign, nprobe=2)
    b.set_pq_index("s", books, pq.pack_codes4(codes) if packed4 else codes,
                   residual=True, packed4=packed4)
    path = tmp_path / ("p4.mvt" if packed4 else "ivfpq.mvt")
    b.build().save(path)
    return Reader.open(path).vector_space("s")


def test_ivfpq_persistence_roundtrip(tmp_path, rng):
    data = _clustered(rng, n_clusters=4, per=60)
    cents, assign, books, codes = train_ivfpq(data, 4, m=4, ksub=16, iters=5,
                                              device="cpu")
    sp = _ivfpq_file(tmp_path, data, cents, assign, books, codes)
    assert sp.info.pq.residual is True
    _, _, rn = sp.pq_arrays()
    recon = reconstruct_pq(codes, books) + cents[assign]
    np.testing.assert_allclose(
        rn, (recon.astype(np.float64) ** 2).sum(1).astype(np.float32), rtol=1e-6)
    idx = IVFPQIndex.from_space(sp, device="cpu")
    np.testing.assert_array_equal(idx.centroids, cents)
    np.testing.assert_array_equal(idx.codebooks, books)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2)
    for mode in ("probe", "scan"):
        res = idx.search(q, k=5, nprobe=4, rerank=240, mode=mode)
        assert np.array_equal(res.indices, oi), mode
    # a plain PQIndex must not take the residual sidecar
    r2 = PQIndex.from_space(sp, m=4, ksub=16, iters=3, device="cpu").search(
        q, k=5, rerank=240)
    assert np.array_equal(r2.indices, oi)


def test_residual_pq_requires_ivf_first(rng):
    data = _clustered(rng, n_clusters=2, per=20)
    _, _, books, codes = train_ivfpq(data, 2, m=4, ksub=8, iters=3, device="cpu")
    b = Builder()
    b.add_vector_space("s", dim=16)
    b.add_vectors("s", data)
    with pytest.raises(BuildError, match="set_ivf_index"):
        b.set_pq_index("s", books, codes, residual=True)


def test_ivfpq_excludes_tombstones(tmp_path, rng):
    data = _clustered(rng, n_clusters=2, per=30)
    b = Builder()
    b.add_vector_space("s", dim=16)
    b.add_vectors("s", data)
    b.delete_vector("s", 5)
    path = tmp_path / "t.mvt"
    b.build().save(path)
    idx = IVFPQIndex.from_space(Reader.open(path).vector_space("s"),
                                num_clusters=2, m=4, ksub=8, iters=3, device="cpu")
    for mode in ("probe", "scan"):
        assert 5 not in idx.search(data[5], k=5, nprobe=2, rerank=59, mode=mode).indices


@pytest.mark.parametrize("metric", METRICS)
def test_masked_scan_matches_probe(rng, metric):
    n, d = 2500, 32
    centers = rng.standard_normal((30, d)).astype(np.float32) * 4
    db = centers[rng.integers(0, 30, n)] + rng.standard_normal(
        (n, d)).astype(np.float32) * 0.3
    idx = IVFPQIndex.build(db, metric, num_clusters=12, m=4, ksub=32, iters=4,
                           device="cpu")
    q = db[rng.integers(0, n, 33)] + 0.05 * rng.standard_normal(
        (33, d)).astype(np.float32)
    rp = idx.search(q, k=9, nprobe=4, mode="probe")
    rs = idx.search(q, k=9, nprobe=4, mode="scan", exact_lut=True)
    np.testing.assert_array_equal(rp.indices, rs.indices)
    np.testing.assert_allclose(rp.scores, rs.scores, rtol=1e-4, atol=1e-4)
    rpr = idx.search(q, k=5, nprobe=4, rerank=40, mode="probe")
    rsr = idx.search(q, k=5, nprobe=4, rerank=40, mode="scan", exact_lut=True)
    np.testing.assert_array_equal(rpr.indices, rsr.indices)


def test_masked_scan_respects_nprobe_semantics(rng):
    n, d = 1200, 16
    centers = rng.standard_normal((20, d)).astype(np.float32) * 6
    db = centers[rng.integers(0, 20, n)] + rng.standard_normal(
        (n, d)).astype(np.float32) * 0.2
    idx = IVFPQIndex.build(db, DistanceMetric.L2, num_clusters=8, m=4, ksub=16,
                           iters=4, device="cpu")
    q = db[:7]
    res = idx.search(q, k=10, nprobe=2, mode="scan", exact_lut=True)
    pc = idx.probe_centroids.numpy()
    cs = 2 * q @ pc.T - (pc**2).sum(1)[None]
    ids = idx.bucket_ids.numpy()
    for r in range(len(q)):
        probed = np.argsort(-cs[r], kind="stable")[:2]
        allowed = {int(x) for b in probed for x in ids[b] if x >= 0}
        assert {int(x) for x in res.indices[r] if x >= 0} <= allowed


def test_auto_mode_routes_by_batch(rng):
    db = rng.standard_normal((800, 16)).astype(np.float32)
    idx = IVFPQIndex.build(db, DistanceMetric.L2, num_clusters=8, m=4, ksub=16,
                           iters=3, device="cpu")
    small = idx.search(db[:4], k=5, nprobe=8, mode="auto")
    big = idx.search(db[:40], k=5, nprobe=8, mode="auto", exact_lut=True)
    np.testing.assert_array_equal(small.indices, big.indices[:4])


def test_ivfpq_packed4_both_modes_and_lifecycle(tmp_path, rng):
    data = _clustered(rng, n_clusters=6, per=80)
    cents, assign, books, codes = train_ivfpq(data, 6, m=4, ksub=16, iters=5,
                                              device="cpu")
    kw = dict(centroids=cents, assignments=assign, codebooks=books, codes=codes,
              device="cpu")
    packed = IVFPQIndex.build(data, DistanceMetric.L2, 6, pack4=True, **kw)
    plain = IVFPQIndex.build(data, DistanceMetric.L2, 6, **kw)
    assert packed.packed4 and not plain.packed4
    assert packed.codes_row.shape[1] == 2
    assert packed.buckets.shape[2] == 2 and plain.buckets.shape[2] == 4
    q = rng.standard_normal((40, 16)).astype(np.float32)
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2)
    for mode in ("probe", "scan"):
        res = packed.search(q, k=5, nprobe=6, rerank=240, mode=mode)
        assert np.array_equal(res.indices, oi), mode
        rp = packed.search(q, k=5, nprobe=6, mode=mode)
        ru = plain.search(q, k=5, nprobe=6, mode=mode)
        overlap = np.mean([len(set(rp.indices[i]) & set(ru.indices[i])) / 5
                           for i in range(len(q))])
        assert overlap >= 0.95, (mode, overlap)
    sp = _ivfpq_file(tmp_path, data, cents, assign, books, codes, packed4=True)
    idx = IVFPQIndex.from_space(sp, device="cpu")
    assert idx.packed4 and idx.codes_row.shape[1] == 2
    assert np.array_equal(idx.search(q, k=5, nprobe=6, rerank=240).indices, oi)
    # online mutation keeps the packed layout and stays searchable
    new = data[:7] + 0.01
    idx.add_rows(new)
    assert idx.codes_row.shape[1] == 2
    r3 = idx.search(new[:2], k=1, nprobe=6, rerank=60)
    assert (r3.distances[:, 0] < 0.1).all()
    idx.delete_rows([int(r3.indices[0, 0])])
    r4 = idx.search(data[:1], k=1, nprobe=6, rerank=60)
    assert r4.indices[0, 0] != r3.indices[0, 0]


def test_recommended_rerank_guidance(rng):
    data = rng.standard_normal((400, 16)).astype(np.float32)
    i8 = IVFPQIndex.build(data, DistanceMetric.L2, num_clusters=8, m=4, ksub=16,
                          pack4=False, device="cpu")
    i4 = IVFPQIndex.build(data, DistanceMetric.L2, num_clusters=8, m=4, ksub=16,
                          pack4=True, device="cpu")
    ref4 = jax_ivfpq.IVFPQIndex.build(data, DistanceMetric.L2, num_clusters=8,
                                      m=4, ksub=16, pack4=True)
    for k, target in ((10, 1.0), (10, 0.7), (10, 0.8), (10, 0.95), (100, 1.0)):
        assert i4.recommended_rerank(k, target) == ref4.recommended_rerank(k, target)
    assert i4.recommended_rerank(k=10) == 400
    assert i8.recommended_rerank(k=10, recall_target=0.7) == 0
    assert i4.recommended_rerank(k=10, recall_target=0.7) > 0
    with pytest.raises(ValueError):
        i4.recommended_rerank(k=10, recall_target=0.0)
    q = rng.standard_normal((8, 16)).astype(np.float32)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)
    res = i4.search(q, k=10, nprobe=8, rerank=i4.recommended_rerank(k=10))
    assert np.array_equal(res.indices, oi)


# ------------------------- tests/test_index_filters.py, IVF-PQ part ---


def _filter_data(rng, n=384, ncenters=12, spread=0.15):
    centers = rng.standard_normal((ncenters, 16)).astype(np.float32)
    rows = centers[rng.integers(0, ncenters, n)]
    rows += spread * rng.standard_normal((n, 16)).astype(np.float32)
    return rows.astype(np.float32)


def _mask(rng, n, sel=0.5):
    m = rng.random(n) < sel
    m[:2] = [True, False]
    return m


@pytest.mark.parametrize("mode", ["scan", "probe"])
def test_ivfpq_filter_exhaustive_equals_masked_oracle(rng, mode):
    data = _filter_data(rng, n=256)
    idx = IVFPQIndex.build(data, DistanceMetric.L2, num_clusters=6, m=4,
                           ksub=16, iters=4, device="cpu")
    q = data[rng.integers(0, 256, 4)] + 0.01
    mask = _mask(rng, 256)
    res = idx.search(q, k=8, nprobe=idx.num_buckets, rerank=256, mode=mode,
                     filter_mask=mask)
    _, oi = numpy_oracle(q, data, 8, DistanceMetric.L2, valid_mask=mask)
    assert np.array_equal(res.indices, oi)


@pytest.mark.parametrize("mode", ["scan", "probe"])
def test_ivfpq_filter_never_leaks(rng, mode):
    data = _filter_data(rng, n=256)
    idx = IVFPQIndex.build(data, DistanceMetric.L2, num_clusters=6, m=4,
                           ksub=16, iters=4, device="cpu")
    mask = _mask(rng, 256, sel=0.3)
    res = idx.search(data[:4], k=8, nprobe=3, rerank=24, mode=mode,
                     filter_mask=mask)
    assert mask[res.indices[res.indices >= 0]].all()
    again = idx.search(data[:4], k=8, nprobe=3, rerank=24, mode=mode,
                       filter_mask=idx.prepare_filter(mask))
    assert np.array_equal(res.indices, again.indices)


def test_ivfpq_filter_composes_with_deletes(rng):
    data = _filter_data(rng, n=160)
    idx = IVFPQIndex.build(data, DistanceMetric.L2, num_clusters=4, m=4,
                           ksub=16, iters=3, device="cpu")
    mask = np.zeros(160, bool)
    mask[:12] = True
    idx.delete_rows([0, 5])
    for mode in ("scan", "probe"):
        res = idx.search(data[:1], k=16, nprobe=idx.num_buckets, rerank=160,
                         mode=mode, filter_mask=mask)
        assert set(res.indices[0][res.indices[0] >= 0].tolist()) == set(range(12)) - {0, 5}


# ----------------------------- tests/test_index_ids.py, IVF-PQ part ---


def _file_with_ids(tmp_path, rng, deleted=(), with_ids=True):
    data = rng.standard_normal((96, 16)).astype(np.float32)
    ids = np.arange(96, dtype=np.uint64) * 13 + 500
    b = Builder()
    b.add_vector_space("e", dim=16)
    b.add_vectors("e", data, ids=ids if with_ids else None)
    for i in deleted:
        b.delete_vector("e", i)
    path = tmp_path / "idx_ids.mvt"
    b.build().save(path)
    return path, data, ids


def _check_ids(res, host_ids):
    valid = res.indices >= 0
    assert np.array_equal(res.ids[valid], host_ids[res.indices[valid]])
    assert (res.ids[~valid] == np.uint64(2**64 - 1)).all()


@pytest.mark.parametrize("deleted", [(), (0, 5, 41)], ids=["as_built", "compacted"])
def test_ivfpq_ids_on_both_modes(tmp_path, rng, deleted):
    path, data, ids = _file_with_ids(tmp_path, rng, deleted=deleted)
    keep = np.ones(96, bool)
    keep[list(deleted)] = False
    if deleted:
        compact(Reader.open(path), tmp_path / "c.mvt")
        path = tmp_path / "c.mvt"
    idx = IVFPQIndex.from_space(Reader.open(path).vector_space("e"),
                                num_clusters=4, m=4, ksub=16, device="cpu")
    for mode in ("scan", "probe"):
        _check_ids(idx.search(data[keep][:3], k=5, mode=mode), ids[keep])
    with pytest.raises(InvalidVectorTypeError):  # appends carry ids
        idx.add_rows(data[:2])
    idx.add_rows(data[:2] + 0.01, ids=ids[:2] + 10_000)
    for mode in ("scan", "probe"):
        _check_ids(idx.search(data[:2] + 0.01, k=5, mode=mode, rerank=40),
                   np.concatenate([ids[keep], ids[:2] + 10_000]))


def test_ivfpq_ids_default_positions(tmp_path, rng):
    path, data, _ = _file_with_ids(tmp_path, rng, with_ids=False)
    idx = IVFPQIndex.from_space(Reader.open(path).vector_space("e"),
                                num_clusters=4, m=4, ksub=16, device="cpu")
    res = idx.search(data[:2], k=4)
    valid = res.indices >= 0
    assert np.array_equal(res.ids[valid], res.indices[valid].astype(np.uint64))


def test_cuda_request_without_cuda_raises(rng):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for hosts without it")
    data = _filter_data(rng, n=64)
    with pytest.raises(RuntimeError, match="cuda"):
        IVFPQIndex.build(data, DistanceMetric.L2, num_clusters=4, m=4, ksub=16)
    with pytest.raises(RuntimeError, match="cuda"):
        train_ivfpq(data, 4, m=4, ksub=16)
