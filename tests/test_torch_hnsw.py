"""The port's HNSW against the JAX package's, exactly: both built with
``threads=1`` (the native build's sequential insertion order) and the same
``seed``, on the native path and on the Python path (the native library
switched off in both packages). The graphs (entry point, every layer's
node ids and adjacency) and the search results (indices, scores,
distances, ids) must be equal.

Mirrors ``tests/test_hnsw.py``, the HNSW tests of
``tests/test_online_mutation.py`` (add and delete, add to an empty graph, a
single node then an add) and the HNSW cases of
``tests/test_index_filters.py`` and ``tests/test_index_ids.py``. Where those
tests gate recall on a build whose graph depends on the thread schedule,
these hold the deterministic graph to the reference's instead; the one
multi-threaded build here is checked for structure only.
"""

import numpy as np
import pytest

import metrovector_tpu.native as jax_native
import metrovector_tpu_torch.native as port_native
from metrovector_tpu.index.hnsw import HNSWIndex as JaxHNSW
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu_torch import Builder, DistanceMetric, Reader
from metrovector_tpu_torch.errors import (
    DimensionMismatchError,
    IndexOutOfBoundsError,
    InvalidVectorTypeError,
)
from metrovector_tpu_torch.format.compact import compact
from metrovector_tpu_torch.format.constants import IndexKind
from metrovector_tpu_torch.index.hnsw import HNSWIndex

from metrovector_tpu import Reader as JaxReader

METRICS = [DistanceMetric.L2, DistanceMetric.COSINE, DistanceMetric.INNER_PRODUCT]


@pytest.fixture(autouse=True, scope="module")
def reference_library_built_here(tmp_path_factory):
    """The JAX package's native HNSW library compiled here from its source
    by its own loader, with the flags the port's loader uses, rather than
    the prebuilt one it ships: two builds of one source by different
    compilers may contract the dot products differently, and the tests
    compare scores bit for bit."""
    saved = (jax_native._HNSW_SO, jax_native._hnsw_lib, jax_native._hnsw_tried)
    jax_native._HNSW_SO = str(tmp_path_factory.mktemp("jax_hnsw") / "libmvthnsw.so")
    jax_native._hnsw_lib, jax_native._hnsw_tried = None, False
    yield
    jax_native._HNSW_SO, jax_native._hnsw_lib, jax_native._hnsw_tried = saved


@pytest.fixture(params=["native", "python"])
def path(request, monkeypatch):
    """Which build and search path both packages take."""
    if request.param == "native":
        assert port_native.hnsw_available() and jax_native.hnsw_available()
    else:
        for mod in (port_native, jax_native):
            monkeypatch.setattr(mod, "hnsw_available", lambda: False)
    return request.param


def _data(rng, n=300, d=16):
    return rng.standard_normal((n, d)).astype(np.float32)


def _clustered(rng, n=300, d=16, c=8):
    centers = rng.standard_normal((c, d)).astype(np.float32) * 5
    return (centers[rng.integers(0, c, n)]
            + 0.3 * rng.standard_normal((n, d)).astype(np.float32))


def _pair(data, metric=DistanceMetric.L2, **kw):
    kw.setdefault("threads", 1)
    return (JaxHNSW.build(data, metric, **kw), HNSWIndex.build(data, metric, **kw))


def _same_graph(ref, port):
    assert port.entry == ref.entry
    assert len(port.layers) == len(ref.layers)
    for (ia, aa), (ib, ab) in zip(port.layers, ref.layers):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(aa, ab)
    np.testing.assert_array_equal(port.rows, ref.rows)
    np.testing.assert_array_equal(port.norms, ref.norms)
    assert (port.valid is None) == (ref.valid is None)
    if port.valid is not None:
        np.testing.assert_array_equal(port.valid, ref.valid)


def _same_results(a, b):
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.distances, b.distances)
    np.testing.assert_array_equal(a.ids, b.ids)


def _recall(res, oi):
    return np.mean([len(set(r) & set(o)) / len(o) for r, o in zip(res.indices, oi)])


# ------------------------------------------------ tests/test_hnsw.py ---


@pytest.mark.parametrize("metric", METRICS)
def test_hnsw_high_recall(path, metric):
    rng = np.random.default_rng(1)
    data = _data(rng, n=400, d=24)
    ref, port = _pair(data, metric, m=12, ef_construction=100, seed=1)
    _same_graph(ref, port)
    q = _data(rng, n=15, d=24)
    res = port.search(q, k=10, ef=128)
    _same_results(res, ref.search(q, k=10, ef=128))
    _, oi = numpy_oracle(q, data, 10, metric)
    assert _recall(res, oi) >= 0.9


def test_ef_monotone_recall(path):
    rng = np.random.default_rng(2)
    data = _data(rng, n=500)
    ref, port = _pair(data, m=8, ef_construction=60)
    _same_graph(ref, port)
    q = _data(rng, n=20)
    _, oi = numpy_oracle(q, data, 10, DistanceMetric.L2)
    recalls = []
    for ef in (10, 64, 256):
        res = port.search(q, k=10, ef=ef)
        _same_results(res, ref.search(q, k=10, ef=ef))
        recalls.append(_recall(res, oi))
    assert recalls == sorted(recalls) and recalls[-1] >= 0.85


def test_graph_is_connected_enough(path):
    """Searching for each row's own vector with a generous beam finds it,
    in the port's graph and in the reference's, which are one graph."""
    rng = np.random.default_rng(3)
    data = _data(rng, n=300, d=8)
    ref, port = _pair(data, m=8, ef_construction=80)
    _same_graph(ref, port)
    res = port.search(data, k=1, ef=128)
    _same_results(res, ref.search(data, k=1, ef=128))
    assert (res.indices[:, 0] == np.arange(300)).mean() >= 0.99


def test_single_and_tiny_corpus(path):
    rng = np.random.default_rng(4)
    one = _data(rng, n=1, d=8)
    ref, port = _pair(one)
    _same_graph(ref, port)
    res = port.search(one, k=3)
    _same_results(res, ref.search(one, k=3))
    assert res.indices[0, 0] == 0 and (res.indices[0, 1:] == -1).all()


def test_distances_match_engine_convention(path):
    rng = np.random.default_rng(5)
    data = _data(rng, n=200, d=8)
    ref, port = _pair(data, m=8, ef_construction=60)
    q = data[7:8] + 0.01
    res = port.search(q, k=1, ef=64)
    _same_results(res, ref.search(q, k=1, ef=64))
    # the distance is √(‖q‖² − (2q·x − ‖x‖²)) in f32: its square errs by at
    # most (D + 3)·2⁻²⁴·(‖q‖ + ‖x‖)², however small the distance
    i = int(res.indices[0, 0])
    q64, x64 = q[0].astype(np.float64), data[i].astype(np.float64)
    bound = (8 + 3) * 2.0**-24 * (np.linalg.norm(q64) + np.linalg.norm(x64)) ** 2
    assert abs(float(res.distances[0, 0]) ** 2 - ((q64 - x64) ** 2).sum()) <= bound


def _save(tmp_path, data, idx, name="h.mvt", ids=None, deleted=()):
    b = Builder()
    b.add_vector_space("s", dim=data.shape[1])
    b.add_vectors("s", data, ids=ids)
    for i in deleted:
        b.delete_vector("s", i)
    if idx is not None:
        b.set_hnsw_index("s", idx.layers, idx.entry, m=idx.m,
                         ef_construction=idx.ef_construction)
    p = tmp_path / name
    b.build().save(p)
    return p


def test_hnsw_persistence_roundtrip(tmp_path, path):
    """The port's file reattaches in both packages to the same graph and
    the same answers."""
    rng = np.random.default_rng(6)
    data = _data(rng, n=300, d=16)
    ref, port = _pair(data, m=8, ef_construction=80, seed=3)
    p = _save(tmp_path, data, port)
    sp = Reader.open(p).vector_space("s")
    assert sp.info.index.kind == IndexKind.HNSW
    re = HNSWIndex.from_space(sp)
    re_ref = JaxHNSW.from_space(JaxReader.open(p).vector_space("s"))
    _same_graph(re_ref, re)
    _same_graph(ref, re)
    q = _data(rng, n=8, d=16)
    _same_results(re.search(q, k=5, ef=64), port.search(q, k=5, ef=64))
    _same_results(re.search(q, k=5, ef=64), re_ref.search(q, k=5, ef=64))
    assert HNSWIndex.from_space(sp, selection="closest").selection == "closest"
    assert HNSWIndex.from_space(sp).selection == "heuristic"
    with pytest.raises(ValueError, match="selection"):
        HNSWIndex.from_space(sp, selection="bogus")


def test_hnsw_excludes_tombstones(tmp_path, path):
    rng = np.random.default_rng(7)
    data = _data(rng, n=150, d=8)
    p = _save(tmp_path, data, None, deleted=(4,))
    port = HNSWIndex.from_space(Reader.open(p).vector_space("s"), m=8,
                                ef_construction=60)
    ref = JaxHNSW.from_space(JaxReader.open(p).vector_space("s"), m=8,
                             ef_construction=60)
    _same_graph(ref, port)
    res = port.search(data[4:5], k=5, ef=64)
    _same_results(res, ref.search(data[4:5], k=5, ef=64))
    assert 4 not in res.indices


def test_hnsw_config_roundtrip_without_graph(tmp_path):
    rng = np.random.default_rng(8)
    b = Builder()
    b.add_vector_space("s", dim=8).with_hnsw_index(m=24, ef_construction=77)
    b.add_vectors("s", _data(rng, n=10, d=8))
    p = tmp_path / "c.mvt"
    b.build().save(p)
    sp = Reader.open(p).vector_space("s")
    assert sp.info.index.params == {"m": 24, "ef_construction": 77}
    assert sp.hnsw_arrays() is None


def test_native_and_python_search_agree_on_same_graph():
    rng = np.random.default_rng(9)
    data = _data(rng, n=600, d=16)
    idx = HNSWIndex.build(data, DistanceMetric.L2, m=8, ef_construction=80,
                          seed=2, threads=1)
    q = _data(rng, n=12, d=16)
    res_native = idx.search(q, k=10, ef=64)
    assert idx._native is not None  # the native path ran
    idx2 = HNSWIndex(rows=idx.rows, norms=idx.norms, layers=idx.layers,
                     entry=idx.entry, metric=idx.metric, m=idx.m,
                     ef_construction=idx.ef_construction, valid=idx.valid,
                     host_ids=idx.host_ids)
    idx2._native_handle = lambda: None  # the Python beam
    res_py = idx2.search(q, k=10, ef=64)
    np.testing.assert_array_equal(res_native.indices, res_py.indices)
    np.testing.assert_allclose(res_native.scores, res_py.scores, rtol=1e-5)


def test_native_graph_survives_append_and_persistence(tmp_path):
    rng = np.random.default_rng(10)
    data = _data(rng, n=300, d=8)
    ref, port = _pair(data, m=8, ef_construction=80)
    new = _data(rng, n=20, d=8)
    ref.add_rows(new)
    port.add_rows(new)
    _same_graph(ref, port)
    res = port.search(new, k=1, ef=128)
    _same_results(res, ref.search(new, k=1, ef=128))
    assert (res.indices[:, 0] == np.arange(300, 320)).mean() >= 0.95
    p = _save(tmp_path, np.concatenate([data, new]), port, name="ng.mvt")
    re = HNSWIndex.from_space(Reader.open(p).vector_space("s"))
    q = _data(rng, n=6, d=8)
    np.testing.assert_array_equal(re.search(q, k=5, ef=64).indices,
                                  port.search(q, k=5, ef=64).indices)


def test_parallel_build_leaves_the_process_thread_count():
    """A build on four threads sizes its team with a ``num_threads`` clause:
    the process's OpenMP default, which torch's CPU kernels share, stays as
    it was (``omp_set_num_threads`` left torch on four threads, and its f32
    sums then differ by an ulp from a process at eight)."""
    import torch

    assert port_native.hnsw_available()
    data = np.random.default_rng(5).standard_normal((600, 16)).astype(np.float32)
    prev = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        HNSWIndex.build(data, DistanceMetric.L2, m=8, ef_construction=40, seed=1,
                        threads=4)
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(prev)


def test_parallel_build_valid_graph():
    """A build on four threads is valid (every neighbor in range, no self
    loop) and searchable; its graph depends on the schedule, so it is
    checked for structure, not recall. The one-thread build equals the
    reference's."""
    rng = np.random.default_rng(11)
    n, d = 2000, 24
    centers = rng.standard_normal((16, d)).astype(np.float32) * 3
    data = centers[rng.integers(0, 16, n)] + rng.standard_normal((n, d)).astype(np.float32)
    ref, port = _pair(data, m=8, ef_construction=60, seed=7)
    _same_graph(ref, port)
    multi = HNSWIndex.build(data, DistanceMetric.L2, m=8, ef_construction=60,
                            seed=7, threads=4)
    for ids, adj in multi.layers:
        live = adj[adj >= 0]
        assert live.size == 0 or (live < n).all()
        for r_i, nid in enumerate(ids):
            assert nid not in set(adj[r_i][adj[r_i] >= 0].tolist())
    res = multi.search(data[:5], k=10, ef=80)
    assert res.indices.shape == (5, 10) and (res.indices >= 0).all()


@pytest.mark.parametrize("selection", ["heuristic", "closest"])
def test_selection_strategies(path, selection):
    rng = np.random.default_rng(12)
    data = _data(rng, n=500, d=16)
    ref, port = _pair(data, m=12, ef_construction=80, seed=3, selection=selection)
    _same_graph(ref, port)
    assert port.selection == selection
    q = _data(rng, n=10, d=16)
    _same_results(port.search(q, k=10, ef=150), ref.search(q, k=10, ef=150))
    ref.add_rows(data[:5] + 0.01)
    port.add_rows(data[:5] + 0.01)
    assert port.rows.shape[0] == 505
    _same_graph(ref, port)
    with pytest.raises(ValueError):
        HNSWIndex.build(data, DistanceMetric.L2, selection="weird")


# ------------------------------------ tests/test_online_mutation.py ---


def test_hnsw_add_and_delete_rows(path):
    rng = np.random.default_rng(13)
    centers = rng.standard_normal((8, 12)).astype(np.float32) * 5
    data = centers[rng.integers(0, 8, 200)] + 0.3 * rng.standard_normal(
        (200, 12)).astype(np.float32)
    ref, port = _pair(data, m=8, ef_construction=60)
    new = centers[rng.integers(0, 8, 30)] + 0.3 * rng.standard_normal(
        (30, 12)).astype(np.float32)
    ref.add_rows(new)
    port.add_rows(new)
    assert port.rows.shape[0] == 230
    _same_graph(ref, port)
    res = port.search(new[:10], k=1, ef=80)
    _same_results(res, ref.search(new[:10], k=1, ef=80))
    assert (res.indices[:, 0] >= 200).mean() >= 0.9
    ref.add_rows(new[:3] + 0.5, seed=5)
    port.add_rows(new[:3] + 0.5, seed=5)
    _same_graph(ref, port)
    ref.delete_rows([0, 220])
    port.delete_rows([0, 220])
    _same_graph(ref, port)
    q = data[rng.integers(0, 200, 10)]
    res = port.search(q, k=5, ef=100)
    _same_results(res, ref.search(q, k=5, ef=100))
    assert not np.isin(res.indices, [0, 220]).any()
    with pytest.raises(IndexOutOfBoundsError):
        port.delete_rows([999])


def test_hnsw_add_to_empty_graph(path):
    rng = np.random.default_rng(14)
    ref, port = _pair(np.zeros((0, 4), np.float32), m=4)
    data = _data(rng, n=30, d=4)
    ref.add_rows(data)
    port.add_rows(data)
    _same_graph(ref, port)
    res = port.search(data[:5], k=1, ef=40)
    _same_results(res, ref.search(data[:5], k=1, ef=40))
    assert (res.indices[:, 0] == np.arange(5)).all()


def test_hnsw_single_node_then_add(path):
    rng = np.random.default_rng(15)
    v0 = _data(rng, n=1, d=4)
    ref, port = _pair(v0, m=4)
    more = _data(rng, n=5, d=4)
    ref.add_rows(more)
    port.add_rows(more)
    _same_graph(ref, port)
    assert port.search(v0, k=1, ef=20).indices[0, 0] == 0
    empty = HNSWIndex.build(np.zeros((0, 4), np.float32), DistanceMetric.L2)
    empty.add_rows(np.zeros((0, 4), np.float32))
    assert empty.rows.shape[0] == 0


# ------------------------------------ tests/test_index_filters.py ---


def _mask(rng, n, sel):
    m = rng.random(n) < sel
    m[0] = True
    return m


def test_hnsw_filter_never_leaks_and_fills_k(path):
    rng = np.random.default_rng(16)
    data = _clustered(rng)
    ref, port = _pair(data, m=8, ef_construction=64, seed=0)
    mask = _mask(rng, 300, 0.5)
    res = port.search(data[:6], k=10, filter_mask=mask)
    _same_results(res, ref.search(data[:6], k=10, filter_mask=mask))
    assert mask[res.indices[res.indices >= 0]].all()
    assert (res.indices >= 0).all()


def test_hnsw_low_selectivity_topup_reaches_exact(path):
    """At ~4% selectivity the ef top-up widens until the graph is visited
    and recovers the masked oracle; one graph in both packages, so one
    answer."""
    rng = np.random.default_rng(17)
    data = _clustered(rng)
    ref, port = _pair(data, m=8, ef_construction=64, seed=0)
    mask = np.zeros(300, bool)
    mask[rng.integers(0, 300, 16)] = True
    q = data[:3]
    res = port.search(q, k=5, filter_mask=mask, ef=16, max_ef=300)
    _same_results(res, ref.search(q, k=5, filter_mask=mask, ef=16, max_ef=300))
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2, valid_mask=mask)
    np.testing.assert_array_equal(res.indices, oi)


def test_hnsw_filter_composes_with_tombstones(path):
    rng = np.random.default_rng(18)
    data = _clustered(rng, n=200)
    ref, port = _pair(data, m=8, ef_construction=64, seed=0)
    mask = np.zeros(200, bool)
    mask[:20] = True
    ref.delete_rows([1, 4])
    port.delete_rows([1, 4])
    res = port.search(data[:2], k=20, filter_mask=mask, max_ef=200)
    _same_results(res, ref.search(data[:2], k=20, filter_mask=mask, max_ef=200))
    for row in res.indices:
        assert set(row[row >= 0].tolist()) == set(range(20)) - {1, 4}


def test_hnsw_filter_shape_error():
    rng = np.random.default_rng(19)
    port = HNSWIndex.build(_clustered(rng, n=64), DistanceMetric.L2, m=4,
                           ef_construction=32, seed=0, threads=1)
    with pytest.raises(DimensionMismatchError):
        port.search(np.zeros((1, 16), np.float32), k=3,
                    filter_mask=np.ones(63, bool))


def test_hnsw_unfiltered_behavior_unchanged(path):
    rng = np.random.default_rng(20)
    data = _clustered(rng, n=200)
    ref, port = _pair(data, m=8, ef_construction=64, seed=0)
    res = port.search(data[:4], k=5, ef=64)
    _same_results(res, ref.search(data[:4], k=5, ef=64))
    _, oi = numpy_oracle(data[:4], data, 5, DistanceMetric.L2)
    np.testing.assert_array_equal(res.indices[:, 0], oi[:, 0])


# ----------------------------------------- tests/test_index_ids.py ---


def test_hnsw_ids_survive_compaction_and_append_contract(tmp_path, path):
    """Ids on the HNSW surface equal the ID column at the result rows,
    survive compaction, and appends carry ids iff the space has them."""
    rng = np.random.default_rng(21)
    data = _data(rng, n=96)
    ids = np.arange(96, dtype=np.uint64) * 13 + 500
    p = _save(tmp_path, data, None, ids=ids, deleted=(0, 5, 41))
    compact(Reader.open(p), tmp_path / "c.mvt")
    sp = Reader.open(tmp_path / "c.mvt").vector_space("s")
    keep = np.ones(96, bool)
    keep[[0, 5, 41]] = False
    port = HNSWIndex.from_space(sp, m=8, ef_construction=64)
    ref = JaxHNSW.from_space(JaxReader.open(tmp_path / "c.mvt").vector_space("s"),
                             m=8, ef_construction=64)
    q = data[keep][:2]
    res = port.search(q, k=3)
    _same_results(res, ref.search(q, k=3))
    ok = res.indices >= 0
    np.testing.assert_array_equal(res.ids[ok], ids[keep][res.indices[ok]])
    assert int(res.ids[0, 0]) == int(ids[1])
    new = _data(rng, n=4)
    new_ids = np.arange(4, dtype=np.uint64) + 10_000
    with pytest.raises(InvalidVectorTypeError):
        port.add_rows(new)
    with pytest.raises(InvalidVectorTypeError):
        port.add_rows(new, ids=ids[keep][:4])
    port.add_rows(new, ids=new_ids)
    ref.add_rows(new, ids=new_ids)
    _same_graph(ref, port)
    res = port.search(new[:1], k=3)
    _same_results(res, ref.search(new[:1], k=3))
    all_ids = np.concatenate([ids[keep], new_ids])
    np.testing.assert_array_equal(res.ids[res.indices >= 0],
                                  all_ids[res.indices[res.indices >= 0]])
