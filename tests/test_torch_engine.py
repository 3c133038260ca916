"""The port's main path end to end against the JAX package: one ``.mvt``
file opened by both ``SearchEngine``s (the JAX one on its Pallas backend,
interpreted on the CPU), compared on indices, ids, distances, range
queries, filters, tombstones, an empty space and ``k`` above the corpus
size; ``DeviceSpace.from_state`` fed from a JAX ``DeviceSpace``; the
shared ``MicroBatcher`` over the port's engine; and the chunked upload."""

import numpy as np
import pytest
import torch

from metrovector_tpu import Builder, DataType, DistanceMetric, Reader
from metrovector_tpu.engine import DeviceSpace as JaxDeviceSpace
from metrovector_tpu.engine import SearchEngine as JaxEngine
from metrovector_tpu_torch import MicroBatcher, SearchEngine
from metrovector_tpu_torch.engine import DeviceSpace

from _torch_parity import METRICS, make_data

N, D = 300, 24


def _file(tmp_path, metric=DistanceMetric.L2, dtype=DataType.FLOAT32, n=N,
          ids=None, deleted=(), seed=0):
    rng = np.random.default_rng(seed)
    x, q = make_data(rng, "integer", n, D, 6)
    b = Builder()
    b.add_vector_space("v", dim=D, metric=metric, dtype=dtype)
    if n:
        b.add_vectors("v", x, ids=ids)
    for r in deleted:
        b.delete_vector("v", r)
    path = tmp_path / "db.mvt"
    b.build().save(path)
    return path, x, q


def _engines(path, precision="highest"):
    port = SearchEngine.open(path, device="cpu", precision=precision)
    ref = JaxEngine.open(path, backend="pallas", precision=precision)
    return port, ref


def _assert_same(a, b):
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_allclose(a.distances, b.distances, rtol=1e-6)
    assert a.metric == b.metric


@pytest.mark.parametrize("storage", ["f32_highest", "f32_default", "f16"])
@pytest.mark.parametrize("metric", METRICS)
def test_search_matches_reference_engine(tmp_path, metric, storage):
    """Integer-valued data: L2/IP bit-identical to the reference; cosine
    (normalization rounds differently) identical in indices here and
    within 1e-6 in score."""
    dtype = DataType.FLOAT16 if storage == "f16" else DataType.FLOAT32
    precision = "default" if storage == "f32_default" else "highest"
    path, x, q = _file(tmp_path, metric, dtype)
    port, ref = _engines(path, precision)
    a, b = port.search(q, k=10), ref.search(q, k=10)
    if storage == "f16":
        assert port.space.data.dtype == torch.float16  # kept f16 resident
    if storage == "f32_default":
        assert port.space.data.dtype == torch.bfloat16
    if metric == DistanceMetric.COSINE:
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_allclose(a.scores, b.scores, rtol=0, atol=1e-6)
    else:
        _assert_same(a, b)


@pytest.mark.parametrize("metric", METRICS)
def test_f16_default_float_queries_match_reference(tmp_path, metric):
    """An f16 space at ``"default"`` is bf16 on the device, but its queries
    stay f32, as the reference's are: only FLOAT32 spaces round their
    queries through bf16. N(0, 1) queries, which bf16 cannot hold, over an
    N(0, 1) f16 corpus: L2/IP identical to the reference; cosine identical
    in indices and within 1e-6 in score."""
    rng = np.random.default_rng(11)
    x, q = make_data(rng, "normal", 600, 32, 6)
    assert not torch.equal(torch.from_numpy(q).bfloat16().float(),
                           torch.from_numpy(q))  # bf16 cannot hold them
    b = Builder()
    b.add_vector_space("v", dim=32, metric=metric, dtype=DataType.FLOAT16)
    b.add_vectors("v", x)
    path = tmp_path / "f16.mvt"
    b.build().save(path)
    port, ref = _engines(path, "default")
    assert port.space.data.dtype == torch.bfloat16
    a, b = port.search(q, k=10), ref.search(q, k=10)
    np.testing.assert_array_equal(a.indices, b.indices)
    if metric == DistanceMetric.COSINE:
        np.testing.assert_allclose(a.scores, b.scores, rtol=0, atol=1e-6)
    else:
        _assert_same(a, b)


def test_search_radius_matches_reference(tmp_path):
    path, x, q = _file(tmp_path)
    port, ref = _engines(path)
    radius = float(np.median(np.linalg.norm(q[:, None] - x[None], axis=-1)))
    a = port.search_radius(q, radius)  # the default cap, 128 < N rows
    b = ref.search_radius(q, radius)
    np.testing.assert_array_equal(a.truncated, b.truncated)
    assert a.truncated.any() and not a.truncated.all()
    for r in range(len(q)):
        np.testing.assert_array_equal(a.indices[r], b.indices[r])
        np.testing.assert_array_equal(a.ids[r], b.ids[r])
        np.testing.assert_allclose(a.distances[r], b.distances[r], rtol=1e-6)


def test_filters_and_tombstones_match_reference(tmp_path):
    path, x, q = _file(tmp_path, deleted=(3, 77))
    port, ref = _engines(path)
    mask = np.random.default_rng(1).random(N) < 0.5
    _assert_same(port.search(q, k=10), ref.search(q, k=10))
    _assert_same(port.search(q, k=10, filter_mask=mask),
                 ref.search(q, k=10, filter_mask=mask))
    _assert_same(port.search(q, k=10, filter_mask=port.prepare_filter(mask)),
                 ref.search(q, k=10, filter_mask=ref.prepare_filter(mask)))
    victims = port.search(q, k=1).indices[:, 0]
    port.space.delete_rows(victims)
    ref.space.delete_rows(victims)
    a, b = port.search(q, k=10, filter_mask=mask), ref.search(q, k=10, filter_mask=mask)
    _assert_same(a, b)
    assert not np.isin(a.indices, [3, 77, *victims]).any()


def test_ids_and_delete_by_id_match_reference(tmp_path):
    ids = np.arange(N, dtype=np.uint64)[::-1] * np.uint64(1000) + np.uint64(5)
    path, x, q = _file(tmp_path, ids=ids)
    port, ref = _engines(path)
    a = port.search(q, k=5)
    np.testing.assert_array_equal(a.ids, ids[a.indices])
    port.space.delete_rows(ids=a.ids[:, 0])
    ref.space.delete_rows(ids=a.ids[:, 0])
    _assert_same(port.search(q, k=5), ref.search(q, k=5))


@pytest.mark.parametrize("k", [257, 1000])
def test_search_above_k_256_matches_reference(tmp_path, k):
    """k past the old 256 (and above the corpus: k_eff = N), and a range
    query with max_results = 300, as the JAX engine answers them."""
    path, x, q = _file(tmp_path, deleted=(5,))
    port, ref = _engines(path)
    _assert_same(port.search(q, k=k), ref.search(q, k=k))
    a = port.search_radius(q, 4e5, max_results=300)
    b = ref.search_radius(q, 4e5, max_results=300)
    np.testing.assert_array_equal(a.truncated, b.truncated)
    for r in range(len(q)):
        np.testing.assert_array_equal(a.indices[r], b.indices[r])


@pytest.mark.parametrize("k", [1, 10, 100, N])
@pytest.mark.parametrize("metric", [DistanceMetric.L2, DistanceMetric.INNER_PRODUCT])
def test_duplicated_rows_tie_like_reference(tmp_path, metric, k):
    """Every row has twins (40 distinct integer rows, repeated), so equal
    scores decide the order everywhere: both engines rank ties by the lower
    row, at k up to N."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, (40, D)).astype(np.float32)
    x = base[rng.integers(0, 40, N)]
    q = rng.integers(0, 4, (7, D)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=D, metric=metric, dtype=DataType.FLOAT32)
    b.add_vectors("v", x)
    path = tmp_path / "twins.mvt"
    b.build().save(path)
    port, ref = _engines(path)
    _assert_same(port.search(q, k=k), ref.search(q, k=k))


@pytest.mark.parametrize("metric", [DistanceMetric.L2, DistanceMetric.INNER_PRODUCT])
def test_wide_corpus_matches_reference(tmp_path, metric):
    """D = 1536 (text-embedding-3-small's width), past the old 1024. Values
    in [0, 15] keep every score exact in f32: identical results."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 16, (200, 1536)).astype(np.float32)
    q = rng.integers(0, 16, (5, 1536)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=1536, metric=metric)
    b.add_vectors("v", x)
    path = tmp_path / "wide.mvt"
    b.build().save(path)
    port, ref = _engines(path)
    _assert_same(port.search(q, k=10), ref.search(q, k=10))
    _assert_same(port.search(q, k=300), ref.search(q, k=300))


def test_k_above_corpus_and_empty_space(tmp_path):
    path, x, q = _file(tmp_path, n=6)
    port, ref = _engines(path)
    _assert_same(port.search(q, k=10), ref.search(q, k=10))
    empty_dir = tmp_path / "empty"
    empty_dir.mkdir()
    path, _, q = _file(empty_dir, n=0)
    port = SearchEngine(Reader.open(path).vector_space("v"), device="cpu")
    ref = JaxEngine(Reader.open(path).vector_space("v"), backend="pallas")
    _assert_same(port.search(q, k=4), ref.search(q, k=4))


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("dtype", [DataType.FLOAT32, DataType.FLOAT16])
def test_from_state_of_reference_device_space(tmp_path, dtype, precision):
    path, x, q = _file(tmp_path, DistanceMetric.INNER_PRODUCT, dtype,
                       deleted=(10,))
    jsp = JaxDeviceSpace.from_space(Reader.open(path).vector_space("v"),
                                    precision=precision)
    state = {name: np.asarray(getattr(jsp, name)) for name in
             ("data", "norms", "valid_mask")}
    state.update(num_valid=jsp.num_valid, dim=jsp.dim, metric=jsp.metric,
                 dtype=jsp.dtype, precision=jsp.precision,
                 host_ids=jsp.host_ids)
    port = SearchEngine(DeviceSpace.from_state(state, device="cpu"))
    ref = JaxEngine(jsp, backend="pallas")
    _assert_same(port.search(q, k=10), ref.search(q, k=10))


def test_unported_modes_raise(tmp_path):
    """add_rows serves (tests/test_torch_mutation.py holds it against the
    reference); int8 spaces open and search
    (tests/test_torch_quantized.py holds them against the reference); "high"
    and "high_verified" run, and on an f16 space (which the reference
    upcasts but keeps as FLOAT16) they run "highest": no over-fetch, no
    certificate."""
    path, _, q = _file(tmp_path, dtype=DataType.INT8)
    assert SearchEngine.open(path, device="cpu").search(q, k=5).indices.shape == (
        len(q), 5)
    path, x, q = _file(tmp_path)
    want = SearchEngine.open(path, device="cpu").search(q, k=5)
    for precision in ("high", "high_verified"):
        _assert_same(SearchEngine.open(path, device="cpu",
                                       precision=precision).search(q, k=5), want)
    path, x, q = _file(tmp_path, dtype=DataType.FLOAT16)
    highest = SearchEngine.open(path, device="cpu").search(q, k=5)
    ver = SearchEngine.open(path, device="cpu", precision="high_verified")
    _assert_same(ver.search(q, k=5), highest)
    assert ver.verify_stats == {"certified": 0, "fallbacks": 0}
    eng = SearchEngine.open(path, device="cpu")
    n0 = eng.space.num_valid
    eng.space.add_rows(x[:1] + 1000)
    assert eng.space.num_valid == n0 + 1
    assert eng.search(x[:1] + 1000, k=1).indices[0, 0] == n0


def test_autotune_not_ported_names_its_roadmap_item(tmp_path):
    """A CPU engine's ``autotune`` refuses: it times the CUDA kernels'
    grid, and the plain version on the CPU has none (as the JAX engine
    refuses ``backend="xla"``)."""
    path, _, _ = _file(tmp_path)
    with pytest.raises(ValueError, match="CUDA kernels"):
        SearchEngine.open(path, device="cpu").autotune()


@pytest.mark.parametrize("precision", ["high", "default"])
def test_precision_modes(tmp_path, precision):
    """The mirror of ``tests/test_engine.py::test_precision_modes``: "high"
    (the bf16x3 split over the f32 corpus, which stays f32 on the device)
    matches the f32 oracle exactly on well-separated data, and the JAX
    engine's indices; "default" (bf16 storage, half the memory) keeps a high
    overlap."""
    from metrovector_tpu.ops.distances import numpy_oracle

    rng = np.random.default_rng(0)
    data = rng.standard_normal((400, 64)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=64)
    b.add_vectors("v", data)
    path = tmp_path / "p.mvt"
    b.build().save(path)
    eng, ref = _engines(path, precision)
    queries = rng.standard_normal((5, 64)).astype(np.float32)
    res = eng.search(queries, k=10)
    _, oi = numpy_oracle(queries, data, 10, DistanceMetric.L2)
    if precision == "high":
        np.testing.assert_array_equal(res.indices, oi)
        np.testing.assert_array_equal(res.indices, ref.search(queries, k=10).indices)
        assert eng.space.data.dtype == torch.float32
    else:
        overlap = np.mean(
            [len(set(res.indices[r]) & set(oi[r])) / 10 for r in range(5)]
        )
        assert overlap >= 0.9
        assert eng.space.data.element_size() == 2


def test_microbatcher_over_port_engine(tmp_path):
    path, x, q = _file(tmp_path)
    port = SearchEngine.open(path, device="cpu")
    qs = np.concatenate([q, x[:10] + 1.0])
    want = port.search(qs, k=5)
    with MicroBatcher(port, k=5, max_batch=8, max_wait_ms=1.0) as mb:
        futs = [mb.submit(v) for v in qs]
        got = [f.result(timeout=60) for f in futs]
    for i, r in enumerate(got):
        np.testing.assert_array_equal(r.indices[0], want.indices[i])
        np.testing.assert_array_equal(r.scores[0], want.scores[i])
        np.testing.assert_array_equal(r.ids[0], want.ids[i])


def test_search_pipelined_matches_search(tmp_path):
    path, x, q = _file(tmp_path)
    port = SearchEngine.open(path, device="cpu")
    batches = [q[:2], q[2:], x[:3]]
    for batch, res in zip(batches, port.search_pipelined(iter(batches), k=4)):
        _assert_same(res, port.search(batch, k=4))


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("chunk_rows", [1, 7, 64, 1000])
def test_put_chunked_is_exact_across_chunk_edges(monkeypatch, chunk_rows, dtype):
    """Uploads in row chunks equal a one-piece copy, also when the chunk
    size does not divide the rows and when converting on the way."""
    from metrovector_tpu_torch.utils import transfer

    rng = np.random.default_rng(4)
    arr = rng.standard_normal((100, 12)).astype(np.float16)
    arr.setflags(write=False)  # as the mapped file's view is
    monkeypatch.setattr(transfer, "CHUNK_BYTES", chunk_rows * arr[0].nbytes)
    out = transfer.put_chunked(arr, "cpu", dtype=dtype)
    want = torch.from_numpy(arr.copy())
    assert torch.equal(out, want if dtype is None else want.to(dtype))
