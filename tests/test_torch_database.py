"""The port's ``Database`` facade against the JAX package's on the CPU: the
same file opened by both (``device="cpu"`` here, ``backend="xla"`` there),
searched through the lazy per-space engines, metadata predicates, the
budget's LRU eviction, sparse spaces, and ``mode="auto"`` routing to each
persisted sidecar (PQ, IVF-PQ, IVF, HNSW), ``mode="exact"`` and the batcher.
Mirrors ``tests/test_database.py`` and ``tests/test_database_routing.py``.
The footprint estimate is the port's own: it must equal what ``nbytes``
reads after the upload, for every dtype, precision, sparse formulation and
index flavor.

Tolerance. The routing corpus, its queries, centroids and codebooks are
integer-valued, so every f32 score is exact and the two facades' results
must be identical; the dense spaces of ``test_database.py`` are compared
to the numpy oracle's indices as there.
"""

import numpy as np
import pytest

import metrovector_tpu as jax_mvt
from metrovector_tpu.index import ivf as jax_ivf
from metrovector_tpu.index import pq as jax_pq
from metrovector_tpu.index.hnsw import HNSWIndex as JaxHNSW
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu_torch import Builder, DataType, Database, DistanceMetric, VectorType
from metrovector_tpu_torch.database import IndexEngine
from metrovector_tpu_torch.engine import SearchEngine
from metrovector_tpu_torch.errors import (
    HBMBudgetExceededError,
    MetadataColumnNotFoundError,
    MvtError,
)
from metrovector_tpu_torch.sparse import SparseSearchEngine

L2 = DistanceMetric.L2
D = 16


def _same(a, b):
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.ids, b.ids)


@pytest.fixture
def db_file(tmp_path):
    rng = np.random.default_rng(1)
    b = Builder()
    b.add_vector_space("docs", dim=8)
    data = rng.standard_normal((50, 8)).astype(np.float32)
    b.add_vectors("docs", data, ids=np.arange(50, dtype=np.uint64) + 500)
    b.add_metadata_column("docs", "lang", ["en", "de"] * 25)
    b.add_metadata_column("docs", "price", list(range(50)))
    b.add_vector_space("imgs", dim=4)
    imgs = rng.standard_normal((10, 4)).astype(np.float32)
    b.add_vectors("imgs", imgs)
    p = tmp_path / "db.mvt"
    b.build().save(p)
    return p, data, imgs


def test_lazy_engines_and_search(db_file):
    p, data, imgs = db_file
    db = Database.open(p, device="cpu")
    ref = jax_mvt.Database.open(p, backend="xla")
    assert db.space_names == ["docs", "imgs"]
    q = np.random.default_rng(2).standard_normal((3, 8)).astype(np.float32)
    res = db.search("docs", q, k=4)
    _, oi = numpy_oracle(q, data, 4, L2)
    np.testing.assert_array_equal(res.indices, oi)
    np.testing.assert_array_equal(res.ids, oi.astype(np.uint64) + 500)
    np.testing.assert_array_equal(res.ids, ref.search("docs", q, k=4).ids)
    assert db.search("imgs", imgs[:1], k=1).indices[0, 0] == 0
    assert isinstance(db.engine("docs"), SearchEngine)
    with pytest.raises(ValueError):
        db.engine()  # two spaces: ambiguous


def test_metadata_predicates(db_file):
    p, data, _ = db_file
    db = Database.open(p, device="cpu")
    ref = jax_mvt.Database.open(p, backend="xla")
    q = np.random.default_rng(3).standard_normal((2, 8)).astype(np.float32)
    res = db.search("docs", q, k=5, where=("lang", "==", "en"))
    mask = np.zeros(50, bool)
    mask[::2] = True
    _, oi = numpy_oracle(q, data, 5, L2, valid_mask=mask.astype(np.float32))
    np.testing.assert_array_equal(res.indices, oi)
    where = [("lang", "==", "de"), ("price", "<", 20)]
    res2 = db.search("docs", q, k=3, where=where)
    np.testing.assert_array_equal(res2.indices,
                                  ref.search("docs", q, k=3, where=where).indices)
    got = res2.indices[res2.indices >= 0]
    assert ((got % 2 == 1) & (got < 20)).all()
    extra = np.zeros(50, bool)
    extra[:10] = True
    res3 = db.search("docs", q, k=3, where=("lang", "in", {"en"}), filter_mask=extra)
    got3 = res3.indices[res3.indices >= 0]
    assert ((got3 % 2 == 0) & (got3 < 10)).all()
    for col, op, val in [("lang", "==", "en"), ("price", ">=", 7), ("lang", "in", {"de"})]:
        np.testing.assert_array_equal(db.column_mask("docs", col, op, val),
                                      ref.column_mask("docs", col, op, val))
    with pytest.raises(MetadataColumnNotFoundError):
        db.column_mask("docs", "nope", "==", 1)
    with pytest.raises(ValueError):
        db.column_mask("docs", "lang", "~=", "en")


def test_index_reattachment(tmp_path):
    rng = np.random.default_rng(4)
    data = rng.standard_normal((300, 16)).astype(np.float32)
    books = jax_pq.train_pq(data, m=4, ksub=16, iters=3)
    codes = jax_pq.encode_pq(data, books)
    recon = jax_pq.reconstruct_pq(codes, books)
    b = Builder()
    b.add_vector_space("v", dim=16)
    b.add_vectors("v", data)
    b.set_pq_index("v", books, codes, np.einsum("ij,ij->i", recon, recon).astype(np.float32))
    p = tmp_path / "pq.mvt"
    b.build().save(p)
    idx = Database.open(p, device="cpu").pq_index("v", keep_vectors=True)
    np.testing.assert_array_equal(idx.codes.numpy()[: len(codes)], codes)
    res = idx.search(data[:3], k=4, rerank=200)
    _, oi = numpy_oracle(data[:3], data, 4, L2)
    np.testing.assert_array_equal(res.indices, oi)


def test_hbm_budget_lru_eviction(db_file):
    p, data, imgs = db_file
    one_space = Database.open(p, device="cpu")._estimate_nbytes("docs")
    db = Database.open(p, device="cpu", hbm_budget=one_space)
    db.search("docs", data[:1], k=3)
    assert set(db._engines) == {"docs"}
    assert 0 < db.resident_bytes <= one_space
    db.search("imgs", imgs[:1], k=3)  # fits only after docs goes
    assert set(db._engines) == {"imgs"}
    db.search("docs", data[:1], k=3)  # rebuilt
    assert set(db._engines) == {"docs"}
    both = one_space + Database.open(p, device="cpu")._estimate_nbytes("imgs")
    big = Database.open(p, device="cpu", hbm_budget=both)
    big.search("docs", data[:1], k=3)
    big.search("imgs", imgs[:1], k=3)
    big.search("docs", data[:1], k=3)  # docs touched: imgs is the oldest
    assert list(big._engines) == ["imgs", "docs"]
    assert big.evict("imgs") is True and big.evict("imgs") is False
    assert list(big._engines) == ["docs"]


def test_hbm_budget_too_small_is_typed_error(db_file):
    p, data, _ = db_file
    db = Database.open(p, device="cpu", hbm_budget=64)
    with pytest.raises(HBMBudgetExceededError) as ei:
        db.search("docs", data[:1], k=1)
    assert isinstance(ei.value, MvtError) and isinstance(ei.value, MemoryError)
    assert ei.value.budget == 64 and ei.value.needed > 64
    assert db._engines == {}


def _dense_file(tmp_path, dtype, tomb):
    rng = np.random.default_rng(5)
    b = Builder()
    h = b.add_vector_space("s", dim=20, dtype=dtype)
    if dtype in (DataType.INT8, DataType.UINT8):
        h.with_quantization(scale=0.5, zero_point=3.0 if dtype == DataType.UINT8 else 0.0)
    b.add_vectors("s", rng.integers(0, 100, (37, 20)).astype(np.float32))
    if tomb:
        b.delete_vector("s", 3)
    p = tmp_path / f"d{int(dtype)}{tomb}.mvt"
    b.build().save(p)
    return p


@pytest.mark.parametrize("tomb", [False, True], ids=["live", "tombstoned"])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("dtype", [DataType.FLOAT32, DataType.FLOAT16,
                                   DataType.BFLOAT16, DataType.INT8, DataType.UINT8],
                         ids=["f32", "f16", "bf16", "int8", "uint8"])
def test_estimate_matches_actual_footprint(tmp_path, dtype, precision, tomb):
    """The port's estimate before the upload equals ``nbytes`` after it:
    f16 and bf16 at 2 bytes, ``"default"`` as bf16, int8 and uint8 at 1
    byte plus uint8's code sums, the mask where there are tombstones."""
    p = _dense_file(tmp_path, dtype, tomb)
    db = Database.open(p, device="cpu", engine_kwargs={"precision": precision})
    est = db._estimate_nbytes("s")
    assert est == db.engine("s").space.nbytes == db.resident_bytes


def test_database_routes_sparse_spaces(tmp_path):
    rng = np.random.default_rng(6)
    b = Builder()
    b.add_vector_space("dense", dim=16)
    b.add_vectors("dense", rng.standard_normal((50, 16)).astype(np.float32))
    b.add_vector_space("sp", dim=64, vector_type=VectorType.SPARSE)
    rows = []
    for _ in range(120):
        nz = int(rng.integers(2, 8))
        rows.append((rng.choice(64, size=nz, replace=False),
                     rng.standard_normal(nz).astype(np.float32)))
    b.add_sparse_vectors("sp", rows)
    b.add_metadata_column("sp", "lang", ["en" if i % 2 else "de" for i in range(120)])
    path = tmp_path / "mix.mvt"
    b.build().save(path)
    db = Database.open(path, device="cpu")
    eng = db.engine("sp")
    assert isinstance(eng, SparseSearchEngine) and eng.formulation == "ell"
    dense_rows = db.reader.vector_space("sp").to_numpy()
    q = rng.standard_normal((4, 64)).astype(np.float32)
    res = db.search("sp", q, k=5, where=("lang", "==", "en"))
    mask = np.asarray([i % 2 == 1 for i in range(120)])
    _, oi = numpy_oracle(q, dense_rows, 5, L2, valid_mask=mask.astype(np.float32))
    np.testing.assert_array_equal(res.indices, oi)
    assert db.resident_bytes >= eng.nbytes > 0
    assert db._estimate_nbytes("sp") == eng.nbytes


def test_sparse_estimate_tracks_coo_fallback(tmp_path):
    rng = np.random.default_rng(7)
    b = Builder()
    b.add_vector_space("sk", dim=512, vector_type=VectorType.SPARSE)
    rows = []
    for i in range(1000):
        nz = 100 if i % 100 == 0 else 1
        rows.append((rng.choice(512, size=nz, replace=False),
                     rng.standard_normal(nz).astype(np.float32)))
    b.add_sparse_vectors("sk", rows)
    b.delete_vector("sk", 5)
    path = tmp_path / "skew.mvt"
    b.build().save(path)
    db = Database.open(path, device="cpu")
    est = db._estimate_nbytes("sk")
    eng = db.engine("sk")
    assert eng.formulation == "coo" and est == eng.nbytes


# ------------------------------------ tests/test_database_routing.py ---


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(7)
    cents = rng.integers(-6, 7, (8, D)).astype(np.float32) * 5
    data = np.concatenate([c + rng.integers(-2, 3, (150, D)) for c in cents]
                          ).astype(np.float32)
    q = data[rng.choice(len(data), 12, replace=False)] + 1
    return data, q.astype(np.float32)


def _grp(n):
    return (np.arange(n) % 3).astype(np.int32)


@pytest.fixture(scope="module")
def paths(corpus, tmp_path_factory):
    """One file per sidecar kind (and one with none), written by the port's
    Builder, with integer centroids and codebooks."""
    data, _ = corpus
    tmp = tmp_path_factory.mktemp("routing")
    cents, _ = jax_ivf.train_kmeans(data, 8, iters=5)
    cents = np.rint(cents).astype(np.float32)
    d2 = (cents.astype(np.float64) ** 2).sum(1)[None] - 2.0 * (data.astype(np.float64) @ cents.T)
    assign = np.argmin(d2, axis=1).astype(np.int32)
    res = data - cents[assign]
    books = np.rint(jax_pq.train_pq(res, m=4, ksub=16, iters=5)).astype(np.float32)
    codes = jax_pq.encode_pq(res, books)
    cb = np.rint(jax_pq.train_pq(data, m=4, ksub=16, iters=5)).astype(np.float32)
    graph = JaxHNSW.build(data, L2, m=8, ef_construction=80, seed=3, threads=1)
    attach = {
        "ivfpq": lambda b: (b.set_ivf_index("s", cents, assign, nprobe=4),
                            b.set_pq_index("s", books, codes, residual=True)),
        "pq": lambda b: b.set_pq_index("s", cb, jax_pq.encode_pq(data, cb)),
        "ivf": lambda b: b.set_ivf_index("s", cents, assign, nprobe=4),
        "hnsw": lambda b: b.set_hnsw_index("s", graph.layers, graph.entry, m=8,
                                           ef_construction=80),
        "plain": lambda b: None,
    }
    out = {}
    for kind, fn in attach.items():
        b = Builder()
        b.add_vector_space("s", dim=D)
        b.add_vectors("s", data)
        b.add_metadata_column("s", "grp", _grp(len(data)))
        fn(b)
        out[kind] = tmp / f"{kind}.mvt"
        b.build().save(out[kind])
    return out


def _recall(idx, oi):
    return np.mean([len(set(idx[r]) & set(oi[r])) / oi.shape[1] for r in range(len(oi))])


@pytest.mark.parametrize("kind", ["ivfpq", "pq", "ivf", "hnsw"])
def test_detection_and_auto_routing(paths, corpus, kind):
    """Each sidecar kind is detected and served, with the reference's
    answers (its recall-oriented defaults included)."""
    data, q = corpus
    db = Database.open(paths[kind], device="cpu")
    assert db.index_kind("s") == kind
    eng = db.engine("s")
    assert isinstance(eng, IndexEngine) and eng.kind == kind
    res = db.search("s", q, k=10)
    ref = jax_mvt.Database.open(paths[kind], backend="xla")
    _same(res, ref.search("s", q, k=10))
    _, oi = numpy_oracle(q, data, 10, L2)
    assert _recall(res.indices, oi) >= 0.9


def test_plain_space_routes_exact(paths, corpus):
    db = Database.open(paths["plain"], device="cpu")
    assert db.index_kind("s") is None
    assert isinstance(db.engine("s"), SearchEngine)
    with pytest.raises(ValueError, match="no index sidecar"):
        db.engine("s", mode="index")
    with pytest.raises(ValueError, match="unknown mode"):
        db.engine("s", mode="bogus")


@pytest.mark.parametrize("kind", ["ivfpq", "pq", "hnsw"])
def test_exact_mode_bypasses_index(paths, corpus, kind):
    data, q = corpus
    db = Database.open(paths[kind], device="cpu")
    res = db.search("s", q, k=10, mode="exact")
    os_, _ = numpy_oracle(q, data, 10, L2)
    np.testing.assert_array_equal(res.scores, os_)
    assert isinstance(db.engine("s", mode="exact"), SearchEngine)
    assert isinstance(db.engine("s"), IndexEngine)
    assert len(db._engines) == 2


@pytest.mark.parametrize("kind", ["ivfpq", "pq", "ivf", "hnsw"])
def test_where_composes_with_routed_index(paths, corpus, kind):
    data, q = corpus
    db = Database.open(paths[kind], device="cpu")
    res = db.search("s", q, k=5, where=("grp", "==", 1))
    fm = _grp(len(data)) == 1
    assert fm[res.indices].all()
    ref = jax_mvt.Database.open(paths[kind], backend="xla")
    _same(res, ref.search("s", q, k=5, where=("grp", "==", 1)))
    _, oi = numpy_oracle(q, data, 5, L2, valid_mask=fm)
    assert _recall(res.indices, oi) >= 0.9


def test_search_kwargs_reach_routed_engine(paths, corpus):
    _, q = corpus
    db = Database.open(paths["ivfpq"], device="cpu")
    res0 = db.search("s", q, k=10, rerank=0)
    direct = db.ivfpq_index("s").search(q, k=10, nprobe=4, rerank=0)
    np.testing.assert_array_equal(res0.indices, direct.indices)


@pytest.mark.parametrize("kind", ["pq", "ivfpq", "hnsw"])
def test_batcher_routes_and_matches_direct(paths, corpus, kind):
    _, q = corpus
    db = Database.open(paths[kind], device="cpu")
    direct = db.search("s", q, k=10)
    with db.batcher("s", k=10, max_batch=4, max_wait_ms=1.0) as mb:
        futs = [mb.submit(q[i]) for i in range(len(q))]
        got = np.concatenate([f.result(timeout=30).indices for f in futs])
    np.testing.assert_array_equal(got, direct.indices)


def test_prepare_where_on_batcher(paths, corpus):
    data, q = corpus
    db = Database.open(paths["plain"], device="cpu")
    prepared = db.prepare_where("s", ("grp", "==", 2))
    with db.batcher("s", k=5, max_batch=4, max_wait_ms=1.0) as mb:
        got = [mb.submit(q[i], filter_mask=prepared).result(timeout=30) for i in range(4)]
    for r in got:
        assert (_grp(len(data))[r.indices] == 2).all()
    with pytest.raises(ValueError, match="predicate"):
        db.prepare_where("s")


def test_evict_drops_all_flavors(paths):
    db = Database.open(paths["pq"], device="cpu")
    db.engine("s", mode="exact")
    db.engine("s", mode="auto")
    assert len(db._engines) == 2
    assert db.evict("s") is True and len(db._engines) == 0
    assert db.evict("s") is False


def test_budget_accounts_index_flavor(paths):
    with pytest.raises(HBMBudgetExceededError):
        Database.open(paths["ivfpq"], device="cpu", hbm_budget=1).engine("s")
    db = Database.open(paths["hnsw"], device="cpu", hbm_budget=1)
    assert isinstance(db.engine("s"), IndexEngine)  # host-resident


@pytest.mark.parametrize("kind", ["ivfpq", "pq", "ivf", "hnsw"])
def test_index_estimate_matches_actual_footprint(paths, kind):
    """Each index flavor's estimate equals the tensors its engine holds on
    the device after the upload (HNSW: none)."""
    db = Database.open(paths[kind], device="cpu")
    est = db._estimate_nbytes("s", kind)
    assert est == db.engine("s").nbytes == db.resident_bytes
    assert (est == 0) == (kind == "hnsw")


def test_estimate_flavors_ordering(paths, corpus):
    """PQ holds its codes on top of the original rows it keeps for the
    re-rank (unpadded, unlike the exact engine's lane-padded block, so it
    can hold less than the exact engine); IVF-PQ holds two layouts on top
    of that; HNSW holds nothing."""
    data, _ = corpus
    db = Database.open(paths["ivfpq"], device="cpu")
    assert db._estimate_nbytes("s", "hnsw") == 0
    assert db._estimate_nbytes("s", "pq") > data.nbytes
    assert db._estimate_nbytes("s", "ivfpq") > db._estimate_nbytes("s", "pq")
    assert db._estimate_nbytes("s", "ivf") > 0
