"""The port's ``SparseSearchEngine`` on its CPU path, mirroring
``tests/test_sparse.py`` and holding it against the JAX engine: one file
opened by both, compared on indices, scores and ids in both formulations
and all three metrics, with filters, tombstones and empty rows; ``from_state``
fed from a JAX engine; the ``auto`` choice on a skewed corpus.

Integer-valued data: every sum is exact in f32, so IP and L2 agree bit for
bit. Cosine divides by ``1/sqrt`` here and ``rsqrt`` there, and normalized
queries are not integers: indices agree (no near-ties in these corpora) and
scores within 1e-6."""

import numpy as np
import pytest
import torch

from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu.sparse import SparseSearchEngine as JaxSparse
from metrovector_tpu_torch import (
    Builder,
    DistanceMetric,
    Reader,
    SparseSearchEngine,
    VectorType,
)
from metrovector_tpu_torch.errors import DimensionMismatchError, InvalidVectorTypeError
from metrovector_tpu_torch.ops.sparse_kernel import ell_topk

from _torch_parity import METRICS


def _random_sparse(rng, n, dim, nnz_per_row, integer=False):
    rows = []
    for _ in range(n):
        nnz = rng.integers(1, nnz_per_row + 1)
        cols = rng.choice(dim, size=nnz, replace=False)
        vals = (rng.integers(-5, 6, nnz) if integer
                else rng.standard_normal(nnz)).astype(np.float32)
        rows.append((cols, vals))
    return rows


def _file(tmp_path, rows, dim, metric=DistanceMetric.L2, deleted=(), ids=None,
          name="s.mvt"):
    b = Builder()
    b.add_vector_space("s", dim=dim, vector_type=VectorType.SPARSE, metric=metric)
    b.add_sparse_vectors("s", rows)
    for r in deleted:
        b.delete_vector("s", r)
    if ids is not None:
        b.set_vector_ids("s", ids)
    path = tmp_path / name
    b.build().save(path)
    return Reader.open(path).vector_space("s")


def _same(a, b, metric):
    np.testing.assert_array_equal(a.indices, b.indices)
    if metric == DistanceMetric.COSINE:
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(a.scores, b.scores)
    if b.ids is not None:
        np.testing.assert_array_equal(a.ids, b.ids)


@pytest.fixture
def sparse_file(tmp_path, rng):
    rows = _random_sparse(rng, n=200, dim=500, nnz_per_row=12)
    b = Builder()
    b.add_vector_space("s", dim=500, vector_type=VectorType.SPARSE)
    b.add_sparse_vectors("s", rows)
    b.add_metadata_column("s", "tag", [f"r{i}" for i in range(200)])
    path = tmp_path / "sparse.mvt"
    b.build().save(path)
    dense = np.zeros((200, 500), np.float32)
    for i, (c, v) in enumerate(rows):
        dense[i, c] = v
    return path, dense


def test_sparse_roundtrip(sparse_file):
    path, dense = sparse_file
    r = Reader.open(path)
    r.validate_with_checksum()
    sp = r.vector_space("s")
    assert sp.is_sparse
    assert sp.num_vectors == 200 and sp.dim == 500
    np.testing.assert_array_equal(sp.to_numpy(), dense)
    v = sp.get_vector(7)
    assert v.nnz == np.count_nonzero(dense[7])
    np.testing.assert_array_equal(v.to_dense(), dense[7])
    np.testing.assert_allclose(
        sp.norms()[:200], (dense.astype(np.float64) ** 2).sum(1), rtol=1e-5
    )
    assert sp.metadata_column("tag")[7] == "r7"


def test_sparse_dense_api_guards(sparse_file, tmp_path):
    path, _ = sparse_file
    sp = Reader.open(path).vector_space("s")
    with pytest.raises(InvalidVectorTypeError):
        sp.padded_array()
    with pytest.raises(InvalidVectorTypeError):
        sp.map_vector_range(0, 5)
    b = Builder()
    b.add_vector_space("d", dim=4)
    with pytest.raises(InvalidVectorTypeError):
        b.add_sparse_vectors("d", [([0], [1.0])])
    b.add_vectors("d", np.eye(4, dtype=np.float32))
    b.build().save(tmp_path / "d.mvt")
    dense_space = Reader.open(tmp_path / "d.mvt").vector_space("d")
    with pytest.raises(InvalidVectorTypeError):
        SparseSearchEngine(dense_space, device="cpu")
    with pytest.raises(ValueError, match="formulation"):
        SparseSearchEngine(sp, device="cpu", formulation="csr")


@pytest.mark.parametrize("metric", METRICS)
def test_sparse_search_matches_oracle(tmp_path, rng, metric):
    rows = _random_sparse(rng, n=300, dim=256, nnz_per_row=10)
    sp = _file(tmp_path, rows, 256, metric)
    eng = SparseSearchEngine(sp, device="cpu")
    assert eng.formulation == "ell" and eng.device == torch.device("cpu")
    queries = rng.standard_normal((6, 256)).astype(np.float32)
    res = eng.search(queries, k=10)
    _, oi = numpy_oracle(queries, sp.to_numpy(), 10, metric)
    np.testing.assert_array_equal(res.indices, oi)


@pytest.mark.parametrize("formulation", ["ell", "coo"])
@pytest.mark.parametrize("metric", METRICS)
def test_formulations_match_reference_engine(tmp_path, rng, formulation, metric):
    """Integer data, a skewed corpus that forces the ELL overflow, tombstones,
    a filter and ids: the port equals the JAX engine."""
    rows = _random_sparse(rng, n=150, dim=300, nnz_per_row=8, integer=True)
    for i in (3, 77):
        rows[i] = (rng.choice(300, size=120, replace=False),
                   rng.integers(-5, 6, 120).astype(np.float32))
    ids = np.arange(150, dtype=np.uint64) * 7 + 3
    sp = _file(tmp_path, rows, 300, metric, deleted=(10, 77), ids=ids)
    port = SparseSearchEngine(sp, device="cpu", formulation=formulation)
    ref = JaxSparse(sp, formulation=formulation)
    assert port.formulation == ref.formulation == formulation
    if formulation == "ell":
        assert port._has_ovf and port.r_cap == ref.r_cap < 120
    q = rng.integers(-3, 4, (5, 300)).astype(np.float32)
    q[0] = sp.to_numpy()[3]  # a query that targets a wide row
    mask = np.arange(150) % 3 != 1
    for fm in (None, mask):
        a = port.search(q, k=10, filter_mask=fm)
        b = ref.search(q, k=10, filter_mask=fm)
        _same(a, b, metric)
        assert not np.isin(a.indices, [10, 77]).any()
    if metric != DistanceMetric.COSINE:
        assert 3 in port.search(q, k=10).indices[0]


@pytest.mark.parametrize("formulation", ["ell", "coo"])
@pytest.mark.parametrize("metric", METRICS)
def test_from_state_matches_reference_engine(tmp_path, rng, formulation, metric):
    rows = _random_sparse(rng, n=120, dim=200, nnz_per_row=9, integer=True)
    rows[5] = (rng.choice(200, size=80, replace=False), np.ones(80, np.float32))
    sp = _file(tmp_path, rows, 200, metric, deleted=(4,))
    ref = JaxSparse(sp, formulation=formulation, nnz_chunk=512)
    state = {"formulation": ref.formulation, "metric": int(ref.metric),
             "dim": ref.dim, "num_vectors": ref.num_vectors,
             "host_ids": ref.host_ids, "norms": np.asarray(ref._norms),
             "valid": np.asarray(ref._valid), "nnz_chunk": ref.nnz_chunk
             if formulation == "coo" else None}
    if formulation == "ell":
        state.update({key: np.asarray(getattr(ref, "_" + key)) for key in (
            "cols_ell", "vals_ell", "ovf_cols", "ovf_rows", "ovf_vals")})
    else:
        state.update({key: np.asarray(getattr(ref, "_" + key))
                      for key in ("cols", "rows", "vals")})
    port = SparseSearchEngine.from_state(state, device="cpu")
    q = rng.integers(-3, 4, (4, 200)).astype(np.float32)
    _same(port.search(q, k=15), ref.search(q, k=15), metric)
    assert port.num_valid == ref.num_valid == 119


@pytest.mark.parametrize("k", [10, 200])
@pytest.mark.parametrize("metric", METRICS)
def test_splade_shaped_queries_match_reference_engine(tmp_path, rng, metric, k):
    """SPLADE-shaped queries (32 nonzeros of 2,048 terms, one query all
    zero) against rows of up to 12 entries: most rows score exactly 0, and
    up to k = N ties decide, lowest row first, in both engines."""
    rows = _random_sparse(rng, n=200, dim=2048, nnz_per_row=12, integer=True)
    sp = _file(tmp_path, rows, 2048, metric, deleted=(7,))
    port = SparseSearchEngine(sp, device="cpu")
    ref = JaxSparse(sp)
    assert port.formulation == ref.formulation == "ell"
    q = np.zeros((5, 2048), np.float32)
    for i in range(4):
        q[i, rng.choice(2048, 32, replace=False)] = rng.choice([-3, -2, -1, 1, 2, 3], 32)
    a, b = port.search(q, k=k), ref.search(q, k=k)
    _same(a, b, metric)
    if metric == DistanceMetric.INNER_PRODUCT:
        assert (a.scores == 0).sum() > a.scores.size // 2
        live = [r for r in range(200) if r != 7]
        assert a.indices[4].tolist() == (live + [-1])[:k]  # the all-zero query


def test_tombstones_and_k_above_live_rows(tmp_path, rng):
    rows = _random_sparse(rng, n=100, dim=64, nnz_per_row=6)
    sp = _file(tmp_path, rows, 64, deleted=(42,))
    eng = SparseSearchEngine(sp, device="cpu")
    res = eng.search(sp.get_vector(42).to_dense(), k=5)
    assert 42 not in res.indices
    mask = np.zeros(100, bool)
    mask[[1, 2, 3, 42]] = True
    res = eng.search(rng.standard_normal((2, 64)).astype(np.float32), k=8,
                     filter_mask=mask)
    assert sorted(res.indices[0, :3]) == [1, 2, 3]
    assert (res.indices[:, 3:] == -1).all() and np.isinf(res.distances[:, 3:]).all()
    assert (res.ids[:, 3:] == np.uint64(2**64 - 1)).all()


def test_search_radius_and_k_above_corpus(tmp_path, rng):
    rows = _random_sparse(rng, n=50, dim=32, nnz_per_row=5)
    sp = _file(tmp_path, rows, 32)
    eng = SparseSearchEngine(sp, device="cpu")
    ref = JaxSparse(sp)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    a = eng.search(q, k=80)
    assert a.indices.shape == (3, 80) and (a.indices[:, 50:] == -1).all()
    ra, rb = (e.search_radius(q, radius=3.0, max_results=50) for e in (eng, ref))
    for x, y in zip(ra.indices, rb.indices):
        np.testing.assert_array_equal(x, y)
    assert not ra.truncated.any()


def test_sparse_dim_inference(tmp_path):
    sp = _file(tmp_path, [([3, 17], [1.0, 2.0]), ([255], [3.0])], 0)
    assert sp.dim == 256
    assert sp.get_vector(1).to_dense()[255] == 3.0
    res = SparseSearchEngine(sp, device="cpu").search(
        np.eye(256, dtype=np.float32)[255], k=1)
    assert res.indices[0, 0] == 1


@pytest.mark.parametrize("formulation", ["ell", "coo"])
def test_sparse_empty_rows(tmp_path, formulation):
    sp = _file(tmp_path, [([], []), ([2], [5.0])], 16)
    assert sp.get_vector(0).nnz == 0
    assert sp.norms()[0] == 0.0
    # under L2 the all-zero row 0 (distance 1) beats row 1 (distance 4)
    res = SparseSearchEngine(sp, device="cpu", formulation=formulation).search(
        np.eye(16, dtype=np.float32)[2], k=2)
    assert res.indices[0].tolist() == [0, 1]
    np.testing.assert_allclose(res.distances[0], [1.0, 4.0], atol=1e-5)


def test_sparse_search_carries_ids(tmp_path, rng):
    rows = []
    for _ in range(30):
        nnz = int(rng.integers(1, 6))
        cols = np.sort(rng.choice(16, nnz, replace=False)).astype(np.uint32)
        rows.append((cols, rng.standard_normal(nnz).astype(np.float32)))
    ids = np.arange(30, dtype=np.uint64) * 3 + 11
    sp = _file(tmp_path, rows, 16, ids=ids)
    eng = SparseSearchEngine(sp, device="cpu")
    dense = np.zeros((2, 16), np.float32)
    c0, v0 = rows[0]
    dense[0, c0] = v0
    res = eng.search(dense, k=3)
    assert res.indices[0, 0] == 0 and res.ids[0, 0] == 11
    live = res.indices >= 0
    np.testing.assert_array_equal(res.ids[live], ids[res.indices[live]])


def test_auto_formulation_matches_reference_choice(tmp_path, rng):
    """auto: ELL for regular distributions, COO when padding would dominate
    (one huge row amid tiny ones), as the JAX engine chooses."""
    regular = _random_sparse(rng, n=64, dim=200, nnz_per_row=6)
    skewed = [([int(i % 200)], [1.0]) for i in range(400)]
    skewed[10] = (rng.choice(200, size=190, replace=False), np.ones(190, np.float32))
    for rows, want in ((regular, "ell"), (skewed, "coo")):
        sp = _file(tmp_path, rows, 200, name=f"{want}.mvt")
        port = SparseSearchEngine(sp, device="cpu")
        ref = JaxSparse(sp)
        assert port.formulation == ref.formulation == want
        q = rng.standard_normal((3, 200)).astype(np.float32)
        _, oi = numpy_oracle(q, sp.to_numpy(), 5, DistanceMetric.L2)
        np.testing.assert_array_equal(port.search(q, k=5).indices, oi)


def test_search_runs_the_kernel_wrapper_once(tmp_path, rng, monkeypatch):
    """An ELL search is one call of ell_topk (its plain version on the CPU)
    with the queries transposed, on the engine's device."""
    import metrovector_tpu_torch.sparse as port_sparse

    calls = []

    def spy(qt, *args):
        calls.append(qt.shape)
        return ell_topk(qt, *args)

    monkeypatch.setattr(port_sparse, "ell_topk", spy)
    sp = _file(tmp_path, _random_sparse(rng, n=40, dim=30, nnz_per_row=4), 30)
    eng = SparseSearchEngine(sp, device="cpu")
    eng.search(rng.standard_normal((7, 30)).astype(np.float32), k=4)
    assert calls == [(30, 7)]


def test_guards_and_unported_options(tmp_path, rng):
    sp = _file(tmp_path, _random_sparse(rng, n=20, dim=16, nnz_per_row=3), 16)
    eng = SparseSearchEngine(sp, device="cpu")
    with pytest.raises(DimensionMismatchError):
        eng.search(np.zeros((1, 15), np.float32))
    with pytest.raises(DimensionMismatchError):
        eng.search(np.zeros((1, 16), np.float32), filter_mask=np.ones(19, bool))
    with pytest.raises(ValueError, match="CUDA kernels"):  # the CPU has no grid
        eng.autotune()
    eng.block_rows = 1024  # the JAX package's tile: an attribute nothing reads
    assert eng.search(np.ones((1, 16), np.float32), k=2).indices.shape == (1, 2)
    assert eng.nbytes > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SparseSearchEngine(sp)  # the default device is CUDA, never a fallback
