"""The port's sharded sparse search (each shard's ELL slice at the corpus's
width with its own overflow tail, K4 once per shard, one exchange) on CPU
meshes against the JAX package's ``ShardedSparseSearchEngine`` on the
8-device virtual CPU mesh, the port's resident ``SparseSearchEngine`` and
the float64 oracle: the mirror of ``tests/test_sparse_sharded.py``.

Against the port's resident engine the answer is identical, scores too: a
row's sum takes the same slots and overflow entries in the same order in
either layout. Against the JAX package the indices are identical and the
scores within 1e-6 relative (its XLA contraction sums a row in its own
order), the band of the reference test."""

import numpy as np
import pytest

from metrovector_tpu import Builder, DistanceMetric, Reader, VectorType
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu.parallel import ShardedSparseSearchEngine as JaxShardedSparse
from metrovector_tpu.parallel import make_mesh as jax_mesh
from metrovector_tpu_torch import Reader as PortReader
from metrovector_tpu_torch import SparseSearchEngine
from metrovector_tpu_torch.errors import DimensionMismatchError, InvalidVectorTypeError
from metrovector_tpu_torch.parallel import ShardedSparseSearchEngine, make_mesh

from _torch_parity import METRICS


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _sparse_file(tmp_path, rng, n=400, dim=300, metric=DistanceMetric.L2, wide=(),
                 tombstone=None, with_ids=False):
    """At least two entries a row (single-entry rows on one column are
    exact cosine ties that the f64 oracle splits by an ulp); ``wide`` rows
    have 120 entries and spill into the overflow tail."""
    rows = []
    for i in range(n):
        nz = 120 if i in wide else int(rng.integers(2, 10))
        cols = rng.choice(dim, size=nz, replace=False)
        rows.append((cols, rng.standard_normal(nz).astype(np.float32)))
    b = Builder()
    b.add_vector_space("s", dim=dim, vector_type=VectorType.SPARSE, metric=metric)
    b.add_sparse_vectors("s", rows)
    if with_ids:
        b.set_vector_ids("s", np.arange(1000, 1000 + n, dtype=np.uint64))
    if tombstone is not None:
        b.delete_vector("s", tombstone)
    path = tmp_path / "s.mvt"
    b.build().save(path)
    return path


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_sharded_sparse_matches_resident_jax_and_oracle(tmp_path, rng, metric, shards):
    path = _sparse_file(tmp_path, rng, metric=metric, wide=(7, 133))
    sp = PortReader.open(path).vector_space("s")
    dense = sp.to_numpy()
    eng = ShardedSparseSearchEngine(sp, cpu_mesh(shards))
    assert eng._has_ovf  # the planted wide rows spill
    q = rng.standard_normal((5, 300)).astype(np.float32)
    q[0] = dense[7]  # a wide row, through the overflow tail
    res = eng.search(q, k=10)
    _, oi = numpy_oracle(q, dense, 10, metric)
    np.testing.assert_array_equal(res.indices, oi)
    single = SparseSearchEngine(sp, device="cpu", formulation="ell").search(q, k=10)
    for field in ("indices", "scores", "distances", "ids"):
        np.testing.assert_array_equal(getattr(res, field), getattr(single, field))
    want = JaxShardedSparse(Reader.open(path).vector_space("s"), jax_mesh(shards)).search(
        q, k=10)
    np.testing.assert_array_equal(res.indices, want.indices)
    np.testing.assert_allclose(res.scores, want.scores, rtol=1e-6)


def test_sharded_sparse_tombstones_and_ids(tmp_path, rng):
    path = _sparse_file(tmp_path, rng, n=300, tombstone=42, with_ids=True)
    sp = PortReader.open(path).vector_space("s")
    dense = sp.to_numpy()
    res = ShardedSparseSearchEngine(sp, cpu_mesh(8)).search(dense[[42, 10]], k=5)
    assert 42 not in res.indices
    mask = np.ones(300, np.float32)
    mask[42] = 0
    _, oi = numpy_oracle(dense[[42, 10]], dense, 5, DistanceMetric.L2, valid_mask=mask)
    np.testing.assert_array_equal(res.indices, oi)
    live = res.indices >= 0
    np.testing.assert_array_equal(res.ids[live], (res.indices[live] + 1000).astype(np.uint64))
    want = JaxShardedSparse(Reader.open(path).vector_space("s"), jax_mesh(8)).search(
        dense[[42, 10]], k=5)
    np.testing.assert_array_equal(res.ids, want.ids)


def test_sharded_sparse_k_exceeds_corpus_and_guards(tmp_path, rng):
    """12 rows over 8 shards (2 a shard: shards 6 and 7 hold none), k = 20:
    the tail is unfilled; a dense space and a wrong width are refused."""
    path = _sparse_file(tmp_path, rng, n=12)
    eng = ShardedSparseSearchEngine(PortReader.open(path).vector_space("s"), cpu_mesh(8))
    q = rng.standard_normal((2, 300)).astype(np.float32)
    res = eng.search(q, k=20)
    assert res.indices.shape == (2, 20)
    assert (res.indices[:, 12:] == -1).all() and np.isneginf(res.scores[:, 12:]).all()
    assert set(res.indices[0, :12]) == set(range(12))
    with pytest.raises(DimensionMismatchError):
        eng.search(q[:, :299], k=3)
    b = Builder()
    b.add_vector_space("d", dim=8)
    b.add_vectors("d", np.zeros((4, 8), np.float32))
    p = tmp_path / "d.mvt"
    b.build().save(p)
    with pytest.raises(InvalidVectorTypeError):
        ShardedSparseSearchEngine(PortReader.open(p).vector_space("d"), cpu_mesh(8))
