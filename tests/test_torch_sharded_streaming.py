"""The port's ``ShardedStreamingSearcher`` (each shard streams its own rows
through its device's staging buffers, K1 once a chunk, one exchange at
the end) on CPU meshes against the port's resident sharded and
single-device searches, the JAX package's ``ShardedStreamingSearcher``
on the 8-device virtual CPU mesh and the float64 oracle: the mirror of the
sharded cases of ``tests/test_streaming.py`` and of the sharded-streaming
case of ``tests/test_parallel_filters.py``.

The data is integer-valued, so every L2 and inner-product score is exact
in f32 and the streamed answer is identical to the resident ones, scores
too (on float data the CPU's BLAS sums a chunk in a shape-dependent
order; on the card K1 sums a row in one order whatever the chunk). Against
the JAX package the indices are identical, the scores within 1e-6
relative (identical on these integers, save its f16 upcast on the host)."""

import numpy as np
import pytest

from metrovector_tpu import Builder, DataType, DistanceMetric, Reader
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu.parallel import ShardedStreamingSearcher as JaxShardedStreaming
from metrovector_tpu.parallel import make_mesh as jax_mesh
from metrovector_tpu_torch import Reader as PortReader
from metrovector_tpu_torch import SearchEngine
from metrovector_tpu_torch.errors import DimensionMismatchError
from metrovector_tpu_torch.parallel import (
    ShardedDeviceSpace,
    ShardedStreamingSearcher,
    make_mesh,
)


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _same(a, b):
    for field in ("indices", "scores", "distances", "ids"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


@pytest.fixture
def big_space(tmp_path, rng):
    data = rng.integers(-8, 9, (2000, 32)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=32)
    b.add_vectors("v", data)
    b.delete_vector("v", 1234)
    path = tmp_path / "d.mvt"
    b.build().save(path)
    return path, data


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_matches_resident_sharded_jax_and_oracle(big_space, rng, shards):
    """Streamed shard by shard == the resident sharded space == the
    resident engine, bit for bit; == the JAX package's streamed answer and
    the oracle's ranks."""
    path, data = big_space
    sp = PortReader.open(path).vector_space("v")
    queries = rng.integers(-8, 9, (4, 32)).astype(np.float32)
    mesh = cpu_mesh(shards)
    got = ShardedStreamingSearcher(sp, mesh, chunk_rows=64).search(queries, k=12)
    _same(got, ShardedDeviceSpace(sp, mesh).search(queries, k=12))
    _same(got, SearchEngine(sp, device="cpu").search(queries, k=12))
    keep = np.ones(2000, np.float32)
    keep[1234] = 0
    _, oi = numpy_oracle(queries, data, 12, DistanceMetric.L2, valid_mask=keep)
    np.testing.assert_array_equal(got.indices, oi)
    want = JaxShardedStreaming(Reader.open(path).vector_space("v"), mesh=jax_mesh(shards),
                               chunk_rows=64, backend="xla").search(queries, k=12)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-6)


@pytest.mark.parametrize("chunk_rows", [64, 96, 256, 512])
def test_chunk_size_invariant(big_space, rng, chunk_rows):
    path, _ = big_space
    sp = PortReader.open(path).vector_space("v")
    queries = rng.integers(-8, 9, (3, 32)).astype(np.float32)
    s = ShardedStreamingSearcher(sp, cpu_mesh(8), chunk_rows=chunk_rows)
    assert s.chunk_rows == min(chunk_rows, s.per) and s.per == 256
    _same(s.search(queries, k=7), ShardedDeviceSpace(sp, cpu_mesh(8)).search(queries, k=7))
    # 2,000 rows: shard 7 holds 208; every chunk counted once
    per_shard = [min(256, 2000 - 256 * j) for j in range(8)]
    assert s.last_trace["chunks"] == sum(-(-r // s.chunk_rows) for r in per_shard)
    assert s.last_trace["bytes"] == 2000 * (128 * 4 + 4 + 4)


def _typed_file(tmp_path, rng, dtype, metric, n=640, d=16):
    lo, hi = {DataType.UINT8: (0, 256), DataType.INT8: (-128, 128)}.get(dtype, (-8, 9))
    data = rng.integers(lo, hi, (n, d)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=d, dtype=dtype, metric=metric)
    b.add_vectors("v", data)
    b.delete_vector("v", 3)
    path = tmp_path / "t.mvt"
    b.build().save(path)
    q = rng.integers(lo if dtype == DataType.UINT8 else -8, hi if dtype == DataType.UINT8 else 9,
                     (3, d)).astype(np.float32)
    return path, q


@pytest.mark.parametrize("dtype,metric", [
    (DataType.BFLOAT16, DistanceMetric.L2),
    (DataType.FLOAT16, DistanceMetric.INNER_PRODUCT),
    (DataType.INT8, DistanceMetric.INNER_PRODUCT),    # raw dots through the merges
    (DataType.UINT8, DistanceMetric.L2),              # the offset sums
    (DataType.UINT8, DistanceMetric.COSINE),          # the affine read
])
def test_other_dtypes_equal_the_resident_searches(tmp_path, rng, dtype, metric):
    """Each dtype ships as the resident engine holds it; the streamed
    answer equals the resident sharded space's and the resident engine's."""
    path, q = _typed_file(tmp_path, rng, dtype, metric)
    sp = PortReader.open(path).vector_space("v")
    got = ShardedStreamingSearcher(sp, cpu_mesh(4), chunk_rows=64).search(q, k=6)
    _same(got, ShardedDeviceSpace(sp, cpu_mesh(4)).search(q, k=6))
    _same(got, SearchEngine(sp, device="cpu").search(q, k=6))
    assert 3 not in got.indices


def test_ids_and_a_corpus_smaller_than_k(tmp_path, rng):
    data = rng.integers(-8, 9, (40, 8)).astype(np.float32)
    ids = np.arange(40, dtype=np.uint64) * 5 + 3
    b = Builder()
    b.add_vector_space("v", dim=8)
    b.add_vectors("v", data, ids=ids)
    path = tmp_path / "tiny.mvt"
    b.build().save(path)
    sp = PortReader.open(path).vector_space("v")
    res = ShardedStreamingSearcher(sp, cpu_mesh(8), chunk_rows=8).search(data[:2], k=50)
    assert (res.indices[:, 0] == [0, 1]).all()
    valid = res.indices >= 0
    assert valid.sum(1).tolist() == [40, 40]
    np.testing.assert_array_equal(res.ids[valid], ids[res.indices[valid]])
    assert (res.ids[~valid] == np.iinfo(np.uint64).max).all()
    _same(res, SearchEngine(sp, device="cpu").search(data[:2], k=50))


def test_filter_with_tombstones_matches_resident_sharded_and_jax(tmp_path, rng):
    data = rng.integers(-8, 9, (600, 32)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=32)
    b.add_vectors("v", data)
    b.delete_vector("v", 7)
    path = tmp_path / "f.mvt"
    b.build().save(path)
    sp = PortReader.open(path).vector_space("v")
    queries = rng.integers(-8, 9, (3, 32)).astype(np.float32)
    mask = rng.random(600) < 0.5
    mask[7] = True  # the tombstone wins over the predicate
    got = ShardedStreamingSearcher(sp, cpu_mesh(4), chunk_rows=64).search(
        queries, k=8, filter_mask=mask)
    _same(got, ShardedDeviceSpace(sp, cpu_mesh(4)).search(queries, k=8, filter_mask=mask))
    omask = mask.astype(np.float32)
    omask[7] = 0.0
    _, oi = numpy_oracle(queries, data, 8, DistanceMetric.L2, valid_mask=omask)
    np.testing.assert_array_equal(got.indices, oi)
    want = JaxShardedStreaming(Reader.open(path).vector_space("v"), mesh=jax_mesh(4),
                               chunk_rows=64, backend="xla").search(
        queries, k=8, filter_mask=mask)
    np.testing.assert_array_equal(got.indices, want.indices)
    with pytest.raises(DimensionMismatchError):
        ShardedStreamingSearcher(sp, cpu_mesh(4)).search(queries, k=3,
                                                        filter_mask=np.ones(599, bool))
