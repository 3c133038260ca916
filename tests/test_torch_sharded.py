"""The port's sharded exact search on CPU meshes (``devices=["cpu"] * S``,
the kernels' plain versions) against the JAX package's on the 8-device
virtual CPU mesh: the mirror of ``tests/test_sharded.py`` and of the
sharded-space cases of ``tests/test_parallel_filters.py``.

Tolerances: on integer-valued data every L2 and inner-product score is
exact in f32 on both sides, so indices and scores are identical; on float
data and for cosine (which divides) the scores agree within the band of
``_torch_parity.tolerance`` (a few f32 ulps of the score, the reference's
exactness contract, ``metrovector_tpu/ops/distances.py:25-35``) and the
indices agree except at near-ties inside it. Against the port's resident
``SearchEngine`` the sharded answer is identical whatever the data: each
row is scored by the same plain version and the exchange keeps the
lowest row on ties."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from metrovector_tpu import Builder, DataType, DistanceMetric, Reader
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu.parallel import ShardedDeviceSpace as JaxSharded
from metrovector_tpu.parallel import dim_sharded_topk as jax_dim
from metrovector_tpu.parallel import grid_sharded_topk as jax_grid
from metrovector_tpu.parallel import make_mesh as jax_mesh
from metrovector_tpu.parallel import make_mesh_2d as jax_mesh_2d
from metrovector_tpu.parallel import query_sharded_topk as jax_query
from metrovector_tpu.parallel import replicate as jax_replicate
from metrovector_tpu.parallel import shard_rows as jax_shard_rows
from metrovector_tpu.parallel import sharded_topk as jax_sharded
from metrovector_tpu_torch import PreparedFilter, SearchEngine
from metrovector_tpu_torch import Reader as PortReader
from metrovector_tpu_torch.errors import DimensionMismatchError
from metrovector_tpu_torch.parallel import (
    ShardedDeviceSpace,
    dim_sharded_topk,
    grid_sharded_topk,
    make_mesh,
    make_mesh_2d,
    query_sharded_topk,
    replicate,
    rows_per_shard,
    shard_rows,
    sharded_topk,
)

from _torch_parity import assert_topk_match, exact_scores, make_data, sq_norms, tolerance
from _torch_parity import unit_rows

SHARDS = [1, 2, 4, 8]


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _np(pair):
    return tuple(np.asarray(t) for t in pair)


def _jax_rows(x, mesh, axis="shard", pad=0):
    return jax_shard_rows(x, mesh, axis=axis, pad_value=pad)


def _port(q, db, norms, n, k, metric, mesh, **kw):
    return _np(sharded_topk(torch.from_numpy(q), db, norms, n, k, metric, mesh, **kw))


@pytest.mark.parametrize("kind", ["integer", "float"])
@pytest.mark.parametrize("metric", [DistanceMetric.L2, DistanceMetric.INNER_PRODUCT,
                                    DistanceMetric.COSINE])
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_topk_matches_jax(rng, shards, metric, kind):
    """sharded_topk on S CPU shards == the JAX sharded_topk (xla) on S
    virtual devices; integer L2/IP identical, else within the band."""
    db, q = make_data(rng, kind, 1000, 32, 6)
    if metric == DistanceMetric.COSINE:
        q = unit_rows(q)  # both kernels take cosine queries normalized
    norms = sq_norms(db)
    got = _port(q, db, norms, 1000, 10, metric, cpu_mesh(shards))
    mesh = jax_mesh(shards)
    want = _np(jax_sharded(jax_replicate(q, mesh), _jax_rows(db, mesh), _jax_rows(norms, mesh),
                           1000, 10, metric, mesh, backend="xla"))
    exact = kind == "integer" and metric != DistanceMetric.COSINE
    assert_topk_match(got, want, exact, tolerance(q, db, metric),
                      exact_scores(q, db, metric))
    if exact:
        _, oi = numpy_oracle(q, db, 10, metric)
        np.testing.assert_array_equal(got[1], oi)


def test_sharded_matches_jax_pallas_interpret(rng):
    """The JAX package's own kernel (interpret mode) on 4 shards."""
    db, q = make_data(rng, "integer", 512, 128, 3)
    norms = sq_norms(db)
    mesh = jax_mesh(4)
    want = _np(jax_sharded(jax_replicate(q, mesh), _jax_rows(db, mesh), _jax_rows(norms, mesh),
                           512, 5, DistanceMetric.L2, mesh, backend="pallas", interpret=True,
                           block_rows=128))
    got = _port(q, db, norms, 512, 5, DistanceMetric.L2, cpu_mesh(4))
    assert_topk_match(got, want, exact=True)


@pytest.mark.parametrize("n,k", [(777, 10), (20, 12), (3, 12)])
def test_uneven_rows_padding_shards_and_k_above_a_shard(rng, n, k):
    """Rows not divisible by the mesh: trailing shards are partly or only
    padding (n = 20: 8 rows a shard, shards 3-7 hold no row; n = 3: k
    passes the corpus) and k passes a shard's valid rows. No padding row
    surfaces; the unfilled tail is (−inf, −1), as in the JAX package."""
    db, q = make_data(rng, "integer", n, 32, 4)
    norms = sq_norms(db)
    got = _port(q, db, norms, n, k, DistanceMetric.L2, cpu_mesh(8))
    kj = min(k, n)
    assert got[1].max() < n
    _, oi = numpy_oracle(q, db, kj, DistanceMetric.L2)
    np.testing.assert_array_equal(got[1][:, :kj], oi)
    assert (got[1][:, kj:] == -1).all() and np.isneginf(got[0][:, kj:]).all()
    if kj <= rows_per_shard(n, 8, 8):  # the JAX scan takes k up to a shard's rows
        mesh = jax_mesh(8)
        want = _np(jax_sharded(jax_replicate(q, mesh), _jax_rows(db, mesh),
                               _jax_rows(norms, mesh), n, kj, DistanceMetric.L2, mesh,
                               backend="xla"))
        assert_topk_match((got[0][:, :kj], got[1][:, :kj]), want, exact=True)


def test_twins_across_shards_keep_the_lowest_row(rng):
    """Equal scores in several shards: the exchange keeps the lowest
    global row first, as lax.top_k over the shard-major lists does."""
    base = rng.integers(0, 16, (8, 16)).astype(np.float32)
    db = np.tile(base, (50, 1))  # every row has twins in every shard
    q = rng.integers(0, 16, (3, 16)).astype(np.float32)
    norms = sq_norms(db)
    got = _port(q, db, norms, 400, 20, DistanceMetric.INNER_PRODUCT, cpu_mesh(4))
    mesh = jax_mesh(4)
    want = _np(jax_sharded(jax_replicate(q, mesh), _jax_rows(db, mesh), _jax_rows(norms, mesh),
                           400, 20, DistanceMetric.INNER_PRODUCT, mesh, backend="xla"))
    assert_topk_match(got, want, exact=True)


def test_shard_placement_and_replication(rng):
    """800 rows over 8 shards: 100 a shard rounded up to the 8-row
    multiple, 104, as the JAX package places them; replicate makes one
    copy per distinct device."""
    db = rng.standard_normal((800, 32)).astype(np.float32)
    mesh = cpu_mesh(8)
    shards = shard_rows(db, mesh)
    assert [tuple(s.shape) for s in shards] == [(104, 32)] * 8
    assert rows_per_shard(800, 8, 8) == 104
    jmesh = jax_mesh(8)
    assert {tuple(s.data.shape) for s in _jax_rows(db, jmesh).addressable_shards} == {(104, 32)}
    np.testing.assert_array_equal(torch.cat(shards)[:800].numpy(), db)
    assert mesh.cards() == 0 and len(replicate(db, mesh)) == 1
    grid = shard_rows(db, make_mesh_2d(2, 4, devices=["cpu"] * 8))
    assert len(grid) == 2 and all(a is b for a, b in zip(grid[0], grid[1]))


@pytest.mark.parametrize("metric", [DistanceMetric.L2, DistanceMetric.INNER_PRODUCT,
                                    DistanceMetric.COSINE])
def test_dim_sharded_matches_jax(rng, metric):
    """Dimension sharding: partial dots summed in shard order, then the
    epilogue and a stable selection; integer L2/IP identical."""
    db, q = make_data(rng, "integer", 300, 512, 4)
    if metric == DistanceMetric.COSINE:
        q = unit_rows(q)
    norms = sq_norms(db)
    got = _np(dim_sharded_topk(torch.from_numpy(q), db, torch.from_numpy(norms), 300, 7,
                               metric, cpu_mesh(8)))
    mesh = jax_mesh(8)
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P(None, "shard")))  # noqa: E731
    want = _np(jax_dim(put(q), put(db), jax_replicate(norms, mesh), 300, 7, metric, mesh))
    assert_topk_match(got, want, metric != DistanceMetric.COSINE, tolerance(q, db, metric),
                      exact_scores(q, db, metric))


def test_dim_sharded_tombstones(rng):
    db, q = make_data(rng, "integer", 200, 256, 2)
    norms = sq_norms(db)
    mesh = cpu_mesh(4)
    _, base = dim_sharded_topk(torch.from_numpy(q), db, norms, 200, 1,
                               DistanceMetric.INNER_PRODUCT, mesh)
    mask = np.ones(200, np.float32)
    mask[base.numpy().ravel()] = 0.0
    got = _np(dim_sharded_topk(torch.from_numpy(q), db, norms, 200, 5,
                               DistanceMetric.INNER_PRODUCT, mesh, valid_mask=mask))
    assert not np.intersect1d(got[1], base.numpy()).size
    jmesh = jax_mesh(4)
    put = lambda a: jax.device_put(a, NamedSharding(jmesh, P(None, "shard")))  # noqa: E731
    want = _np(jax_dim(put(q), put(db), jax_replicate(norms, jmesh), 200, 5,
                       DistanceMetric.INNER_PRODUCT, jmesh,
                       valid_mask=jax_replicate(mask, jmesh)))
    assert_topk_match(got, want, exact=True)


def test_query_sharded_matches_jax(rng):
    db, q = make_data(rng, "integer", 600, 24, 32)  # 4 queries a device
    norms = sq_norms(db)
    mesh = make_mesh(devices=["cpu"] * 8, axis="query")
    got = _np(query_sharded_topk(torch.from_numpy(q), db, norms, 600, 7, DistanceMetric.L2,
                                 mesh))
    jmesh = jax_mesh(8, axis="query")
    want = _np(jax_query(jax.device_put(q, NamedSharding(jmesh, P("query", None))),
                         jax_replicate(db, jmesh), jax_replicate(norms, jmesh), 600, 7,
                         DistanceMetric.L2, jmesh, backend="xla"))
    assert_topk_match(got, want, exact=True)


@pytest.mark.parametrize("grid,backend", [((2, 4), "xla"), ((4, 2), "pallas")])
def test_grid_sharded_matches_jax(rng, grid, backend):
    """The 2-D (query, shard) mesh with a mask, against the JAX grid on
    xla and on its kernel in interpret mode."""
    n_query, n_shard = grid
    db, q = make_data(rng, "integer", 512, 16, 16)
    norms = sq_norms(db)
    mask = (rng.random(512) > 0.05).astype(np.float32)
    mesh = make_mesh_2d(n_query, n_shard, devices=["cpu"] * 8)
    got = _np(grid_sharded_topk(torch.from_numpy(q), db, norms, 512, 5, DistanceMetric.L2, mesh,
                                valid_mask=mask))
    jmesh = jax_mesh_2d(n_query, n_shard)
    extra = dict(interpret=True, block_rows=128) if backend == "pallas" else {}
    want = _np(jax_grid(jax.device_put(q, NamedSharding(jmesh, P("query", None))),
                        _jax_rows(db, jmesh), _jax_rows(norms, jmesh), 512, 5,
                        DistanceMetric.L2, jmesh, valid_mask=_jax_rows(mask, jmesh),
                        backend=backend, **extra))
    assert_topk_match(got, want, exact=True)
    _, oi = numpy_oracle(q, db, 5, DistanceMetric.L2, valid_mask=mask)
    np.testing.assert_array_equal(got[1], oi)


def test_query_and_grid_sharded_int8_uint8(rng):
    """The quantized routes on both mappings: symmetric int8 (``scale``
    the combined factor on raw integer dots) query-sharded, and the uint8
    offset correction (``bias_row``) on the 2-D grid, against the JAX
    package and the float64 oracle."""
    n, d, k = 384, 16, 5
    codes = rng.integers(-128, 128, (n, d)).astype(np.int8)
    scale = 0.05
    deq = codes.astype(np.float32) * scale
    norms = sq_norms(deq)
    q = rng.integers(-128, 128, (16, d)).astype(np.int8)
    _, oi = numpy_oracle(q.astype(np.float32) * scale, deq, k, DistanceMetric.INNER_PRODUCT)
    qmesh = make_mesh(devices=["cpu"] * 8, axis="query")
    got = _np(query_sharded_topk(torch.from_numpy(q), codes, norms, n, k,
                                 DistanceMetric.INNER_PRODUCT, qmesh, scale=scale * scale))
    np.testing.assert_array_equal(got[1], oi)
    jq = jax_mesh(8, axis="query")
    want = _np(jax_query(jax.device_put(q, NamedSharding(jq, P("query", None))),
                         jax_replicate(codes, jq), jax_replicate(norms, jq), n, k,
                         DistanceMetric.INNER_PRODUCT, jq, backend="xla", scale=scale * scale))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=4 * 2.0**-24)

    u8 = rng.integers(0, 256, (n, d)).astype(np.float32)
    un = sq_norms(u8)
    shifted = (u8.astype(np.int16) - 128).astype(np.int8)
    rowsums = shifted.sum(1, dtype=np.int32).astype(np.float32)
    qi = rng.integers(0, 256, (8, d)).astype(np.float32)
    qq = (qi - 128).astype(np.int8)
    _, oi2 = numpy_oracle(qi, u8, k, DistanceMetric.L2)
    got2 = _np(grid_sharded_topk(torch.from_numpy(qq), shifted, un, n, k, DistanceMetric.L2,
                                 make_mesh_2d(2, 4, devices=["cpu"] * 8), scale=1.0,
                                 bias_row=rowsums, bias_scale=128.0))
    np.testing.assert_array_equal(got2[1], oi2)
    jg = jax_mesh_2d(2, 4)
    want2 = _np(jax_grid(jax.device_put(qq, NamedSharding(jg, P("query", None))),
                         _jax_rows(shifted, jg), _jax_rows(un, jg), n, k, DistanceMetric.L2,
                         jg, backend="pallas", interpret=True, block_rows=64, scale=1.0,
                         bias_row=_jax_rows(rowsums, jg), bias_scale=128.0))
    assert_topk_match(got2, want2, exact=True)


def test_mismatched_arguments_raise(rng):
    """The port's guards where the JAX package guards its backends: the
    uint8 offset correction needs int8 queries over an int8 corpus, the
    affine read needs f32 queries, a query batch must split evenly, a grid
    needs its two axes, and a mesh needs devices that exist."""
    n, d = 128, 8
    db = rng.integers(-128, 128, (n, d)).astype(np.int8)
    norms = sq_norms(db)
    bias = db.astype(np.int32).sum(1).astype(np.float32)
    q8 = torch.from_numpy(rng.integers(-128, 128, (8, d)).astype(np.int8))
    mesh = cpu_mesh(8)
    with pytest.raises(ValueError):
        sharded_topk(q8.float(), db.astype(np.float32), norms, n, 3, DistanceMetric.L2, mesh,
                     bias_row=bias, bias_scale=128.0)
    with pytest.raises(ValueError):
        sharded_topk(q8, db, norms, n, 3, DistanceMetric.L2, mesh, affine=(128.0, 1.0))
    qmesh = make_mesh(devices=["cpu"] * 3, axis="query")
    with pytest.raises(ValueError, match="equal parts"):
        query_sharded_topk(q8, db, norms, n, 3, DistanceMetric.L2, qmesh)
    with pytest.raises(ValueError, match="mesh"):
        grid_sharded_topk(q8, db, norms, n, 3, DistanceMetric.L2, mesh)
    with pytest.raises(ValueError, match="only 2 given"):
        make_mesh(3, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()  # the default is every card: no fallback to the CPU


# -- ShardedDeviceSpace -------------------------------------------------------


def _space_file(tmp_path, rng, dtype, metric, n=300, d=24, ids=False, dead=(5,)):
    """A file of integer-valued rows (uint8 codes 0..255, int8 -128..127,
    floats -8..8) with tombstones; returns its path and rows."""
    if dtype == DataType.UINT8:
        data = rng.integers(0, 256, (n, d)).astype(np.float32)
    elif dtype == DataType.INT8:
        data = rng.integers(-128, 128, (n, d)).astype(np.float32)
    else:
        data = rng.integers(-8, 9, (n, d)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=d, dtype=dtype, metric=metric)
    b.add_vectors("v", data, ids=np.arange(n, dtype=np.uint64) * 7 + 3 if ids else None)
    for r in dead:
        b.delete_vector("v", r)
    path = tmp_path / "s.mvt"
    b.build().save(path)
    return path, data


def _queries(rng, dtype, d, nq=5):
    if dtype == DataType.UINT8:
        return rng.integers(0, 256, (nq, d)).astype(np.float32)
    return rng.integers(-8, 9, (nq, d)).astype(np.float32)


@pytest.mark.parametrize("metric", [DistanceMetric.L2, DistanceMetric.INNER_PRODUCT,
                                    DistanceMetric.COSINE])
@pytest.mark.parametrize("dtype", [DataType.FLOAT32, DataType.FLOAT16, DataType.BFLOAT16,
                                   DataType.INT8, DataType.UINT8])
def test_sharded_space_matches_resident_and_jax(tmp_path, rng, dtype, metric):
    """Every dtype's K1 route (FFMA, the integer kernel with and without the
    offset sums, the affine uint8 cosine read) over 4 shards with a
    tombstone: identical to the port's resident engine, and to the JAX
    ShardedDeviceSpace (its own kernel in interpret mode for uint8 and for
    bf16 and int8 cosine) in indices, the scores within a few ulps (its
    epilogue rounds in another order where a scale is not 1 or the metric
    is cosine)."""
    path, data = _space_file(tmp_path, rng, dtype, metric, ids=True)
    q = _queries(rng, dtype, 24)
    sp = PortReader.open(path).vector_space("v")
    got = ShardedDeviceSpace(sp, cpu_mesh(4)).search(q, k=6)
    ref = SearchEngine(sp, device="cpu").search(q, k=6)
    for field in ("indices", "scores", "distances", "ids"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))
    assert 5 not in got.indices
    # The JAX package's xla route renormalizes cosine queries after
    # rounding (bf16) or quantizing (int8) them; its kernel, which the port
    # mirrors, takes them as normalized: hold those cases to the kernel
    # (uint8 L2/IP runs the kernel there anyway).
    kernel = dtype == DataType.UINT8 or (
        metric == DistanceMetric.COSINE and dtype in (DataType.BFLOAT16, DataType.INT8))
    backend = "pallas" if kernel else "xla"
    want = JaxSharded(Reader.open(path).vector_space("v"), jax_mesh(4)).search(
        q, k=6, backend=backend, interpret=True)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_allclose(got.scores, want.scores, rtol=2.0**-20, atol=1e-6)


@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_space_end_to_end(tmp_path, rng, shards):
    """The reference's end-to-end case: a deleted row never surfaces, even
    queried by itself; answers equal the masked oracle."""
    data = rng.standard_normal((300, 24)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=24)
    b.add_vectors("v", data)
    b.delete_vector("v", 5)
    path = tmp_path / "s.mvt"
    b.build().save(path)
    ds = ShardedDeviceSpace(PortReader.open(path).vector_space("v"), cpu_mesh(shards))
    queries = data[[5, 17, 200]]
    res = ds.search(queries, k=4)
    assert 5 not in res.indices
    assert res.indices[1, 0] == 17 and res.indices[2, 0] == 200
    mask = np.ones(300, np.float32)
    mask[5] = 0
    _, oi = numpy_oracle(queries, data, 4, DistanceMetric.L2, valid_mask=mask)
    np.testing.assert_array_equal(res.indices, oi)


def _filter(rng, n, sel=0.5):
    m = rng.random(n) < sel
    m[:2] = [True, False]
    m[7] = True  # the predicate passes the tombstoned row: the tombstone wins
    return m


@pytest.fixture
def filter_file(tmp_path, rng):
    data = rng.standard_normal((600, 32)).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=32)
    b.add_vectors("v", data)
    b.delete_vector("v", 7)
    path = tmp_path / "f.mvt"
    b.build().save(path)
    return path, data


@pytest.mark.parametrize("shards,backend", [(8, "xla"), (2, "pallas")])
def test_filter_with_tombstones_matches_jax(filter_file, rng, shards, backend):
    path, data = filter_file
    queries = data[[7, 20, 100]]
    mask = _filter(rng, 600)
    got = ShardedDeviceSpace(PortReader.open(path).vector_space("v"), cpu_mesh(shards)).search(
        queries, k=6, filter_mask=mask)
    want = JaxSharded(Reader.open(path).vector_space("v"), jax_mesh(shards)).search(
        queries, k=6, backend=backend, interpret=True, filter_mask=mask)
    np.testing.assert_array_equal(got.indices, want.indices)
    omask = mask.astype(np.float32)
    omask[7] = 0.0
    _, oi = numpy_oracle(queries, data, 6, DistanceMetric.L2, valid_mask=omask)
    np.testing.assert_array_equal(got.indices, oi)
    assert 7 not in got.indices


def test_prepared_filter_and_shape_errors(filter_file, rng):
    path, data = filter_file
    sp = PortReader.open(path).vector_space("v")
    ds = ShardedDeviceSpace(sp, cpu_mesh(4))
    mask = _filter(rng, 600, sel=0.3)
    prep = ds.prepare_filter(mask)
    assert len(prep.mask) == 4 and prep.mask[0].shape == (ds.rows_per_shard,)
    raw = ds.search(data[:3], k=5, filter_mask=mask)
    via = ds.search(data[:3], k=5, filter_mask=prep)
    np.testing.assert_array_equal(raw.indices, via.indices)
    with pytest.raises(DimensionMismatchError):
        ds.search(data[:1], k=3, filter_mask=np.ones(599, bool))
    with pytest.raises(DimensionMismatchError):
        ds.prepare_filter(np.ones(601, bool))
    with pytest.raises(DimensionMismatchError):
        ds.search(data[:1], k=3, filter_mask=PreparedFilter(mask=prep.mask, num_valid=599))
    resident = SearchEngine(sp, device="cpu").prepare_filter(mask)
    with pytest.raises(ValueError, match="another surface"):
        ds.search(data[:1], k=3, filter_mask=resident)


def test_filter_fewer_than_k_passing_rows(filter_file):
    path, data = filter_file
    mask = np.zeros(600, bool)
    mask[[3, 9]] = True
    res = ShardedDeviceSpace(PortReader.open(path).vector_space("v"), cpu_mesh(2)).search(
        data[:1], k=5, filter_mask=mask)
    assert set(res.indices[0][:2].tolist()) == {3, 9}
    assert (res.indices[0][2:] == -1).all()
    assert (res.ids[0][2:] == np.iinfo(np.uint64).max).all()
