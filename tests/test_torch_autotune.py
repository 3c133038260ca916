"""``autotune`` of the port's four engines and the tuned grids in a file's
hints: the mirror of ``tests/test_autotune.py`` and
``tests/test_tune_persist.py``.

The port's knob is the kernels' launch grid (``ops.grid.Grid``: a multiple
of one wave of scan blocks, and the query tile where the library holds
several). On the CPU the plain versions run and have no grid, so
``autotune`` raises there; the flow (measure, sort, skip, fail, apply,
persist, adopt) is tested with the CUDA check and ``utils.tune.measure_once``
substituted, as the JAX package's tests inject timings, and a spy on each
engine's kernel wrapper that records the grid it was handed. Every grid
gives the same answer, which the tests check against the oracle too."""

import numpy as np
import pytest

import metrovector_tpu_torch.engine as eng_mod
import metrovector_tpu_torch.index.ivfpq as ivfpq_mod
import metrovector_tpu_torch.index.pq as pq_mod
import metrovector_tpu_torch.sparse as sparse_mod
import metrovector_tpu_torch.utils.tune as tune_mod
from metrovector_tpu import Builder, DataType, DistanceMetric, VectorType
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu_torch import (
    Database, IVFPQIndex, PQIndex, Reader, SearchEngine, SparseSearchEngine,
)
from metrovector_tpu_torch.engine import DeviceSpace
from metrovector_tpu_torch.ops.adc_kernel import QUERY_TILES, fused_adc_topk
from metrovector_tpu_torch.ops.grid import WAVES, Grid, as_grid, wave_blocks
from metrovector_tpu_torch.ops.sparse_kernel import ell_topk
from metrovector_tpu_torch.ops.topk_kernel import fused_topk


def _dense_file(tmp_path, n=300, d=16, seed=3, dtype=DataType.FLOAT32):
    rng = np.random.default_rng(seed)
    data = (rng.integers(0, 256, (n, d)) if dtype == DataType.UINT8
            else rng.standard_normal((n, d))).astype(np.float32)
    b = Builder()
    b.add_vector_space("v", dim=d, dtype=dtype)
    b.add_vectors("v", data)
    path = tmp_path / "t.mvt"
    b.build().save(path)
    return path, data


def _pq_file(tmp_path, n=512, d=32, seed=0):
    from metrovector_tpu.index import encode_pq, train_pq

    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    books = train_pq(data, m=4, ksub=16, iters=4, seed=seed)
    b = Builder()
    b.add_vector_space("v", dim=d)
    b.add_vectors("v", data)
    b.set_pq_index("v", books, encode_pq(data, books))
    path = tmp_path / "pq.mvt"
    b.build().save(path)
    return path, data


def _ivfpq_file(tmp_path, n=600, d=32, seed=0):
    from metrovector_tpu.index import train_ivfpq

    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, d)).astype(np.float32)
    cent, assign, books, codes = train_ivfpq(data, num_clusters=8, m=4, ksub=16,
                                             iters=4, seed=seed)
    b = Builder()
    b.add_vector_space("v", dim=d)
    b.add_vectors("v", data)
    b.set_ivf_index("v", cent, assign)
    b.set_pq_index("v", books, codes, residual=True)
    path = tmp_path / "ivfpq.mvt"
    b.build().save(path)
    return path, data


def _sparse_file(tmp_path, n=300, d=64, seed=0):
    rng = np.random.default_rng(seed)
    b = Builder()
    b.add_vector_space("sp", dim=d, vector_type=VectorType.SPARSE)
    rows = []
    for _ in range(n):
        nnz = int(rng.integers(1, 6))
        rows.append((np.sort(rng.choice(d, size=nnz, replace=False)).astype(np.int32),
                     rng.standard_normal(nnz).astype(np.float32)))
    b.add_sparse_vectors("sp", rows)
    path = tmp_path / "sp.mvt"
    b.build().save(path)
    return path


@pytest.fixture
def on_card(monkeypatch):
    """The autotune flow on the CPU: the CUDA check passes and each timing
    is the next of a list (the launches still run), or a constant."""
    monkeypatch.setattr(tune_mod, "require_kernels", lambda device, what: None)
    real = tune_mod.measure_once

    def use(times=None):
        it = iter(times) if times is not None else None

        def fake(run):
            real(run)  # still run it: a failing candidate fails here
            return next(it) if it is not None else 1e-3

        monkeypatch.setattr(tune_mod, "measure_once", fake)

    use()
    return use


@pytest.fixture
def spy(monkeypatch):
    """The grids each engine handed its kernel wrapper."""
    seen = []

    def wrap(fn, pos=None):
        def inner(*a, **kw):
            seen.append(a[pos] if pos is not None and len(a) > pos else kw.get("grid"))
            return fn(*a, **kw)
        return inner

    monkeypatch.setattr(eng_mod, "fused_topk", wrap(fused_topk))
    monkeypatch.setattr(pq_mod, "fused_adc_topk", wrap(fused_adc_topk))
    monkeypatch.setattr(ivfpq_mod, "fused_adc_topk", wrap(fused_adc_topk))
    monkeypatch.setattr(sparse_mod, "ell_topk", wrap(ell_topk, pos=11))
    return seen


# ---------------------------------------------------------------- the knob ---


def test_grid_none_is_one_wave_and_waves_scale_it():
    assert wave_blocks(132, None) == 132 == wave_blocks(132, Grid(1.0, None))
    assert [wave_blocks(132, Grid(w)) for w in WAVES] == [66, 132, 264, 528]
    assert wave_blocks(1, Grid(0.25)) == 1
    assert as_grid({"waves": 2, "tile": None}) == Grid(2.0, None)
    assert as_grid(None) is None and as_grid(Grid(0.5, 8)) == Grid(0.5, 8)
    assert Grid(0.5, 8, cap=True).saved() == {"waves": 0.5, "tile": 8}
    with pytest.raises(ValueError, match="waves and tile"):
        as_grid({"block_rows": 512})
    with pytest.raises(ValueError, match="waves and tile"):
        as_grid({"waves": 1.0, "cap": True})  # a file holds no cap
    with pytest.raises(TypeError, match="Grid or a mapping"):
        as_grid((0.5, 8))


@pytest.mark.parametrize("bad", [Grid(0.0), Grid(float("nan")), Grid(-1.0),
                                 Grid(float("inf")), Grid(1.0, 32)])
def test_wrappers_validate_the_grid_on_the_cpu(bad):
    """On the CPU the plain versions ignore the grid, but every wrapper
    checks it: positive finite waves, and a tile its library holds (K1 holds
    one, so none; K2's lookup scan 1-32; K4 32-256)."""
    import torch

    from metrovector_tpu_torch.ops.topk_kernel import fused_topk_presampled

    q, db = torch.ones(2, 8), torch.ones(40, 8)
    norms = torch.full((40,), 8.0)
    with pytest.raises(ValueError, match="fused_topk"):
        fused_topk(q, db, norms, 40, 3, DistanceMetric.L2, grid=bad)
    with pytest.raises(ValueError, match="fused_topk_presampled"):
        fused_topk_presampled(q, db, norms, 40, 3, DistanceMetric.L2, grid=bad)
    books = torch.ones(2, 4, 4)
    codes = torch.zeros(40, 2, dtype=torch.uint8)
    adc_bad = bad if bad.tile is None else Grid(1.0, 3)
    with pytest.raises(ValueError, match="fused_adc_topk"):
        fused_adc_topk(q, codes, books, norms, 40, 3, DistanceMetric.L2, grid=adc_bad)
    qt = torch.ones(8, 2)
    cols, vals = torch.zeros(40, 2, dtype=torch.int32), torch.ones(40, 2)
    ell_bad = bad if bad.tile is None else Grid(1.0, 48)
    with pytest.raises(ValueError, match="ell_topk"):
        ell_topk(qt, cols, vals, None, None, None, norms, 40, 3, DistanceMetric.L2,
                 grid=ell_bad)


def test_valid_grids_give_the_plain_answer():
    import torch

    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((3, 8)).astype(np.float32))
    db = torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32))
    norms = (db * db).sum(1)
    base = fused_topk(q, db, norms, 50, 5, DistanceMetric.L2)
    for g in (Grid(0.5), Grid(4.0, None, cap=True), {"waves": 2.0}):
        got = fused_topk(q, db, norms, 50, 5, DistanceMetric.L2, grid=g)
        assert all(torch.equal(a, b) for a, b in zip(got, base))
    books = torch.from_numpy(rng.standard_normal((2, 4, 4)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 4, (50, 2)).astype(np.uint8))
    a = fused_adc_topk(q, codes, books, norms, 50, 5, DistanceMetric.L2)
    for tile in QUERY_TILES:
        b = fused_adc_topk(q, codes, books, norms, 50, 5, DistanceMetric.L2,
                           grid=Grid(2.0, tile))
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_adc_tile_is_a_cap_only_for_the_index_grid():
    """Which of K2's lookup-scan tiles fit shared memory depends on the
    fetch and the LUT, which a tuned grid does not record: a grid with
    ``cap`` falls back to the largest tile that fits and is no larger
    (the wrapper's own pick if none is); without it the tile is taken as
    it is, and the wrapper raises if it does not fit."""
    from metrovector_tpu_torch.ops.adc_kernel import _grid_tile

    fits_k10 = {1: 9, 2: 8, 4: 6, 8: 4, 16: 3, 32: 2}  # tile: blocks per SM
    fits_k400 = {1: 4, 2: 3, 4: 2, 8: 2, 16: 1}  # tile 32 no longer fits
    assert _grid_tile(None, fits_k400, 8) == 8
    assert _grid_tile(Grid(2.0), fits_k400, 8) == 8
    assert _grid_tile(Grid(1.0, 32), fits_k10, 8) == 32
    assert _grid_tile(Grid(1.0, 32), fits_k400, 8) == 32  # not in the fit: raises
    assert _grid_tile(Grid(1.0, 32, cap=True), fits_k400, 8) == 16
    assert _grid_tile(Grid(1.0, 4, cap=True), fits_k400, 8) == 4
    assert _grid_tile(Grid(1.0, 2, cap=True), {4: 1, 8: 1}, 8) == 8


def test_pq_index_grid_reaches_the_kernel_as_a_cap(tmp_path, spy):
    """A grid tuned at one fetch and LUT and adopted from the file serves
    searches at another: the index hands the kernel its tile as a cap,
    while a grid passed to one search is handed over as it is."""
    from metrovector_tpu_torch.utils.tune import persist_tuned

    path, _ = _pq_file(tmp_path)
    persist_tuned(Reader.open(path).vector_space("v"), "adc",
                  {"cuda": Grid(1.0, 32).saved()})
    idx = PQIndex.from_space(Reader.open(path).vector_space("v"), device="cpu")
    assert idx.grid == Grid(1.0, 32)
    q = np.random.default_rng(2).standard_normal((4, idx.dim)).astype(np.float32)
    adopted = idx.search(q, k=5, rerank=400, exact_lut=True)
    explicit = idx.search(q, k=5, rerank=400, exact_lut=True, grid=Grid(1.0, 8))
    assert spy == [Grid(1.0, 32, cap=True), Grid(1.0, 8)]
    np.testing.assert_array_equal(adopted.indices, explicit.indices)
    np.testing.assert_array_equal(adopted.scores, explicit.scores)


# ----------------------------------------------------------- SearchEngine ---


def test_explicit_grid_reaches_the_kernel_and_stays_exact(tmp_path, spy):
    path, data = _dense_file(tmp_path)
    eng = SearchEngine(Reader.open(path).vector_space("v"), device="cpu",
                       grid=Grid(2.0))
    assert eng.grid == Grid(2.0, None)
    q = np.random.default_rng(0).standard_normal((4, 16)).astype(np.float32)
    res = eng.search(q, k=6)
    assert spy == [Grid(2.0, None)]
    _, oi = numpy_oracle(q, data, 6, DistanceMetric.L2)
    np.testing.assert_array_equal(res.indices, oi)
    with pytest.raises(ValueError, match="holds one"):
        SearchEngine(Reader.open(path).vector_space("v"), device="cpu", grid=Grid(1.0, 32))


def test_autotune_measures_applies_and_stays_exact(tmp_path, on_card, spy):
    path, data = _dense_file(tmp_path)
    eng = SearchEngine(Reader.open(path).vector_space("v"), device="cpu")
    assert eng.grid is None  # nothing persisted: one wave
    q = np.random.default_rng(0).standard_normal((4, 16)).astype(np.float32)
    on_card([0.004, 0.003, 0.001, 0.002])  # one timing a candidate (iters=1)
    report = eng.autotune(queries=q, k=5, waves_candidates=[0.5, 1, 2, 4], iters=1)
    assert [r["waves"] for r in report] == [2.0, 4.0, 1.0, 0.5]
    assert report == sorted(report, key=lambda r: r["ms"])
    assert all(set(r) >= {"waves", "tile", "ms"} and r["tile"] is None for r in report)
    assert eng.grid == Grid(2.0, None)  # the winner applied
    # each candidate's grid reached the kernel: once to warm up, once timed
    assert spy == [Grid(w, None) for w in (0.5, 0.5, 1.0, 1.0, 2.0, 2.0, 4.0, 4.0)]
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2)
    np.testing.assert_array_equal(eng.search(q, k=5).indices, oi)

    eng2 = SearchEngine(Reader.open(path).vector_space("v"), device="cpu")
    eng2.autotune(queries=q, k=5, waves_candidates=[2], iters=1, apply=False)
    assert eng2.grid is None  # apply=False leaves the grid as it was


def test_autotune_requires_cuda_kernels(tmp_path):
    """As the JAX engine refuses ``backend="xla"``: a CPU engine runs the
    plain versions, which have no grid."""
    path, _ = _dense_file(tmp_path)
    with pytest.raises(ValueError, match="CUDA kernels"):
        SearchEngine(Reader.open(path).vector_space("v"), device="cpu").autotune()
    pq_path, _ = _pq_file(tmp_path)
    idx = PQIndex.from_space(Reader.open(pq_path).vector_space("v"), device="cpu")
    with pytest.raises(ValueError, match="CUDA kernels"):
        idx.autotune(k=5, batch=8)
    eng = SparseSearchEngine(Reader.open(_sparse_file(tmp_path)).vector_space("sp"),
                             device="cpu")
    with pytest.raises(ValueError, match="CUDA kernels"):
        eng.autotune(k=3, batch=4)


def test_database_engine_kwargs_reach_the_kernel(tmp_path, spy):
    path, data = _dense_file(tmp_path, n=150, d=8)
    db = Database.open(path, device="cpu", engine_kwargs={"grid": {"waves": 4.0}})
    eng = db.engine("v")
    assert eng.grid == Grid(4.0, None)
    q = np.random.default_rng(6).standard_normal((3, 8)).astype(np.float32)
    res = db.search("v", q, k=4)
    assert spy == [Grid(4.0, None)]
    _, oi = numpy_oracle(q, data, 4, DistanceMetric.L2)
    np.testing.assert_array_equal(res.indices, oi)


def test_autotune_on_quantized_space_stays_exact(tmp_path, on_card):
    path, data = _dense_file(tmp_path, n=400, d=32, seed=12, dtype=DataType.UINT8)
    eng = SearchEngine(Reader.open(path).vector_space("v"), device="cpu")
    q = np.random.default_rng(12).integers(0, 256, (4, 32)).astype(np.float32)
    report = eng.autotune(queries=q, k=5, waves_candidates=[1, 2], iters=1)
    assert len(report) == 2 and np.isfinite(report[0]["ms"])
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2)
    np.testing.assert_array_equal(eng.search(q, k=5).indices, oi)


def test_autotune_records_skipped_oversized_tiles(tmp_path, on_card):
    """A tile above the sample batch is reported with a ``skipped`` note
    and no time; the winner is a measured candidate."""
    path, _ = _pq_file(tmp_path)
    idx = PQIndex.from_space(Reader.open(path).vector_space("v"), device="cpu")
    report = idx.autotune(k=5, batch=4, waves_candidates=[1], iters=1)
    assert [r["tile"] for r in report if "skipped" in r] == [8, 16, 32]
    assert all(r["ms"] == float("inf") for r in report if "skipped" in r)
    assert len(report) == 1 + len(QUERY_TILES)
    assert "skipped" not in report[0] and idx.grid == Grid(1.0, report[0]["tile"])
    sparse = SparseSearchEngine(Reader.open(_sparse_file(tmp_path)).vector_space("sp"),
                                device="cpu")
    rep = sparse.autotune(k=3, batch=4, waves_candidates=[1], iters=1)
    assert sorted(r["tile"] for r in rep if "skipped" in r) == [64, 128, 256]


def test_int8_product_route_tunes_waves_alone(tmp_path, on_card):
    """A pq4 index searched with ``int8_lut=True`` runs the int8 LUT's
    tensor-core product, built with one tile: only waves are candidates."""
    path, _ = _pq_file(tmp_path)
    idx = PQIndex.from_space(Reader.open(path).vector_space("v"), device="cpu")
    report = idx.autotune(k=5, batch=8, iters=1, int8_lut=True, rerank=20)
    assert [r["tile"] for r in report] == [None] * len(WAVES)


# ---------------------------------------------------------- persistence ---


def test_dense_autotune_persist_and_adopt(tmp_path, on_card):
    path, data = _dense_file(tmp_path)
    eng = SearchEngine(Reader.open(path).vector_space("v"), device="cpu")
    on_card([0.002, 0.001])
    report = eng.autotune(k=3, batch=4, waves_candidates=[1, 4], iters=1, persist=True)
    assert report[0]["waves"] == 4.0
    hints = Reader.open(path).manifest.hints["tuned"]["v"]["dense"]
    assert hints == {"cuda": {"waves": 4.0, "tile": None}}
    # a fresh engine of a fresh reader adopts it; an explicit grid wins
    eng2 = SearchEngine(Reader.open(path).vector_space("v"), device="cpu")
    assert eng2.grid == Grid(4.0, None)
    eng3 = SearchEngine(Reader.open(path).vector_space("v"), device="cpu", grid=Grid(0.5))
    assert eng3.grid == Grid(0.5, None)
    q = np.random.default_rng(0).standard_normal((4, 16)).astype(np.float32)
    _, oi = numpy_oracle(q, data, 5, DistanceMetric.L2)
    np.testing.assert_array_equal(eng2.search(q, k=5).indices, oi)
    Reader.open(path).validate_with_checksum()  # only the footer changed


def test_dense_persist_requires_file_backed_space(tmp_path, on_card):
    path, _ = _dense_file(tmp_path)
    dev = DeviceSpace.from_space(Reader.open(path).vector_space("v"), device="cpu")
    with pytest.raises(ValueError, match="file-backed"):
        SearchEngine(dev).autotune(k=3, batch=4, waves_candidates=[1], iters=1,
                                   persist=True)


def test_pq_autotune_slow_default_loses(tmp_path, on_card, spy):
    """The default plan (one wave, the kernel's tile) measures slower than a
    candidate: the candidate wins, is persisted and adopted, and serves the
    same answer as the default."""
    path, _ = _pq_file(tmp_path)
    idx = PQIndex.from_space(Reader.open(path).vector_space("v"), device="cpu")
    on_card([0.5, 0.005])
    report = idx.autotune(k=5, batch=8, waves_candidates=[1], tile_candidates=[None, 4],
                          iters=1, persist=True, rerank=20)
    assert (report[0]["waves"], report[0]["tile"]) == (1.0, 4)
    assert report[1]["ms"] == 500.0
    assert idx.grid == Grid(1.0, 4)
    assert spy[-1] == Grid(1.0, 4)
    idx2 = PQIndex.from_space(Reader.open(path).vector_space("v"), device="cpu")
    assert idx2.grid == Grid(1.0, 4)
    q = np.random.default_rng(1).standard_normal((4, idx.dim)).astype(np.float32)
    tuned = idx2.search(q, k=5, rerank=20)
    default = idx2.search(q, k=5, rerank=20, grid=Grid())
    np.testing.assert_array_equal(tuned.indices, default.indices)
    np.testing.assert_array_equal(tuned.scores, default.scores)


def test_pq_autotune_failing_candidate_records_error(tmp_path, on_card):
    path, _ = _pq_file(tmp_path)
    idx = PQIndex.from_space(Reader.open(path).vector_space("v"), device="cpu")
    report = idx.autotune(k=5, batch=8, waves_candidates=[1], tile_candidates=[7, 4],
                          iters=1)
    bad = [r for r in report if r["tile"] == 7][0]
    assert bad["ms"] == float("inf") and "tile=7" in bad["error"]
    assert report[-1] is bad and idx.grid == Grid(1.0, 4)  # the finite winner applies


def test_pq_persist_without_winner_raises(tmp_path, on_card):
    path, _ = _pq_file(tmp_path)
    idx = PQIndex.from_space(Reader.open(path).vector_space("v"), device="cpu")
    with pytest.raises(RuntimeError, match="nothing persisted"):
        idx.autotune(k=5, batch=8, waves_candidates=[1], tile_candidates=[3], iters=1,
                     persist=True)
    assert "tuned" not in Reader.open(path).manifest.hints


def test_ivfpq_autotune_persist_and_adopt(tmp_path, on_card, spy):
    path, _ = _ivfpq_file(tmp_path)
    idx = IVFPQIndex.from_space(Reader.open(path).vector_space("v"), device="cpu")
    on_card([0.003, 0.001])
    report = idx.autotune(k=5, batch=8, nprobe=4, waves_candidates=[1, 2], iters=1,
                          persist=True)
    assert report[0]["waves"] == 2.0 and idx.grid == Grid(2.0, None)
    assert spy and all(g is not None for g in spy)  # the scan mode, at batch 8
    idx2 = IVFPQIndex.from_space(Reader.open(path).vector_space("v"), device="cpu")
    assert idx2.grid == Grid(2.0, None)
    q = np.random.default_rng(1).standard_normal((4, idx.dim)).astype(np.float32)
    tuned = idx2.search(q, k=5, nprobe=4, mode="scan")
    default = idx2.search(q, k=5, nprobe=4, mode="scan", grid=Grid())
    np.testing.assert_array_equal(tuned.indices, default.indices)


def test_sparse_autotune_persist_and_adopt(tmp_path, on_card):
    path = _sparse_file(tmp_path)
    eng = SparseSearchEngine(Reader.open(path).vector_space("sp"), device="cpu")
    assert eng.formulation == "ell"
    on_card([0.003, 0.001, 0.002])
    report = eng.autotune(k=3, batch=4, waves_candidates=[1], iters=1, persist=True,
                          tile_candidates=[None, 32, 256])
    assert (report[0]["waves"], report[0]["tile"]) == (1.0, 32)
    assert "skipped" in report[-1] and report[-1]["tile"] == 256
    eng2 = SparseSearchEngine(Reader.open(path).vector_space("sp"), device="cpu")
    assert eng2.grid == Grid(1.0, 32)
    q = np.random.default_rng(1).standard_normal((4, eng2.dim)).astype(np.float32)
    np.testing.assert_array_equal(eng2.search(q, k=3).indices,
                                  eng2.search(q, k=3, grid=Grid()).indices)
    coo = SparseSearchEngine(Reader.open(path).vector_space("sp"), device="cpu",
                             formulation="coo")
    with pytest.raises(ValueError, match="ELL"):
        coo.autotune(k=3, batch=4)


# ----------------------------------------------- hints across packages ---


def test_jax_tuned_file_adopts_nothing_in_the_port(tmp_path):
    """The JAX package's Mosaic tiles (``block_rows``, ``query_tile``) in
    every family are not the port's knob: nothing is adopted."""
    from metrovector_tpu import rewrite_hints as jax_rewrite

    path, _ = _dense_file(tmp_path)
    jax_rewrite(path, {"tuned": {"v": {fam: {"block_rows": 64, "query_tile": 128}
                                       for fam in ("dense", "adc", "ivfpq")}}})
    assert SearchEngine(Reader.open(path).vector_space("v"), device="cpu").grid is None
    pq_path, _ = _pq_file(tmp_path)
    jax_rewrite(pq_path, {"tuned": {"v": {"adc": {"block_rows": 1024}}}})
    assert PQIndex.from_space(Reader.open(pq_path).vector_space("v"),
                              device="cpu").grid is None
    sp_path = _sparse_file(tmp_path)
    jax_rewrite(sp_path, {"tuned": {"sp": {"sparse": {"block_rows": 4096}}}})
    assert SparseSearchEngine(Reader.open(sp_path).vector_space("sp"),
                              device="cpu").grid is None


def test_both_tunings_survive_in_one_footer(tmp_path, on_card):
    """The JAX engine tunes and persists its tiles, then the port its grid
    (and the other way round in another family): both stay, and each
    package adopts its own and leaves the other's alone."""
    import metrovector_tpu as jax_mvt

    path, _ = _dense_file(tmp_path)
    jeng = jax_mvt.SearchEngine(jax_mvt.Reader.open(path).vector_space("v"))
    jeng.autotune(k=3, batch=4, block_rows_candidates=[64], query_tile_candidates=[128],
                  iters=1, persist=True)
    eng = SearchEngine(Reader.open(path).vector_space("v"), device="cpu")
    assert eng.grid is None
    eng.autotune(k=3, batch=4, waves_candidates=[2], iters=1, persist=True)
    dense = Reader.open(path).manifest.hints["tuned"]["v"]["dense"]
    assert dense == {"block_rows": 64, "query_tile": 128,
                     "cuda": {"waves": 2.0, "tile": None}}
    jeng2 = jax_mvt.SearchEngine(jax_mvt.Reader.open(path).vector_space("v"))
    assert (jeng2.block_rows, jeng2.query_tile) == (64, 128)
    assert SearchEngine(Reader.open(path).vector_space("v"),
                        device="cpu").grid == Grid(2.0, None)
    # port first, JAX second, in the sparse family
    sp_path = _sparse_file(tmp_path)
    seng = SparseSearchEngine(Reader.open(sp_path).vector_space("sp"), device="cpu")
    seng.autotune(k=3, batch=4, waves_candidates=[0.5], tile_candidates=[None], iters=1,
                  persist=True)
    jax_sparse = jax_mvt.SparseSearchEngine(jax_mvt.Reader.open(sp_path).vector_space("sp"))
    assert jax_sparse.block_rows is None  # the port's grid is not its tile
    jax_sparse.autotune(k=3, batch=4, block_rows_candidates=[8192], iters=1, persist=True)
    sparse = Reader.open(sp_path).manifest.hints["tuned"]["sp"]["sparse"]
    assert sparse == {"cuda": {"waves": 0.5, "tile": None}, "block_rows": 8192}
    assert SparseSearchEngine(Reader.open(sp_path).vector_space("sp"),
                              device="cpu").grid == Grid(0.5, None)
