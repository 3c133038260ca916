"""int8, uint8 and bf16 spaces: the port against the JAX package on the same
numpy inputs.

* ``fused_topk``'s integer path (int8 queries over int8 rows, ``scale``,
  ``bias_row``/``bias_scale``, the deferred-scale inner product) on CPU
  tensors, its plain version, against the Pallas kernel in interpret mode;
  a planted pair of raw dots that round to one scaled score pins the
  deferred mode's tie rule (the higher raw dot first, not the lower row).
* ``SearchEngine(device="cpu")`` against ``SearchEngine(backend="pallas")``
  on INT8, UINT8 (L2, IP, cosine) and BFLOAT16 files: the resident cases of
  ``tests/test_uint8_offset.py`` and ``tests/test_engine.py``'s int8, uint8
  and bf16 spaces; and ``DeviceSpace.from_state`` from the JAX space.

Tolerances. The port rounds its epilogue as the reference writes it:
``f32(idot)·scale``, then ``+ bias_scale·bias_row``, then ``2·s − ‖x‖²`` or
``s·(1/√‖x‖²)``, each step to f32. The queries are quantized by the same
numpy arithmetic, so the integer dots are the same. Where no step rounds
(scale 1 and an integral bias, or the deferred inner product, whose one
multiply is the reference's), indices and scores are identical. Elsewhere
XLA's CPU backend, which runs the reference here, fuses steps: it turns
``2·(a·s) − n`` into one ``fma(a, 2s, −n)`` (checked against its output)
and takes ``rsqrt`` by its own approximation. There indices are identical
and scores within 16 f32 ulp of the largest term (``|score|``, ``‖x‖²``,
``2|C(q)|``); cosine scores within 4 ulp of the reference's (the reference
also re-normalizes the uint8 cosine queries). bf16 spaces over float
data: the products are exact but the f32 sums run in another order, so
scores agree within the f32 band of ``_torch_parity`` and indices except at
near-ties; over integer data, identical.
"""

import numpy as np
import pytest
import torch

from metrovector_tpu import Builder, DataType, DistanceMetric, Reader
from metrovector_tpu.engine import SearchEngine as JaxEngine
from metrovector_tpu.ops import fused_topk as jax_fused_topk
from metrovector_tpu_torch import Reader as PortReader
from metrovector_tpu_torch.engine import DeviceSpace, SearchEngine
from metrovector_tpu_torch.ops.topk_kernel import _check, fused_topk

from _torch_parity import METRICS, assert_topk_match, exact_scores, tolerance

L2, IP, COS = DistanceMetric.L2, DistanceMetric.INNER_PRODUCT, DistanceMetric.COSINE
N, D, NQ = 300, 40, 7


def _int_inputs(form, metric, seed=5):
    """int8 rows and queries, f32 norms of the dequantized rows, and the
    form's scale and bias: ``int8`` (a scale, no bias: deferred for IP),
    ``unit`` (scale 1.0) or ``offset`` (a uint8 space's recentred codes,
    their row sums and a bias scale)."""
    rng = np.random.default_rng(seed)
    db = rng.integers(-128, 128, (N, D)).astype(np.int8)
    q = rng.integers(-128, 128, (NQ, D)).astype(np.int8)
    scale = {"int8": 0.37, "unit": 1.0, "offset": 1.0}[form]
    norms = ((db.astype(np.float64) * scale) ** 2).sum(1).astype(np.float32)
    bias = bias_scale = None
    if form == "offset":
        bias = db.sum(1, dtype=np.int32).astype(np.float32)
        bias_scale = 96.0
        norms = ((db.astype(np.float64) + 128) ** 2).sum(1).astype(np.float32)
    return db, q, norms, scale, bias, bias_scale


def _port_int(q, db, norms, nv, k, metric, mask, scale, bias, bias_scale):
    t = torch.from_numpy
    return fused_topk(t(q), t(db), t(norms), nv, k, metric,
                      None if mask is None else t(mask), scale=scale,
                      bias_row=None if bias is None else t(bias),
                      bias_scale=1.0 if bias_scale is None else bias_scale)


def _ulps(got, want) -> np.ndarray:
    """|got − want| in f32 ulps of ``want``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want))


def _assert_band(got, want, metric, terms):
    """Identical indices; cosine scores within 4 ulp, others within 16 ulp
    of ``terms`` (per query: the magnitude of the largest term)."""
    (s_g, i_g), (s_w, i_w) = got, want
    np.testing.assert_array_equal(i_g, i_w)
    live = i_w >= 0
    if DistanceMetric(metric) == COS:
        assert _ulps(s_g[live], s_w[live]).max(initial=0) <= 4
        return
    tol = 16 * np.spacing(np.float32(terms))[:, None]
    assert (np.abs(s_g.astype(np.float64) - s_w) <= tol)[live].all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("form", ["int8", "unit", "offset"])
@pytest.mark.parametrize("metric", METRICS)
def test_int_path_matches_pallas(metric, form, masked):
    db, q, norms, scale, bias, bias_scale = _int_inputs(form, metric)
    rng = np.random.default_rng(9)
    mask = (rng.random(N) > 0.3).astype(np.float32) if masked else None
    nv, k = (N - 23, 17) if masked else (N, 10)
    before = fused_topk.launches_int
    got = _port_int(q, db, norms, nv, k, metric, mask, scale, bias, bias_scale)
    assert fused_topk.launches_int == before  # the plain path is no launch
    want = jax_fused_topk(q, db, norms, np.int32(nv), k, metric, valid_mask=mask,
                          scale=scale, bias_row=bias,
                          bias_scale=1.0 if bias_scale is None else bias_scale,
                          block_rows=128, interpret=True)
    got = tuple(a.numpy() for a in got)
    want = tuple(np.asarray(a) for a in want)
    if metric != COS and (form != "int8" or metric == IP):
        assert_topk_match(got, want, exact=True)
    else:
        dots = np.abs(q.astype(np.float64) @ db.astype(np.float64).T) * scale
        _assert_band(got, want, metric, 2 * dots.max(1) + norms.max())


def _planted_tie():
    """Queries and rows (D = 640) where rows 3 and 5 have raw dots d and
    d + 1 (d > 2^23) and a scale ``s`` rounds both products to one f32."""
    d = 640
    q = np.full((1, d), 127, np.int8)
    q[0, 0] = 1
    db = np.random.default_rng(2).integers(-20, 20, (16, d)).astype(np.int8)
    db[5] = 127
    db[3] = 127
    db[3, 0] = 126
    lo = np.float32(q[0].astype(np.int64) @ db[3].astype(np.int64))
    hi = np.float32(q[0].astype(np.int64) @ db[5].astype(np.int64))
    assert hi == lo + 1 and lo > 2**23
    for s in np.random.default_rng(0).uniform(0.1, 0.9, 1000).astype(np.float32):
        if lo * s == hi * s:  # f32 products
            return q, db, float(s)
    raise AssertionError("no scale merges the planted pair")


def test_deferred_scale_tie_keeps_higher_raw_dot():
    q, db, s = _planted_tie()
    norms = (db.astype(np.float64) ** 2).sum(1).astype(np.float32) * s * s
    got = _port_int(q, db, norms, 16, 4, IP, None, s, None, None)
    want = jax_fused_topk(q, db, norms, np.int32(16), 4, IP, scale=s,
                          block_rows=128, interpret=True)
    s_g, i_g = (a.numpy() for a in got)
    assert list(i_g[0, :2]) == [5, 3] and s_g[0, 0] == s_g[0, 1]
    assert_topk_match((s_g, i_g), tuple(np.asarray(a) for a in want), exact=True)
    # scale 0 and below is not deferred: ties go to the lower row
    neg = _port_int(q, db, norms, 16, 4, IP, None, -s, None, None)
    want = jax_fused_topk(q, db, norms, np.int32(16), 4, IP, scale=-s,
                          block_rows=128, interpret=True)
    assert_topk_match(tuple(a.numpy() for a in neg),
                      tuple(np.asarray(a) for a in want), exact=True)


def test_int_path_input_checks():
    db, q, norms, *_ = _int_inputs("int8", IP)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="int8 db"):
        fused_topk(t(q), t(db.astype(np.float32)), t(norms), N, 5, IP)
    with pytest.raises(ValueError, match="bias_row goes with int8"):
        fused_topk(t(q.astype(np.float32)), t(db.astype(np.float32)), t(norms),
                   N, 5, IP, bias_row=t(norms))
    with pytest.raises(ValueError, match="affine"):
        fused_topk(t(q.astype(np.float32)), t(db), t(norms), N, 5, IP)


@pytest.mark.parametrize("form", ["int8", "unit", "offset"])
@pytest.mark.parametrize("metric", METRICS)
def test_int_path_reads_first_d_of_padded_rows(metric, form):
    """The engine hands the integer path the first D columns of its padded
    blocks: random bytes past D change nothing, and the kernel's checks
    take such row-strided views (not so a strided f32 corpus)."""
    db, q, norms, scale, bias, bias_scale = _int_inputs(form, metric)
    rng = np.random.default_rng(4)
    wide_db = rng.integers(-128, 128, (N, 128)).astype(np.int8)
    wide_q = rng.integers(-128, 128, (NQ, 128)).astype(np.int8)
    wide_db[:, :D], wide_q[:, :D] = db, q
    t = torch.from_numpy
    args = dict(scale=scale, bias_row=None if bias is None else t(bias),
                bias_scale=1.0 if bias_scale is None else bias_scale)
    got = fused_topk(t(wide_q)[:, :D], t(wide_db)[:, :D], t(norms), N, 10, metric, **args)
    want = fused_topk(t(q), t(db), t(norms), N, 10, metric, **args)
    assert_topk_match(tuple(a.numpy() for a in got), tuple(a.numpy() for a in want),
                      exact=True)
    _check(t(wide_q)[:, :D], t(wide_db)[:, :D], t(norms), 10, None, args["bias_row"])
    f32 = t(wide_db.astype(np.float32))[:, :D]
    with pytest.raises(ValueError, match="db must be contiguous"):
        _check(t(q.astype(np.float32)), f32, t(norms), 10, None)


@pytest.mark.parametrize("metric", METRICS)
def test_affine_load_matches_dequantized_rows(metric):
    """``affine``'s plain version is the f32 scan of ``(c + off)·scale``
    computed in f32, the rows the reference's dequantizing read gives."""
    db, _, _, *_ = _int_inputs("int8", metric)
    rng = np.random.default_rng(4)
    off, sc = np.float32(128.0 - 17.25), np.float32(0.031)
    rows = (db.astype(np.float32) + off) * sc
    norms = (rows.astype(np.float64) ** 2).sum(1).astype(np.float32)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    if metric == COS:
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    t = torch.from_numpy
    got = fused_topk(t(q), t(db), t(norms), N, 9, metric,
                     affine=(128.0 - 17.25, 0.031))
    want = fused_topk(t(q), t(rows), t(norms), N, 9, metric)
    assert_topk_match(tuple(a.numpy() for a in got),
                      tuple(a.numpy() for a in want), exact=True)


# -- the engine: files written by the JAX Builder, read by both packages ------


def _space(tmp_path, name, data, dtype, metric, quant=None):
    b = Builder()
    sp = b.add_vector_space("s", dim=data.shape[1], dtype=dtype, metric=metric)
    if quant is not None:
        sp.with_quantization(scale=quant[0], zero_point=quant[1])
    b.add_vectors("s", data)
    path = tmp_path / f"{name}.mvt"
    b.build().save(path)
    return path


def _engines(path, precision="highest"):
    jax_sp = Reader.open(path).vector_space("s")
    port_sp = PortReader.open(path).vector_space("s")
    return (JaxEngine(jax_sp, backend="pallas", precision=precision),
            SearchEngine(port_sp, device="cpu", precision=precision))


def _same_result(got, want, space=None, prep=None):
    """Identical results; with the port's ``space`` and prepared queries
    ``prep``, identical where the reference's epilogue rounds nothing that
    XLA's CPU backend fuses (module docstring), else within the band."""
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.ids, want.ids)
    if space is not None:
        deferred = space.dtype == DataType.INT8 and space.metric == IP
        if space.metric == COS or not (prep.dot_scale == 1.0 or deferred):
            const = 0.0 if prep.const is None else 2 * np.abs(prep.const)
            terms = (np.abs(want.scores).max(1, where=want.indices >= 0, initial=0)
                     + float(space.norms.max()) + const)
            _assert_band((got.scores, got.indices), (want.scores, want.indices),
                         space.metric, terms)
            return
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.distances, want.distances)


def _u8_cases(rng):
    """(name, data, metric, quantization or None, queries): the resident
    cases of tests/test_uint8_offset.py and tests/test_engine.py."""
    ints = rng.integers(0, 256, (500, 32)).astype(np.float32)
    ip = rng.integers(0, 256, (300, 16)).astype(np.float32)
    pos = (rng.random((200, 16)) * 4 + 1).astype(np.float32)
    cos = (rng.random((100, 16)) + 0.5).astype(np.float32)
    raw = rng.standard_normal((400, 24)).astype(np.float32) * 3.0 + 1.5
    noisy = rng.integers(0, 256, (4, 32)).astype(np.float32)
    noisy += rng.standard_normal(noisy.shape).astype(np.float32) * 0.3
    return [
        ("integer_l2", ints, L2, (1.0, 0.0), rng.integers(0, 256, (6, 32)).astype(np.float32)),
        ("integer_l2_narrow", ints, L2, (1.0, 0.0),
         rng.integers(10, 200, (6, 32)).astype(np.float32)),
        ("integer_ip", ip, IP, (1.0, 0.0), rng.integers(0, 256, (4, 16)).astype(np.float32)),
        ("float_queries", ints, L2, (1.0, 0.0), noisy),
        ("affine_zero_point", pos, L2, None, pos[:3]),
        ("affine_ip", pos, IP, None, pos[5:9] * 0.7),
        ("cosine", cos, COS, None, cos[:2]),
        ("cosine_affine", raw, COS, None, rng.standard_normal((5, 24)).astype(np.float32)),
    ]


@pytest.mark.parametrize("case", range(8))
def test_uint8_engine_matches_pallas(tmp_path, case):
    name, data, metric, quant, queries = _u8_cases(np.random.default_rng(21))[case]
    path = _space(tmp_path, name, data, DataType.UINT8, metric, quant)
    jax_eng, port_eng = _engines(path)
    k = 10 if data.shape[0] >= 300 else 5
    before = fused_topk.launches_int + fused_topk.launches_affine
    got = port_eng.search(queries, k=k)
    assert fused_topk.launches_int + fused_topk.launches_affine == before
    _same_result(got, jax_eng.search(queries, k=k), port_eng.space,
                 port_eng.space.prepare_queries(queries))
    if metric != COS:  # the offset algebra's constant comes back
        np.testing.assert_array_equal(
            port_eng.space.prepare_queries(queries).const,
            jax_eng.space.prepare_queries(queries).const)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("data_kind", ["float", "codes"])
def test_int8_engine_matches_pallas(tmp_path, metric, data_kind):
    """Auto-calibrated int8 spaces of float data (tests/test_engine.py's
    ranking parity) and int8 codes with a stated scale (deep10m's form)."""
    rng = np.random.default_rng(31)
    if data_kind == "float":
        data, quant = rng.standard_normal((200, 32)).astype(np.float32), None
    else:
        data, quant = rng.integers(-128, 128, (200, 32)).astype(np.int8), (0.02, 0.0)
    path = _space(tmp_path, f"i8_{data_kind}", data, DataType.INT8, metric, quant)
    jax_eng, port_eng = _engines(path)
    queries = rng.standard_normal((4, 32)).astype(np.float32)
    _same_result(port_eng.search(queries, k=10), jax_eng.search(queries, k=10),
                 port_eng.space, port_eng.space.prepare_queries(queries))


def test_quantized_filters_tombstones_and_small_k(tmp_path):
    rng = np.random.default_rng(41)
    data = rng.integers(0, 256, (90, 16)).astype(np.float32)
    b = Builder()
    b.add_vector_space("s", dim=16, dtype=DataType.UINT8,
                       metric=L2).with_quantization(scale=1.0, zero_point=0.0)
    b.add_vectors("s", data)
    for r in (2, 40, 77):
        b.delete_vector("s", r)
    path = tmp_path / "t.mvt"
    b.build().save(path)
    jax_eng, port_eng = _engines(path)
    queries = rng.integers(0, 256, (3, 16)).astype(np.float32)
    keep = rng.random(90) > 0.5
    _same_result(port_eng.search(queries, k=8, filter_mask=keep),
                 jax_eng.search(queries, k=8, filter_mask=keep))
    _same_result(port_eng.search(queries, k=200), jax_eng.search(queries, k=200))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("data_kind", ["integer", "normal"])
def test_bf16_engine_matches_pallas(tmp_path, metric, data_kind):
    rng = np.random.default_rng(51)
    if data_kind == "integer":
        data = rng.integers(0, 256, (128, 64)).astype(np.float32)
        queries = rng.integers(0, 256, (5, 64)).astype(np.float32)
    else:
        data = rng.standard_normal((128, 64)).astype(np.float32)
        queries = rng.standard_normal((5, 64)).astype(np.float32)
    path = _space(tmp_path, "bf", data, DataType.BFLOAT16, metric)
    jax_eng, port_eng = _engines(path)
    got, want = port_eng.search(queries, k=10), jax_eng.search(queries, k=10)
    if data_kind == "integer" and metric != COS:
        _same_result(got, want)
        return
    rows = PortReader.open(path).vector_space("s").to_numpy()
    qb = port_eng.space.prepare_queries(queries).qdev.numpy()[:, :64]
    assert_topk_match((got.scores, got.indices), (want.scores, want.indices),
                      exact=False, tol=tolerance(qb, rows, metric),
                      scores64=exact_scores(qb, rows, metric))


def test_bf16_space_end_to_end(tmp_path):
    data = np.random.default_rng(61).standard_normal((128, 64)).astype(np.float32)
    path = _space(tmp_path, "b", data, DataType.BFLOAT16, L2)
    sp = PortReader.open(path).vector_space("s")
    np.testing.assert_array_equal(
        sp.to_numpy(),
        Reader.open(path).vector_space("s").to_numpy().astype(np.float32))
    eng = SearchEngine(sp, device="cpu")
    assert eng.space.data.dtype == torch.bfloat16
    assert eng.search(data[10], k=1).indices[0, 0] == 10
    # "high" and "high_verified" change nothing for bf16, as in the reference
    for precision in ("high", "high_verified", "default"):
        jax_eng, port_eng = _engines(path, precision)
        _same_result(port_eng.search(data[:4], k=5), eng.search(data[:4], k=5))


@pytest.mark.parametrize("dtype", [DataType.INT8, DataType.UINT8, DataType.BFLOAT16])
def test_device_space_from_jax_state(tmp_path, dtype):
    rng = np.random.default_rng(71)
    data = rng.integers(0, 100, (150, 24)).astype(np.float32)
    quant = None if dtype == DataType.BFLOAT16 else (0.5, 3.0 if dtype == DataType.UINT8 else 0.0)
    metric = L2 if dtype == DataType.UINT8 else IP
    path = _space(tmp_path, "st", data, dtype, metric, quant)
    jax_eng, port_eng = _engines(path)
    js = jax_eng.space
    state = {key: np.asarray(getattr(js, key)) for key in (
        "data", "norms", "num_valid", "dim", "metric", "dtype", "scale",
        "zero_point", "precision")}
    state["rowsums"] = None if js.rowsums is None else np.asarray(js.rowsums)
    state["host_ids"] = js.host_ids
    ds = DeviceSpace.from_state(state, device="cpu")
    assert ds.scale == port_eng.space.scale and ds.zero_point == port_eng.space.zero_point
    assert torch.equal(ds.data, port_eng.space.data)
    if dtype == DataType.UINT8:
        assert torch.equal(ds.rowsums, port_eng.space.rowsums)
    queries = rng.integers(0, 100, (3, 24)).astype(np.float32)
    _same_result(SearchEngine(ds).search(queries, k=7), jax_eng.search(queries, k=7))
