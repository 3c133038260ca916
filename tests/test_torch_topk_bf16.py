"""``precision="default"`` of the port's ``fused_topk`` (its plain version on
CPU tensors: bf16-rounded queries, exact f32 dots) against the JAX
package's Pallas ``fused_topk(..., precision="default")`` run in interpret
mode on the same bf16 corpus and queries, and the routing that sends a
space's scans there (``kernel_precision``) at every call site: the engine,
streaming and sharded search.

Both sides multiply the same bf16 values, so every product is exact in f32;
only the order of the f32 sums differs. On small-integer data every sum is
exact too and the results are identical. On N(0, 1) data each side's sum
errs from the f64 sum of the same products by at most ``D·2⁻²⁴(1 + 2⁻⁶)·S
+ 2⁻²³·S`` (``S = Σ|q_d x_d| ≤ ‖q‖‖x‖``, ``engine.high_sum_bounds``' f32
term), so two sides differ by at most twice that (:func:`band`); indices
must agree except where two rows' f64 scores lie inside the band around the
k-th (a near-tie). The kernel (``csrc/topk_int_kernel.cu`` over bf16) runs on the
card (``chip_smoke.py`` phase 14 (g)); its host side is in
``tests/test_torch_wgmma_scan.py``."""

import ml_dtypes
import numpy as np
import pytest
import torch

from metrovector_tpu import Builder, DataType, DistanceMetric
from metrovector_tpu.engine import SearchEngine as JaxEngine
from metrovector_tpu.ops import fused_topk as jax_fused_topk
from metrovector_tpu_torch import Reader as PortReader
from metrovector_tpu_torch import SearchEngine
from metrovector_tpu_torch.engine import high_sum_bounds
from metrovector_tpu_torch.ops.topk_kernel import (
    bf16_queries,
    fused_topk,
    fused_topk_presampled,
    fused_topk_presampled_reference,
    fused_topk_reference,
    kernel_precision,
)
from metrovector_tpu_torch.parallel import (
    ShardedDeviceSpace,
    ShardedStreamingSearcher,
    StreamingSearcher,
    make_mesh,
)

from _torch_parity import METRICS, assert_topk_match, make_data, sq_norms, unit_rows

N, NQ = 400, 7
L2, IP, COS = DistanceMetric.L2, DistanceMetric.INNER_PRODUCT, DistanceMetric.COSINE


def _bf16(v: np.ndarray) -> np.ndarray:
    """``v`` rounded to bf16 (to nearest, ties to even), as f32."""
    return v.astype(ml_dtypes.bfloat16).astype(np.float32)


def band(q, x, norms, metric) -> np.ndarray:
    """Per-query bound on |port − reference| (module docstring), with the
    epilogue's roundings: L2 doubles the dot and rounds ``2·dot − ‖x‖²`` on
    each side; cosine scales by 1/‖x‖ (rsqrt against 1/sqrt: two more
    roundings)."""
    d = x.shape[1]
    c = 2 * high_sum_bounds(d)[1]  # two f32 routes
    if DistanceMetric(metric) == COS:
        return np.full(q.shape[0], c + 2.0**-21)
    qn = np.linalg.norm(q.astype(np.float64), axis=1)
    xmax = float(np.sqrt(norms.astype(np.float64).max()))
    if DistanceMetric(metric) == L2:
        return 2 * c * qn * xmax + 2.0**-23 * (2 * qn * xmax + xmax * xmax)
    return c * qn * xmax


def _scores64(q, x, norms, metric, live):
    """float64 scores of the exact products of the bf16 values: the oracle
    for the order of near-ties."""
    dots = q.astype(np.float64) @ x.astype(np.float64).T
    n64 = norms.astype(np.float64)
    if metric == L2:
        s = 2.0 * dots - n64[None, :]
    elif metric == COS:
        s = dots / np.sqrt(np.maximum(n64, 1e-30))[None, :]
    else:
        s = dots
    return np.where(live[None, :], s, -np.inf)


def _inputs(kind, metric, d, seed):
    """bf16-exact rows, f32 queries (bf16-exact on integer data; unit rows
    for cosine, which bf16 cannot hold), the rows' norms and a mask."""
    rng = np.random.default_rng(seed)
    x, q = make_data(rng, kind, N, d, NQ)
    if kind == "integer":  # in bf16's exact range, scores exact in f32
        x, q = x % 64, q % 64
    x = _bf16(x)
    if metric == COS:
        q = unit_rows(q)
    mask = (rng.random(N) > 0.25).astype(np.float32)
    return x, q, sq_norms(x), mask


def _port(q, x, norms, num_valid, k, metric, vm, fn=fused_topk, **kw):
    return fn(torch.from_numpy(q), torch.from_numpy(x).to(torch.bfloat16),
              torch.from_numpy(norms), num_valid, k, metric,
              valid_mask=None if vm is None else torch.from_numpy(vm),
              precision="default", **kw)


@pytest.mark.parametrize("k", [1, 10, 100, 257])
@pytest.mark.parametrize("d", [100, 128])
@pytest.mark.parametrize("kind", ["integer", "normal"])
@pytest.mark.parametrize("metric", METRICS)
def test_default_matches_pallas_interpret(metric, kind, d, k):
    """A mask and ``num_valid`` inside the corpus alternate with the case;
    at k = 257 more rows than are left may be asked for."""
    x, q, norms, mask = _inputs(kind, metric, d, seed=d + k)
    masked = (d + k) % 2 == 1
    num_valid, vm = (N - 37, mask) if masked else (N, None)
    before = fused_topk.launches_bf16
    got = _port(q, x, norms, num_valid, k, metric, vm)
    assert fused_topk.launches_bf16 == before  # the plain path is no launch
    qb = _bf16(q)  # the reference engine casts its queries to bf16
    want = jax_fused_topk(qb.astype(ml_dtypes.bfloat16), x.astype(ml_dtypes.bfloat16),
                          norms, np.int32(num_valid), k, metric, valid_mask=vm,
                          block_rows=256, interpret=True, precision="default")
    live = np.arange(N) < num_valid
    if vm is not None:
        live &= vm != 0
    assert_topk_match(
        tuple(t.numpy() for t in got), tuple(np.asarray(a) for a in want),
        exact=kind == "integer" and metric != COS,
        tol=band(qb, x, norms, metric),
        scores64=_scores64(qb, x, norms, metric, live),
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.int8])
def test_default_takes_bf16_corpus_only(dtype):
    q = torch.zeros((2, 16))
    x = torch.zeros((8, 16), dtype=dtype)
    for fn in (fused_topk, fused_topk_reference):
        with pytest.raises(ValueError, match="bf16"):
            fn(q, x, torch.zeros(8), 8, 2, L2, precision="default")
    with pytest.raises(ValueError, match="bf16"):
        fused_topk_presampled(q, x, torch.zeros(8), 8, 2, L2, precision="default")


def test_query_rounding_is_idempotent():
    """Rounding to bf16 twice is rounding once; values bf16 holds (small
    integers, bf16 bit patterns widened) pass unchanged; halfway cases go
    to even."""
    rng = np.random.default_rng(4)
    v = torch.from_numpy(np.concatenate([
        rng.standard_normal(4998), rng.integers(-256, 257, 498),
        [1 + 2.0**-8, 1 + 3 * 2.0**-8, -(1 + 2.0**-8), 0.0, -0.0, 3.0e38],
    ]).astype(np.float32)).reshape(-1, 6)
    once = bf16_queries(v)
    assert once.dtype == torch.float32 and once.shape == v.shape
    assert torch.equal(bf16_queries(once), once)
    np.testing.assert_array_equal(once.numpy(), _bf16(v.numpy()))
    ints = v[torch.isin(v, v.round()) & (v.abs() <= 256)]
    assert torch.equal(bf16_queries(ints), ints)
    tail = once.flatten()[-6:]
    assert tail[0] == 1.0 and tail[1] == 1 + 2.0**-6 and tail[2] == -1.0


_ROUTES = {  # (dtype, engine precision) -> fused_topk precision
    (DataType.FLOAT32, "highest"): "highest",
    (DataType.FLOAT32, "high"): "high",
    (DataType.FLOAT32, "high_verified"): "high",
    (DataType.FLOAT32, "default"): "default",
    (DataType.FLOAT16, "highest"): "highest",
    (DataType.FLOAT16, "high"): "highest",
    (DataType.FLOAT16, "high_verified"): "highest",
    (DataType.FLOAT16, "default"): "highest",  # bf16 rows, f32 queries: FFMA
    (DataType.BFLOAT16, "highest"): "default",
    (DataType.BFLOAT16, "high"): "default",
    (DataType.BFLOAT16, "high_verified"): "default",
    (DataType.BFLOAT16, "default"): "default",
    (DataType.INT8, "highest"): "highest",
    (DataType.INT8, "high"): "highest",
    (DataType.INT8, "high_verified"): "highest",
    (DataType.INT8, "default"): "highest",
    (DataType.UINT8, "highest"): "highest",
    (DataType.UINT8, "high"): "highest",
    (DataType.UINT8, "high_verified"): "highest",
    (DataType.UINT8, "default"): "highest",
}


@pytest.mark.parametrize("dtype, precision", sorted(_ROUTES, key=str))
def test_kernel_precision_for_every_dtype_and_precision(dtype, precision):
    assert kernel_precision(dtype, precision) == _ROUTES[(dtype, precision)]
    assert kernel_precision(int(dtype), precision) == _ROUTES[(dtype, precision)]


def _space_file(tmp_path, dtype, metric, kind="integer", n=300, d=40, seed=0):
    rng = np.random.default_rng(seed)
    x, q = make_data(rng, kind, n, d, 6)
    if kind == "integer":
        x, q = x % 64, q % 64
    b = Builder()
    b.add_vector_space("v", dim=d, metric=metric, dtype=dtype)
    b.add_vectors("v", x)
    for r in (5, 111):
        b.delete_vector("v", r)
    path = tmp_path / f"{dtype.name}.mvt"
    b.build().save(path)
    return path, x, q


class _Spy:
    """Records the precision of every ``fused_topk`` call made through a
    module's name for it."""

    def __init__(self, monkeypatch, module):
        self.seen = []
        real = module.fused_topk

        def spy(*args, **kw):
            self.seen.append(kw.get("precision", args[7] if len(args) > 7 else "highest"))
            return real(*args, **kw)

        monkeypatch.setattr(module, "fused_topk", spy)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("storage, precision, route", [
    ("f32", "default", "default"), ("bf16", "highest", "default"),
    ("bf16", "high_verified", "default"), ("f16", "default", "highest"),
    ("f32", "high", "high"),
])
def test_engine_scans_at_the_routed_precision(tmp_path, monkeypatch, metric, storage,
                                              precision, route):
    """The engine hands fused_topk kernel_precision's answer, and answers
    as the JAX engine on its Pallas backend: integer data, L2/IP identical,
    cosine identical in indices and within 1e-6 in score."""
    import metrovector_tpu_torch.engine as eng_mod

    dtype = {"f32": DataType.FLOAT32, "bf16": DataType.BFLOAT16,
             "f16": DataType.FLOAT16}[storage]
    path, x, q = _space_file(tmp_path, dtype, metric)
    spy = _Spy(monkeypatch, eng_mod)
    port = SearchEngine.open(path, device="cpu", precision=precision)
    got = port.search(q, k=10)
    assert spy.seen == [route]
    want = JaxEngine.open(path, backend="pallas", precision=precision).search(q, k=10)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.ids, want.ids)
    if metric == COS:
        np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.scores, want.scores)


@pytest.mark.parametrize("metric", METRICS)
def test_bf16_engine_on_normal_data_within_the_band(tmp_path, metric):
    """A BFLOAT16 space of N(0, 1) rows against the JAX engine: scores
    within :func:`band` of the bf16-rounded queries, indices equal but at
    near-ties."""
    path, x, q = _space_file(tmp_path, DataType.BFLOAT16, metric, kind="normal", seed=3)
    port = SearchEngine.open(path, device="cpu")
    got = port.search(q, k=10)
    want = JaxEngine.open(path, backend="pallas").search(q, k=10)
    rows = PortReader.open(path).vector_space("v").to_numpy()
    qb = port.space.prepare_queries(q).qdev.numpy()[:, : rows.shape[1]]
    live = np.ones(rows.shape[0], bool)
    live[[5, 111]] = False
    assert_topk_match((got.scores, got.indices), (want.scores, want.indices),
                      exact=False, tol=band(qb, rows, sq_norms(rows), metric),
                      scores64=_scores64(qb, rows, sq_norms(rows), metric, live))


@pytest.mark.parametrize("stride", [8, 32])
@pytest.mark.parametrize("metric", [L2, IP])
def test_presampled_default_matches_its_plain_version(metric, stride):
    """fused_topk_presampled at "default" (its plain path on CPU tensors)
    is its plain version and fused_topk's answer, bit for bit, on integer
    data with a mask and num_valid off the stride."""
    x, q, norms, mask = _inputs("integer", metric, 64, seed=stride)
    args = (q, x, norms, N - 13, 10, metric, None)
    got = _port(*args, fn=fused_topk_presampled, stride=stride)
    plain = _port(*args, fn=fused_topk_presampled_reference, stride=stride)
    np.testing.assert_array_equal(got[0].numpy(), plain[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), plain[1].numpy())
    one = _port(*args)
    np.testing.assert_array_equal(got[0].numpy(), one[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), one[1].numpy())
    masked = _port(q, x, norms, N, 10, metric, mask, fn=fused_topk_presampled,
                   stride=stride)
    whole = _port(q, x, norms, N, 10, metric, mask)
    np.testing.assert_array_equal(masked[1].numpy(), whole[1].numpy())


def test_streamed_and_sharded_bf16_scan_at_default(tmp_path, monkeypatch):
    """StreamingSearcher, ShardedStreamingSearcher and ShardedDeviceSpace of
    a BFLOAT16 space hand fused_topk "default" and answer as the resident
    engine, bit for bit."""
    import metrovector_tpu_torch.parallel.sharded_search as sharded_mod
    import metrovector_tpu_torch.parallel.streaming as stream_mod

    path, x, q = _space_file(tmp_path, DataType.BFLOAT16, L2, n=1000, d=24)
    sp = PortReader.open(path).vector_space("v")
    want = SearchEngine(sp, device="cpu").search(q, k=7)
    mesh = make_mesh(devices=["cpu"] * 4)
    stream_spy = _Spy(monkeypatch, stream_mod)
    shard_spy = _Spy(monkeypatch, sharded_mod)
    for searcher in (StreamingSearcher(sp, chunk_rows=256, device="cpu"),
                     ShardedStreamingSearcher(sp, mesh=mesh, chunk_rows=128),
                     ShardedDeviceSpace(sp, mesh)):
        got = searcher.search(q, k=7)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.scores, want.scores)
        np.testing.assert_array_equal(got.ids, want.ids)
    assert stream_spy.seen and set(stream_spy.seen) == {"default"}
    assert shard_spy.seen and set(shard_spy.seen) == {"default"}

