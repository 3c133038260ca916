"""``precision="high"`` of the port's ``fused_topk`` on CPU tensors (its plain
bf16x3 version) against the JAX package's Pallas ``fused_topk(...,
precision="high")`` run in interpret mode, and the port's ``split_bf16x3``
against ``jnp.astype(bfloat16)`` bit for bit.

Both sides form the same split (``hi = bf16(v)``, ``lo = bf16(v − hi)``,
round to nearest even) and the same exact products; only the order of the
f32 sums differs. On small-integer data the split is exact (``lo = 0``) and
so is every sum: the results are identical. On N(0, 1) data each side's sum
errs from the f64 sum of the same products by at most ``D·2⁻²⁴(1 + 2⁻⁶)·S
+ 2⁻²³·S`` (``S = Σ|q_d x_d| ≤ ‖q‖‖x‖``), so two sides differ by at most
twice that (:func:`band`); indices must agree except where two rows' f64
bf16x3 scores lie inside the band around the k-th (a near-tie)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from metrovector_tpu import DistanceMetric
from metrovector_tpu.ops import fused_topk as jax_fused_topk
from metrovector_tpu_torch.engine import high_dot_bounds, high_sum_bounds
from metrovector_tpu_torch.ops import topk_kernel
from metrovector_tpu_torch.ops.distances import bf16x3_dots, split_bf16x3
from metrovector_tpu_torch.ops.topk_kernel import fused_topk, fused_topk_reference

from _torch_parity import (
    METRICS,
    assert_topk_match,
    exact_scores,
    make_data,
    sq_norms,
    unit_rows,
)

N, NQ = 400, 7


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


def _split_jax(v: np.ndarray):
    """The reference kernel's split (``topk_kernel.py:625-628``)."""
    v32 = jnp.asarray(v, jnp.float32)
    hi = v32.astype(jnp.bfloat16)
    lo = (v32 - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    return np.asarray(hi), np.asarray(lo)


def _split_torch(v: np.ndarray):
    hi, lo = split_bf16x3(torch.from_numpy(v))
    return hi.view(torch.int16).numpy(), lo.view(torch.int16).numpy()


def _edge_values() -> np.ndarray:
    one = np.float32(1.0)
    ulp7 = np.float32(2.0**-7)  # bf16's spacing at 1
    vals = [
        0.0, -0.0, 1.0, -1.0,
        one + ulp7 / 2,            # halfway: ties to even (down to 1)
        one + 3 * ulp7 / 2,        # halfway: ties to even (up)
        -(one + ulp7 / 2),
        one + ulp7 / 2 + 2.0**-23,  # just above halfway: up
        2.0**-118 * (1 + 2.0**-9 + 2.0**-20),  # lo below 2^-126: subnormal
        2.0**-126,                 # the least normal
        2.0**-140, -(2.0**-149),   # f32 subnormals
        1.2e-38, 3.0e38, -3.3e38,
        np.finfo(np.float32).max,  # hi rounds up to inf
        np.finfo(np.float32).tiny * 3.75,
        65504.0, 1.0 / 3.0, np.pi, 255.0, 257.0,
    ]
    rng = np.random.default_rng(5)
    return np.concatenate([
        np.array(vals, np.float32),
        rng.standard_normal(2000).astype(np.float32),
        (rng.standard_normal(500) * 1e-38).astype(np.float32),
        rng.integers(-300, 300, 500).astype(np.float32),
    ])


def test_split_bf16x3_matches_jax_bit_for_bit():
    """``hi`` is ``jnp.astype(bfloat16)`` bit for bit, and so is ``lo`` of
    the exact difference ``v − f32(hi)``. XLA's CPU backend, which runs the
    reference here, flushes a subnormal f32 difference to zero before its
    rounding; the port keeps it, as a split that flushes nothing must (the
    kernel is built without fast math). Only ``|v| < 2⁻¹¹⁸`` is concerned."""
    v = _edge_values()
    hi_t, lo_t = _split_torch(v)
    hi_j, lo_j = _split_jax(v)
    np.testing.assert_array_equal(hi_t.view(np.uint16), _bits(hi_j))
    diff = v - np.asarray(hi_j).astype(np.float32)  # exact, nothing flushed
    lo_exact = np.asarray(jnp.asarray(diff).astype(jnp.bfloat16))
    np.testing.assert_array_equal(lo_t.view(np.uint16), _bits(lo_exact))
    sub = (diff != 0) & (np.abs(diff) < np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(lo_t.view(np.uint16)[~sub], _bits(lo_j)[~sub])
    assert sub.any() and (lo_t.view(np.uint16)[sub] & 0x7FFF != 0).any()
    # the cases the list names: ties to even, signed zeros, a subnormal lo
    # kept (not flushed), a hi that overflows to inf
    hi = hi_t.view(np.uint16)
    lo = lo_t.view(np.uint16)
    assert hi[4] == 0x3F80 and hi[5] == 0x3F82 and hi[6] == 0xBF80
    assert hi[7] == 0x3F81
    assert hi[1] == 0x8000
    assert hi[8] == 0x0480 and lo[8] == 0x0040  # hi = 2^-118, lo = 2^-127
    assert hi[15] == 0x7F80 and lo[15] == 0xFF80


def test_split_bf16x3_recovers_sixteen_bits():
    rng = np.random.default_rng(6)
    v = rng.standard_normal(10_000).astype(np.float32)
    hi, lo = split_bf16x3(torch.from_numpy(v))
    rec = hi.double() + lo.double()
    err = (rec - torch.from_numpy(v).double()).abs()
    assert (err.numpy() <= 2.0**-16 * np.abs(v)).all()


def _bf16x3_scores64(q, x, norms, metric, live):
    """float64 scores of the exact bf16x3 products, which both sides sum in
    f32: the oracle for the order of near-ties."""
    bf = ml_dtypes.bfloat16

    def split(v):
        hi = v.astype(bf)
        return (hi.astype(np.float64),
                (v - hi.astype(np.float32)).astype(bf).astype(np.float64))

    q_hi, q_lo = split(q)
    x_hi, x_lo = split(x)
    dots = q_hi @ x_hi.T + q_hi @ x_lo.T + q_lo @ x_hi.T
    n64 = norms.astype(np.float64)
    if metric == DistanceMetric.L2:
        s = 2.0 * dots - n64[None, :]
    elif metric == DistanceMetric.COSINE:
        s = dots / np.sqrt(np.maximum(n64, 1e-30))[None, :]
    else:
        s = dots
    return np.where(live[None, :], s, -np.inf)


@pytest.mark.parametrize("d", [64, 100, 960])
def test_bf16x3_dots_in_f64_match_the_oracle(d):
    """``bf16x3_dots(..., torch.float64)`` (the chip check's near-tie
    oracle) sums the same exact products as the numpy oracle, and the f32
    route stays within its summation bound of it."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((5, d)).astype(np.float32)
    x = rng.standard_normal((300, d)).astype(np.float32)
    live = np.ones(300, bool)
    want = _bf16x3_scores64(q, x, np.zeros(300, np.float32),
                            DistanceMetric.INNER_PRODUCT, live)
    got = bf16x3_dots(torch.from_numpy(q), torch.from_numpy(x), torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)
    f32 = bf16x3_dots(torch.from_numpy(q), torch.from_numpy(x)).double().numpy()
    s_abs = np.abs(q).astype(np.float64) @ np.abs(x).astype(np.float64).T
    assert (np.abs(f32 - want) <= high_sum_bounds(d)[1] * s_abs).all()


def band(q, x, norms, metric) -> np.ndarray:
    """Per-query bound on |port − reference| at "high" (module docstring),
    with the epilogue's roundings: L2 doubles the dot and rounds
    ``2·dot − ‖x‖²`` on each side; cosine scales by 1/‖x‖ (rsqrt against
    1/sqrt: two more roundings)."""
    d = x.shape[1]
    c = 2 * high_sum_bounds(d)[1]  # two f32 routes
    if DistanceMetric(metric) == DistanceMetric.COSINE:
        return np.full(q.shape[0], c + 2.0**-21)
    qn = np.linalg.norm(q.astype(np.float64), axis=1)
    xmax = float(np.sqrt(norms.astype(np.float64).max()))
    if DistanceMetric(metric) == DistanceMetric.L2:
        return 2 * c * qn * xmax + 2.0**-23 * (2 * qn * xmax + xmax * xmax)
    return c * qn * xmax


def _inputs(kind, metric, d, seed):
    rng = np.random.default_rng(seed)
    x, q = make_data(rng, kind, N, d, NQ)
    if kind == "integer":  # in bf16's exact range, scores exact in f32
        x, q = x % 64, q % 64
    if metric == DistanceMetric.COSINE:
        q = unit_rows(q)
    mask = (rng.random(N) > 0.25).astype(np.float32)
    return x, q, sq_norms(x), mask


@pytest.mark.parametrize("d, k", [(64, 1), (64, 257), (100, 10), (100, 257),
                                  (960, 10), (960, 1)])
@pytest.mark.parametrize("kind", ["integer", "normal"])
@pytest.mark.parametrize("metric", METRICS)
def test_high_matches_pallas_interpret(metric, kind, d, k):
    """Masks and ``num_valid`` below N alternate with the case; at k = 257
    more rows than are left may be asked for."""
    x, q, norms, mask = _inputs(kind, metric, d, seed=d + k)
    masked = (d + k) % 2 == 1
    num_valid, vm = (N - 37, mask) if masked else (N, None)
    before = fused_topk.launches_high
    got = fused_topk(torch.from_numpy(q), torch.from_numpy(x),
                     torch.from_numpy(norms), num_valid, k, metric,
                     None if vm is None else torch.from_numpy(vm),
                     precision="high")
    assert fused_topk.launches_high == before  # the plain path is no launch
    want = jax_fused_topk(q, x, norms, np.int32(num_valid), k, metric,
                          valid_mask=vm, block_rows=256, interpret=True,
                          precision="high")
    live = np.arange(N) < num_valid
    if vm is not None:
        live &= vm != 0
    got = tuple(t.numpy() for t in got)
    assert_topk_match(
        got, tuple(np.asarray(a) for a in want),
        exact=kind == "integer" and metric != DistanceMetric.COSINE,
        tol=band(q, x, norms, metric),
        scores64=_bf16x3_scores64(q, x, norms, metric, live),
    )
    # The split's own error stays inside the scan's part of the certificate:
    # |high − f64| <= scan * S on every returned row.
    scan, _ = high_dot_bounds(d)
    s_g, i_g = got
    true = exact_scores(q, x, DistanceMetric.INNER_PRODUCT)
    s_abs = np.abs(q.astype(np.float64)) @ np.abs(x.astype(np.float64)).T
    if metric == DistanceMetric.INNER_PRODUCT:
        fin = i_g >= 0
        rows = np.where(fin, i_g, 0)
        err = np.abs(s_g - np.take_along_axis(true, rows, 1))
        lim = scan * np.take_along_axis(s_abs, rows, 1)
        assert (err[fin] <= lim[fin]).all()


@pytest.mark.parametrize("metric", METRICS)
def test_high_differs_from_highest_only_in_band(metric):
    """On N(0, 1) data "high" and "highest" pick the same rows except at
    near-ties of the exact scores, within the split's band."""
    x, q, norms, _ = _inputs("normal", metric, 128, seed=11)
    args = (torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(norms),
            N, 10, metric)
    hi = fused_topk_reference(*args, precision="high")
    ref = fused_topk_reference(*args)
    scan, rescore = high_dot_bounds(128)
    tol = band(q, x, norms, metric) + (scan + rescore) * (
        1.0 if metric == DistanceMetric.COSINE
        else np.linalg.norm(q, axis=1) * np.sqrt(norms.max())
        * (2 if metric == DistanceMetric.L2 else 1))
    live = np.ones(N, bool)
    assert_topk_match(tuple(t.numpy() for t in hi), tuple(t.numpy() for t in ref),
                      exact=False, tol=tol,
                      scores64=exact_scores(q, x, metric, live))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_high_takes_f32_corpus_only(dtype):
    q = torch.zeros((2, 16))
    x = torch.zeros((8, 16), dtype=dtype)
    with pytest.raises(ValueError, match="f32"):
        fused_topk(q, x, torch.zeros(8), 8, 2, DistanceMetric.L2, precision="high")
    with pytest.raises(ValueError, match="precision"):
        fused_topk(q, x.float(), torch.zeros(8), 8, 2, DistanceMetric.L2,
                   precision="default")


@pytest.mark.parametrize("k", [1, 10, 18, 22, 23, 128, 129, 257, 5000])
def test_high_kernel_shared_memory(k):
    """A bf16x3 scan block (csrc/topk_high_kernel.cu) fits in shared memory
    at every k and batch, with a ring of at least MIN_STAGES stages: lists
    above SCAN_SMEM_K live in device memory, and up to k = 22 (the main
    path's k = 10 plus the default margin of 8 is 18) they stay in shared
    memory at every batch, beside at least four stages of 128 queries."""
    for nq in (1, 8, 16, 32, 33, 64, 100, 128, 129, 255, 256, 1000):
        shape = topk_kernel._high_shape(nq, k)
        assert shape.smem <= topk_kernel.SMEM_LIMIT
        assert topk_kernel.MIN_STAGES <= shape.stages <= topk_kernel.HIGH_MAX_STAGES
        assert shape.nw in topk_kernel.HIGH_NW and not shape.resident
        stage = 64 * 32 * 4 + 2 * shape.nw * 128
        assert shape.smem == topk_kernel._scan_smem(
            stage, shape.stages, 0, shape.nw, 0 if shape.big else k)
        # the tile follows the batch: 2 nw queries, the least that holds it
        assert 2 * shape.nw >= min(nq, 128)
        assert shape.nw == 16 or 2 * (shape.nw // 2) < min(nq, 128) or shape.big
        if k <= 22:
            assert not shape.big
            assert shape.stages >= (4 if nq > 64 else topk_kernel.HIGH_MAX_STAGES)
        assert shape.big == (k > topk_kernel.SCAN_SMEM_K) or k > 22


def _trunc(v: np.ndarray, ulp: np.ndarray) -> np.ndarray:
    """v truncated toward zero to a multiple of ulp."""
    return np.trunc(v / ulp) * ulp


def _wgmma_step(acc: np.ndarray, terms: np.ndarray) -> np.ndarray:
    """One wgmma k step in the worst case the certificate models: the 16
    products and the accumulator aligned to the largest exponent among them
    and truncated to 24 bits there, their sum (exact in float64) truncated
    to 24 bits once more."""
    big = np.maximum(np.abs(terms).max(axis=-1), np.abs(acc))
    ulp = np.exp2(np.floor(np.log2(np.where(big > 0, big, 1.0))) - 23)
    total = _trunc(acc, ulp) + _trunc(terms, ulp[..., None]).sum(axis=-1)
    tulp = np.exp2(np.floor(np.log2(np.where(total != 0, np.abs(total), 1.0))) - 23)
    return _trunc(total, tulp)


def _emulate_wgmma_bf16x3(q: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The bf16x3 kernel's dots [Q, N] in its order: per k step of 16 dims
    one wgmma adds x_hi q_hi into acc, two add x_lo q_hi, then x_hi q_lo,
    into sml; at the end acc + sml is rounded once to f32."""
    def halves(v):
        hi, lo = split_bf16x3(torch.from_numpy(v))
        return hi.float().double().numpy(), lo.float().double().numpy()

    (qh, ql), (xh, xl) = halves(q), halves(x)
    d = q.shape[1]
    acc = np.zeros((q.shape[0], x.shape[0]))
    sml = np.zeros_like(acc)
    for s in range(0, d, 16):
        e = slice(s, min(s + 16, d))

        def prods(a, b):
            return a[:, None, e] * b[None, :, e]  # exact: 8 x 8 significant bits

        acc = _wgmma_step(acc, prods(qh, xh))
        sml = _wgmma_step(sml, prods(qh, xl))
        sml = _wgmma_step(sml, prods(ql, xh))
    return (acc.astype(np.float32) + sml.astype(np.float32)).astype(np.float64)


@pytest.mark.parametrize("kind", ["positive", "mixed"])
@pytest.mark.parametrize("d", [16, 100, 128, 960, 1536])
def test_wgmma_accumulation_within_certificate(d, kind):
    """The certificate's model of the tensor cores holds for the kernel's
    k step and grouping (csrc/topk_high_kernel.cu: one 16-deep wgmma step
    per add, x_hi q_hi apart from the two small terms): the emulated
    worst-case truncating sums stay within high_sum_bounds(D)[0] of the
    exact sum of the same products, in units of S = sum |q_d x_d|, where
    nothing cancels (all positive) and on mixed signs."""
    rng = np.random.default_rng(d)
    if kind == "positive":
        q = rng.random((4, d)).astype(np.float32)
        x = rng.random((64, d)).astype(np.float32)
    else:
        q = rng.standard_normal((4, d)).astype(np.float32)
        x = rng.standard_normal((64, d)).astype(np.float32)
    got = _emulate_wgmma_bf16x3(q, x)
    exact = bf16x3_dots(torch.from_numpy(q), torch.from_numpy(x),
                        torch.float64).numpy()
    s_abs = np.abs(q.astype(np.float64)) @ np.abs(x.astype(np.float64)).T
    ratio = np.abs(got - exact) / (high_sum_bounds(d)[0] * s_abs)
    assert ratio.max() < 1.0
    assert np.abs(got - exact).max() > 0  # the emulation does truncate
