"""K2's int8 LUT: the port's ``fused_adc_topk(int8_lut=True)`` on CPU
tensors (its plain version) against the JAX package's Pallas
``fused_adc_topk(int8_lut=True)`` in interpret mode, the quantization
itself against the reference's lines, and ``PQIndex.search(int8_lut=True)``
against the JAX index's ``backend="pallas"``.

Tolerance. Both packages quantize the f32 LUT per query by the same rule
(``sq = max(max|LUT|, 1e-30)/127``, ``clip(rint(LUT/sq), ±127)``) and add
the int8 entries exactly, so where the f32 LUTs agree bit for bit (integer
queries and codebooks: every entry an exact f32 integer) L2 and IP results
are identical. On float data the two einsums may round an entry one f32
ulp apart, which can move its int8 value by one step: each of the m
entries of a row then differs by at most ``sq``, so scores agree within
``m·sq`` (``2·m·sq`` for L2, ``m·sq/‖x̂‖`` for cosine) plus a rounding, and
indices agree outside that band. Cosine scores also differ by the
reference's ``rsqrt`` of the norms (4 f32 ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrovector_tpu import DistanceMetric
from metrovector_tpu.index import pq as jax_pq
from metrovector_tpu.index.pq import pack_codes4
from metrovector_tpu.ops.adc_kernel import fused_adc_topk as jax_fused_adc_topk
from metrovector_tpu_torch.index.pq import PQIndex
from metrovector_tpu_torch.ops import adc_kernel
from metrovector_tpu_torch.ops.adc_kernel import adc_lut, fused_adc_topk, quantize_lut

from _torch_parity import METRICS, assert_topk_match, exact_scores, unit_rows

N, DSUB, NQ = 300, 4, 5
COS = DistanceMetric.COSINE


def _pq_inputs(kind, m, ksub, seed=7):
    """(codebooks [m, ksub, DSUB], codes [N, m] u8, recon norms [N],
    queries [NQ, D], mask [N]), integer-valued or N(0, 1)."""
    rng = np.random.default_rng(seed)
    if kind == "integer":
        books = rng.integers(-8, 8, (m, ksub, DSUB)).astype(np.float32)
        q = rng.integers(-8, 8, (NQ, m * DSUB)).astype(np.float32)
    else:
        books = rng.standard_normal((m, ksub, DSUB)).astype(np.float32)
        q = rng.standard_normal((NQ, m * DSUB)).astype(np.float32)
    codes = rng.integers(0, ksub, (N, m)).astype(np.uint8)
    recon = np.concatenate([books[j][codes[:, j]] for j in range(m)], axis=1)
    rnorms = (recon.astype(np.float64) ** 2).sum(1).astype(np.float32)
    mask = (rng.random(N) > 0.3).astype(np.float32)
    return books, codes, recon, rnorms, q, mask


@jax.jit
def _reference_quantize(lut):
    """The reference's quantization, ``metrovector_tpu/ops/adc_kernel.py``
    :431-436, on an f32 LUT."""
    s_q = jnp.maximum(jnp.max(jnp.abs(lut), axis=1, keepdims=True), 1e-30)
    sq = (s_q / 127.0).astype(jnp.float32)
    return jnp.clip(jnp.round(lut / sq), -127, 127).astype(jnp.int8), sq[:, 0]


@pytest.mark.parametrize("kind", ["integer", "normal", "halves"])
def test_quantize_lut_matches_reference(kind):
    rng = np.random.default_rng(3)
    lut = rng.standard_normal((6, 64)).astype(np.float32) * 3
    if kind == "integer":
        lut = np.rint(lut * 20)
    elif kind == "halves":  # entries exactly halfway between two steps
        lut = (rng.integers(-127, 127, (6, 64)) + 0.5).astype(np.float32)
        lut[:, 0] = 127.0  # max|lut| = 127, so sq = 1
    lut[2] = 0.0  # an all-zero query: sq = 1e-30 / 127
    got_q, got_s = quantize_lut(torch.from_numpy(lut))
    want_q, want_s = (np.asarray(a) for a in _reference_quantize(lut))
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_q.numpy(), want_q)


def _band(q, books, recon, rnorms, metric):
    """Per-query bound on |score_a − score_b| (module docstring): m steps
    of the int8 LUT, doubled for L2, over ‖x̂‖ for cosine, plus a rounding
    of the largest score."""
    m = books.shape[0]
    lut = adc_lut(torch.from_numpy(q), torch.from_numpy(books), True)
    _, sq = quantize_lut(lut)
    base = m * sq.numpy().astype(np.float64)
    if DistanceMetric(metric) == DistanceMetric.L2:
        base = 2 * base
    elif DistanceMetric(metric) == COS:
        base = base / np.sqrt(max(float(rnorms.min()), 1e-30))
    top = np.abs(exact_scores(q, recon, metric)).max(axis=1)
    return 1.01 * base + 8 * 2.0**-24 * top


def _port(q, stored, books, rnorms, num_valid, k, metric, mask, packed4):
    before = fused_adc_topk.launches, fused_adc_topk.int8_launches
    s, i = fused_adc_topk(
        torch.from_numpy(q), torch.from_numpy(stored), torch.from_numpy(books),
        torch.from_numpy(rnorms), num_valid, k, metric,
        None if mask is None else torch.from_numpy(mask), packed4=packed4,
        int8_lut=True,
    )
    assert (fused_adc_topk.launches, fused_adc_topk.int8_launches) == before
    return s.numpy(), i.numpy()


CASES = [  # (kind, m, ksub, packed4, masked)
    ("integer", 4, 16, False, False),
    ("integer", 5, 16, True, True),
    ("integer", 3, 256, False, True),
    ("normal", 4, 16, True, False),
    ("normal", 4, 32, False, True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("metric", METRICS)
def test_int8_lut_matches_pallas_interpret(metric, case):
    kind, m, ksub, packed4, masked = case
    books, codes, recon, rnorms, q, mask = _pq_inputs(kind, m, ksub)
    if metric == COS:
        q = unit_rows(q)
    num_valid, vm, k = (N - 23, mask, 12) if masked else (N, None, 10)
    stored = pack_codes4(codes) if packed4 else codes
    got = _port(q, stored, books, rnorms, num_valid, k, metric, vm, packed4)
    want = jax_fused_adc_topk(q, stored, books, rnorms, np.int32(num_valid), k,
                              metric, valid_mask=vm, int8_lut=True,
                              block_rows=128, interpret=True, packed4=packed4)
    want = tuple(np.asarray(a) for a in want)
    live = np.arange(N) < num_valid
    if vm is not None:
        live &= vm != 0
    if kind == "integer" and metric != COS:
        assert_topk_match(got, want, exact=True)
        return
    # the int8 problem's float64 scores: the sums of quantized entries
    lut8, sq = quantize_lut(adc_lut(torch.from_numpy(q), torch.from_numpy(books), True))
    lut8 = lut8.numpy().astype(np.float64).reshape(NQ, m, ksub)
    dots = sum(lut8[:, j, codes[:, j]] for j in range(m)) * sq.numpy()[:, None]
    if DistanceMetric(metric) == DistanceMetric.L2:
        s64 = 2 * dots - rnorms.astype(np.float64)[None]
    elif DistanceMetric(metric) == COS:
        s64 = dots / np.sqrt(rnorms.astype(np.float64))[None]
    else:
        s64 = dots
    assert_topk_match(got, want, exact=False,
                      tol=_band(q, books, recon, rnorms, metric),
                      scores64=np.where(live[None], s64, -np.inf))


def test_int8_lut_exclusions_raise():
    books, codes, _, rnorms, q, _ = _pq_inputs("integer", 4, 16)
    t = torch.from_numpy
    with pytest.raises(ValueError, match=adc_kernel.INT8_LUT_EXCLUSIVE):
        fused_adc_topk(t(q), t(codes), t(books), t(rnorms), N, 5,
                       DistanceMetric.L2, exact_lut=True, int8_lut=True)
    with pytest.raises(ValueError, match=adc_kernel.INT8_LUT_EXCLUSIVE):
        fused_adc_topk(t(q), t(codes), t(books), t(rnorms), N, 5,
                       DistanceMetric.L2, int8_lut=True,
                       group_bias=torch.zeros((NQ, 3)),
                       group_ids=torch.zeros(N, dtype=torch.int32))
    # the reference refuses the same combinations with the same words
    with pytest.raises(ValueError, match=adc_kernel.INT8_LUT_EXCLUSIVE):
        jax_fused_adc_topk(q, codes, books, rnorms, np.int32(N), 5,
                           DistanceMetric.L2, exact_lut=True, int8_lut=True,
                           interpret=True)


def _ref_index(metric, packed4, seed=6):
    """A JAX index over integer rows with integer codebooks and two
    tombstones (tests/test_torch_pq.py's form)."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 200, (12, 16))
    data = (centers[rng.integers(0, 12, 300)]
            + rng.integers(-6, 7, (300, 16))).astype(np.float32)
    books = np.rint(jax_pq.train_pq(data, m=4, ksub=16, iters=3, seed=seed))
    tomb = np.zeros(len(data), bool)
    tomb[[5, 77]] = True
    ref = jax_pq.PQIndex.build(data, metric, codebooks=books, pack4=packed4,
                               valid_mask=tomb)
    q = data[rng.integers(0, len(data), 6)] + rng.integers(-9, 10, (6, 16))
    return ref, data, q.astype(np.float32)


def _state(ref):
    state = {name: None if getattr(ref, name) is None else np.asarray(getattr(ref, name))
             for name in ("codebooks", "codes", "recon_norms", "db", "db_norms", "valid")}
    state.update(metric=int(ref.metric), dim=ref.dim, num_vectors=ref.num_vectors,
                 packed4=ref.packed4, host_ids=ref.host_ids)
    return state


@pytest.mark.parametrize("rerank", [0, 40])
@pytest.mark.parametrize("packed4", [False, True], ids=["u8", "packed4"])
@pytest.mark.parametrize("metric", METRICS)
def test_pq_index_int8_lut_matches_pallas_reference(metric, packed4, rerank):
    """Integer rows, codebooks and queries: the f32 LUTs agree bit for bit,
    so L2/IP results are identical, with and without the re-rank (which
    runs K3's plain version on the ADC candidates); cosine indices are
    identical and scores within 4 f32 ulp."""
    ref, data, q = _ref_index(metric, packed4)
    port = PQIndex.from_state(_state(ref), device="cpu")
    a = port.search(q, k=10, rerank=rerank, int8_lut=True)
    b = ref.search(q, k=10, rerank=rerank, int8_lut=True, backend="pallas")
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.ids, b.ids)
    if metric == COS:
        live = b.indices >= 0
        ulps = (np.abs(a.scores[live].astype(np.float64) - b.scores[live])
                / np.spacing(np.abs(b.scores[live])))
        assert ulps.max(initial=0) <= 4
        return
    np.testing.assert_array_equal(a.scores, b.scores)
