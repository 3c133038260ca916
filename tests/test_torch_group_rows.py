"""The port's bucket-major map ``fused_adc_topk(..., group_rows=)`` on CPU
tensors (its plain path) against the JAX package's ``fused_adc_topk(...,
group_rows=, interpret=True)`` and against the port's own ``group_ids``
form on the same numpy inputs from a seed: the bf16 LUT's rounding of the
bias, a tombstoned row, k above the probed rows, tail rows past
G·group_rows (no bias), and N that is not a multiple of ``group_rows``
(which the JAX kernel does not take). The CUDA path's layout of the rows
(``_rows_layout``: no argsort, no copy, a slot is its own row) is held to
the plain version through the bucket kernel's emulated order. The
arguments that exclude each other raise."""

import numpy as np
import pytest
import torch

from metrovector_tpu import DistanceMetric
from metrovector_tpu.index.pq import pack_codes4
from metrovector_tpu.ops.adc_kernel import fused_adc_topk as jax_fused_adc_topk
from metrovector_tpu_torch.ops.adc_kernel import (
    _rows_layout,
    fused_adc_topk,
    fused_adc_topk_reference,
)

from _torch_parity import METRICS, assert_topk_match, unit_rows
from test_torch_ivf_scan import _bit_identical, _emulate

T = torch.from_numpy


def _inputs(seed, n, groups, m=4, ksub=16, nq=5, probe=2, kind="integer"):
    """(codebooks, codes [n, m] u8, recon norms, queries, mask, bias [nq,
    G]): integer codebooks and queries (every f32 sum exact), a few
    tombstoned rows, and per query ``probe`` probed buckets of integer bias
    above 256 in magnitude (a bf16 LUT rounds them), two of them tied,
    −1e30 on the rest."""
    rng = np.random.default_rng(seed)
    if kind == "integer":
        books = rng.integers(-4, 5, (m, ksub, 2)).astype(np.float32)
        q = rng.integers(-4, 5, (nq, m * 2)).astype(np.float32)
    else:
        books = rng.standard_normal((m, ksub, 2)).astype(np.float32)
        q = rng.standard_normal((nq, m * 2)).astype(np.float32)
    codes = rng.integers(0, ksub, (n, m)).astype(np.uint8)
    recon = np.concatenate([books[j][codes[:, j]] for j in range(m)], 1)
    rn = (recon.astype(np.float64) ** 2).sum(1).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[rng.choice(n, max(1, n // 50), replace=False)] = 0.0  # tombstones
    bias = np.full((nq, groups), -1e30, np.float32)
    for r in range(nq):
        chosen = rng.choice(groups, min(probe, groups), replace=False)
        vals = rng.integers(-3000, 3000, len(chosen)).astype(np.float32)
        vals[-1] = vals[0]  # a tied pair where two are probed
        bias[r, chosen] = vals
    return books, codes, rn, q, mask, bias


def _port(q, codes, books, rn, num_valid, k, metric, mask, exact_lut, packed4, bias,
          **kw):
    before = fused_adc_topk.launches, fused_adc_topk.group_rows_launches
    s, i = fused_adc_topk(T(q), T(codes), T(books), T(rn), num_valid, k, metric,
                          T(mask), exact_lut, packed4, T(bias), **kw)
    assert (fused_adc_topk.launches, fused_adc_topk.group_rows_launches) == before
    return s.numpy(), i.numpy()


JAX_CASES = [  # (kind, groups, group_rows, tail buckets, packed4, exact_lut, k)
    ("integer", 3, 128, 0, False, True, 10),
    ("integer", 3, 128, 0, True, False, 40),  # the bf16 LUT rounds the bias
    ("integer", 4, 128, 0, False, False, 300),  # k above the probed rows
    ("normal", 2, 256, 0, True, True, 12),
    ("integer", 128, 128, 1, True, False, 20),  # a tail bucket: no bias
]


@pytest.mark.parametrize("case", JAX_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("metric", METRICS)
def test_group_rows_matches_pallas_interpret(metric, case):
    """The reference takes N a multiple of ``group_rows`` and ``group_rows``
    a multiple of 128; rows of bucket G or more match none of its bias
    columns only past its 128-column padding, so the tail case has G =
    128."""
    kind, groups, gr, tail, packed4, exact_lut, k = case
    n = (groups + tail) * gr
    books, codes, rn, q, mask, bias = _inputs(groups + k, n, groups, kind=kind)
    if metric == DistanceMetric.COSINE:
        q = unit_rows(q)
    stored = pack_codes4(codes) if packed4 else codes
    num_valid = n - 3
    got = _port(q, stored, books, rn, num_valid, k, metric, mask, exact_lut, packed4,
                bias, group_rows=gr)
    want = jax_fused_adc_topk(q, stored, books, rn, np.int32(num_valid), k, metric,
                              valid_mask=mask, exact_lut=exact_lut, block_rows=128,
                              interpret=True, packed4=packed4, group_bias=bias,
                              group_rows=gr)
    want = tuple(np.asarray(a) for a in want)
    gids = (np.arange(n) // gr).astype(np.int32)
    ids_form = _port(q, stored, books, rn, num_valid, k, metric, mask, exact_lut,
                     packed4, bias, group_ids=T(gids))
    np.testing.assert_array_equal(got[0], ids_form[0])
    np.testing.assert_array_equal(got[1], ids_form[1])
    if kind == "integer" and metric != DistanceMetric.COSINE:
        assert_topk_match(got, want, exact=True)
    else:  # the same sums in another order: indices, and scores to a few ulps
        np.testing.assert_array_equal(got[1], want[1])
        fin = want[1] >= 0
        np.testing.assert_allclose(got[0][fin], want[0][fin], rtol=2e-6, atol=1e-5)
    if k == 300:
        assert (got[1] == -1).any()  # slots past the probed rows stay unfilled
    if tail:
        assert (got[1] >= groups * gr).any()  # tail rows score without a bias
    assert not np.isin(got[1], np.flatnonzero(mask == 0)).any()


@pytest.mark.parametrize("n, groups, gr", [(1000, 8, 96), (1000, 12, 96), (777, 5, 1),
                                           (640, 3, 200)])
@pytest.mark.parametrize("metric", METRICS)
def test_group_rows_is_the_group_ids_form(metric, n, groups, gr):
    """Any N and ``group_rows`` (past the reference's limits): the tail
    past G·group_rows takes no bias and every query scans it, buckets past
    N are empty, and the result is the ``group_ids = row // group_rows``
    form's, bit for bit."""
    books, codes, rn, q, mask, bias = _inputs(n + gr, n, groups, probe=3)
    if metric == DistanceMetric.COSINE:
        q = unit_rows(q)
    gids = (np.arange(n) // gr).astype(np.int32)
    for exact_lut, k in ((True, 17), (False, n)):
        got = _port(q, codes, books, rn, n - 1, k, metric, mask, exact_lut, False, bias,
                    group_rows=gr)
        want = _port(q, codes, books, rn, n - 1, k, metric, mask, exact_lut, False, bias,
                     group_ids=T(gids))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n, groups, gr", [(1000, 8, 96), (1000, 12, 96), (384, 3, 128)])
@pytest.mark.parametrize("metric", METRICS)
def test_rows_layout_through_the_bucket_kernel_order(metric, n, groups, gr):
    """What the CUDA path hands the bucket kernel: bucket g's slots from
    g·group_rows, ``min(group_rows, N − g·group_rows)`` of them (none past
    N), the tail as bucket G, no ids (a slot is its row). The kernel's
    order over it, emulated, is the plain version's answer bit for bit."""
    books, codes, rn, q, mask, bias = _inputs(n * 3 + gr, n, groups, probe=3)
    if metric == DistanceMetric.COSINE:
        q = unit_rows(q)
    layout = _rows_layout(T(codes), T(rn), gr, groups)
    lc, ids, ln, starts, stride, counts = layout
    assert ids is None and starts is None and stride == gr
    assert lc.data_ptr() == T(codes).data_ptr() or torch.equal(lc, T(codes))
    want_counts = [max(0, min(gr, n - g * gr)) for g in range(groups)]
    assert counts.tolist() == want_counts + [max(0, n - groups * gr)]
    assert int(counts.sum()) == n
    emu_layout = (lc, torch.arange(n, dtype=torch.int32), ln, None, gr, counts)
    for k, qt, splits in ((12, 1, 3), (n, 2, 2)):
        got = _emulate(T(q), T(books), emu_layout, T(bias), n - 2, k, metric, T(mask),
                       False, False, qt, splits)
        ref = fused_adc_topk_reference(T(q), T(codes), T(books), T(rn), n - 2, k, metric,
                                       T(mask), False, False, T(bias), group_rows=gr)
        _bit_identical(got, ref, f"{metric.name} n={n} G={groups} group_rows={gr} k={k}")


@pytest.mark.parametrize("name", ["with_ids", "with_buckets", "without_bias",
                                  "negative", "int8_lut"])
def test_group_rows_checks_raise(name):
    q, codes, books = torch.zeros((2, 8)), torch.zeros((10, 4), dtype=torch.uint8), \
        torch.zeros((4, 16, 2))
    kw = {"group_bias": torch.zeros((2, 3)), "group_rows": 4}
    if name == "with_ids":
        kw["group_ids"] = torch.zeros(10, dtype=torch.int32)
    elif name == "with_buckets":
        kw["buckets"] = (torch.zeros((3, 4, 4), dtype=torch.uint8),
                         torch.zeros((3, 4), dtype=torch.int32), torch.zeros((3, 4)),
                         torch.zeros(3, dtype=torch.int32))
    elif name == "without_bias":
        del kw["group_bias"]
    elif name == "negative":
        kw["group_rows"] = -2
    else:
        kw["int8_lut"] = True
    with pytest.raises(ValueError):
        fused_adc_topk(q, codes, books, torch.zeros(10), 10, 3, DistanceMetric.L2, **kw)
