"""metrovector_tpu_torch.ops.distances against the JAX package's
``exact_topk_xla`` and ``numpy_oracle``: the same numpy inputs through both,
over L2 / cosine / IP, row padding (``num_valid`` < rows), tombstone masks
and ``k`` above the live rows. Integer-valued data must agree bit for bit;
float data within the tolerance stated in ``_torch_parity``."""

import numpy as np
import pytest
import torch

from metrovector_tpu import DistanceMetric
from metrovector_tpu.ops.distances import distances_np as jax_distances_np
from metrovector_tpu.ops.distances import exact_topk_xla, numpy_oracle
from metrovector_tpu_torch.ops.distances import (
    distances_np,
    exact_topk,
    mask_scores,
    scores_to_distances,
)

from _torch_parity import (
    METRICS,
    assert_topk_match,
    exact_scores,
    make_data,
    sq_norms,
    tolerance,
    unit_rows,
)

N, D, NQ, BLOCK = 700, 32, 5, 256


def _scenario(rng, name):
    """(num_valid, valid_mask or None, k)."""
    if name == "plain":
        return N, None, 10
    if name == "padding":
        return N - 123, None, 10
    if name == "mask":
        return N, (rng.random(N) > 0.3).astype(np.float32), 10
    # k above the live rows: 6 rows survive the mask
    mask = np.zeros(N, np.float32)
    mask[rng.choice(N, 6, replace=False)] = 1.0
    return N, mask, 10


@pytest.mark.parametrize("scenario", ["plain", "padding", "mask", "k_gt_valid"])
@pytest.mark.parametrize("kind", ["integer", "normal"])
@pytest.mark.parametrize("metric", METRICS)
def test_exact_topk_matches_xla_and_oracle(metric, kind, scenario):
    rng = np.random.default_rng(11)
    x, q = make_data(rng, kind, N, D, NQ)
    num_valid, mask, k = _scenario(rng, scenario)
    norms = sq_norms(x)
    got = exact_topk(torch.from_numpy(q), torch.from_numpy(x),
                     torch.from_numpy(norms), num_valid, k, metric,
                     valid_mask=None if mask is None else torch.from_numpy(mask),
                     block_rows=BLOCK)
    got = tuple(t.numpy() for t in got)
    want = exact_topk_xla(q, x, norms, num_valid, k, metric,
                          valid_mask=mask, block_rows=BLOCK)
    want = tuple(np.asarray(a) for a in want)
    assert got[1].dtype == np.int32 and got[0].dtype == np.float32

    live = np.arange(N) < num_valid
    if mask is not None:
        live &= mask != 0
    exact = kind == "integer" and metric != DistanceMetric.COSINE
    tol = tolerance(q, x, metric)
    s64 = exact_scores(q, x, metric, live)
    assert_topk_match(got, want, exact, tol, s64)

    # and against the reference's brute-force oracle (indices, sentinels)
    _, oi = numpy_oracle(q, np.where(live[:, None], x, np.nan), k, metric)
    n_live = int(live.sum())
    assert (got[1][:, n_live:] == -1).all()
    if exact:
        np.testing.assert_array_equal(got[1][:, :n_live], oi[:, :min(k, n_live)])


@pytest.mark.parametrize("metric", METRICS)
def test_scores_to_distances_matches_reference(metric):
    rng = np.random.default_rng(5)
    scores = rng.standard_normal((4, 6)).astype(np.float32) * 10
    qn = (rng.random(4) * 100).astype(np.float32)
    want = jax_distances_np(scores, metric, qn)
    np.testing.assert_array_equal(distances_np(scores, metric, qn), want)
    got = scores_to_distances(torch.from_numpy(scores), metric,
                              torch.from_numpy(qn)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_mask_scores_padding_and_mask():
    s = torch.ones((2, 6))
    mask = torch.tensor([1, 0, 1, 1, 1, 1], dtype=torch.float32)
    out = mask_scores(s, 10, 14, mask)
    # rows 10..15; row 11 masked, rows ≥ 14 are padding
    want = torch.tensor([1, -np.inf, 1, 1, -np.inf, -np.inf])
    assert torch.equal(out[0], want) and torch.equal(out[1], want)


def test_cosine_queries_normalized_inside():
    """Un-normalized queries give the same cosine ranking as unit ones."""
    rng = np.random.default_rng(9)
    x, q = make_data(rng, "normal", 300, 16, 3)
    norms = torch.from_numpy(sq_norms(x))
    a = exact_topk(torch.from_numpy(q * 7.5), torch.from_numpy(x), norms, 300,
                   8, DistanceMetric.COSINE)
    b = exact_topk(torch.from_numpy(unit_rows(q)), torch.from_numpy(x), norms,
                   300, 8, DistanceMetric.COSINE)
    assert torch.equal(a[1], b[1])
