"""Shared helpers for the tests that hold metrovector_tpu_torch against the
JAX package: inputs made with numpy from a seed, and one comparison rule
for two top-k results.

Tolerance on float data: each engine's f32 dot product of length D errs by
at most D·2⁻²⁴·‖q‖·‖x‖ from the exact one, and L2 doubles the dot, so two
engines' scores differ by at most ``4·D·2⁻²⁴·‖q‖·max‖x‖``; for cosine (unit
queries, rows scaled by 1/‖x‖) by ``4·D·2⁻²⁴`` plus two roundings of the
normalization, ``2⁻²²``. Indices must agree except where two rows' exact
scores lie inside that band around the k-th score (a near-tie).
"""

from __future__ import annotations

import numpy as np

from metrovector_tpu import DistanceMetric

METRICS = [DistanceMetric.L2, DistanceMetric.INNER_PRODUCT, DistanceMetric.COSINE]


def make_data(rng, kind: str, n: int, d: int, nq: int):
    """(corpus [n, d], queries [nq, d]) f32: integer values in [0, 255]
    (every L2/IP score exact in f32 for d ≤ 128) or N(0, 1)."""
    if kind == "integer":
        return (rng.integers(0, 256, (n, d)).astype(np.float32),
                rng.integers(0, 256, (nq, d)).astype(np.float32))
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((nq, d)).astype(np.float32))


def sq_norms(x) -> np.ndarray:
    return (np.asarray(x, np.float64) ** 2).sum(1).astype(np.float32)


def unit_rows(q) -> np.ndarray:
    return (q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
            ).astype(np.float32)


def tolerance(q, x, metric) -> np.ndarray:
    """Per-query bound on |score_a − score_b| between two f32 engines."""
    d = x.shape[1]
    if DistanceMetric(metric) == DistanceMetric.COSINE:
        return np.full(q.shape[0], 4 * d * 2.0**-24 + 2.0**-22)
    xmax = float(np.sqrt(sq_norms(x).max())) if len(x) else 0.0
    return 4 * d * 2.0**-24 * np.linalg.norm(q.astype(np.float64), axis=1) * xmax


def exact_scores(q, x, metric, live=None) -> np.ndarray:
    """float64 scores ``[Q, N]`` in the engines' greater-is-better
    convention (queries as given, not normalized); −inf where not live."""
    q64, x64 = np.asarray(q, np.float64), np.asarray(x, np.float64)
    dots = q64 @ x64.T
    metric = DistanceMetric(metric)
    if metric == DistanceMetric.L2:
        s = 2.0 * dots - (x64 ** 2).sum(1)[None, :]
    elif metric == DistanceMetric.COSINE:
        s = dots / np.maximum(np.linalg.norm(q64, axis=1)[:, None]
                              * np.linalg.norm(x64, axis=1)[None, :], 1e-30)
    else:
        s = dots
    if live is not None:
        s = np.where(np.asarray(live)[None, :], s, -np.inf)
    return s


def assert_topk_match(got, want, exact: bool, tol=None, scores64=None):
    """``got``/``want``: (scores [Q, k], indices [Q, k]) as numpy arrays.
    ``exact``: indices and scores bit-identical. Otherwise scores within
    ``tol`` per query and index sets equal except at near-ties."""
    s_g, i_g = (np.asarray(a) for a in got)
    s_w, i_w = (np.asarray(a) for a in want)
    assert s_g.shape == s_w.shape and i_g.shape == i_w.shape
    if exact:
        np.testing.assert_array_equal(i_g, i_w)
        np.testing.assert_array_equal(s_g, s_w)
        return
    np.testing.assert_array_equal(i_g < 0, i_w < 0)
    fin = i_w >= 0
    with np.errstate(invalid="ignore"):
        diff = np.where(fin, np.abs(s_g - s_w), 0.0)
    assert (diff <= tol[:, None]).all(), f"max score diff {diff.max()}"
    for r in range(i_g.shape[0]):
        odd = sorted(set(i_g[r][i_g[r] >= 0]) ^ set(i_w[r][i_w[r] >= 0]))
        if odd:
            boundary = s_w[r][fin[r]][-1]
            assert (np.abs(scores64[r, odd] - boundary) <= tol[r]).all(), (
                f"query {r}: rows {odd} differ outside the tie band"
            )
