"""Score conventions and the plain PyTorch exact top-k path.

The counterpart of :mod:`metrovector_tpu.ops.distances`, which is the
behavioural spec: every metric maps to a score where greater is better,

* ``INNER_PRODUCT``: ``q · x``
* ``COSINE``:        ``(q · x) / (‖q‖ ‖x‖)``
* ``L2``:            ``2 q·x − ‖x‖²`` (``‖q‖²`` is restored only when
  scores become user-facing distances)

and top-k orders by (score descending, row index ascending). Accumulation
is f32 whatever the storage dtype. f32 matmuls here run in full f32: the
setting is pinned inside each call (:func:`full_f32_matmul`), never taken
from the process-wide defaults, because TF32 keeps about three decimal
digits and visibly reorders near-ties.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..format.constants import DistanceMetric


@contextlib.contextmanager
def full_f32_matmul():
    """Run f32 matmuls in full f32 inside the block, then restore the
    caller's settings."""
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    prev_prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
        torch.set_float32_matmul_precision(prev_prec)


def split_bf16x3(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16x3 split of an f32 tensor, as the reference's ``"high"``
    kernel forms it: ``hi = bf16(t)``, ``lo = bf16(t − f32(hi))``, both
    rounded to nearest even (subnormals kept). ``t − f32(hi)`` is exact, so
    ``hi + lo`` carries about 16 significand bits of ``t``."""
    t = t.float()
    hi = t.to(torch.bfloat16)
    return hi, (t - hi.float()).to(torch.bfloat16)


def bf16x3_dots(queries: torch.Tensor, db: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q_hi·x_hi + q_hi·x_lo + q_lo·x_hi`` over f32 ``queries [Q, D]`` and
    ``db [N, D]``: three full-precision matmuls of the bf16 halves widened
    to ``dtype`` (every product exact), summed in the reference's order."""
    q_hi, q_lo = (h.to(dtype) for h in split_bf16x3(queries))
    x_hi, x_lo = (h.to(dtype) for h in split_bf16x3(db))
    with full_f32_matmul():
        dots = q_hi @ x_hi.T
        dots += q_hi @ x_lo.T
        dots += q_lo @ x_hi.T
    return dots


def int_dots(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """``[Q, N]`` f32 dots of int8 ``queries`` and ``db``: the exact integer
    sums (f64 holds every one, since |dot| ≤ 2¹⁴·D < 2⁵³), each rounded
    once to f32 as an int32 → f32 conversion rounds (to nearest even)."""
    return (queries.double() @ db.double().T).float()


def f32_scalar(x: float, device) -> torch.Tensor:
    """``x`` rounded to f32, as a 0-d tensor: an operand that multiplies in
    f32, as the reference's ``jnp.float32(x)`` does."""
    return torch.tensor(float(np.float32(x)), dtype=torch.float32, device=device)


def deferred_scale(db: torch.Tensor, metric, bias_row, scale: float) -> bool:
    """The reference's deferred-scale test (``topk_kernel.py:923-929``):
    int8 inner product with no bias and ``scale > 0`` ranks the unscaled
    dots and multiplies only the k outputs by ``scale``. Where two raw dots
    round to one scaled value, the higher raw dot stays first."""
    return (db.dtype == torch.int8
            and DistanceMetric(metric) == DistanceMetric.INNER_PRODUCT
            and bias_row is None and float(scale) > 0.0)


def int_scores_block(
    queries: torch.Tensor,
    db: torch.Tensor,
    db_norms: torch.Tensor,
    metric: DistanceMetric,
    scale: torch.Tensor | None = None,
    bias_row: torch.Tensor | None = None,
    bias_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Greater-is-better ``[Q, N]`` scores of int8 ``queries`` over int8
    ``db`` in the reference's epilogue order: ``f32(idot)·scale``, then
    ``+ bias_scale·bias_row`` (a product and a sum, each rounded to f32:
    no fused multiply-add), then the metric (cosine queries are taken as
    already normalized). ``scale`` None: the raw dots (deferred mode)."""
    dots = int_dots(queries, db)
    if scale is not None:
        dots = dots * scale
    if bias_row is not None:
        dots = dots + bias_scale * bias_row[None, :]
    metric = DistanceMetric(metric)
    if metric == DistanceMetric.INNER_PRODUCT:
        return dots
    if metric == DistanceMetric.L2:
        return 2.0 * dots - db_norms[None, :]
    if metric == DistanceMetric.COSINE:
        return dots * (1.0 / torch.sqrt(torch.clamp(db_norms, min=1e-30)))[None, :]
    raise NotImplementedError(f"metric {metric!r} has no built-in score kernel")


def exact_topk_int(
    queries: torch.Tensor,
    db: torch.Tensor,
    db_norms: torch.Tensor,
    num_valid: int,
    k: int,
    metric: DistanceMetric,
    valid_mask: torch.Tensor | None = None,
    scale: float = 1.0,
    bias_row: torch.Tensor | None = None,
    bias_scale: float = 0.0,
    block_rows: int = 16384,
    raw_scores: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of int8 ``queries`` over int8 ``db`` in plain PyTorch
    (:func:`int_scores_block`, blocks and ties as :func:`exact_topk`): the
    reference kernel's integer path. ``scale``, ``bias_scale`` round to
    f32 as the reference passes them; in the deferred mode
    (:func:`deferred_scale`) the raw dots are ranked and the k outputs
    scaled, unless ``raw_scores``."""
    dev = queries.device
    defer = deferred_scale(db, metric, bias_row, scale)
    sc = f32_scalar(scale, dev)
    bs = None if bias_row is None else f32_scalar(bias_scale, dev)
    nq, n = queries.shape[0], db.shape[0]
    best = empty_topk(nq, dev)
    for start in range(0, n, block_rows):
        stop = min(n, start + block_rows)
        s = int_scores_block(
            queries, db[start:stop], db_norms[start:stop], metric,
            None if defer else sc,
            None if bias_row is None else bias_row[start:stop], bs)
        vm = None if valid_mask is None else valid_mask[start:stop]
        best = carry_topk(best, mask_scores(s, start, num_valid, vm), start, k)
    out_s, out_i = finish_topk(best, k)
    return (out_s * sc if defer and not raw_scores else out_s), out_i


def dequantize_rows(db: torch.Tensor, affine: tuple[float, float]) -> torch.Tensor:
    """f32 rows ``(c + off)·scale`` of int8 codes ``db``, ``affine = (off,
    scale)``, each step rounded to f32: the reference's dequantizing read of
    recentred uint8 codes (``off = 128 − zero_point``)."""
    off, sc = (f32_scalar(v, db.device) for v in affine)
    return (db.float() + off) * sc


def scores_block(
    queries: torch.Tensor,
    db: torch.Tensor,
    db_norms: torch.Tensor,
    metric: DistanceMetric,
    query_inv_norms: torch.Tensor | None = None,
    precision: str = "highest",
) -> torch.Tensor:
    """Greater-is-better score matrix ``[Q, N]`` for one corpus block.
    ``db`` may be any float dtype; it is widened to f32 (exact for f16 and
    bf16). ``query_inv_norms``: ``[Q]`` reciprocal query norms (cosine).
    ``precision="high"``: the dots are :func:`bf16x3_dots` of f32 inputs."""
    if precision == "high":
        dots = bf16x3_dots(queries, db)
    else:
        with full_f32_matmul():
            dots = queries.float() @ db.float().T
    metric = DistanceMetric(metric)
    if metric == DistanceMetric.INNER_PRODUCT:
        return dots
    if metric == DistanceMetric.L2:
        return 2.0 * dots - db_norms[None, :]
    if metric == DistanceMetric.COSINE:
        inv_db = 1.0 / torch.sqrt(torch.clamp(db_norms, min=1e-30))
        if query_inv_norms is None:
            q32 = queries.float()
            query_inv_norms = 1.0 / torch.sqrt(
                torch.clamp((q32 * q32).sum(-1), min=1e-30)
            )
        return dots * inv_db[None, :] * query_inv_norms[:, None]
    raise NotImplementedError(f"metric {metric!r} has no built-in score kernel")


def scores_to_distances(
    scores: torch.Tensor, metric: DistanceMetric,
    query_sq_norms: torch.Tensor | None = None,
) -> torch.Tensor:
    """Internal scores → the user-facing quantity: Euclidean distance for
    L2 (ascending), similarity for cosine, dot product for IP."""
    metric = DistanceMetric(metric)
    if metric == DistanceMetric.L2:
        if query_sq_norms is None:
            raise ValueError("L2 distance conversion requires query norms")
        return torch.sqrt(torch.clamp(query_sq_norms[:, None] - scores, min=0.0))
    return scores


def distances_np(scores, metric: DistanceMetric, query_sq_norms=None):
    """NumPy twin of :func:`scores_to_distances` for host-side result
    finalization."""
    metric = DistanceMetric(metric)
    scores = np.asarray(scores)
    if metric == DistanceMetric.L2:
        if query_sq_norms is None:
            raise ValueError("L2 distance conversion requires query norms")
        return np.sqrt(
            np.maximum(np.asarray(query_sq_norms)[:, None] - scores, 0.0)
        )
    return scores


def mask_scores(
    scores: torch.Tensor,
    row_offset: int,
    num_valid: int,
    valid_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Force padded rows (global row ≥ ``num_valid``) and tombstoned rows
    (``valid_mask == 0``) to −inf so they never enter the top-k."""
    n = scores.shape[1]
    rows = row_offset + torch.arange(n, device=scores.device)
    neg_inf = torch.tensor(float("-inf"), device=scores.device)
    out = torch.where(rows[None, :] < num_valid, scores, neg_inf)
    if valid_mask is not None:
        out = torch.where(valid_mask[None, :] != 0, out, neg_inf)
    return out


def exact_topk(
    queries: torch.Tensor,
    db: torch.Tensor,
    db_norms: torch.Tensor,
    num_valid: int,
    k: int,
    metric: DistanceMetric,
    valid_mask: torch.Tensor | None = None,
    block_rows: int = 16384,
    query_inv_norms: torch.Tensor | None = None,
    precision: str = "highest",
    affine: tuple[float, float] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k in plain PyTorch, the twin of ``exact_topk_xla``: scans
    the corpus in ``block_rows`` blocks with a carried candidate list, so
    ``[Q, N]`` never exists whole. Returns ``(scores [Q, k] f32,
    indices [Q, k] int32)`` best first; slots beyond the unmasked rows hold
    (−inf, −1). ``precision="high"`` scores by :func:`bf16x3_dots`.
    ``affine``: ``db`` holds int8 codes, dequantized a block at a time by
    :func:`dequantize_rows`.

    Ties go to the lowest index (:func:`carry_topk`). ``torch.topk``
    promises no tie order and is not used."""
    metric = DistanceMetric(metric)
    q = queries.float()
    if metric == DistanceMetric.COSINE and query_inv_norms is None:
        query_inv_norms = 1.0 / torch.sqrt(
            torch.clamp((q * q).sum(-1), min=1e-30)
        )
    nq, n = q.shape[0], db.shape[0]
    best = empty_topk(nq, q.device)
    for start in range(0, n, block_rows):
        stop = min(n, start + block_rows)
        blk = db[start:stop]
        if affine is not None:
            blk = dequantize_rows(blk, affine)
        s = scores_block(q, blk, db_norms[start:stop], metric,
                         query_inv_norms, precision)
        vm = None if valid_mask is None else valid_mask[start:stop]
        best = carry_topk(best, mask_scores(s, start, num_valid, vm), start, k)
    return finish_topk(best, k)


def empty_topk(nq: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The carried candidates before the first block: none."""
    return (torch.empty((nq, 0), dtype=torch.float32, device=device),
            torch.empty((nq, 0), dtype=torch.int64, device=device))


def carry_topk(best, s: torch.Tensor, start: int, k: int):
    """Merge one block's scores ``s [Q, B]`` (rows ``start .. start+B-1``)
    into the carried candidates ``best`` and keep the k best. The carried
    candidates (earlier rows) come first and each part is in ascending row
    order among equal scores, so one stable sort on −score orders by
    (score descending, row ascending)."""
    nq = s.shape[0]
    idx = torch.arange(start, start + s.shape[1], device=s.device).expand(nq, -1)
    return carry_topk_ids(best, s, idx, k)


def carry_topk_ids(best, s: torch.Tensor, ids: torch.Tensor, k: int):
    """:func:`carry_topk` with explicit ids ``ids [Q, B]`` (int64) for the
    block's columns, in any order: among equal scores the carried
    candidates come first, then the block's in column order, as
    ``lax.top_k`` over ``[carried, block]`` keeps them by position."""
    best_s, best_i = best
    cand_s = torch.cat([best_s, s], dim=1)
    cand_i = torch.cat([best_i, ids], dim=1)
    order = torch.sort(-cand_s, dim=1, stable=True).indices[:, :k]
    return torch.gather(cand_s, 1, order), torch.gather(cand_i, 1, order)


def finish_topk(best, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Carried candidates → ``(scores [Q, k] f32, indices [Q, k] int32)``,
    padded with (−inf, −1) where fewer than k rows were scanned; −inf
    slots carry −1."""
    best_s, best_i = best
    nq, dev = best_s.shape[0], best_s.device
    if best_s.shape[1] < k:  # fewer rows than k: pad with sentinels
        pad = k - best_s.shape[1]
        best_s = torch.cat(
            [best_s, torch.full((nq, pad), float("-inf"), device=dev)], dim=1
        )
        best_i = torch.cat(
            [best_i, torch.full((nq, pad), -1, dtype=torch.int64, device=dev)],
            dim=1,
        )
    best_i = torch.where(torch.isneginf(best_s), -1, best_i)
    return best_s, best_i.to(torch.int32)


def rescore_topk(
    queries: torch.Tensor,
    db: torch.Tensor,
    db_norms: torch.Tensor,
    cand_idx: torch.Tensor,
    k: int,
    metric: DistanceMetric,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 re-scoring of a candidate set, the verified top-k: the
    counterpart of ``metrovector_tpu.ops.distances.rescore_topk`` (the
    ``high_verified`` repair leg). ``queries``: ``[Q, D]`` f32 (cosine
    queries pre-normalized); ``cand_idx``: ``[Q, R]`` rows, ``-1`` for an
    unfilled slot. Ties break to the lowest row index. Runs through the
    gather + rescore kernel (:func:`.gather_kernel.rescore_candidates`) on
    CUDA tensors and its plain version on CPU tensors."""
    from .gather_kernel import rescore_candidates

    return rescore_candidates(queries, db, db_norms, cand_idx, k, metric,
                              tie="row")


def numpy_oracle(queries, db, k, metric, valid_mask=None):
    """Brute force in NumPy with float64 sums, the reference's ground truth
    (``metrovector_tpu.ops.distances.numpy_oracle``). Scores are ranked
    after a cast to f32, so rows whose f64 scores differ below an f32 ulp
    (BLAS blocking of duplicate rows) tie, and ties go to the lowest row.
    Returns (scores [Q, k], indices [Q, k])."""
    q = np.asarray(queries, dtype=np.float64)
    x = np.asarray(db, dtype=np.float64)
    metric = DistanceMetric(metric)
    if metric == DistanceMetric.L2:
        s = -((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        s += (q * q).sum(-1)[:, None]
    elif metric == DistanceMetric.COSINE:
        s = (q @ x.T) / np.maximum(
            np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(x, axis=1)[None, :],
            1e-30)
    elif metric == DistanceMetric.INNER_PRODUCT:
        s = q @ x.T
    else:
        raise NotImplementedError(metric)
    if valid_mask is not None:
        s = np.where(np.asarray(valid_mask)[None, :] != 0, s, -np.inf)
    s = s.astype(np.float32)
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, idx, axis=1), idx
