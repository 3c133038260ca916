"""The port's row gather and gather + rescore (on CPU tensors, their plain
versions) against the JAX package: the Pallas ``gather_rows`` in interpret
mode (a gather is a byte copy: bit-identical, clamping included),
``rescore_topk`` (ties to the lowest row) and the PQ re-rank
``_rerank_impl`` (ties to the candidate's position). On integer-valued
data every L2/IP score is exact in f32, so results must be identical;
cosine is held to the f32 band of ``_torch_parity``."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from metrovector_tpu import DistanceMetric
from metrovector_tpu.index.pq import _rerank_impl
from metrovector_tpu.ops.distances import rescore_topk as jax_rescore_topk
from metrovector_tpu.ops.gather_kernel import gather_rows as jax_gather_rows
from metrovector_tpu_torch.ops import gather_kernel
from metrovector_tpu_torch.ops.distances import rescore_topk
from metrovector_tpu_torch.ops.gather_kernel import (
    gather_rows,
    gather_rows_reference,
    rescore_candidates,
)
from metrovector_tpu_torch.ops.select import merge_scratch
from metrovector_tpu_torch.ops.topk_kernel import SMEM_LIMIT

from _torch_parity import METRICS, assert_topk_match, exact_scores, sq_norms, tolerance


def _as_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "uint8"])
def test_gather_reference_bit_identical_to_pallas(dtype):
    """Including indices below 0 and at or above N (clamped)."""
    rng = np.random.default_rng(1)
    n, d = 104, 24
    db = (rng.standard_normal((n, d)) * 50).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)
    idx = np.concatenate([rng.integers(0, n, 29), [-1, 0, 103, 104, 5_000_000, -7]]
                         ).astype(np.int32)
    want = np.asarray(jax_gather_rows(jnp.asarray(db), jnp.asarray(idx),
                                      interpret=True))
    got = gather_rows(_as_torch(db), torch.from_numpy(idx))
    assert gather_rows.launches == 0  # CPU tensors take the plain version
    want_t = _as_torch(np.ascontiguousarray(want))
    assert got.dtype == want_t.dtype and got.shape == want_t.shape
    np.testing.assert_array_equal(_bits(got), _bits(want_t))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_gather_reference_f16_and_index_types(dtype):
    """f16 (which the TPU kernel lacked), int32 and int64 indices; any N,
    no N % 8 rule."""
    db = torch.arange(7 * 5, dtype=torch.float32).reshape(7, 5).to(torch.float16)
    idx = torch.tensor([6, -2, 9, 3], dtype=dtype)
    got = gather_rows(db, idx)
    assert torch.equal(got, db[torch.tensor([6, 0, 6, 3])])
    assert torch.equal(got, gather_rows_reference(db, idx))


def _rescore_inputs(seed, n=200, d=16, nq=6, r=40, dup=False):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 16, (n, d)).astype(np.float32)
    if dup:  # every row has twins: exact ties between different rows
        x = x[rng.integers(0, n // 8, n)]
    q = rng.integers(0, 16, (nq, d)).astype(np.float32)
    cand = np.stack([rng.permutation(n)[:r] for _ in range(nq)]).astype(np.int32)
    cand[:, -3:] = -1  # unfilled slots
    return x, q, cand


@pytest.mark.parametrize("metric", METRICS)
def test_rescore_topk_matches_reference(metric):
    x, q, cand = _rescore_inputs(2, dup=True)
    if metric == DistanceMetric.COSINE:
        q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    norms = sq_norms(x)
    got = rescore_topk(torch.from_numpy(q), torch.from_numpy(x),
                       torch.from_numpy(norms), torch.from_numpy(cand), 12, metric)
    want = jax_rescore_topk(q, x, norms, cand, 12, metric)
    live = np.zeros(len(x), bool)
    live[cand[cand >= 0]] = True
    assert_topk_match(tuple(t.numpy() for t in got),
                      tuple(np.asarray(a) for a in want),
                      exact=metric != DistanceMetric.COSINE,
                      tol=tolerance(q, x, metric),
                      scores64=exact_scores(q, x, metric, live))


@pytest.mark.parametrize("metric", METRICS)
def test_pq_rerank_matches_reference_tie_rules(metric):
    """On a corpus of duplicate rows the PQ re-rank (ties to position) equals
    ``_rerank_impl``, the row tie rule equals ``rescore_topk``, and the two
    rules give different orders, as they should."""
    x, q, cand = _rescore_inputs(3, dup=True)
    norms = sq_norms(x)
    args = (torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(norms),
            torch.from_numpy(cand), 15, metric)
    by_pos = rescore_candidates(*args, tie="position")
    by_row = rescore_candidates(*args, tie="row")
    want_pos = _rerank_impl(q, x, norms, cand, 15, metric, False)
    want_row = jax_rescore_topk(q, x, norms, cand, 15, metric)
    exact = metric != DistanceMetric.COSINE
    live = np.zeros(len(x), bool)
    live[cand[cand >= 0]] = True
    for got, want in ((by_pos, want_pos), (by_row, want_row)):
        assert_topk_match(tuple(t.numpy() for t in got),
                          tuple(np.asarray(a) for a in want), exact=exact,
                          tol=tolerance(q, x, metric),
                          scores64=exact_scores(q, x, metric, live))
    if exact:
        assert not np.array_equal(by_pos[1].numpy(), by_row[1].numpy())
        np.testing.assert_array_equal(by_pos[0].numpy(), by_row[0].numpy())


@pytest.mark.parametrize("r, k", [(4097, 10), (5000, 257), (8192, 8192)])
@pytest.mark.parametrize("tie", ["position", "row"])
def test_rescore_any_r_matches_reference(r, k, tie):
    """More candidates than the old 4096 (the kernel then sorts chunks and
    merges them), in both tie modes, on a corpus of duplicate rows; R = k
    keeps every candidate."""
    rng = np.random.default_rng(7)
    n = 9000
    x = rng.integers(0, 16, (n // 8, 16)).astype(np.float32)[rng.integers(0, n // 8, n)]
    q = rng.integers(0, 16, (3, 16)).astype(np.float32)
    cand = np.stack([rng.permutation(n)[:r] for _ in range(3)]).astype(np.int32)
    cand[:, ::11] = -1
    norms = sq_norms(x)
    got = rescore_candidates(torch.from_numpy(q), torch.from_numpy(x),
                             torch.from_numpy(norms), torch.from_numpy(cand), k,
                             DistanceMetric.L2, tie=tie)
    if tie == "position":
        want = _rerank_impl(q, x, norms, cand, k, DistanceMetric.L2, False)
    else:
        want = jax_rescore_topk(q, x, norms, cand, k, DistanceMetric.L2)
    assert_topk_match(tuple(t.numpy() for t in got),
                      tuple(np.asarray(a) for a in want), exact=True)


def test_rescore_invalid_candidates_are_sentinels():
    x, q, cand = _rescore_inputs(4, r=8)
    cand[0, :] = -1
    cand[1, 2:] = -1
    s, i = rescore_candidates(torch.from_numpy(q), torch.from_numpy(x),
                              torch.from_numpy(sq_norms(x)),
                              torch.from_numpy(cand), 5, DistanceMetric.L2)
    assert (i[0] == -1).all() and torch.isneginf(s[0]).all()
    assert (i[1, :2] >= 0).all() and (i[1, 2:] == -1).all()


@pytest.mark.parametrize("name", ["k_zero", "k_above_r", "tie", "cand_shape"])
def test_rescore_argument_checks_raise(name):
    x, q, cand = _rescore_inputs(5, r=8)
    k, tie = 3, "position"
    if name == "k_zero":
        k = 0
    elif name == "k_above_r":
        k = 9
    elif name == "tie":
        tie = "score"
    elif name == "cand_shape":
        cand = cand[:2]
    with pytest.raises(ValueError):
        rescore_candidates(torch.from_numpy(q), torch.from_numpy(x),
                           torch.from_numpy(sq_norms(x)),
                           torch.from_numpy(cand), k, DistanceMetric.L2, tie=tie)


def test_rescore_kernel_checks_raise():
    from metrovector_tpu_torch.ops import gather_kernel

    q, x = torch.zeros((2, 8)), torch.zeros((10, 8))
    for bad in ((q, x.to(torch.int8), torch.zeros(10)),
                (q, torch.zeros((10, 6)), torch.zeros(10)),
                (q, x, torch.zeros(11))):
        with pytest.raises(ValueError):
            gather_kernel._check_rescore(*bad, torch.zeros((2, 4), dtype=torch.int32), 2)


def _emulate_plan(scores, keys, plan, k):
    """The kernel's selection on the host: each split's best list_len by
    (score descending, key ascending, position), then the splits' lists
    merged stably in split order, the first k kept."""
    r = scores.shape[0]
    lists = []
    for s in range(plan.splits):
        pos = np.arange(s * plan.split_len, min(r, (s + 1) * plan.split_len))
        order = np.lexsort((pos, keys[pos], -scores[pos]))[:plan.list_len]
        lists.append(pos[order])
    merged = np.concatenate(lists)
    order = np.lexsort((np.arange(len(merged)), keys[merged], -scores[merged]))
    return merged[order][:k]


@pytest.mark.parametrize("r", [1, 37, 400, 4096, 4097, 20_000])
@pytest.mark.parametrize("nq", [1, 32, 256, 4097])
def test_rescore_plan_covers_every_candidate_once(nq, r):
    """Every candidate falls in exactly one split; the splits' lists hold
    at least k entries; no more splits than scoring passes over R, and no
    split longer than SPLIT_MAX; the batch's blocks fill the
    card where the candidates allow; the last-block merge is planned only
    for k <= WARP_LIST and stays within its bounds, and the merge tree's
    scratch is what select.merge_scratch says; and the block's shared
    memory fits at D = 128 and D = 3072."""
    sms = 132
    for k in sorted({1, min(10, r), min(300, r), r}):
        for d in (128, 3072):
            plan = gather_kernel.rescore_plan(nq, r, k, d, sms)
            starts = np.arange(plan.splits) * plan.split_len
            covered = np.concatenate([np.arange(a, min(r, a + plan.split_len))
                                      for a in starts])
            np.testing.assert_array_equal(covered, np.arange(r))
            assert (plan.splits - 1) * plan.split_len < r
            assert plan.split_len <= gather_kernel.SPLIT_MAX
            assert plan.splits <= -(-r // gather_kernel.PASS)  # no split below half a pass
            assert plan.list_len == min(k, plan.split_len)
            assert plan.splits * plan.list_len >= k
            want = gather_kernel.BLOCKS_PER_SM * sms
            fill = min(want, nq * -(-r // gather_kernel.PASS),
                       nq * gather_kernel.MAX_SPLITS)
            assert nq * plan.splits >= min(fill, want) or plan.splits == -(
                -r // gather_kernel.PASS)
            if plan.splits == 1:
                assert plan.merge == gather_kernel.MERGE_NONE and plan.part == 0
            elif plan.merge == gather_kernel.MERGE_BLOCK:
                assert k <= gather_kernel.WARP_LIST  # the fold is a warp selection
                assert plan.splits <= gather_kernel.MAX_SPLITS
                assert plan.part == plan.splits * plan.list_len <= gather_kernel.MERGE_ENTRIES
                assert plan.room >= plan.part + gather_kernel.WARPS * gather_kernel.WARP_LIST
            else:
                assert (plan.part, plan.tmp) == merge_scratch(
                    plan.splits, plan.list_len, k)
            if plan.list_len <= gather_kernel.WARP_LIST:
                assert plan.sort_len == plan.split_len
                assert plan.room >= gather_kernel.WARPS * gather_kernel.WARP_LIST
            else:
                assert plan.sort_len >= plan.split_len
                assert plan.sort_len & (plan.sort_len - 1) == 0
            assert plan.smem <= SMEM_LIMIT


@pytest.mark.parametrize("nq", [1, 32, 256])
@pytest.mark.parametrize("r, k", [(400, 10), (4097, 100), (20_000, 10)])
def test_rescore_plan_selection_matches_one_sort(nq, r, k):
    """The plan's split-then-merge selection, emulated on the host, picks
    what one stable sort of all candidates picks, with many exact ties
    (scores from 5 values, keys from 50 rows)."""
    rng = np.random.default_rng(r + nq)
    scores = rng.integers(0, 5, r).astype(np.float64)
    keys = rng.integers(0, 50, r)
    plan = gather_kernel.rescore_plan(nq, r, k, 128, 132)
    want = np.lexsort((np.arange(r), keys, -scores))[:k]
    np.testing.assert_array_equal(_emulate_plan(scores, keys, plan, k), want)


@pytest.mark.parametrize("tie", ["position", "row"])
@pytest.mark.parametrize("nq, r", [(1, 400), (32, 400), (256, 400), (32, 4097)])
def test_rescore_twins_across_splits_match_reference(nq, r, tie):
    """Twin rows placed in different splits of the plan (the first and the
    last split hold copies of the same rows), and one split whose
    candidates are all -1, held against ``_rerank_impl`` (ties by
    position) and ``rescore_topk`` (ties by row)."""
    rng = np.random.default_rng(9)
    n, d, k = 600, 16, 10
    x = rng.integers(0, 8, (n, d)).astype(np.float32)
    x[300:] = x[:300]  # row i + 300 is row i's twin
    q = rng.integers(0, 8, (nq, d)).astype(np.float32)
    plan = gather_kernel.rescore_plan(nq, r, k, d, 132)
    cand = rng.integers(0, n, (nq, r)).astype(np.int32)
    twins = rng.integers(0, 300, (nq, 8))
    cand[:, :8] = twins + 300  # the twin with the higher row comes first
    cand[:, -8:] = twins
    if plan.splits > 2:
        cand[:, plan.split_len:2 * plan.split_len] = -1  # the second split: empty
    norms = sq_norms(x)
    got = rescore_candidates(torch.from_numpy(q), torch.from_numpy(x),
                             torch.from_numpy(norms), torch.from_numpy(cand), k,
                             DistanceMetric.L2, tie=tie)
    if tie == "position":
        want = _rerank_impl(q, x, norms, cand, k, DistanceMetric.L2, False)
    else:
        want = jax_rescore_topk(q, x, norms, cand, k, DistanceMetric.L2)
    assert_topk_match(tuple(t.numpy() for t in got),
                      tuple(np.asarray(a) for a in want), exact=True)
