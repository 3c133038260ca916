"""The schedule of K2's bucket kernel (``csrc/adc_bucket_kernel.cu``), the
IVF-PQ scan's kernel, on the CPU.

The kernel cannot run here, so its schedule has a plain form,
``ivf_scan_plan``: per tile of queries the union of the buckets they probe,
cut into chunks of 32 slots, shared by the splits. These tests hold that
plan to covering every probed (query, slot) pair once, and a torch
emulation of the kernel's order (per-split lists over the plan's chunks,
merged by (score descending, row ascending), as ``rank_key`` orders them)
to the plain version ``fused_adc_topk_reference`` bit for bit: over the
three metrics, 4-bit packed and 8-bit codes, f32 and bf16 LUTs, ties at the
nprobe-th bucket (split cells), tombstones after ``delete_rows``, a filter,
a fetch above the probed rows, duplicate rows in different buckets, and the
row-order form's rows in no bucket (grouped as the CUDA path groups them).
Then the emulation stands in for the kernel inside ``IVFPQIndex.search``
and the slice is held against the JAX package's scan (interpret mode).

Tolerance: none. The emulation adds the LUT entries and the bias in the
plain version's order, so scores and indices must be identical; the JAX
cases use integer data (``test_torch_ivfpq.py``), where every sum is exact.
"""

import numpy as np
import pytest
import torch

from metrovector_tpu import DistanceMetric
from metrovector_tpu_torch.index import ivfpq as ivfpq_mod
from metrovector_tpu_torch.index.ivfpq import IVFPQIndex
from metrovector_tpu_torch.index.pq import pack_codes4
from metrovector_tpu_torch.ops import adc_kernel, select
from metrovector_tpu_torch.ops.adc_kernel import (
    CHUNK, DEAD_BIAS, _bucket_layout, _group_layout, adc_lut, bucket_splits,
    fused_adc_topk, fused_adc_topk_reference, ivf_scan_plan, lut_bias,
    unpack_nibbles,
)

from _torch_parity import METRICS
from test_torch_ivfpq import _ref_index, _same, _recon, state_of

# --------------------------------------------------------------- the plan ---


def _random_probes(rng, nq, nb, per_query, groups=None):
    probed = np.zeros((nq, nb), bool)
    for r in range(nq):
        probed[r, rng.choice(groups or nb, per_query, replace=False)] = True
    if groups is not None:
        probed[:, groups:] = True  # the no-bias bucket: every query
    return probed


@pytest.mark.parametrize("qt,splits", [(1, 1), (1, 5), (4, 3), (8, 40), (32, 7)])
@pytest.mark.parametrize("seed", [0, 1])
def test_plan_covers_every_probed_pair_once(seed, qt, splits):
    """Each query's probed (bucket, slot) pairs are covered exactly once by
    its tile's splits; every chunk is one bucket's, at most 32 slots, in
    ascending bucket order over the tile's splits, and no bucket outside
    the tile's union is read."""
    rng = np.random.default_rng(seed)
    nq, nb = 37, 90
    counts = rng.integers(0, 150, nb)
    counts[::11] = 0  # empty buckets have no chunk
    probed = _random_probes(rng, nq, nb, 6, groups=nb - 1)
    plan = ivf_scan_plan(probed, counts, qt, splits)
    assert len(plan) == -(-nq // qt)
    for t, shares in enumerate(plan):
        assert len(shares) == splits
        union = probed[t * qt:(t + 1) * qt].any(0)
        flat = [c for share in shares for c in share]
        per = -(-len(flat) // splits)
        assert all(len(share) <= per for share in shares)
        assert [b for b, _, _ in flat] == sorted(b for b, _, _ in flat)
        seen = {}
        for b, j, n in flat:
            assert union[b] and 0 < n <= CHUNK and j % CHUNK == 0 and j + n <= counts[b]
            for slot in range(j, j + n):
                seen[(b, slot)] = seen.get((b, slot), 0) + 1
        assert set(seen.values()) <= {1}
        want = {(b, s) for b in np.flatnonzero(union) for s in range(counts[b])}
        assert set(seen) == want
        for r in range(t * qt, min(nq, (t + 1) * qt)):  # each query's pairs
            mine = {(b, s) for b in np.flatnonzero(probed[r]) for s in range(counts[b])}
            assert mine <= set(seen)


def test_plan_of_a_tile_that_probes_nothing():
    plan = ivf_scan_plan(np.zeros((3, 5), bool), np.full(5, 40), 2, 4)
    assert plan == [[[]] * 4, [[]] * 4]


@pytest.mark.parametrize("nq,qt,k,smem,want", [
    (256, 1, 400, True, 2),      # one wave of 528 blocks
    (32, 1, 400, True, 16),
    (8, 1, 400, True, 66),
    (1, 1, 400, True, 128),      # at most BUCKET_MAX_SPLITS
    (256, 4, 400, True, 8),
    (4096, 1, 2000, False, 1),   # device lists: the scratch bound
    (64, 1, 3000, False, 8),
])
def test_bucket_splits(nq, qt, k, smem, want):
    s = bucket_splits(nq, qt, 132 * 4, k, smem)
    assert s == want
    assert 1 <= s <= adc_kernel.BUCKET_MAX_SPLITS <= select.MAX_SPLITS
    if not smem and s > 1:
        assert nq * s * k * 8 <= select.SCRATCH_BYTES


@pytest.mark.parametrize("splits,k,smem,want", [
    (2, 400, True, False), (8, 400, True, False), (9, 400, True, True),
    (108, 10, True, True), (1, 3000, False, True),
])
def test_bucket_merge_by_tree(splits, k, smem, want):
    """The merge tree folds the bucket kernel's lists past 8 splits at any
    k (and always for lists in device memory)."""
    assert adc_kernel.bucket_merge_by_tree(splits, k, smem) == want


def test_group_layout_groups_rows_by_bucket():
    """The row-order form on CUDA: rows grouped by bucket on the device, in
    ascending row order, and the rows of no bucket (−1, or ≥ G) last, as
    bucket G."""
    gids = torch.tensor([2, 0, -1, 2, 5, 1, 0, 2], dtype=torch.int32)
    codes = torch.arange(16, dtype=torch.uint8).reshape(8, 2)
    norms = torch.arange(8, dtype=torch.float32)
    bcodes, ids, bnorms, starts, stride, counts = _group_layout(codes, norms, gids, 3)
    assert ids.dtype == torch.int32 and counts.dtype == torch.int32
    assert ids.tolist() == [1, 6, 5, 0, 3, 7, 2, 4]
    assert counts.tolist() == [2, 1, 3, 2] and starts.tolist() == [0, 2, 3, 6]
    assert torch.equal(bcodes, codes[ids.long()]) and torch.equal(bnorms, norms[ids.long()])
    assert stride == 0


# ----------------------------------------------- the kernel's order, emulated ---


def _emulate(q, books, layout, bias, num_valid, k, metric, mask, exact_lut,
             packed4, qt, splits):
    """The bucket kernel's answer in plain torch, in its order: for each
    tile of ``qt`` queries and each split, the plan's chunks scored as the
    kernel scores them (the m lookups in ascending j in f32, then the bias,
    the −1e28 rule, the metric), each split's k best rows by (score
    descending, row ascending), then those lists merged by the same key."""
    codes2d, ids, norms, starts, stride, counts = layout
    metric = DistanceMetric(metric)
    m, ksub, _ = books.shape
    nq = q.shape[0]
    lut = adc_lut(q, books, exact_lut).float()
    gb = lut_bias(bias, exact_lut)
    groups, nb = gb.shape[1], counts.shape[0]
    probed = np.ones((nq, nb), bool)
    probed[:, :groups] = (gb > DEAD_BIAS).numpy()
    first = (starts.numpy() if starts is not None
             else np.arange(nb, dtype=np.int64) * stride)
    out_s = torch.full((nq, k), float("-inf"))
    out_i = torch.full((nq, k), -1, dtype=torch.int32)
    for t, shares in enumerate(ivf_scan_plan(probed, counts.numpy(), qt, splits)):
        qs = torch.arange(t * qt, min(nq, (t + 1) * qt))
        lists = [[] for _ in qs]
        for share in shares:
            if not share:
                continue
            slot = torch.from_numpy(np.concatenate(
                [first[b] + j + np.arange(n) for b, j, n in share]))
            bkt = torch.from_numpy(np.concatenate([np.full(n, b) for b, _, n in share]))
            rows = ids[slot].long()
            blk = codes2d[slot]
            if packed4:
                blk = unpack_nibbles(blk, m)
            blk = blk.long()
            acc = torch.zeros((len(qs), len(slot)))
            for j in range(m):  # ascending j, in f32
                acc = acc + lut[qs][:, j * ksub + blk[:, j]]
            biased = (bkt < groups)[None, :]
            b = gb[qs][:, bkt.clamp(max=groups - 1)]
            probes = ~biased | (b > DEAD_BIAS)
            acc = torch.where(biased & probes, acc + b, acc)
            ok = probes & (acc > DEAD_BIAS)
            nrm = norms[slot][None, :]
            if metric == DistanceMetric.L2:
                s = 2.0 * acc - nrm
            elif metric == DistanceMetric.COSINE:
                s = acc * (1.0 / torch.sqrt(torch.clamp(nrm, min=1e-30)))
            else:
                s = acc
            live = (rows >= 0) & (rows < num_valid)
            if mask is not None:
                live &= mask[rows.clamp(min=0)] != 0
            s = torch.where(ok & live[None, :], s, float("-inf"))
            for r in range(len(qs)):
                lists[r].append(_best(s[r], rows, k))
        for r, parts in enumerate(lists):
            if parts:
                sc, rw = _best(torch.cat([p[0] for p in parts]),
                               torch.cat([p[1] for p in parts]), k)
                out_s[qs[r], :len(sc)] = sc
                out_i[qs[r], :len(rw)] = rw.to(torch.int32)
    return out_s, out_i


def _best(s, rows, k):
    """The k best finite (score, row) pairs by (score descending, row
    ascending): the order of ``rank_key`` (−0 ties +0)."""
    keep = torch.isfinite(s)
    s, rows = s[keep], rows[keep]
    order = np.lexsort((rows.numpy(), -s.numpy().astype(np.float64)))[:k]
    return s[order], rows[order]


def _bit_identical(got, ref, what):
    gs, gi = got
    rs, ri = ref
    assert torch.equal(gi, ri), what
    assert torch.equal(gs.view(torch.int32), rs.view(torch.int32)), what


def _bucketed(rng, n, groups, bsize, kind, m, ksub, twins=False):
    """Row-order inputs and the same rows in a [G, B] bucket layout (as
    ``fill_buckets`` lays them out: padding −1 past each fill), with
    tombstoned slots (id −1 inside the fill, mask 0) and, with ``twins``,
    duplicate rows planted in other buckets."""
    if kind == "integer":
        books = rng.integers(0, 8, (m, ksub, 4)).astype(np.float32)
    else:
        books = rng.standard_normal((m, ksub, 4)).astype(np.float32)
    codes = rng.integers(0, ksub, (n, m)).astype(np.uint8)
    gids = rng.integers(0, groups, n).astype(np.int32)
    if twins:  # rows 0..39 copied to 40..79 in other buckets
        codes[40:80] = codes[:40]
        gids[40:80] = (gids[:40] + 1 + rng.integers(0, groups - 1, 40)) % groups
    recon = np.concatenate([books[j][codes[:, j]] for j in range(m)], 1)
    rn = (recon.astype(np.float64) ** 2).sum(1).astype(np.float32)
    if twins:
        rn[40:80] = rn[:40]
    mask = np.ones(n, np.float32)
    dead = rng.random(n) < 0.08
    mask[dead] = 0
    bcodes = np.zeros((groups, bsize, m), np.uint8)
    bids = np.full((groups, bsize), -1, np.int32)
    bnorms = np.zeros((groups, bsize), np.float32)
    fill = np.zeros(groups, np.int32)
    for g in range(groups):
        rows = np.flatnonzero(gids == g)
        rng.shuffle(rows)  # any order inside a bucket
        bcodes[g, :len(rows)] = codes[rows]
        bids[g, :len(rows)] = np.where(dead[rows], -1, rows)  # tombstones: −1
        bnorms[g, :len(rows)] = rn[rows]
        fill[g] = len(rows)
    return books, codes, gids, rn, mask, (bcodes, bids, bnorms, fill)


def _bias(rng, nq, groups, per_query, kind, tie=True):
    bias = np.full((nq, groups), -1e30, np.float32)
    for r in range(nq):
        probed = rng.choice(groups, per_query, replace=False)
        vals = (rng.integers(-3000, 3000, per_query).astype(np.float32) if kind == "integer"
                else (rng.standard_normal(per_query) * 1000).astype(np.float32))
        if tie:
            vals[1] = vals[0]
        bias[r, probed] = vals
    return bias


EMU_CASES = [  # (kind, m, ksub, packed4, exact_lut, k, qt, splits)
    ("integer", 4, 16, True, False, 10, 1, 1),
    ("integer", 4, 16, True, True, 40, 4, 3),
    ("integer", 4, 32, False, False, 300, 2, 5),
    ("normal", 5, 16, True, True, 25, 8, 2),
    ("normal", 4, 256, False, False, 60, 32, 4),
]


@pytest.mark.parametrize("case", EMU_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("metric", METRICS)
def test_emulated_kernel_matches_plain_on_bucket_layout(metric, case):
    """The kernel's order over a bucket layout (shuffled buckets, padding,
    tombstoned slots, a filter, tied and unprobed buckets, duplicate rows
    in different buckets, num_valid inside the rows) against the plain
    version over the same rows in row order."""
    kind, m, ksub, packed4, exact_lut, k, qt, splits = case
    rng = np.random.default_rng(ksub + k)
    n, groups, nq = 1500, 24, 9
    books, codes, gids, rn, mask, (bcodes, bids, bnorms, fill) = _bucketed(
        rng, n, groups, 140, kind, m, ksub, twins=True)
    filt = mask * (rng.random(n) < 0.7)
    q = (rng.integers(0, 8, (nq, m * 4)) if kind == "integer"
         else rng.standard_normal((nq, m * 4))).astype(np.float32)
    if metric == DistanceMetric.COSINE:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    stored = pack_codes4(codes) if packed4 else codes
    bstored = (pack_codes4(bcodes.reshape(-1, m)).reshape(groups, 140, -1)
               if packed4 else bcodes)
    T = torch.from_numpy
    layout = _bucket_layout((T(bstored), T(bids), T(bnorms), T(fill)))
    for vm, num_valid in ((mask, n), (filt, n - 301)):
        bias = T(_bias(rng, nq, groups, 4, kind))
        args = (T(q), T(stored), T(books), T(rn), num_valid, k, metric, T(vm),
                exact_lut, packed4, bias, T(gids))
        ref = fused_adc_topk_reference(*args)
        got = _emulate(T(q), T(books), layout, bias, num_valid, k, metric, T(vm),
                       exact_lut, packed4, qt, splits)
        _bit_identical(got, ref, f"{case} {metric.name} num_valid={num_valid}")


@pytest.mark.parametrize("packed4", [False, True], ids=["u8", "packed4"])
@pytest.mark.parametrize("metric", METRICS)
def test_emulated_kernel_matches_plain_on_row_order_groups(metric, packed4):
    """The row-order form as the CUDA path runs it: rows grouped on the
    device, live rows of group −1 or ≥ G in a last bucket that takes no
    bias and every query scans (a bias of 0.0 would turn −0.0 into +0.0)."""
    rng = np.random.default_rng(5)
    m, ksub, n, groups, nq, k = 4, 16, 900, 11, 6, 30
    books = rng.integers(-4, 5, (m, ksub, 4)).astype(np.float32)
    codes = rng.integers(0, ksub, (n, m)).astype(np.uint8)
    recon = np.concatenate([books[j][codes[:, j]] for j in range(m)], 1)
    rn = (recon.astype(np.float64) ** 2).sum(1).astype(np.float32)
    gids = rng.integers(0, groups, n).astype(np.int32)
    gids[::17] = -1
    gids[5::23] = groups + 3
    mask = (rng.random(n) < 0.9).astype(np.float32)
    q = rng.integers(-3, 4, (nq, m * 4)).astype(np.float32)
    q[0] = 0  # every score 0.0 or -0.0: ties by row
    if metric == DistanceMetric.COSINE:
        q[1:] /= np.linalg.norm(q[1:], axis=1, keepdims=True)
    stored = pack_codes4(codes) if packed4 else codes
    T = torch.from_numpy
    bias = T(_bias(rng, nq, groups, 3, "integer"))
    args = (T(q), T(stored), T(books), T(rn), n, k, metric, T(mask), True,
            packed4, bias, T(gids))
    ref = fused_adc_topk_reference(*args)
    layout = _group_layout(T(stored), T(rn), T(gids), groups)
    got = _emulate(T(q), T(books), layout, bias, n, k, metric, T(mask), True,
                   packed4, 2, 3)
    _bit_identical(got, ref, f"{metric.name} packed4={packed4}")


def test_fetch_above_the_probed_rows_leaves_unfilled_slots():
    """Fetch 400 where the probed buckets hold fewer rows: the slots past
    them hold (−inf, −1), and no bucket outside the probes surfaces."""
    rng = np.random.default_rng(2)
    m, ksub, n, groups = 4, 16, 2000, 40
    books, codes, gids, rn, mask, bl = _bucketed(rng, n, groups, 90, "integer", m, ksub)
    q = rng.integers(0, 8, (3, m * 4)).astype(np.float32)
    bias = _bias(rng, 3, groups, 1, "integer", tie=False)
    T = torch.from_numpy
    args = (T(q), T(codes), T(books), T(rn), n, 400, DistanceMetric.L2, T(mask),
            False, False, T(bias), T(gids))
    ref = fused_adc_topk_reference(*args)
    got = _emulate(T(q), T(books), _bucket_layout(tuple(map(T, bl))), T(bias), n, 400,
                   DistanceMetric.L2, T(mask), False, False, 1, 4)
    _bit_identical(got, ref, "fetch 400 at one probed bucket")
    filled = (got[1] >= 0).sum(1).numpy()
    live = [int(((gids == np.flatnonzero(bias[r] > -1e28)[0]) & (mask != 0)).sum())
            for r in range(3)]
    assert filled.tolist() == live and max(live) < 400
    assert (got[0][:, -1] == float("-inf")).all() and (got[1][:, -1] == -1).all()


# -------------------------------------------------------- the IVF-PQ scan ---


def _index_layout(idx):
    return _bucket_layout((idx.buckets, idx.bucket_ids, idx.bucket_norms, idx.bucket_fill))


def test_index_bucket_layout_holds_the_scan_rows():
    """What the kernel relies on: every slot below a bucket's fill holds a
    live row's codes and norm, or id −1; every live row sits in the bucket
    ``row_bucket`` names; ``bucket_fill`` follows ``fill`` through
    ``delete_rows`` and ``rebuild``."""
    ref, data, q, _, _ = _ref_index(DistanceMetric.L2, True)
    port = IVFPQIndex.from_state(state_of(ref), device="cpu")

    def check():
        assert port.bucket_fill.dtype == torch.int32
        assert port.bucket_fill.tolist() == port.fill.tolist()
        ids = port.bucket_ids.numpy()
        for b, f in enumerate(port.fill):
            assert (ids[b, f:] == -1).all()
            rows = ids[b, :f][ids[b, :f] >= 0]
            slots = np.flatnonzero(ids[b, :f] >= 0)
            np.testing.assert_array_equal(port.buckets.numpy()[b, slots],
                                          port.codes_row.numpy()[rows])
            np.testing.assert_array_equal(port.bucket_norms.numpy()[b, slots],
                                          port.rnorms_row.numpy()[rows])
            assert (port.row_bucket.numpy()[rows] == b).all()
        live = np.flatnonzero(port.row_valid.numpy() != 0)
        assert sorted(live) == sorted(ids[ids >= 0])

    check()
    port.delete_rows(np.arange(0, 300, 7))
    check()
    port.rebuild()
    check()


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("nprobe", [1, 2, 5])
def test_emulated_kernel_on_the_index_layout(metric, nprobe):
    """The kernel's order over the index's own bucket layout with the scan's
    real bias (nprobe 2 cuts through the heavy cell's tied buckets), after
    ``delete_rows`` and with a filter, against the plain row-order scan."""
    ref, data, q, rng, _ = _ref_index(metric, True)
    port = IVFPQIndex.from_state(state_of(ref), device="cpu")
    port.delete_rows(np.arange(3, 500, 11))
    qd = torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True)
                          if metric == DistanceMetric.COSINE else q)
    bias, _ = port._scan_bias(qd, nprobe)
    ties = ((bias > -1e28).sum(1) > nprobe).any()
    assert ties or nprobe != 2  # the split cell's buckets tie
    filt = port.row_valid * torch.from_numpy((rng.random(len(data)) < 0.6).astype(np.float32))
    for vm in (port.row_valid, filt):
        args = (qd, port.codes_row, port._books, port.rnorms_row, port.num_vectors, 50,
                metric, vm, False, True, bias, port.row_bucket)
        ref_out = fused_adc_topk_reference(*args)
        got = _emulate(qd, port._books, _index_layout(port), bias, port.num_vectors, 50,
                       metric, vm, False, True, 2, 3)
        _bit_identical(got, ref_out, f"{metric.name} nprobe={nprobe}")


@pytest.mark.parametrize("packed4", [False, True], ids=["u8", "packed4"])
@pytest.mark.parametrize("metric", METRICS)
def test_search_through_the_kernel_order_matches_reference(metric, packed4):
    """``IVFPQIndex.search(mode="scan")`` with the emulated kernel in the
    place of the CUDA launch (the bucket layout, the kernel's order) against
    the JAX package's scan, through split-cell ties, a filter and
    ``delete_rows``; the scan hands the kernel its bucket layout."""
    ref, data, q, rng, dead = _ref_index(metric, packed4)
    port = IVFPQIndex.from_state(state_of(ref), device="cpu")
    seen = []

    def kernel(q_, codes, books, rnorms, num_valid, k, metric_, valid_mask=None,
               exact_lut=False, packed4=False, group_bias=None, group_ids=None,
               buckets=None, grid=None):
        seen.append(buckets is not None)
        return _emulate(q_, books, _bucket_layout(buckets), group_bias, num_valid, k,
                        metric_, valid_mask, exact_lut, packed4, 2, 3)

    saved = ivfpq_mod.fused_adc_topk
    ivfpq_mod.fused_adc_topk = kernel
    try:
        mask = rng.random(len(data)) < 0.7
        kw = dict(k=10, nprobe=2, mode="scan")
        for fm in (None, mask):
            a = port.search(q, filter_mask=fm, **kw)
            b = ref.search(q, filter_mask=fm, **kw)
            live = ~dead & (mask if fm is not None else True)
            _same(a, b, metric, q, _recon(), live)
        victims = a.indices[:, 0]
        port.delete_rows(victims)
        ref.delete_rows(victims)
        dead[victims] = True
        _same(port.search(q, **kw), ref.search(q, **kw), metric, q, _recon(), ~dead)
    finally:
        ivfpq_mod.fused_adc_topk = saved
    assert seen and all(seen)


def test_bucket_form_checks_raise():
    q, codes, books = torch.zeros((2, 8)), torch.zeros((10, 4), dtype=torch.uint8), \
        torch.zeros((4, 16, 2))
    bias, ids = torch.zeros((2, 3)), torch.zeros(10, dtype=torch.int32)
    good = (torch.zeros((3, 5, 4), dtype=torch.uint8), torch.zeros((3, 5), dtype=torch.int32),
            torch.zeros((3, 5)), torch.zeros(3, dtype=torch.int32))
    call = lambda **kw: fused_adc_topk(q, codes, books, torch.zeros(10), 10, 3,  # noqa: E731
                                       DistanceMetric.L2, **kw)
    call(group_bias=bias, group_ids=ids, buckets=good)  # CPU: the plain version
    with pytest.raises(ValueError, match="group_bias"):
        call(buckets=good)
    for bad in ((good[0][:2],) + good[1:], (good[0], good[1][:, :4]) + good[2:],
                good[:3] + (torch.zeros(4, dtype=torch.int32),)):
        with pytest.raises(ValueError):
            call(group_bias=bias, group_ids=ids, buckets=bad)
    with pytest.raises(ValueError, match="int32"):
        adc_kernel._check_cuda(q, codes, books, torch.zeros(10), 3, None, True, bias, ids,
                               good[:3] + (torch.zeros(3, dtype=torch.int64),))
    adc_kernel._check_cuda(q, codes, books, torch.zeros(10), 3, None, True, bias, ids, good)
