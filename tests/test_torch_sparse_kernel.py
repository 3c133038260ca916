"""The port's sparse ELL kernels on CPU tensors (their plain versions)
against the JAX package: ``ell_dots_reference`` against the TPU kernel
``benchmarks/sparse_vmem_proto.py::vmem_tiled_dots`` run in interpret mode
(imported from its file, which stays as it is) and against
``sparse._ell_dots``; ``ell_topk_reference`` against ``_sparse_topk_ell``
with an overflow tail, masks, the three metrics, k above the rows left and
sparse queries whose zero scores tie; the postings of a query batch
(``query_postings_reference``) against a NumPy loop.

Tolerance. On integer-valued values and queries every sum is exact in f32,
so IP and L2 agree bit for bit whatever the order of the sums. Otherwise
two f32 sums of the same R terms differ by at most
``2·R·2⁻²⁴·Σ_r|q[c_r]·v_r|`` (doubled for L2, whose score doubles the dot);
cosine scales that by the row's 1/‖x‖ and adds a few roundings of the
normalization (the JAX package takes ``rsqrt``, the port ``1/sqrt``).
Indices agree except at near-ties inside that band."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from metrovector_tpu import DistanceMetric
from metrovector_tpu import sparse as jax_sparse
from metrovector_tpu_torch.ops import sparse_kernel
from metrovector_tpu_torch.ops.sparse_kernel import (
    ell_dots,
    ell_dots_reference,
    ell_topk,
    ell_topk_reference,
    query_postings,
)
from metrovector_tpu_torch.sparse import ell_layout

from _torch_parity import METRICS, assert_topk_match

REPO = Path(__file__).resolve().parent.parent
DIM, N, NQ = 512, 1500, 9


def _proto():
    """benchmarks/sparse_vmem_proto.py, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        "sparse_vmem_proto", REPO / "benchmarks" / "sparse_vmem_proto.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _values(rng, kind, size):
    if kind == "integer":
        return rng.integers(-4, 5, size).astype(np.float32)
    return rng.standard_normal(size).astype(np.float32)


def _corpus(rng, kind, n=N, dim=DIM, wide=(5, 60, 61)):
    """A CSR corpus of up to 12 entries a row, some rows empty and a few
    far wider than the ELL width (they spill into the overflow)."""
    counts = rng.integers(0, 13, n)
    counts[list(wide)] = 90
    cols = np.concatenate([np.sort(rng.choice(dim, c, replace=False))
                           for c in counts]).astype(np.int32)
    vals = _values(rng, kind, cols.size)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, cols, vals


def _dense(indptr, cols, vals, n, dim):
    x = np.zeros((n, dim), np.float64)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    np.add.at(x, (rows, cols), vals.astype(np.float64))
    return x


@pytest.mark.parametrize("kind", ["integer", "normal"])
def test_ell_dots_matches_vmem_tiled_dots_interpret(kind):
    rng = np.random.default_rng(1)
    n_pad, r, block = 512, 8, 128
    cols = rng.integers(0, DIM, (n_pad, r)).astype(np.int32)
    vals = _values(rng, kind, (n_pad, r))
    qt = _values(rng, kind, (DIM, NQ))
    before = ell_dots.launches
    got = ell_dots(torch.from_numpy(qt), torch.from_numpy(cols),
                   torch.from_numpy(vals)).numpy()
    assert ell_dots.launches == before  # the plain path is no launch
    proto = np.asarray(_proto().vmem_tiled_dots(qt, cols, vals, block,
                                                interpret=True))
    xla = np.asarray(jax_sparse._ell_dots(qt, cols, vals, block)).T
    if kind == "integer":
        np.testing.assert_array_equal(got, proto)
        np.testing.assert_array_equal(got, xla)
    else:
        band = 2 * r * 2.0**-24 * (np.abs(vals)[:, :, None]
                                   * np.abs(qt)[cols]).sum(1)
        assert (np.abs(got - proto) <= band).all()
        assert (np.abs(got - xla) <= band).all()


def test_ell_dots_adds_slots_in_order():
    """The plain version's f32 sum runs slot by slot: the same as a NumPy
    loop in f32, bit for bit, on float data."""
    rng = np.random.default_rng(2)
    cols = rng.integers(0, 64, (40, 7)).astype(np.int32)
    vals = rng.standard_normal((40, 7)).astype(np.float32)
    qt = rng.standard_normal((64, 5)).astype(np.float32)
    want = np.zeros((40, 5), np.float32)
    for j in range(7):
        want = want + qt[cols[:, j]] * vals[:, j, None]
    got = ell_dots_reference(torch.from_numpy(qt), torch.from_numpy(cols),
                             torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_overflow(layout, chunk=256):
    """The port's CSR overflow tail as the JAX package's padded COO."""
    ptr = layout["ovf_ptr"]
    n_pad = ptr.size - 1
    rows = np.repeat(np.arange(n_pad, dtype=np.int32), np.diff(ptr))
    pad = (-rows.size) % chunk if rows.size else chunk
    return (np.pad(layout["ovf_cols"], (0, pad)),
            np.pad(rows, (0, pad), constant_values=n_pad),
            np.pad(layout["ovf_vals"], (0, pad)))


def _tolerance(q, indptr, cols, vals, metric, norms):
    """Per-query bound on |score_port − score_jax| (module docstring)."""
    n = indptr.size - 1
    counts = np.diff(indptr)
    rows = np.repeat(np.arange(n), counts)
    absdot = np.zeros((q.shape[0], n))
    np.add.at(absdot.T, rows, (np.abs(q[:, cols]) * np.abs(vals)[None]).T)
    bound = 2 * counts[None] * 2.0**-24 * absdot
    if metric == DistanceMetric.L2:
        bound = 2 * bound
    if metric == DistanceMetric.COSINE:
        bound = bound / np.sqrt(np.maximum(norms[:n], 1e-30))[None] + 2.0**-21
    return bound.max(1) + 1e-30


def _scores64(q, x, metric, live):
    dots = q.astype(np.float64) @ x.T
    nrm = (x ** 2).sum(1)
    if metric == DistanceMetric.L2:
        s = 2 * dots - nrm[None]
    elif metric == DistanceMetric.COSINE:
        s = dots / np.sqrt(np.maximum(nrm, 1e-30))[None]
    else:
        s = dots
    return np.where(live[None], s, -np.inf)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["integer", "normal"])
@pytest.mark.parametrize("metric", METRICS)
def test_ell_topk_matches_sparse_topk_ell(metric, kind, masked):
    rng = np.random.default_rng(3)
    indptr, cols, vals = _corpus(rng, kind)
    layout = ell_layout(indptr, cols, vals, N)
    assert layout["ovf_ptr"][-1] > 0  # the wide rows spill
    n_pad = layout["cols_ell"].shape[0]
    x = _dense(indptr, cols, vals, N, DIM)
    norms = np.zeros(n_pad, np.float32)
    norms[:N] = (x ** 2).sum(1)
    q = _values(rng, kind, (NQ, DIM))
    if metric == DistanceMetric.COSINE:
        q = (q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
             ).astype(np.float32)
    num_rows, k = (N - 30, 12) if masked else (N, 10)
    valid = None
    live = np.arange(N) < num_rows
    if masked:
        valid = np.zeros(n_pad, np.float32)
        valid[:N] = rng.random(N) > 0.3
        live &= valid[:N] != 0
    oc, orow, ov = _jax_overflow(layout)
    want = jax_sparse._sparse_topk_ell(
        q, layout["cols_ell"], layout["vals_ell"], oc, orow, ov, norms, valid,
        k, metric, num_rows, 2048, 256, True)
    t = torch.from_numpy
    before = ell_topk.launches
    got = ell_topk(t(np.ascontiguousarray(q.T)), t(layout["cols_ell"]),
                   t(layout["vals_ell"]), t(layout["ovf_ptr"]),
                   t(layout["ovf_cols"]), t(layout["ovf_vals"]), t(norms),
                   num_rows, k, metric, None if valid is None else t(valid))
    assert ell_topk.launches == before
    exact = kind == "integer" and metric != DistanceMetric.COSINE
    assert_topk_match(
        tuple(a.numpy() for a in got), tuple(np.asarray(a) for a in want),
        exact=exact, tol=_tolerance(q, indptr, cols, vals, metric, norms),
        scores64=_scores64(q, x, metric, live))


@pytest.mark.parametrize("metric", METRICS)
def test_ell_topk_k_above_live_rows(metric):
    """k above the rows left after masking: the tail is (−inf, −1), as the
    JAX package gives it."""
    rng = np.random.default_rng(4)
    indptr, cols, vals = _corpus(rng, "integer", n=300, dim=128, wide=(2,))
    layout = ell_layout(indptr, cols, vals, 300)
    n_pad = layout["cols_ell"].shape[0]
    x = _dense(indptr, cols, vals, 300, 128)
    norms = np.zeros(n_pad, np.float32)
    norms[:300] = (x ** 2).sum(1)
    valid = np.zeros(n_pad, np.float32)
    valid[:40:2] = 1  # 20 live rows
    q = rng.integers(-3, 4, (4, 128)).astype(np.float32)
    t = torch.from_numpy
    s, i = ell_topk(t(np.ascontiguousarray(q.T)), t(layout["cols_ell"]),
                    t(layout["vals_ell"]), t(layout["ovf_ptr"]),
                    t(layout["ovf_cols"]), t(layout["ovf_vals"]), t(norms),
                    300, 50, metric, t(valid))
    oc, orow, ov = _jax_overflow(layout)
    ws, wi = jax_sparse._sparse_topk_ell(
        q, layout["cols_ell"], layout["vals_ell"], oc, orow, ov, norms, valid,
        50, metric, 300, 2048, 256, True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    assert (i.numpy()[:, 20:] == -1).all() and torch.isneginf(s[:, 20:]).all()
    assert set(i.numpy()[0, :20]) == set(range(0, 40, 2))


def test_ell_topk_ties_go_to_lowest_row():
    """Duplicate rows tie exactly; the lower row comes first."""
    rng = np.random.default_rng(5)
    base_c = rng.integers(0, 32, (10, 4)).astype(np.int32)
    base_v = rng.integers(1, 4, (10, 4)).astype(np.float32)
    pick = rng.integers(0, 10, 400)
    cols, vals = base_c[pick], base_v[pick]
    qt = rng.integers(0, 3, (32, 3)).astype(np.float32)
    t = torch.from_numpy
    s, i = ell_topk_reference(t(qt), t(cols), t(vals), None, None, None,
                              t(np.zeros(400, np.float32)), 400, 60,
                              DistanceMetric.INNER_PRODUCT)
    s, i = s.numpy(), i.numpy()
    for r in range(3):
        same = s[r][1:] == s[r][:-1]
        assert (i[r][1:][same] > i[r][:-1][same]).all()


def _bad(name):
    qt = torch.zeros((16, 2))
    cols = torch.zeros((10, 3), dtype=torch.int32)
    vals = torch.zeros((10, 3))
    named = [("norms", torch.zeros(10), torch.float32, (10,))]
    if name == "cols_dtype":
        cols = cols.long()
    elif name == "vals_shape":
        vals = torch.zeros((10, 4))
    elif name == "norms_shape":
        named = [("norms", torch.zeros(11), torch.float32, (10,))]
    elif name == "qt_dtype":
        qt = qt.double()
    elif name == "not_contiguous":
        qt = torch.zeros((2, 16)).T
    return qt, cols, vals, named


@pytest.mark.parametrize("name", ["cols_dtype", "vals_shape", "norms_shape",
                                  "qt_dtype", "not_contiguous"])
def test_kernel_input_checks_raise(name):
    with pytest.raises(ValueError):
        sparse_kernel._check(*_bad(name))


def test_tile_shape_and_shared_memory():
    """A block covers the batch with the fewest groups of 32 queries, at
    most 8, and 16 or 32 rows a tile (half a 64-entry buffer at most);
    its lists live in shared memory up to k = 16, and every block fits in
    the 227 KB an H100 block may use."""
    assert [sparse_kernel._tile_shape(nq)[0] for nq in (1, 32, 33, 64, 65, 256, 300)
            ] == [1, 1, 2, 2, 4, 8, 8]
    for qg in (1, 2, 4, 8):
        rows = sparse_kernel._tile_shape(32 * qg)[1]
        assert rows in (16, 32)
        assert (sparse_kernel._shared_bytes(qg, rows, 16)
                == sparse_kernel._shared_bytes(qg, rows, 17) + 32 * qg * 8 * 16)
        assert sparse_kernel._shared_bytes(qg, 32, 16) <= 227 * 1024


@pytest.mark.parametrize("dim,nq", [(30_522, 70_400), (30_522, 256),
                                    (4096, 32_768 + 232), (512, 10**6),
                                    (2**24, 100)])
def test_query_chunks_cover_large_batches(dim, nq):
    """On the card a batch runs in chunks of whole query tiles, one launch
    each, whose worst-case postings stay within the cap and below int32
    offsets: 30,522 terms x 70,400 queries (past 2^31 entries) is answered
    in 17 chunks, not refused."""
    chunks = sparse_kernel._query_chunks(dim, nq)
    assert chunks[0][0] == 0 and chunks[-1][1] == nq
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    tile = 256 if dim * 256 <= sparse_kernel._POSTINGS_CAP else 32
    for q0, q1 in chunks:
        assert q1 > q0 and q0 % tile == 0
        assert dim * (q1 - q0) <= max(sparse_kernel._POSTINGS_CAP, 32 * dim) < 2**31
    assert (len(chunks) == 1) == (dim * nq <= sparse_kernel._POSTINGS_CAP)
    if (dim, nq) == (30_522, 70_400):
        assert len(chunks) == 17


def test_query_chunks_refuse_past_int32_offsets():
    """A vocabulary whose 32-query postings pass 2^31 entries is refused."""
    with pytest.raises(ValueError):
        sparse_kernel._query_chunks(2**26, 1)


def _np_postings(q, qtile):
    """The postings of ``q [dim, nq]`` by a loop: keys (tile, term) in
    order, queries ascending, every value != 0 kept."""
    dim, nq = q.shape
    qptr, post_q, post_v = [0], [], []
    for b in range(-(-nq // qtile)):
        for c in range(dim):
            for j in range(b * qtile, min(nq, (b + 1) * qtile)):
                if q[c, j] != 0:
                    post_q.append(j)
                    post_v.append(q[c, j])
            qptr.append(len(post_q))
    return (np.array(qptr), np.array(post_q, np.int64),
            np.array(post_v, np.float32))


def _postings_case(rng, case):
    """(qt [dim, nq], qtile) of one postings case."""
    if case == "empty_batch":
        return np.zeros((50, 0), np.float32), 32
    if case == "dense":
        return rng.integers(1, 4, (20, 40)).astype(np.float32), 32
    nq = 100 if case == "tiles" else 9
    q = rng.integers(-2, 3, (50, nq)).astype(np.float32)
    q[rng.random(q.shape) < 0.8] = 0
    q[3, :4] = -0.0
    q[4, 1], q[5, 2], q[6, 3] = np.inf, -np.inf, np.nan
    if case == "all_zero_query":
        q[:, 2] = 0
        q[::2, 2] = -0.0
    return q, 32


@pytest.mark.parametrize("case", ["signed_zero_inf_nan", "empty_batch",
                                  "all_zero_query", "tiles", "dense"])
def test_query_postings_match_numpy(case):
    rng = np.random.default_rng(6)
    q, qtile = _postings_case(rng, case)
    before = query_postings.launches
    qptr, post_q, post_v = (a.numpy() for a in query_postings(torch.from_numpy(q), qtile))
    assert query_postings.launches == before  # the plain path is no launch
    want = _np_postings(q, qtile)
    np.testing.assert_array_equal(qptr, want[0])
    np.testing.assert_array_equal(post_q, want[1])
    np.testing.assert_array_equal(post_v, want[2])  # NaN matches NaN
    assert qptr.dtype == post_q.dtype == np.int32
    for key in range(qptr.size - 1):  # queries ascending within a key
        assert (np.diff(post_q[qptr[key]:qptr[key + 1]]) > 0).all()
    if case == "signed_zero_inf_nan":
        assert not np.isin([0, 1, 2, 3], post_q[qptr[3]:qptr[4]]).any()  # -0 dropped
        assert np.isposinf(post_v[qptr[4]:qptr[5]]).any()
        assert np.isneginf(post_v[qptr[5]:qptr[6]]).any()
        assert np.isnan(post_v[qptr[6]:qptr[7]]).any()
    if case == "all_zero_query":
        assert 2 not in post_q
    if case == "tiles":
        assert qptr.size == 4 * 50 + 1
        for b in range(4):
            keys = post_q[qptr[b * 50]:qptr[(b + 1) * 50]]
            assert ((keys >= 32 * b) & (keys < 32 * (b + 1))).all()
    if case == "dense":
        np.testing.assert_array_equal(np.diff(qptr), [32] * 20 + [8] * 20)


@pytest.mark.parametrize("metric", METRICS)
def test_ell_topk_sparse_queries_tie_at_zero(metric):
    """Queries of 8 nonzeros of 512 terms (one all zero): most rows score
    exactly 0 (−‖x‖² for L2), and at k = N the ties go to the lowest row,
    as in the JAX package."""
    rng = np.random.default_rng(7)
    n = 300
    indptr, cols, vals = _corpus(rng, "integer", n=n, wide=(4,))
    layout = ell_layout(indptr, cols, vals, n)
    n_pad = layout["cols_ell"].shape[0]
    x = _dense(indptr, cols, vals, n, DIM)
    norms = np.zeros(n_pad, np.float32)
    norms[:n] = (x ** 2).sum(1)
    q = np.zeros((5, DIM), np.float32)
    for i in range(4):
        q[i, rng.choice(DIM, 8, replace=False)] = rng.choice([-3, -2, -1, 1, 2, 3], 8)
    if metric == DistanceMetric.COSINE:
        q = (q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-30)
             ).astype(np.float32)
    oc, orow, ov = _jax_overflow(layout)
    want = jax_sparse._sparse_topk_ell(
        q, layout["cols_ell"], layout["vals_ell"], oc, orow, ov, norms, None,
        n, metric, n, 2048, 256, True)
    t = torch.from_numpy
    got = ell_topk(t(np.ascontiguousarray(q.T)), t(layout["cols_ell"]),
                   t(layout["vals_ell"]), t(layout["ovf_ptr"]),
                   t(layout["ovf_cols"]), t(layout["ovf_vals"]), t(norms), n,
                   n, metric)
    s = got[0].numpy()
    if metric == DistanceMetric.INNER_PRODUCT:
        assert (s == 0).sum() > s.size // 2  # zero ties decide most slots
    exact = metric != DistanceMetric.COSINE
    assert_topk_match(
        tuple(a.numpy() for a in got), tuple(np.asarray(a) for a in want),
        exact=exact, tol=_tolerance(q, indptr, cols, vals, metric, norms),
        scores64=_scores64(q, x, metric, np.ones(n, bool)))


def test_other_device_raises():
    q = torch.zeros((16, 2), device="meta")
    with pytest.raises(ValueError):
        ell_topk(q, torch.zeros((4, 2), dtype=torch.int32, device="meta"),
                 torch.zeros((4, 2), device="meta"), None, None, None,
                 torch.zeros(4, device="meta"), 4, 2, DistanceMetric.L2)
    with pytest.raises(ValueError):
        ell_dots(q, torch.zeros((4, 2), dtype=torch.int32, device="meta"),
                 torch.zeros((4, 2), device="meta"))
