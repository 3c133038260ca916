"""The port's sparse ELL kernels on CPU tensors (their plain versions)
against the JAX package: ``ell_dots_reference`` against the TPU kernel
``benchmarks/sparse_vmem_proto.py::vmem_tiled_dots`` run in interpret mode
(imported from its file, which stays as it is) and against
``sparse._ell_dots``; ``ell_topk_reference`` against ``_sparse_topk_ell``
with an overflow tail, masks, the three metrics and k above the rows left.

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


def test_query_groups_and_shared_memory():
    """A block covers the batch with the fewest groups of 32 queries, at
    most 8; its shared memory (the score tile) is about 33 KB for each."""
    assert [sparse_kernel._query_groups(nq) for nq in (1, 32, 33, 64, 65, 256, 300)
            ] == [1, 1, 2, 2, 4, 8, 8]
    sizes = {sparse_kernel._shared_bytes(qg) for qg in (1, 2, 4, 8)}
    assert max(sizes) <= 35_000


def test_other_device_raises():
    q = torch.zeros((16, 2), device="meta")
    with pytest.raises(ValueError):
        ell_topk(q, torch.zeros((4, 2), dtype=torch.int32, device="meta"),
                 torch.zeros((4, 2), device="meta"), None, None, None,
                 torch.zeros(4, device="meta"), 4, 2, DistanceMetric.L2)
    with pytest.raises(ValueError):
        ell_dots(q, torch.zeros((4, 2), dtype=torch.int32, device="meta"),
                 torch.zeros((4, 2), device="meta"))
