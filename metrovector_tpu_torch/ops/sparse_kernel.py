"""Sparse ELL scan and fused top-k: the wrappers of the Hopper kernels in
``csrc/sparse_kernel.cu`` and their plain PyTorch versions.

Replaces ``benchmarks/sparse_vmem_proto.py::vmem_tiled_dots`` (the TPU
kernel of the sparse ELL contraction) and the search it served,
``metrovector_tpu/sparse.py::_sparse_topk_ell``. The corpus is in ELL
layout, ``cols``/``vals`` ``[n_pad, R]`` (pad entries column 0, value 0),
with the entries of rows wider than R in a per-row CSR tail
(``ovf_ptr [n_pad + 1]`` int64, ``ovf_cols``, ``ovf_vals``); queries come
transposed, ``qt [dim, Q]`` f32.

* :func:`ell_dots` is the TPU kernel's contract: ``dots [n_pad, Q]``,
  ``dots[n, q] = Σ_r qt[cols[n, r], q] · vals[n, r]`` over the ELL slots.
* :func:`ell_topk` is the fused search: the same sums, then the overflow,
  the metric epilogue, the masks and a per-query top-k; the ``[Q, n]``
  score matrix never reaches device memory.

Both versions add a row's products in ascending slot order, then its
overflow entries in order, each product and each sum rounded to f32 on its
own, so kernel and plain version agree bit for bit. A CUDA tensor goes to
the kernel or the call raises; a CPU tensor goes to the plain version.
``ell_dots.launches`` and ``ell_topk.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..format.constants import DistanceMetric
from . import select
from .distances import carry_topk, empty_topk, finish_topk

# Shape constants of csrc/sparse_kernel.cu
_QUERY_GROUPS = (1, 2, 4, 8)  # a block covers 32 x QG queries
_TILE_SCORES = 256  # rows per tile x QG
_BUFFER = 64
_MERGE_MAX_K = 1024  # select.cuh's merge_kernel takes lists of k up to this
_PLAIN_ROWS = 65536  # rows per block of the plain versions

_METRICS = (
    DistanceMetric.L2, DistanceMetric.INNER_PRODUCT, DistanceMetric.COSINE
)


def ell_dots_reference(qt: torch.Tensor, cols: torch.Tensor,
                       vals: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`ell_dots`: slot by slot in ascending order,
    ``acc += qt[cols[:, r]] * vals[:, r]`` in f32, in blocks of rows."""
    n, r = cols.shape
    out = torch.empty((n, qt.shape[1]), dtype=torch.float32, device=qt.device)
    for start in range(0, n, _PLAIN_ROWS):
        c = cols[start:start + _PLAIN_ROWS].long()
        v = vals[start:start + _PLAIN_ROWS]
        acc = torch.zeros((c.shape[0], qt.shape[1]), dtype=torch.float32,
                          device=qt.device)
        for j in range(r):
            acc = acc + qt[c[:, j]] * v[:, j, None]
        out[start:start + _PLAIN_ROWS] = acc
    return out


def _add_overflow(acc, qt, start, ovf_ptr, ovf_cols, ovf_vals):
    """Add rows ``start ..``'s overflow entries to ``acc [B, Q]`` in their
    order within each row (one pass per rank: rows are unique in a pass)."""
    stop = start + acc.shape[0]
    lo, hi = int(ovf_ptr[start]), int(ovf_ptr[stop])
    if hi == lo:
        return acc
    counts = (ovf_ptr[start + 1:stop + 1] - ovf_ptr[start:stop])
    rows = torch.repeat_interleave(
        torch.arange(acc.shape[0], device=acc.device), counts)
    rank = torch.arange(lo, hi, device=acc.device) - ovf_ptr[start:stop][rows]
    cols = ovf_cols[lo:hi].long()
    vals = ovf_vals[lo:hi]
    for j in range(int(rank.max()) + 1):
        sel = rank == j
        rr = rows[sel]
        acc[rr] = acc[rr] + qt[cols[sel]] * vals[sel][:, None]
    return acc


def row_scores(acc: torch.Tensor, norms: torch.Tensor, metric) -> torch.Tensor:
    """The metric epilogue of dots ``acc [rows, Q]`` with the rows' squared
    norms: IP ``s``, L2 ``2s − ‖x‖²``, cosine ``s · 1/sqrt(max(‖x‖², 1e-30))``
    (queries pre-normalized)."""
    if metric == DistanceMetric.L2:
        return 2.0 * acc - norms[:, None]
    if metric == DistanceMetric.COSINE:
        return acc * (1.0 / torch.sqrt(torch.clamp(norms, min=1e-30)))[:, None]
    return acc


def ell_topk_reference(
    qt: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    ovf_ptr: torch.Tensor | None,
    ovf_cols: torch.Tensor | None,
    ovf_vals: torch.Tensor | None,
    norms: torch.Tensor,
    num_rows: int,
    k: int,
    metric,
    valid_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ell_topk` (same signature and results): the
    dots of :func:`ell_dots_reference`, then the overflow, the epilogue and
    the masks per block of rows, with a carried candidate list selected by
    a stable sort (ties to the lowest row)."""
    metric = DistanceMetric(metric)
    n, r = cols.shape
    nq = qt.shape[1]
    best = empty_topk(nq, qt.device)
    rows_all = torch.arange(n, device=qt.device)
    for start in range(0, n, _PLAIN_ROWS):
        stop = min(n, start + _PLAIN_ROWS)
        acc = ell_dots_reference(qt, cols[start:stop], vals[start:stop])
        if ovf_ptr is not None:
            acc = _add_overflow(acc, qt, start, ovf_ptr, ovf_cols, ovf_vals)
        s = row_scores(acc, norms[start:stop], metric)
        live = rows_all[start:stop] < num_rows
        if valid_mask is not None:
            live = live & (valid_mask[start:stop] != 0)
        s = torch.where(live[:, None], s, torch.tensor(float("-inf"),
                                                        device=s.device))
        best = carry_topk(best, s.T, start, k)
    return finish_topk(best, k)


def _shared_bytes(qg: int) -> int:
    """Dynamic shared memory of one scan block of 32·``qg`` queries: the
    score tile and the buffer fills (lists and buffers live in device
    scratch)."""
    return 32 * qg * (4 * (_TILE_SCORES // qg + 1) + 4)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device_index: int, qg: int) -> int:
    """Scan blocks of ``qg`` query groups an SM holds at once, from the
    runtime's occupancy calculator on the current device."""
    from ._build import load, raise_for

    lib = load()
    per_sm = ctypes.c_int(0)
    raise_for(lib, lib.mvt_ell_topk_occupancy(qg, ctypes.byref(per_sm)),
              "ell_topk")
    return max(1, per_sm.value)


def _query_groups(nq: int) -> int:
    """The fewest query groups (32 queries each) that hold the batch, at
    most 8: a block of 256 queries reads each ELL entry once."""
    return next((g for g in _QUERY_GROUPS if 32 * g >= nq), _QUERY_GROUPS[-1])


def _check(qt, cols, vals, named) -> None:
    """Devices, dtypes, shapes and contiguity of the kernels' inputs;
    ``named``: the other ``(name, tensor, dtype, shape)`` inputs."""
    dev = qt.device
    if qt.dtype != torch.float32 or qt.dim() != 2:
        raise ValueError("qt must be a [dim, Q] float32 tensor")
    if cols.dtype != torch.int32 or cols.dim() != 2:
        raise ValueError("cols must be an [n, R] int32 tensor")
    n = cols.shape[0]
    if n >= 2**31:
        raise ValueError(f"N={n} rows: the kernel's row indices are int32")
    for name, t, dtype, shape in [("vals", vals, torch.float32,
                                   tuple(cols.shape))] + named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, qt on {dev}: one device only")
        if t.dtype != dtype or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a {list(shape or ['?'])} {dtype} tensor")
    for name, t in [("qt", qt), ("cols", cols), ("vals", vals)] + [
            (nm, t) for nm, t, _, _ in named]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ell_dots(qt: torch.Tensor, cols: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """``dots [n, Q]`` f32 of the ELL rows ``cols``/``vals`` ``[n, R]``
    against ``qt [dim, Q]`` (columns must lie in ``[0, dim)``)."""
    if qt.device.type == "cpu":
        return ell_dots_reference(qt, cols, vals)
    if qt.device.type != "cuda":
        raise ValueError(f"ell_dots runs on CUDA or CPU, not {qt.device}")
    _check(qt, cols, vals, [])
    from ._build import load, raise_for

    lib = load()
    n, r = cols.shape
    nq = qt.shape[1]
    out = torch.empty((n, nq), dtype=torch.float32, device=qt.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(qt.device):
        err = lib.mvt_ell_dots(qt.data_ptr(), cols.data_ptr(), vals.data_ptr(),
                               n, r, nq, out.data_ptr(),
                               torch.cuda.current_stream(qt.device).cuda_stream)
    raise_for(lib, err, "ell_dots")
    ell_dots.launches += 1
    return out


ell_dots.launches = 0


def ell_topk(
    qt: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    ovf_ptr: torch.Tensor | None,
    ovf_cols: torch.Tensor | None,
    ovf_vals: torch.Tensor | None,
    norms: torch.Tensor,
    num_rows: int,
    k: int,
    metric,
    valid_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``qt [dim, Q]`` f32 (columns pre-normalized for
    cosine) over the ELL rows ``cols``/``vals`` ``[n, R]`` plus their
    overflow (``ovf_ptr [n + 1]`` int64 into ``ovf_cols`` int32 /
    ``ovf_vals`` f32, or three Nones), with squared norms ``norms [n]`` f32;
    rows ≥ ``num_rows`` and rows where ``valid_mask [n]`` (f32) is 0 never
    enter. Returns ``(scores [Q, k] f32, rows [Q, k] int32)`` by (score
    descending, row ascending); unfilled slots hold (−inf, −1). On CUDA
    ``1 ≤ k ≤ n``."""
    metric = DistanceMetric(metric)
    if metric not in _METRICS:
        raise NotImplementedError(f"metric {metric!r} has no built-in score kernel")
    if qt.device.type == "cpu":
        return ell_topk_reference(qt, cols, vals, ovf_ptr, ovf_cols, ovf_vals,
                                  norms, num_rows, k, metric, valid_mask)
    if qt.device.type != "cuda":
        raise ValueError(f"ell_topk runs on CUDA or CPU, not {qt.device}")
    n, r = cols.shape
    named = [("norms", norms, torch.float32, (n,))]
    if valid_mask is not None:
        named.append(("valid_mask", valid_mask, torch.float32, (n,)))
    if ovf_ptr is not None:
        named += [("ovf_ptr", ovf_ptr, torch.int64, (n + 1,)),
                  ("ovf_cols", ovf_cols, torch.int32, None),
                  ("ovf_vals", ovf_vals, torch.float32, tuple(ovf_cols.shape))]
    _check(qt, cols, vals, named)
    if k < 1 or (n and k > n):  # an empty corpus leaves every slot unfilled
        raise ValueError(f"k={k} is outside the kernel's limit 1 <= k <= N={n}")
    from ._build import load, raise_for

    lib = load()
    nq = qt.shape[1]
    dev = qt.device
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0 or n == 0:  # nothing to scan: every slot stays unfilled
        return out_s.fill_(float("-inf")), out_i.fill_(-1)
    qg = _query_groups(nq)
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        want = max(1, sms * _blocks_per_sm(dev.index, qg) // -(-nq // (32 * qg)))
        splits, rows_per_split, length = select.row_splits(
            n, _TILE_SCORES // qg, want, nq, k, lists_in_smem=False)
        tree = not (length == k and k <= _MERGE_MAX_K)
        part_s, part_i, tmp_s, tmp_i = select.scratch(nq, splits, length, k,
                                                      dev, tree=tree)
        buf_s = torch.empty(nq * splits * _BUFFER, dtype=torch.float32, device=dev)
        buf_i = torch.empty(nq * splits * _BUFFER, dtype=torch.int32, device=dev)
        has_ovf = ovf_ptr is not None and ovf_cols.numel() > 0
        err = lib.mvt_ell_topk(
            qt.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            ovf_ptr.data_ptr() if has_ovf else None,
            ovf_cols.data_ptr() if has_ovf else None,
            ovf_vals.data_ptr() if has_ovf else None,
            norms.data_ptr(),
            None if valid_mask is None else valid_mask.data_ptr(),
            nq, n, r, max(0, min(int(num_rows), n)), k, int(metric),
            qg, splits, rows_per_split, length,
            part_s.data_ptr(), part_i.data_ptr(),
            buf_s.data_ptr(), buf_i.data_ptr(),
            tmp_s.data_ptr(), tmp_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_for(lib, err, "ell_topk")
    ell_topk.launches += 1
    return out_s, out_i


ell_topk.launches = 0
