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
* :func:`query_postings` turns a batch into the postings both kernels walk:
  per (query tile, term), the tile's nonzero query values, queries
  ascending. It runs on the card inside both wrappers.

Both versions add a row's products in ascending slot order, then its
overflow entries in order, each product and each sum rounded to f32 on its
own, so kernel and plain version agree bit for bit; the kernels skip the
products of zero query values, which leave such a sum unchanged (the
source's note says why). A CUDA tensor goes to the kernel or the call
raises; a CPU tensor goes to the plain version. On CUDA a batch whose
worst-case postings would pass :data:`_POSTINGS_CAP` entries runs as
chunks of whole query tiles, one launch each (:func:`_query_chunks`).
``ell_dots.launches``, ``ell_topk.launches`` and
``query_postings.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..format.constants import DistanceMetric
from . import select
from .distances import carry_topk, empty_topk, finish_topk
from .grid import check_grid, wave_blocks

# Shape constants of csrc/sparse_kernel.cu
_QUERY_GROUPS = (1, 2, 4, 8)  # a block covers 32 x QG queries
QUERY_TILES = tuple(32 * g for g in _QUERY_GROUPS)  # grid.tile candidates
# ell_topk's rows a score tile, by QG: the shapes the kernel is built with
_TILE_ROWS = {1: 32, 2: 32, 4: 32, 8: 16}
_SMEM_LIST_K = 16  # ell_topk keeps lists of k up to this in shared memory
_POSTING_KEYS = 8  # (query tile, term) keys a block of the postings build
_POSTINGS_CAP = 2**27  # postings entries one launch may size (1 GiB)
_BUFFER = 64
_MERGE_MAX_K = 1024  # select.cuh's merge_kernel takes lists of k up to this
_MERGE_MAX_SPLITS = 64  # past this many lists, the merge tree folds them
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


def _tile_shape(nq: int, tile: int | None = None) -> tuple[int, int]:
    """``(qg, rows)`` of an ell_topk score tile for a batch of ``nq``: the
    fewest query groups (32 queries each, at most 8) that hold the batch,
    or ``tile // 32`` of them, and the rows a tile for that width (16 or
    32: at most half a 64-entry buffer; chosen by measurement, PERF.md).
    ell_dots and the postings use the same query groups."""
    if tile is not None:
        return tile // 32, _TILE_ROWS[tile // 32]
    qg = next((g for g in _QUERY_GROUPS if 32 * g >= nq), _QUERY_GROUPS[-1])
    return qg, _TILE_ROWS[qg]


def _query_chunks(dim: int, nq: int) -> list[tuple[int, int]]:
    """The ranges ``[q0, q1)`` of a batch of ``nq`` queries over ``dim``
    terms that the kernels take one launch each: as many whole 256-query
    tiles as keep a launch's worst-case postings (``dim`` entries a query)
    within :data:`_POSTINGS_CAP` entries, and never fewer than 32 queries.
    The postings' offsets are int32, so ``32 · dim`` must stay below 2^31."""
    if 32 * dim >= 2**31:
        raise ValueError(f"dim={dim}: the postings of 32 queries pass int32 offsets")
    step = _POSTINGS_CAP // max(dim, 1)
    step = step // 256 * 256 if step >= 256 else max(32, step // 32 * 32)
    return [(q0, min(nq, q0 + step)) for q0 in range(0, nq, step)]


def _shared_bytes(qg: int, rows: int, list_len: int) -> int:
    """Dynamic shared memory of one ell_topk block of 32·``qg`` queries and
    ``rows`` rows whose lists hold ``list_len`` entries: the score tile,
    each of the 8 warps' tags, per query the candidate rows and the bar,
    and the lists themselves when ``list_len`` ≤ :data:`_SMEM_LIST_K`
    (longer ones live in device scratch)."""
    lists = 8 * list_len if list_len <= _SMEM_LIST_K else 0
    return 32 * qg * (4 * (rows + 1) + 4 * 8 + 12 + lists)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device_index: int, qg: int, rows: int, list_len: int) -> int:
    """ell_topk blocks of shape (``qg``, ``rows``) with lists of
    ``list_len`` an SM holds at once, from the runtime's occupancy
    calculator on the current device."""
    from ._build import load, raise_for

    lib = load()
    per_sm = ctypes.c_int(0)
    raise_for(lib, lib.mvt_ell_topk_occupancy(qg, rows, list_len,
                                               ctypes.byref(per_sm)), "ell_topk")
    return max(1, per_sm.value)


def query_postings_reference(qt: torch.Tensor, qtile: int
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`query_postings`: ``(qptr, post_q, post_v)``
    with ``post_*`` exactly as long as the nonzeros."""
    dim, nq = qt.shape
    tiles = -(-nq // qtile)
    x = torch.nn.functional.pad(qt, (0, tiles * qtile - nq))
    x = x.reshape(dim, tiles, qtile).permute(1, 0, 2)  # [tiles, dim, qtile]
    nz = x != 0  # drops ±0, keeps inf and NaN
    qptr = torch.zeros(tiles * dim + 1, dtype=torch.int32, device=qt.device)
    qptr[1:] = torch.cumsum(nz.sum(2).reshape(-1), 0)
    b, _, j = nz.nonzero(as_tuple=True)  # (tile, term, query) ascending
    return qptr, (b * qtile + j).to(torch.int32), x[nz]


def query_postings(qt: torch.Tensor, qtile: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The nonzero values of ``qt [dim, Q]`` f32 as postings keyed by
    (query tile of ``qtile`` queries, term): ``qptr [tiles · dim + 1]``
    int32, where key ``b · dim + c`` owns ``post_q`` (int32, the global
    query index, ascending within a key) and ``post_v`` (f32) entries
    ``qptr[key] .. qptr[key + 1]``. An entry is kept where ``qt[c, q] != 0``:
    −0 is dropped, inf and NaN are kept. On CUDA the build never waits on
    the host: ``post_*`` have room for ``dim · Q`` entries, of which the
    first ``qptr[-1]`` are written, and are the two columns of one
    ``[dim · Q, 2]`` int32 buffer (:func:`_packed_postings`); ``dim · Q``
    must stay below 2^31 there. The kernels' wrappers build the postings of
    a large batch a chunk of queries at a time (:func:`_query_chunks`)."""
    if qt.device.type == "cpu":
        return query_postings_reference(qt, qtile)
    qptr, packed = _packed_postings(qt, qtile)
    return qptr, packed[:, 0], packed[:, 1].view(torch.float32)


def _packed_postings(qt: torch.Tensor, qtile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(qptr, post [dim · Q, 2] int32)`` of :func:`query_postings` on
    CUDA, each entry (query, value bits) side by side as the kernels read
    it."""
    if qt.device.type != "cuda":
        raise ValueError(f"query_postings runs on CUDA or CPU, not {qt.device}")
    if qt.dtype != torch.float32 or qt.dim() != 2 or not qt.is_contiguous():
        raise ValueError("qt must be a contiguous [dim, Q] float32 tensor")
    if qtile < 32 or qtile % 32:
        raise ValueError(f"qtile={qtile} must be a positive multiple of 32")
    dim, nq = qt.shape
    if dim * nq >= 2**31:
        raise ValueError(f"dim x Q = {dim * nq}: the postings' offsets are int32")
    from ._build import load, raise_for

    lib = load()
    keys = -(-nq // qtile) * dim
    dev = qt.device
    qptr = torch.empty(keys + 1, dtype=torch.int32, device=dev)
    post = torch.empty((dim * nq, 2), dtype=torch.int32, device=dev)
    scratch = torch.empty(keys + -(-keys // _POSTING_KEYS), dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        err = lib.mvt_query_postings(
            qt.data_ptr(), dim, nq, qtile, scratch.data_ptr(), qptr.data_ptr(),
            post.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    raise_for(lib, err, "query_postings")
    query_postings.launches += 1
    return qptr, post


query_postings.launches = 0


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
    dim, nq = qt.shape
    out = torch.empty((n, nq), dtype=torch.float32, device=qt.device)
    if out.numel() == 0:
        return out
    for q0, q1 in _query_chunks(dim, nq):
        qc = qt if q1 - q0 == nq else qt[:, q0:q1].contiguous()
        qg, _ = _tile_shape(q1 - q0)
        qptr, post = _packed_postings(qc, 32 * qg)
        with torch.cuda.device(qt.device):
            err = lib.mvt_ell_dots(qc.data_ptr(), qptr.data_ptr(), post.data_ptr(),
                                   dim, cols.data_ptr(), vals.data_ptr(), n, r,
                                   q1 - q0, qg, out[:, q0:q1].data_ptr(), nq,
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
    grid=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``qt [dim, Q]`` f32 (columns pre-normalized for
    cosine) over the ELL rows ``cols``/``vals`` ``[n, R]`` plus their
    overflow (``ovf_ptr [n + 1]`` int64 into ``ovf_cols`` int32 /
    ``ovf_vals`` f32, or three Nones), with squared norms ``norms [n]`` f32;
    rows ≥ ``num_rows`` and rows where ``valid_mask [n]`` (f32) is 0 never
    enter. Returns ``(scores [Q, k] f32, rows [Q, k] int32)`` by (score
    descending, row ascending); unfilled slots hold (−inf, −1). On CUDA
    ``1 ≤ k ≤ n``. ``grid``: a :class:`.grid.Grid` whose ``waves`` multiply
    the one-wave split count and whose ``tile`` (:data:`QUERY_TILES`) is a
    block's queries, or None for one wave and :func:`_tile_shape`'s tile;
    the plain version ignores it."""
    metric = DistanceMetric(metric)
    if metric not in _METRICS:
        raise NotImplementedError(f"metric {metric!r} has no built-in score kernel")
    grid = check_grid(grid, QUERY_TILES, "ell_topk")
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
    dim, nq = qt.shape
    out_s = torch.empty((nq, k), dtype=torch.float32, device=qt.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=qt.device)
    if nq == 0 or n == 0:  # nothing to scan: every slot stays unfilled
        return out_s.fill_(float("-inf")), out_i.fill_(-1)
    for q0, q1 in _query_chunks(dim, nq):
        qc = qt if q1 - q0 == nq else qt[:, q0:q1].contiguous()
        _ell_topk_launch(qc, cols, vals, ovf_ptr, ovf_cols, ovf_vals, norms,
                         num_rows, k, metric, valid_mask,
                         _tile_shape(q1 - q0, None if grid is None else grid.tile),
                         out_s[q0:q1], out_i[q0:q1], grid)
    return out_s, out_i


def _ell_topk_launch(qt, cols, vals, ovf_ptr, ovf_cols, ovf_vals, norms,
                     num_rows, k, metric, valid_mask, shape, out_s, out_i,
                     grid=None) -> None:
    """One launch of :func:`ell_topk`'s postings build, scan and merge for
    the checked inputs, with score tiles of ``shape`` = (qg, rows) (a shape
    the library was built with), into ``out_s``/``out_i`` ``[Q, k]``, with
    one wave of scan blocks times ``grid``'s waves."""
    from ._build import load, raise_for

    lib = load()
    n, r = cols.shape
    dim, nq = qt.shape
    dev = qt.device
    qg, rows = shape
    qptr, post = _packed_postings(qt, 32 * qg)
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        per_sm = _blocks_per_sm(dev.index, qg, rows, min(k, n))
        want = max(1, wave_blocks(sms * per_sm, grid) // -(-nq // (32 * qg)))
        splits, rows_per_split, length = select.row_splits(
            n, rows, want, nq, k, lists_in_smem=False)
        tree = not (length == k and k <= _MERGE_MAX_K
                    and splits <= _MERGE_MAX_SPLITS)
        part_s, part_i, tmp_s, tmp_i = select.scratch(nq, splits, length, k,
                                                      dev, tree=tree)
        buf_s = torch.empty(nq * splits * _BUFFER, dtype=torch.float32, device=dev)
        buf_i = torch.empty(nq * splits * _BUFFER, dtype=torch.int32, device=dev)
        # Per query, the best k-th entry of any split's full list: shared
        # only when every list is k long (a shorter one's last entry is no
        # bound on the top k).
        kth_key = (torch.zeros(nq, dtype=torch.int64, device=dev)
                   if length == k else None)
        has_ovf = ovf_ptr is not None and ovf_cols.numel() > 0
        err = lib.mvt_ell_topk(
            qt.data_ptr(), qptr.data_ptr(), post.data_ptr(),
            dim, cols.data_ptr(), vals.data_ptr(),
            ovf_ptr.data_ptr() if has_ovf else None,
            ovf_cols.data_ptr() if has_ovf else None,
            ovf_vals.data_ptr() if has_ovf else None,
            norms.data_ptr(),
            None if valid_mask is None else valid_mask.data_ptr(),
            nq, n, r, max(0, min(int(num_rows), n)), k, int(metric),
            qg, rows, splits, rows_per_split, length, int(tree),
            part_s.data_ptr(), part_i.data_ptr(),
            buf_s.data_ptr(), buf_i.data_ptr(),
            None if kth_key is None else kth_key.data_ptr(),
            tmp_s.data_ptr(), tmp_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_for(lib, err, "ell_topk")
    ell_topk.launches += 1


ell_topk.launches = 0
