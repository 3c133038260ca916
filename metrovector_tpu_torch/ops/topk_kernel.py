"""Fused distance + top-k: the wrappers of the Hopper kernels
``csrc/topk_kernel.cu`` (precision ``"highest"``: f32 FFMA, also over int8
codes dequantized as they are staged, ``affine``),
``csrc/topk_high_kernel.cu`` (``"high"``: the bf16x3 split on the tensor
cores) and ``csrc/topk_int_kernel.cu`` (int8 queries over an int8 corpus:
exact integer dots on the tensor cores), and their plain PyTorch versions.

Replaces ``metrovector_tpu/ops/topk_kernel.py::fused_topk``. A CUDA tensor
goes to a kernel or the call raises; a CPU tensor goes to
:func:`fused_topk_reference`. ``fused_topk.launches`` counts launches of the
FFMA kernel over a float corpus, ``launches_affine`` over an affine int8
one, ``launches_high`` those of the bf16x3 kernel and ``launches_int`` those
of the integer kernel (the passes of one call count once), so a run can
show that its main path went through them.

Like the TPU kernel it takes any ``1 ≤ k ≤ N`` and any D: above k = 256 the
per-split lists move from shared memory into device memory and a merge
tree folds them (:mod:`.select`); queries and corpus are staged 16 dims at
a time, so any D takes the same kernel. The Mosaic/VMEM tuning knobs of the TPU
kernel (``block_rows``, ``query_tile``, ``merge``, ``vmem_retry``) have no
counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from ..format.constants import DistanceMetric

from . import select
from .distances import deferred_scale, exact_topk, exact_topk_int

SMEM_LIMIT = 232_448  # bytes of shared memory a block may opt into (sm_90)
# Shape constants of csrc/topk_kernel.cu
SMEM_K = 256  # lists in shared memory up to this k
# Block tiles (queries, rows) by TileId; a chunk of 16 dims of the tile's
# queries and rows is staged at once. The default build has 32 x 256 only,
# the faster tile at every measured batch (tools/scan_kernel_sweep.py, which
# builds both with -DMVT_K1_ALL_TILES; PERF.md).
TILE_32x256, TILE_64x128 = 0, 1
_TILES = {TILE_32x256: (32, 256), TILE_64x128: (64, 128)}
_TILE = TILE_32x256
_CHUNK = 16
_BUFFER = 64

# Shape constants of csrc/topk_high_kernel.cu: 64 x 128 block tiles, a ring
# of 3 chunks, lists in shared memory up to HIGH_SMEM_K.
HIGH_QB, HIGH_RB, HIGH_STAGES, HIGH_SMEM_K = 64, 128, 3, 128
# Shape constants of csrc/topk_int_kernel.cu: 64 x 128 block tiles, lists
# in shared memory up to INT_SMEM_K; queries are read 16 bytes at a time.
INT_QB, INT_RB, INT_SMEM_K, INT_PIECE = 64, 128, 128, 16
INT_MAX_D = 2**17  # int32 dots of int8 stay exact below this D
_PRECISIONS = ("highest", "high")

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_AFFINE_CODE = 3  # an int8 corpus read as (c + off) * scale
_METRICS = (
    DistanceMetric.L2, DistanceMetric.INNER_PRODUCT, DistanceMetric.COSINE
)


def fused_topk_reference(
    queries: torch.Tensor,
    db: torch.Tensor,
    db_norms: torch.Tensor,
    num_valid: int,
    k: int,
    metric,
    valid_mask: torch.Tensor | None = None,
    precision: str = "highest",
    scale: float = 1.0,
    bias_row: torch.Tensor | None = None,
    bias_scale: float = 1.0,
    affine: tuple[float, float] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_topk` (same signature and results):
    :func:`~.distances.exact_topk` with the kernel's cosine epilogue, which
    takes queries as already normalized. At ``"high"`` the dots are
    :func:`~.distances.bf16x3_dots`: the kernel's products exactly, summed
    in another order. int8 queries: :func:`~.distances.exact_topk_int`;
    ``affine``: the int8 corpus dequantized a block at a time."""
    metric = DistanceMetric(metric)
    _check_precision(precision, db)
    if queries.dtype == torch.int8:
        return exact_topk_int(queries, db, db_norms, int(num_valid), k, metric,
                              valid_mask=valid_mask, scale=scale,
                              bias_row=bias_row, bias_scale=bias_scale)
    inv_q = None
    if metric == DistanceMetric.COSINE:
        inv_q = torch.ones(queries.shape[0], device=queries.device)
    return exact_topk(queries, db, db_norms, int(num_valid), k, metric,
                      valid_mask=valid_mask, query_inv_norms=inv_q,
                      precision=precision, affine=affine)


def _shared_bytes(k: int, tile: int = _TILE) -> int:
    """Dynamic shared memory of one scan block: two chunks of the queries
    and of the corpus (f32 in shared memory whatever the corpus dtype), the
    8 warps' 32 votes, and per query the bar, the score row, the buffer and
    its fill, and the list (none above :data:`SMEM_K`: it lives in device
    memory)."""
    qb, rb = _TILES[tile]
    chunks = 2 * _CHUNK * (qb + rb) * 4
    lists = 0 if k > SMEM_K else k
    return chunks + 4 * 256 + qb * (8 + 4 * rb + 8 * _BUFFER + 4 + 8 * lists)


def _shared_bytes_high(k: int) -> int:
    """Dynamic shared memory of one bf16x3 scan block: the ring of chunks
    (f32 rows; the queries' hi and lo words), and per query the bar, the
    score row, the candidate words, the buffer and its fill, and the list
    (none above :data:`HIGH_SMEM_K`)."""
    chunks = HIGH_STAGES * 16 * 4 * (HIGH_QB + HIGH_RB)
    lists = 0 if k > HIGH_SMEM_K else k
    return chunks + HIGH_QB * (8 + 4 * HIGH_RB + HIGH_RB // 8 + 8 * _BUFFER
                               + 4 + 8 * lists)


def _check_precision(precision: str, db: torch.Tensor) -> None:
    if precision not in _PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {', '.join(_PRECISIONS)}")
    if precision == "high" and db.dtype != torch.float32:
        raise ValueError(
            f"precision='high' splits an f32 corpus into bf16 halves; db is {db.dtype}"
        )


def _check_dtypes(queries, db, bias_row, affine) -> None:
    """The three forms: int8 queries over an int8 corpus (optional
    ``bias_row``); f32 queries over an int8 corpus with ``affine``; f32
    queries over an f32, f16 or bf16 corpus."""
    if queries.dtype == torch.int8:
        if db.dtype != torch.int8 or affine is not None:
            raise ValueError("int8 queries take an int8 db and no affine")
        if queries.dim() == 2 and queries.shape[1] >= INT_MAX_D:
            raise ValueError(f"D={queries.shape[1]}: int8 dots are exact for "
                             f"D < {INT_MAX_D}")
        return
    if bias_row is not None:
        raise ValueError("bias_row goes with int8 queries")
    if (db.dtype == torch.int8) != (affine is not None):
        raise ValueError("an int8 db takes int8 queries or an affine "
                         "dequantization (off, scale)")


def _check(queries, db, db_norms, k, valid_mask, bias_row=None,
           affine=None) -> None:
    _check_dtypes(queries, db, bias_row, affine)
    dev = queries.device
    named = [("db", db), ("db_norms", db_norms)]
    if valid_mask is not None:
        named.append(("valid_mask", valid_mask))
    if bias_row is not None:
        named.append(("bias_row", bias_row))
    for name, t in named:
        if t.device != dev:
            raise ValueError(
                f"{name} is on {t.device}, queries on {dev}: one device only"
            )
    if queries.dtype not in (torch.float32, torch.int8) or queries.dim() != 2:
        raise ValueError("queries must be a [Q, D] float32 or int8 tensor")
    if db.dim() != 2 or (db.dtype not in _DTYPE_CODES and db.dtype != torch.int8):
        raise ValueError(
            "db must be a [N, D] float32, float16, bfloat16 or int8 tensor, got "
            f"{db.dtype} with shape {tuple(db.shape)}"
        )
    nq, d = queries.shape
    n = db.shape[0]
    if db.shape[1] != d:
        raise ValueError(f"queries have D={d}, db has D={db.shape[1]}")
    if k < 1 or (n and k > n):  # an empty corpus leaves every slot unfilled
        raise ValueError(f"k={k} is outside the kernel's limit 1 <= k <= N={n}")
    if d < 1:
        raise ValueError("queries and db need at least one dimension")
    if n >= 2**31:
        raise ValueError(f"N={n} rows: the kernel's row indices are int32")
    for name, t in named[1:]:
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be a [{n}] float32 tensor")
    # The integer kernel reads rows of any stride (the engine's blocks are
    # padded past D); the others need contiguous tensors.
    strided = {"queries", "db"} if queries.dtype == torch.int8 else set()
    for name, t in [("queries", queries)] + named:
        if not (t.stride(-1) == 1 if name in strided else t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous"
                             + (" along its rows" if name in strided else ""))


def fused_topk(
    queries: torch.Tensor,
    db: torch.Tensor,
    db_norms: torch.Tensor,
    num_valid: int,
    k: int,
    metric,
    valid_mask: torch.Tensor | None = None,
    precision: str = "highest",
    scale: float = 1.0,
    bias_row: torch.Tensor | None = None,
    bias_scale: float = 1.0,
    affine: tuple[float, float] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``queries [Q, D]`` f32 (pre-normalized for cosine)
    over ``db [N, D]`` (f32 / f16 / bf16) with squared norms
    ``db_norms [N]`` f32; rows ≥ ``num_valid`` and rows where
    ``valid_mask [N]`` (f32) is 0 never enter. Returns ``(scores [Q, k]
    f32, indices [Q, k] int32)`` by (score descending, index ascending);
    unfilled slots hold (−inf, −1). On CUDA ``1 ≤ k ≤ N``, any D.

    ``precision``: ``"highest"`` (f32 dots, the FFMA kernel) or ``"high"``
    (an f32 ``db`` only: the reference's in-kernel bf16x3 split,
    ``q_hi·x_hi + q_hi·x_lo + q_lo·x_hi`` with exact products and f32
    sums, on the tensor cores).

    The reference's integer path: int8 ``queries`` over an int8 ``db``
    (D < 2¹⁷), exact int32 dots rounded to f32, times ``scale``, plus
    ``bias_scale·bias_row [N]`` f32 when given (uint8 offset spaces), each
    rounded to f32, then the metric; int8 inner product with no bias and
    ``scale > 0`` ranks the raw dots and scales the k outputs
    (:func:`~.distances.deferred_scale`). There ``queries`` and ``db`` may
    be row-strided views (``stride(1) == 1``), such as the first D columns
    of padded blocks: the kernel reads D bytes a row. ``affine = (off, scale)``: f32
    queries over an int8 ``db`` read as ``(c + off)·scale`` in f32 (the
    uint8 cosine space), by the FFMA kernel."""
    metric = DistanceMetric(metric)
    if metric not in _METRICS:
        raise NotImplementedError(f"metric {metric!r} has no built-in score kernel")
    _check_precision(precision, db)
    if queries.device.type == "cpu":
        _check_dtypes(queries, db, bias_row, affine)
        return fused_topk_reference(queries, db, db_norms, num_valid, k,
                                    metric, valid_mask, precision, scale,
                                    bias_row, bias_scale, affine)
    if queries.device.type != "cuda":
        raise ValueError(f"fused_topk runs on CUDA or CPU, not {queries.device}")
    _check(queries, db, db_norms, k, valid_mask, bias_row, affine)
    from ._build import load

    lib = load()
    nq = queries.shape[0]
    n = db.shape[0]
    dev = queries.device
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0 or n == 0:  # nothing to scan: every slot stays unfilled
        return out_s.fill_(float("-inf")), out_i.fill_(-1)
    with torch.cuda.device(dev):
        if queries.dtype == torch.int8:
            _launch_int(lib, queries, db, db_norms, valid_mask, bias_row,
                        num_valid, k, metric, scale, bias_scale,
                        deferred_scale(db, metric, bias_row, scale), out_s, out_i)
            fused_topk.launches_int += 1
        elif precision == "high":
            _launch_high(lib, queries, db, db_norms, valid_mask, num_valid, k,
                         metric, out_s, out_i)
            fused_topk.launches_high += 1
        else:
            _launch(lib, queries, db, db_norms, valid_mask, num_valid, k,
                    metric, _TILE, out_s, out_i, affine=affine)
            if affine is None:
                fused_topk.launches += 1
            else:
                fused_topk.launches_affine += 1
    return out_s, out_i


def _plan(dev, nq, n, k, smem_k, tile, occupancy, splits=None):
    """The host plan of one launch: ``(splits, rows_per_split, length,
    tree, part_s, part_i, tmp_s, tmp_i, slots)`` for a kernel whose blocks
    take ``tile = (queries, rows)`` and keep lists of up to ``smem_k`` in
    shared memory. ``occupancy(k_smem, big)`` returns the scan blocks that
    fit on one SM; ``splits`` (default: one wave, as many scan blocks as
    fit on the card at once) sets the row splits, fewer above ``smem_k`` if
    the lists would pass the scratch bound."""
    big = k > smem_k
    if splits is None:
        per_sm = occupancy(min(k, smem_k), int(big))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = max(1, sms * max(1, per_sm) // -(-nq // tile[0]))
    splits, rows_per_split, length = select.row_splits(
        n, tile[1], splits, nq, k, lists_in_smem=not big)
    tree = select.merge_by_tree(splits, k, not big)
    scratch = select.scratch(nq, splits, length, k, dev, tree=tree)
    slots = select.bar_slots(nq, splits, dev)
    return (splits, rows_per_split, length, tree) + tuple(scratch) + (slots,)


def _occupancy(lib, entry, what, *args):
    """``occupancy(k_smem, big)`` for :func:`_plan` through the library's
    occupancy entry point ``entry`` (leading arguments ``args``)."""
    from ._build import raise_for

    def per_sm(k_smem, big):
        out = ctypes.c_int(0)
        raise_for(lib, entry(*args, k_smem, big, ctypes.byref(out)), what)
        return out.value

    return per_sm


def _launch_high(lib, queries, db, db_norms, valid_mask, num_valid, k, metric,
                 out_s, out_i) -> None:
    """One launch of the query split, the bf16x3 scan and the merge for
    checked inputs into ``out_s``/``out_i``, with one wave of scan blocks
    (as :func:`_launch`)."""
    from ._build import raise_for

    nq, d = queries.shape
    n = db.shape[0]
    dev = queries.device
    splits, rows_per_split, length, tree, part_s, part_i, tmp_s, tmp_i, slots = _plan(
        dev, nq, n, k, HIGH_SMEM_K, (HIGH_QB, HIGH_RB),
        _occupancy(lib, lib.mvt_fused_topk_high_occupancy, "fused_topk[high]"))
    # The split queries: per query and 16 dims, 16 words of bf16 pairs.
    qsplit = torch.empty(nq * -(-d // _CHUNK) * 16, dtype=torch.int32,
                         device=dev)
    err = lib.mvt_fused_topk_high(
        queries.data_ptr(), qsplit.data_ptr(), db.data_ptr(),
        db_norms.data_ptr(),
        None if valid_mask is None else valid_mask.data_ptr(),
        nq, n, d, max(0, min(int(num_valid), n)), k, int(metric),
        splits, rows_per_split, length, int(tree),
        part_s.data_ptr(), part_i.data_ptr(), slots.data_ptr(),
        tmp_s.data_ptr(), tmp_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_for(lib, err, "fused_topk[high]")


def _launch_int(lib, queries, db, db_norms, valid_mask, bias_row, num_valid,
                k, metric, scale, bias_scale, defer, out_s, out_i) -> None:
    """One launch of the integer scan, the merge and (``defer``) the scale
    for checked inputs into ``out_s``/``out_i``, with one wave of scan
    blocks (as :func:`_launch`). The kernel reads the queries 16 bytes at a
    time: they go over as they are where D is a multiple of 16 and their
    rows are 16-byte aligned, else copied into rows of zeros up to the next
    multiple of 16."""
    from ._build import raise_for

    nq, d = queries.shape
    n = db.shape[0]
    dev = queries.device
    splits, rows_per_split, length, tree, part_s, part_i, tmp_s, tmp_i, slots = _plan(
        dev, nq, n, k, INT_SMEM_K, (INT_QB, INT_RB),
        _occupancy(lib, lib.mvt_fused_topk_int_occupancy, "fused_topk[int8]"))
    if d % INT_PIECE or queries.stride(0) % INT_PIECE or queries.data_ptr() % INT_PIECE:
        width = -(-d // INT_PIECE) * INT_PIECE
        queries = torch.zeros((nq, width), dtype=torch.int8,
                              device=dev).narrow(1, 0, d).copy_(queries)
    err = lib.mvt_fused_topk_int(
        queries.data_ptr(), queries.stride(0), db.data_ptr(), db.stride(0),
        db_norms.data_ptr(),
        None if valid_mask is None else valid_mask.data_ptr(),
        None if bias_row is None else bias_row.data_ptr(),
        float(scale), float(bias_scale), int(defer),
        nq, n, d, max(0, min(int(num_valid), n)), k, int(metric),
        splits, rows_per_split, length, int(tree),
        part_s.data_ptr(), part_i.data_ptr(), slots.data_ptr(),
        tmp_s.data_ptr(), tmp_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_for(lib, err, "fused_topk[int8]")


def _launch(lib, queries, db, db_norms, valid_mask, num_valid, k, metric,
            tile, out_s, out_i, splits=None, affine=None) -> None:
    """One launch of the scan and the merge for checked inputs with block
    tile ``tile`` (a tile the library was built with) into
    ``out_s``/``out_i``. ``splits`` as in :func:`_plan`; ``affine = (off,
    scale)``: an int8 ``db`` dequantized as it is staged."""
    from ._build import raise_for

    nq, d = queries.shape
    n = db.shape[0]
    dev = queries.device
    code = _AFFINE_CODE if affine is not None else _DTYPE_CODES[db.dtype]
    off, sc = affine if affine is not None else (0.0, 1.0)
    splits, rows_per_split, length, tree, part_s, part_i, tmp_s, tmp_i, slots = _plan(
        dev, nq, n, k, SMEM_K, _TILES[tile],
        _occupancy(lib, lib.mvt_fused_topk_occupancy, "fused_topk", code, tile),
        splits)
    err = lib.mvt_fused_topk(
        queries.data_ptr(), db.data_ptr(), code, float(off), float(sc),
        db_norms.data_ptr(),
        None if valid_mask is None else valid_mask.data_ptr(),
        nq, n, d, max(0, min(int(num_valid), n)), k, int(metric), tile,
        splits, rows_per_split, length, int(tree),
        part_s.data_ptr(), part_i.data_ptr(),
        slots.data_ptr(),
        tmp_s.data_ptr(), tmp_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_for(lib, err, "fused_topk")


fused_topk.launches = 0
fused_topk.launches_affine = 0
fused_topk.launches_high = 0
fused_topk.launches_int = 0
