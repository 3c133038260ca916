"""Fused distance + top-k: the wrappers of the Hopper kernels
``csrc/topk_kernel.cu`` (precision ``"highest"``: f32 FFMA over an f32, f16
or bf16 corpus, also over int8 codes dequantized as they are staged,
``affine``), ``csrc/topk_high_kernel.cu`` (``"high"``: the bf16x3 split on
the tensor cores) and ``csrc/topk_int_kernel.cu`` (one pass on the tensor
cores: int8 queries over an int8 corpus, exact integer dots; or, at
``"default"``, bf16 queries over a bf16 corpus, exact products summed in
f32), and their plain PyTorch versions.
:func:`kernel_precision` names the precision that scans a space of a given
dtype.

Replaces ``metrovector_tpu/ops/topk_kernel.py::fused_topk`` and
``fused_topk_presampled``. A CUDA tensor goes to a kernel or the call
raises; a CPU tensor goes to :func:`fused_topk_reference`.
``fused_topk.launches`` counts launches of the FFMA kernel over a float
corpus, ``launches_affine`` over an affine int8 one, ``launches_high`` those
of the bf16x3 kernel, ``launches_int`` those of the one-pass kernel over
int8 and ``launches_bf16`` over bf16 (the passes of one call count once), ``launches_presampled`` the two-phase calls of
:func:`fused_topk_presampled` (each of whose phases also counts on its
route), so a run can show that its main path went through them.

A seed (``seed_s``, ``seed_i``: the exact top-k of rows the scan leaves out,
``exclude_stride`` or a mask) starts every split's bar at the key of its
k-th entry and enters the final merge once, as lists of its own
(``csrc/select.cuh``'s ``seed_floor`` and ``seed_lists_kernel``), on all
four kernels.

Like the TPU kernel it takes any ``1 ≤ k ≤ N`` and any D: above k = 256 the
per-split lists move from shared memory into device memory and a merge
tree folds them (:mod:`.select`); queries and corpus are staged 16 dims at
a time, so any D takes the same kernel. The Mosaic/VMEM tuning knobs of the TPU
kernel (``block_rows``, ``query_tile``, ``merge``, ``vmem_retry``) have no
counterpart here; ``grid`` (:class:`.grid.Grid`) moves the one-wave split
count of every route (the library holds one block tile, so no ``tile``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

from ..format.constants import DataType, DistanceMetric
from ..utils.timing import RECORDER

from . import select
from .grid import check_grid, wave_blocks
from .distances import (
    deferred_scale, exact_topk, exact_topk_int, f32_scalar, finish_topk,
)

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

# Shape constants of the tensor-core scans (csrc/wgmma_scan.cuh): a stage
# holds SCAN_ROWS rows (the wgmma M); a tile of queries is two consumer
# warpgroups of NW queries each (the wgmma N); a query's candidate buffer
# holds SCAN_BUF (select.cuh's kBuf); lists live in shared memory up to
# SCAN_SMEM_K where they fit beside a ring of at least MIN_STAGES stages,
# else in device memory.
SCAN_ROWS, SCAN_BUF, SCAN_SMEM_K, MIN_STAGES = 64, 64, 128, 2
SCAN_ALIGN = 16  # TMA reads rows whose stride and base are 16-byte multiples
# csrc/topk_int_kernel.cu: a stage's chunk is 128 bytes of dims; a tile
# takes the whole batch up to 256 queries.
INT_NW, INT_CHUNK, INT_MAX_STAGES = (16, 32, 64, 128), 128, 8
# csrc/topk_high_kernel.cu: a stage's chunk is 32 f32 dims and the chunk's
# split queries (128 bytes a query); tiles of up to 128 queries.
HIGH_NW, HIGH_CHUNK, HIGH_MAX_STAGES = (16, 32, 64), 32, 6
INT_MAX_D = 2**17  # int32 dots of int8 stay exact below this D
_PRECISIONS = ("highest", "high", "default")

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
    seed_s: torch.Tensor | None = None,
    seed_i: torch.Tensor | None = None,
    exclude_stride: int | None = None,
    raw_scores: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_topk` (same signature and results):
    :func:`~.distances.exact_topk` with the kernel's cosine epilogue, which
    takes queries as already normalized. At ``"high"`` the dots are
    :func:`~.distances.bf16x3_dots`: the kernel's products exactly, summed
    in another order; at ``"default"`` the queries are rounded to bf16
    (:func:`bf16_queries`) and the dots are exact f32 matmuls of the bf16
    values, the kernel's products summed in another order. int8 queries:
    :func:`~.distances.exact_topk_int`;
    ``affine``: the int8 corpus dequantized a block at a time. The rows
    ``r % exclude_stride == 0`` are masked out of the scan, and the seed is
    merged with the scan's k best by (score descending, row ascending); in
    the deferred mode both are raw dots and the scale multiplies the merged
    k unless ``raw_scores``."""
    metric = DistanceMetric(metric)
    _check_precision(precision, db)
    if exclude_stride:
        keep = torch.arange(db.shape[0], device=db.device) % int(exclude_stride) != 0
        valid_mask = keep.float() if valid_mask is None else torch.where(
            keep, valid_mask, torch.zeros((), device=db.device))
    defer = False
    if queries.dtype == torch.int8:
        defer = deferred_scale(db, metric, bias_row, scale)
        s, i = exact_topk_int(queries, db, db_norms, int(num_valid), k, metric,
                              valid_mask=valid_mask, scale=scale,
                              bias_row=bias_row, bias_scale=bias_scale,
                              raw_scores=True)
    else:
        if precision == "default":
            queries = bf16_queries(queries)
        inv_q = None
        if metric == DistanceMetric.COSINE:
            inv_q = torch.ones(queries.shape[0], device=queries.device)
        s, i = exact_topk(queries, db, db_norms, int(num_valid), k, metric,
                          valid_mask=valid_mask, query_inv_norms=inv_q,
                          precision=precision, affine=affine)
    if seed_s is not None:
        s, i = merge_seed(s, i, seed_s, seed_i, k)
    if defer and not raw_scores:
        s = s * f32_scalar(scale, s.device)
    return s, i


def bf16_queries(queries: torch.Tensor) -> torch.Tensor:
    """f32 ``queries`` rounded to bf16 (to nearest, ties to even) and held
    as f32, as ``"default"`` scans them: the identity on values bf16 holds,
    so a second rounding changes nothing."""
    return queries.to(torch.bfloat16).float()


def kernel_precision(dtype, precision: str) -> str:
    """The :func:`fused_topk` precision that scans a space of ``dtype``
    (:class:`~..format.constants.DataType`) searched at ``precision`` (the
    engine's: ``"highest"``, ``"high"``, ``"high_verified"`` or
    ``"default"``): ``"default"`` (the one-pass bf16 kernel) for a BFLOAT16
    space at any precision and an f32 space at ``"default"`` (bf16 rows and
    bf16-rounded queries), ``"high"`` for an f32 space at ``"high"`` or
    ``"high_verified"``, else ``"highest"``. An f16 space at ``"default"``
    stays at ``"highest"``: its rows are bf16 but its queries f32, which
    bf16 cannot hold (the FFMA kernel reads them as they are)."""
    dtype = DataType(dtype)
    if dtype == DataType.BFLOAT16 or (dtype == DataType.FLOAT32
                                      and precision == "default"):
        return "default"
    if dtype == DataType.FLOAT32 and precision in ("high", "high_verified"):
        return "high"
    return "highest"


def merge_seed(s: torch.Tensor, i: torch.Tensor, seed_s: torch.Tensor,
               seed_i: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best of a scan's ``(s, i) [Q, k]`` and a seed ``[Q, k']`` of
    other rows, by (score descending, row ascending); unfilled slots
    (−inf, −1)."""
    big = torch.iinfo(torch.int64).max
    cand_s = torch.cat([seed_s.float(), s], dim=1)
    cand_i = torch.cat([seed_i.long(), i.long()], dim=1)
    cand_i = torch.where(torch.isneginf(cand_s), big, cand_i)
    order = torch.sort(cand_i, dim=1, stable=True).indices
    cand_s, cand_i = cand_s.gather(1, order), cand_i.gather(1, order)
    order = torch.sort(-cand_s, dim=1, stable=True).indices[:, :k]
    return finish_topk((cand_s.gather(1, order), cand_i.gather(1, order)), k)


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


class ScanShape(NamedTuple):
    """The shape of one tensor-core scan launch: ``nw`` queries per consumer
    warpgroup (a tile of ``2 nw``), ``stages`` in the ring, the tile's
    queries ``resident`` in shared memory (the integer scan), the lists in
    device memory (``big``), and the block's dynamic shared memory."""

    nw: int
    stages: int
    resident: bool
    big: bool
    smem: int


def _sel_bytes(nw: int, k_smem: int) -> int:
    """``wgmma_scan.cuh::sel_bytes``: one consumer warpgroup's selection
    state, per query the bar key, the epilogue's bar, the buffer's offers,
    the buffer and ``k_smem`` list entries."""
    raw = nw * (8 + 4 + 4 + 8 * SCAN_BUF + 8 * k_smem)
    return -(-raw // 16) * 16


def _scan_smem(stage: int, stages: int, q_bytes: int, nw: int, k_smem: int) -> int:
    """``wgmma_scan.cuh::scan_smem``: alignment slack, the ring, resident
    queries, two warpgroups' selection state and the barriers."""
    return (1024 + stages * stage + q_bytes + 2 * _sel_bytes(nw, k_smem)
            + 8 * (2 * stages + 1))


def _tile_nw(nq: int, choices: tuple[int, ...]) -> int:
    """The least NW of ``choices`` whose tile of 2 NW holds the batch, or
    the largest."""
    for nw in choices:
        if 2 * nw >= nq:
            return nw
    return choices[-1]


def _scan_shape(nq: int, k: int, choices, max_stages: int, stage_of,
                q_bytes_of) -> ScanShape:
    """The largest tile (the batch's, where it fits) whose state and a ring
    of at least :data:`MIN_STAGES` fit in :data:`SMEM_LIMIT`: lists in
    shared memory if ``k`` allows, else in device memory; queries resident
    where ``q_bytes_of`` allows, else streamed with each stage. Then as
    many stages as fit, up to ``max_stages``."""
    top = choices.index(_tile_nw(nq, choices))
    for nw in choices[top::-1]:
        for big in ([False] if k <= SCAN_SMEM_K else []) + [True]:
            k_smem = 0 if big else k
            for resident in (True, False) if q_bytes_of else (False,):
                stage = stage_of(2 * nw, resident)
                q_bytes = q_bytes_of(2 * nw) if resident else 0
                fixed = _scan_smem(0, 0, q_bytes, nw, k_smem)
                stages = min(max_stages, (SMEM_LIMIT - fixed) // (stage + 16))
                if stages >= MIN_STAGES:
                    return ScanShape(nw, stages, resident, big,
                                     _scan_smem(stage, stages, q_bytes, nw, k_smem))
    raise ValueError(f"no tensor-core scan shape for k={k}")


@functools.lru_cache(maxsize=512)
def _int_shape(nq: int, row_bytes: int, k: int) -> ScanShape:
    """The one-pass scan's shape (csrc/topk_int_kernel.cu) over rows of
    ``row_bytes`` (D for int8, 2 D for bf16): a stage is 64 rows of a
    128-byte chunk (plus the tile's chunk of queries unless they are
    resident, ``ceil(row_bytes / 128)`` chunks of ``2 nw`` queries)."""
    nch = -(-row_bytes // INT_CHUNK)
    return _scan_shape(
        nq, k, INT_NW, INT_MAX_STAGES,
        lambda qb, resident: SCAN_ROWS * INT_CHUNK + (0 if resident else qb * INT_CHUNK),
        lambda qb: nch * qb * INT_CHUNK)


@functools.lru_cache(maxsize=512)
def _high_shape(nq: int, k: int) -> ScanShape:
    """The bf16x3 scan's shape (csrc/topk_high_kernel.cu): a stage is 64 f32
    rows of a 32-dim chunk and the chunk's split queries, 128 bytes each,
    whatever D."""
    return _scan_shape(
        nq, k, HIGH_NW, HIGH_MAX_STAGES,
        lambda qb, resident: SCAN_ROWS * HIGH_CHUNK * 4 + qb * 4 * HIGH_CHUNK,
        None)


def _tma_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` ``[R, D]`` as it is where TMA can read its rows (row stride and
    base address multiples of :data:`SCAN_ALIGN` bytes), else one copy into
    zero-padded rows of the next such stride (its first D columns)."""
    elem = t.element_size()
    if (t.stride(0) * elem) % SCAN_ALIGN == 0 and t.data_ptr() % SCAN_ALIGN == 0:
        return t
    width = -(-t.shape[1] * elem // SCAN_ALIGN) * SCAN_ALIGN // elem
    return torch.zeros((t.shape[0], width), dtype=t.dtype,
                       device=t.device).narrow(1, 0, t.shape[1]).copy_(t)


def _check_precision(precision: str, db: torch.Tensor) -> None:
    if precision not in _PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {', '.join(_PRECISIONS)}")
    if precision == "high" and db.dtype != torch.float32:
        raise ValueError(
            f"precision='high' splits an f32 corpus into bf16 halves; db is {db.dtype}"
        )
    if precision == "default" and db.dtype != torch.bfloat16:
        raise ValueError(
            f"precision='default' scans a bf16 corpus in one pass; db is {db.dtype}"
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
           affine=None, precision="highest") -> None:
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
    # The tensor-core kernels read the corpus's rows at any stride (TMA; the
    # engine's int8 blocks are padded past D, the presampled scan's
    # subsample is every stride-th row), the integer one the queries' too;
    # the rest must be contiguous.
    strided = ({"queries", "db"} if queries.dtype == torch.int8
               else {"db"} if precision in ("high", "default") else set())
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
    seed_s: torch.Tensor | None = None,
    seed_i: torch.Tensor | None = None,
    exclude_stride: int | None = None,
    raw_scores: bool = False,
    *,
    grid=None,
    _seed_stride: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``queries [Q, D]`` f32 (pre-normalized for cosine)
    over ``db [N, D]`` (f32 / f16 / bf16) with squared norms
    ``db_norms [N]`` f32; rows ≥ ``num_valid`` and rows where
    ``valid_mask [N]`` (f32) is 0 never enter. Returns ``(scores [Q, k]
    f32, indices [Q, k] int32)`` by (score descending, index ascending);
    unfilled slots hold (−inf, −1). On CUDA ``1 ≤ k ≤ N``, any D.

    ``precision``: ``"highest"`` (f32 dots, the FFMA kernel), ``"high"``
    (an f32 ``db`` only: the reference's in-kernel bf16x3 split,
    ``q_hi·x_hi + q_hi·x_lo + q_lo·x_hi`` with exact products and f32
    sums, on the tensor cores) or ``"default"`` (a bf16 ``db`` only: the
    reference's one-pass bf16 dot; the queries are rounded to bf16 once,
    :func:`bf16_queries`, and the exact products summed in f32 on the
    tensor cores). A bf16 ``db`` at ``"highest"`` keeps its f32 queries
    and the FFMA kernel.

    The reference's integer path: int8 ``queries`` over an int8 ``db``
    (D < 2¹⁷), exact int32 dots rounded to f32, times ``scale``, plus
    ``bias_scale·bias_row [N]`` f32 when given (uint8 offset spaces), each
    rounded to f32, then the metric; int8 inner product with no bias and
    ``scale > 0`` ranks the raw dots and scales the k outputs
    (:func:`~.distances.deferred_scale`; ``raw_scores`` leaves them
    raw). There ``queries`` and ``db`` may be row-strided views
    (``stride(1) == 1``), such as the first D columns of padded blocks: the
    kernel reads D bytes a row; so may ``db`` at ``"high"`` and
    ``"default"``. ``affine =
    (off, scale)``: f32 queries over an int8 ``db`` read as ``(c +
    off)·scale`` in f32 (the uint8 cosine space), by the FFMA kernel.

    The reference's two-phase arguments: ``seed_s [Q, k']`` f32 and
    ``seed_i [Q, k']`` int32 (``k' ≤ k``, best first, (−inf, −1)
    unfilled) are the exact top-k' of rows the scan does not score, in the
    scan's own score domain (raw dots in the deferred mode), and
    ``exclude_stride`` leaves the rows ``r % exclude_stride == 0`` out of
    the scan; the result is the k best of both. ``_seed_stride``
    (:func:`fused_topk_presampled`'s phase 2): ``seed_i`` counts rows of
    ``db[::_seed_stride]``, multiplied as the kernel reads them.

    ``grid``: a :class:`.grid.Grid` of ``waves`` (the multiple of one wave
    of scan blocks; no ``tile``), or None for one wave. The plain version
    ignores it; the answer is the same.

    While a profiler runs the call is the span ``ops.fused_topk``: on CUDA
    the host wrapper (checks, the library's handle, the outputs, the grid,
    the ctypes calls) up to its last enqueue; on the CPU the plain
    version's whole computation."""
    tok = (RECORDER.begin("ops.fused_topk") if _profiler._is_profiler_enabled
           else None)
    try:
        metric = DistanceMetric(metric)
        if metric not in _METRICS:
            raise NotImplementedError(f"metric {metric!r} has no built-in score kernel")
        _check_precision(precision, db)
        grid = check_grid(grid, (), "fused_topk")
        if (seed_s is None) != (seed_i is None):
            raise ValueError("seed_s and seed_i come together")
        if queries.device.type == "cpu":
            _check_dtypes(queries, db, bias_row, affine)
            if seed_i is not None and _seed_stride != 1:
                seed_i = torch.where(seed_i >= 0, seed_i * _seed_stride, seed_i)
            return fused_topk_reference(queries, db, db_norms, num_valid, k,
                                        metric, valid_mask, precision, scale,
                                        bias_row, bias_scale, affine, seed_s, seed_i,
                                        exclude_stride, raw_scores)
        seed = None if seed_s is None else (seed_s, seed_i, _seed_stride)
        return _fused_topk_cuda(queries, db, db_norms, num_valid, k, metric,
                                valid_mask, precision, scale, bias_row, bias_scale,
                                affine, seed, exclude_stride, raw_scores, grid)
    finally:
        if tok is not None:
            RECORDER.end(tok)


def _check_seed(seed, nq: int, k: int, dev) -> None:
    seed_s, seed_i, _ = seed
    if (seed_s.device != dev or seed_i.device != dev or seed_s.dtype != torch.float32
            or seed_i.dtype != torch.int32 or seed_s.dim() != 2
            or seed_s.shape != seed_i.shape or seed_s.shape[0] != nq
            or not 1 <= seed_s.shape[1] <= k
            or not (seed_s.is_contiguous() and seed_i.is_contiguous())):
        raise ValueError(
            f"seed_s and seed_i must be contiguous [Q={nq}, k' <= {k}] float32 and "
            f"int32 tensors on {dev}")


def _fused_topk_cuda(queries, db, db_norms, num_valid, k, metric, valid_mask,
                     precision, scale, bias_row, bias_scale, affine, seed,
                     exclude_stride, raw_scores, grid=None):
    """:func:`fused_topk` on CUDA; ``seed``: ``(seed_s, seed_i, mul)``, the
    seed's indices times ``mul``, or None; ``grid`` checked."""
    if queries.device.type != "cuda":
        raise ValueError(f"fused_topk runs on CUDA or CPU, not {queries.device}")
    _check(queries, db, db_norms, k, valid_mask, bias_row, affine, precision)
    if seed is not None:
        _check_seed(seed, queries.shape[0], k, queries.device)
    excl = int(exclude_stride or 0)
    if excl < 0:
        raise ValueError(f"exclude_stride={exclude_stride} must be positive")
    from ._build import load

    lib = load()
    nq = queries.shape[0]
    n = db.shape[0]
    dev = queries.device
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0 or n == 0:  # nothing to scan: every slot stays unfilled
        out_s.fill_(float("-inf")), out_i.fill_(-1)
        if seed is None:
            return out_s, out_i
        return merge_seed(out_s, out_i, seed[0], seed[1] * seed[2], k)
    with torch.cuda.device(dev):
        if queries.dtype == torch.int8:
            _launch_int(lib, queries, db, db_norms, valid_mask, bias_row,
                        num_valid, k, metric, scale, bias_scale,
                        deferred_scale(db, metric, bias_row, scale), out_s, out_i,
                        seed=seed, excl=excl, raw=raw_scores, grid=grid)
            fused_topk.launches_int += 1
        elif precision == "default":  # the same scan over bf16 operands
            _launch_int(lib, queries.to(torch.bfloat16), db, db_norms, valid_mask,
                        None, num_valid, k, metric, 1.0, 0.0, False, out_s, out_i,
                        seed=seed, excl=excl, grid=grid)
            fused_topk.launches_bf16 += 1
        elif precision == "high":
            _launch_high(lib, queries, db, db_norms, valid_mask, num_valid, k,
                         metric, out_s, out_i, seed=seed, excl=excl, grid=grid)
            fused_topk.launches_high += 1
        else:
            _launch(lib, queries, db, db_norms, valid_mask, num_valid, k,
                    metric, _TILE, out_s, out_i, affine=affine, seed=seed,
                    excl=excl, grid=grid)
            if affine is None:
                fused_topk.launches += 1
            else:
                fused_topk.launches_affine += 1
    return out_s, out_i


def _subsample(queries, db, db_norms, num_valid, k, stride, precision,
               valid_mask, sub):
    """Phase 1's inputs: ``(db_sub, norms_sub, nv_sub, mask_sub, k_sub)``,
    as the reference forms them (``topk_kernel.py:1079-1098``)."""
    n = db.shape[0]
    n_sub = -(-n // stride)
    if sub is None:
        db_sub = db[::stride]
        if (queries.device.type == "cuda" and queries.dtype != torch.int8
                and precision == "highest"):
            db_sub = db_sub.contiguous()  # the FFMA kernel reads whole rows
        sub = (db_sub, db_norms[::stride].contiguous())
    db_sub, norms_sub = sub
    if db_sub.shape[0] != n_sub or tuple(norms_sub.shape) != (n_sub,):
        raise ValueError(f"sub must hold the {n_sub} rows db[::{stride}] and their norms")
    nv_sub = max(0, -(-int(num_valid) // stride))  # rows i·stride < num_valid
    mask_sub = None if valid_mask is None else valid_mask[::stride].contiguous()
    return db_sub, norms_sub, nv_sub, mask_sub, min(k, n_sub)


def fused_topk_presampled(
    queries: torch.Tensor,
    db: torch.Tensor,
    db_norms: torch.Tensor,
    num_valid: int,
    k: int,
    metric,
    scale: float = 1.0,
    stride: int = 64,
    precision: str = "highest",
    valid_mask: torch.Tensor | None = None,
    sub: tuple[torch.Tensor, torch.Tensor] | None = None,
    grid=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-phase exact top-k, identical to :func:`fused_topk` (the
    reference's ``fused_topk_presampled``, ``topk_kernel.py:1040``): phase 1
    is :func:`fused_topk` of the ``[::stride]`` row subsample, its scores
    left raw (``raw_scores``); phase 2 scans the other rows with that
    top-k as its seed (``exclude_stride=stride``), so seed ∪ scan
    partitions the rows. Every split's bar then starts at the seed's k-th
    entry, where a plain scan starts from nothing. Corpora of at most
    ``4·stride`` rows take one plain :func:`fused_topk`.

    ``sub``: the pre-sliced ``(db[::stride], db_norms[::stride])``. Without
    it the subsample is ``db[::stride]`` as a strided view where the route
    reads row strides (int8 queries; ``"high"``, ``"default"``), else one contiguous copy
    (the FFMA kernel). The arguments are :func:`fused_topk`'s; the
    reference's TPU knobs (``block_rows``, ``query_tile``, ``merge``,
    ``interpret``) have no counterpart here; ``grid`` goes to both phases.
    A CPU tensor goes to :func:`fused_topk_presampled_reference`."""
    metric = DistanceMetric(metric)
    grid = check_grid(grid, (), "fused_topk_presampled")
    if queries.device.type == "cpu":
        _check_precision(precision, db)
        _check_dtypes(queries, db, None, None)
        return fused_topk_presampled_reference(queries, db, db_norms, num_valid, k,
                                               metric, scale, stride, precision,
                                               valid_mask, sub)
    if db.shape[0] <= 4 * stride:
        return fused_topk(queries, db, db_norms, num_valid, k, metric, valid_mask,
                          precision, scale, grid=grid)
    _check_precision(precision, db)
    db_sub, norms_sub, nv_sub, mask_sub, k_sub = _subsample(
        queries, db, db_norms, num_valid, k, stride, precision, valid_mask, sub)
    seed_s, seed_i = fused_topk(queries, db_sub, norms_sub, nv_sub, k_sub, metric,
                                mask_sub, precision, scale, raw_scores=True, grid=grid)
    out = fused_topk(queries, db, db_norms, num_valid, k, metric, valid_mask, precision,
                     scale, seed_s=seed_s, seed_i=seed_i, exclude_stride=stride,
                     grid=grid, _seed_stride=stride)
    fused_topk.launches_presampled += 1
    return out


def fused_topk_presampled_reference(
    queries: torch.Tensor,
    db: torch.Tensor,
    db_norms: torch.Tensor,
    num_valid: int,
    k: int,
    metric,
    scale: float = 1.0,
    stride: int = 64,
    precision: str = "highest",
    valid_mask: torch.Tensor | None = None,
    sub: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_topk_presampled` (same signature and
    results): its two phases through :func:`fused_topk_reference`, on any
    device."""
    metric = DistanceMetric(metric)
    if db.shape[0] <= 4 * stride:
        return fused_topk_reference(queries, db, db_norms, num_valid, k, metric,
                                    valid_mask, precision, scale)
    db_sub, norms_sub, nv_sub, mask_sub, k_sub = _subsample(
        queries, db, db_norms, num_valid, k, stride, precision, valid_mask, sub)
    seed_s, seed_i = fused_topk_reference(queries, db_sub, norms_sub, nv_sub, k_sub,
                                          metric, mask_sub, precision, scale,
                                          raw_scores=True)
    seed_i = torch.where(seed_i >= 0, seed_i * stride, seed_i)
    return fused_topk_reference(queries, db, db_norms, num_valid, k, metric,
                                valid_mask, precision, scale, seed_s=seed_s,
                                seed_i=seed_i, exclude_stride=stride)


def _plan(dev, nq, n, k, smem_k, tile, occupancy, splits=None, seed_k=0, grid=None):
    """The host plan of one launch: ``(splits, rows_per_split, length,
    tree, part_s, part_i, tmp_s, tmp_i, slots, seed_lists)`` for a kernel
    whose blocks take ``tile = (queries, rows)`` and keep lists of up to
    ``smem_k`` in shared memory. ``occupancy(k_smem, big)`` returns the
    scan blocks that fit on one SM; ``splits`` (default: one wave, as many
    scan blocks as fit on the card at once, times ``grid``'s waves,
    :func:`.grid.wave_blocks`) sets the row splits, fewer
    above ``smem_k`` if the lists would pass the scratch bound. A seed of
    ``seed_k`` entries takes ``seed_lists`` lists of ``length`` after the
    splits' (:func:`.select.seed_lists`), and leaves room for one beside
    :data:`.select.MAX_SPLITS` splits' lists in shared memory."""
    big = k > smem_k
    if splits is None:
        per_sm = occupancy(min(k, smem_k), int(big))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = max(1, wave_blocks(sms * max(1, per_sm), grid) // -(-nq // tile[0]))
    if seed_k:
        splits = min(splits, select.MAX_SPLITS - 1)
    splits, rows_per_split, length = select.row_splits(
        n, tile[1], splits, nq, k, lists_in_smem=not big)
    nseed = select.seed_lists(seed_k, length)
    tree = select.merge_by_tree(splits + nseed, k, not big)
    scratch = select.scratch(nq, splits + nseed, length, k, dev, tree=tree)
    slots = select.bar_slots(nq, splits, dev)
    return (splits, rows_per_split, length, tree) + tuple(scratch) + (slots, nseed)


def _seed_args(seed, nseed: int, excl: int) -> tuple:
    """The C entry points' seed arguments: ``seed_s, seed_i, kseed,
    seed_mul, nseed, excl``."""
    if seed is None:
        return (None, None, 0, 1, 0, excl)
    seed_s, seed_i, mul = seed
    return (seed_s.data_ptr(), seed_i.data_ptr(), seed_s.shape[1], int(mul), nseed, excl)


_OCCUPANCY: dict[tuple, int] = {}


def _occupancy(lib, entry, what, *args):
    """``occupancy(k_smem, big)`` for :func:`_plan` through the library's
    occupancy entry point ``entry`` (leading arguments ``args``), asked once
    per kernel instance and device."""
    from ._build import raise_for

    def per_sm(k_smem, big):
        key = (what, torch.cuda.current_device(), *args, k_smem, big)
        if key not in _OCCUPANCY:
            out = ctypes.c_int(0)
            raise_for(lib, entry(*args, k_smem, big, ctypes.byref(out)), what)
            _OCCUPANCY[key] = out.value
        return _OCCUPANCY[key]

    return per_sm


def _launch_high(lib, queries, db, db_norms, valid_mask, num_valid, k, metric,
                 out_s, out_i, seed=None, excl=0, grid=None) -> None:
    """One launch of the query split, the bf16x3 scan and the merge for
    checked inputs into ``out_s``/``out_i``, with one wave of scan blocks
    (as :func:`_launch`) of the shape :func:`_high_shape` picks. A corpus
    whose rows TMA cannot read goes over as :func:`_tma_rows`' copy.
    ``seed``, ``excl`` and ``grid`` as in :func:`_launch`."""
    from ._build import raise_for

    nq, d = queries.shape
    n = db.shape[0]
    dev = queries.device
    shape = _high_shape(nq, k)
    splits, rows_per_split, length, tree, part_s, part_i, tmp_s, tmp_i, slots, nseed = _plan(
        dev, nq, n, k, 0 if shape.big else k, (2 * shape.nw, SCAN_ROWS),
        _occupancy(lib, lib.mvt_fused_topk_high_occupancy, "fused_topk[high]",
                   shape.nw, shape.stages),
        seed_k=0 if seed is None else seed[0].shape[1], grid=grid)
    # The split queries: per tile of 2 nw queries and chunk of 32 dims, the
    # stage's image of their hi and lo halves (128 bytes a query).
    tiles = -(-nq // (2 * shape.nw))
    qsplit = torch.empty(tiles * -(-d // HIGH_CHUNK) * 2 * shape.nw * 4 * HIGH_CHUNK,
                         dtype=torch.uint8, device=dev)
    db = _tma_rows(db)
    err = lib.mvt_fused_topk_high(
        queries.data_ptr(), qsplit.data_ptr(), db.data_ptr(), db.stride(0),
        db_norms.data_ptr(),
        None if valid_mask is None else valid_mask.data_ptr(),
        nq, n, d, max(0, min(int(num_valid), n)), k, int(metric),
        shape.nw, shape.stages, int(shape.big),
        splits, rows_per_split, length, int(tree),
        part_s.data_ptr(), part_i.data_ptr(), slots.data_ptr(),
        tmp_s.data_ptr(), tmp_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), *_seed_args(seed, nseed, excl),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_for(lib, err, "fused_topk[high]")


def _launch_int(lib, queries, db, db_norms, valid_mask, bias_row, num_valid,
                k, metric, scale, bias_scale, defer, out_s, out_i, seed=None,
                excl=0, raw=False, grid=None) -> None:
    """One launch of the one-pass scan, the merge and (``defer``, unless
    ``raw``) the scale for checked inputs into ``out_s``/``out_i``, with
    one wave of scan blocks (as :func:`_launch`) of the shape
    :func:`_int_shape` picks. The operands are int8, or bf16 (queries
    already rounded, no bias, scale 1, no ``defer``) as ``db`` is. TMA
    reads the first D values of each row of queries and corpus: each goes
    over as it is where its row stride and base are 16-byte multiples (the
    engine's padded blocks), else as :func:`_tma_rows`' copy. ``seed``,
    ``excl`` and ``grid`` as in :func:`_launch`; in deferred mode the
    seed's scores are raw dots."""
    from ._build import raise_for

    nq, d = queries.shape
    n = db.shape[0]
    dev = queries.device
    bf16 = db.dtype == torch.bfloat16
    what = "fused_topk[bf16]" if bf16 else "fused_topk[int8]"
    row_bytes = d * db.element_size()
    shape = _int_shape(nq, row_bytes, k)
    splits, rows_per_split, length, tree, part_s, part_i, tmp_s, tmp_i, slots, nseed = _plan(
        dev, nq, n, k, 0 if shape.big else k, (2 * shape.nw, SCAN_ROWS),
        _occupancy(lib, lib.mvt_fused_topk_int_occupancy, what, int(bf16), shape.nw,
                   -(-row_bytes // INT_CHUNK), shape.stages, int(shape.resident)),
        seed_k=0 if seed is None else seed[0].shape[1], grid=grid)
    queries, db = _tma_rows(queries), _tma_rows(db)
    err = lib.mvt_fused_topk_int(
        int(bf16), queries.data_ptr(), queries.stride(0), db.data_ptr(), db.stride(0),
        db_norms.data_ptr(),
        None if valid_mask is None else valid_mask.data_ptr(),
        None if bias_row is None else bias_row.data_ptr(),
        float(scale), float(bias_scale), int(defer),
        nq, n, d, max(0, min(int(num_valid), n)), k, int(metric),
        shape.nw, shape.stages, int(shape.resident), int(shape.big),
        splits, rows_per_split, length, int(tree),
        part_s.data_ptr(), part_i.data_ptr(), slots.data_ptr(),
        tmp_s.data_ptr(), tmp_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), *_seed_args(seed, nseed, excl), int(raw),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_for(lib, err, what)


def _launch(lib, queries, db, db_norms, valid_mask, num_valid, k, metric,
            tile, out_s, out_i, splits=None, affine=None, seed=None,
            excl=0, grid=None) -> None:
    """One launch of the scan and the merge for checked inputs with block
    tile ``tile`` (a tile the library was built with) into
    ``out_s``/``out_i``. ``splits`` as in :func:`_plan`; ``affine = (off,
    scale)``: an int8 ``db`` dequantized as it is staged; ``seed = (seed_s,
    seed_i, mul)``: the seed (its indices times ``mul``) that starts the
    bars and joins the merge; ``excl`` > 0: rows ``r % excl == 0`` are
    left out; ``grid``: the waves of :func:`_plan`."""
    from ._build import raise_for

    nq, d = queries.shape
    n = db.shape[0]
    dev = queries.device
    code = _AFFINE_CODE if affine is not None else _DTYPE_CODES[db.dtype]
    off, sc = affine if affine is not None else (0.0, 1.0)
    splits, rows_per_split, length, tree, part_s, part_i, tmp_s, tmp_i, slots, nseed = _plan(
        dev, nq, n, k, SMEM_K, _TILES[tile],
        _occupancy(lib, lib.mvt_fused_topk_occupancy, "fused_topk", code, tile),
        splits, seed_k=0 if seed is None else seed[0].shape[1], grid=grid)
    err = lib.mvt_fused_topk(
        queries.data_ptr(), db.data_ptr(), code, float(off), float(sc),
        db_norms.data_ptr(),
        None if valid_mask is None else valid_mask.data_ptr(),
        nq, n, d, max(0, min(int(num_valid), n)), k, int(metric), tile,
        splits, rows_per_split, length, int(tree),
        part_s.data_ptr(), part_i.data_ptr(),
        slots.data_ptr(),
        tmp_s.data_ptr(), tmp_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), *_seed_args(seed, nseed, excl),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_for(lib, err, "fused_topk")


fused_topk.launches = 0
fused_topk.launches_affine = 0
fused_topk.launches_high = 0
fused_topk.launches_bf16 = 0
fused_topk.launches_int = 0
fused_topk.launches_presampled = 0
