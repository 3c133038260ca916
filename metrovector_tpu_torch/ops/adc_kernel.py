"""PQ asymmetric-distance scan + top-k: the wrapper of the Hopper kernels
``csrc/adc_scan.cuh`` (built as ``csrc/adc_kernel.cu``, its int8-LUT
lookup instances as ``csrc/adc_int8_kernel.cu``), for an int8 LUT at
ksub ≤ 16 ``csrc/adc_int8_mma_kernel.cu`` (the tensor-core product,
:func:`int8_lut_route`) and, for the IVF
bucket bias, ``csrc/adc_bucket_kernel.cu``, and their plain PyTorch
version.

Replaces ``metrovector_tpu/ops/adc_kernel.py::fused_adc_topk`` for uint8
codes ``[N, m]`` and nibble-packed codes ``[N, ⌈m/2⌉]`` (``packed4``), with
an f32 (``exact_lut``), bf16 or int8 (``int8_lut``) lookup table. A CUDA
tensor goes to the kernel or the call raises; a CPU tensor goes to
:func:`fused_adc_topk_reference`. ``fused_adc_topk.launches`` counts kernel
launches (scan and merge of one call count once), and
``fused_adc_topk.group_launches`` and ``int8_launches`` those of them with
a bucket bias and with an int8 LUT, ``group_rows_launches`` those of the
bucket bias with the bucket-major map ``group_rows``, ``int8_mma_launches``
those of the int8 LUT's tensor-core product.

The per-query table ``LUT[q, j·ksub + c] = q_j · C[j, c]`` is a small
einsum outside the kernel, as in the JAX package, in full f32 and then
rounded to bf16 unless ``exact_lut``. Both versions add the m looked-up
entries of a row in ascending j in f32, so they agree bit for bit. The
int8 LUT is the f32 table quantized per query as the reference does
(:func:`quantize_lut`); both versions add its entries exactly in integers
(on CUDA, routed by :func:`int8_lut_route`: at ksub ≤ 16 as the int8
tensor-core product of the rows' one-hot codes and the LUT, above, and
for a pq4 LUT too large for the product, as lookups adding two queries an
integer add) and multiply the sum, rounded to f32, by the query's scale.

The IVF bucket bias (``group_bias [Q, G]`` f32 with ``group_ids [N]``
int32, the form IVF-PQ's scan calls): a row of bucket ``g = group_ids[row]``
adds ``group_bias[q, g]`` after its m lookups, and the bias rides the LUT's
type as in the reference, which concatenates it onto the LUT before the
cast (with a bf16 LUT it is rounded to bf16, to nearest even). A row whose
bias is at most −1e28 (an unprobed bucket: the reference passes −1e30), or
whose dots with the bias are at most −1e28, scores exactly −inf; a
``group_ids`` outside ``[0, G)`` (−1: a tombstoned row) adds no bias. The
first rule is the reference's second one except where a row's LUT sum
alone exceeds about 1e21 in magnitude. On CUDA the bucket bias runs the
bucket kernel, which scores only the buckets that some query of a tile
probes: over ``buckets``, the caller's bucket layout of the same rows (the
IVF-PQ index keeps one), or else over the rows grouped by ``group_ids`` on
the device (:func:`_group_layout`). :func:`ivf_scan_plan` is the plain form
of the kernel's schedule. The implicit bucket-major map ``group_rows``
(``bucket = row // group_rows``, for rows stored bucket by bucket) goes
with ``group_bias`` alone; rows whose bucket is G or more take no bias and
every query scans them, as a ``group_ids`` outside ``[0, G)`` does. (The
reference's one-hot pads the bias columns to a multiple of 128 with
−1e30, so there a row whose bucket lies in ``[G, ⌈G/128⌉·128)`` scores
−inf; the reference also takes only ``N`` a multiple of ``group_rows``
and ``group_rows`` a multiple of 128, which the port does not ask.) On
CUDA it runs the bucket kernel over the rows as they stand: bucket g's
slots start at g·group_rows, the tail past G·group_rows is bucket G, and a
slot is its own row (no argsort, no copy). Not ported: the Mosaic knobs
(``block_rows``, ``query_tile``, ``vmem_retry``); ``grid``
(:class:`.grid.Grid`) moves the one-wave split count of every route and
picks the lookup scan's query tile (:data:`QUERY_TILES`; the int8 product
and the bucket kernel are built with one tile each and take its waves
alone); a tile that does not fit raises, unless the grid has ``cap``
(:func:`_grid_tile`). Any ``1 ≤ k ≤ N``: above
k = 1024 the per-split lists live in device memory and a merge tree folds
them (:mod:`.select`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..format.constants import DistanceMetric

from . import select
from .grid import check_grid, wave_blocks
from .distances import carry_topk, empty_topk, finish_topk, full_f32_matmul, mask_scores
from .topk_kernel import (
    MIN_STAGES, SCAN_ROWS, SMEM_LIMIT, ScanShape, _scan_smem, _tile_nw,
)
from .topk_kernel import _occupancy as _scan_occupancy
from .topk_kernel import _plan as _scan_plan

SMEM_K = 1024  # lists in shared memory up to this k
# Shape constants of csrc/adc_scan.cuh
_QUERY_TILES = (1, 2, 4, 8, 16, 32)
QUERY_TILES = _QUERY_TILES  # the lookup scan's tiles, grid.tile candidates
_ROW_TILE = 256
_BUFFER = 64
# Scan blocks an SM should hold at once. Fewer leave the shared-memory
# lookups' latency exposed: on an H100 the largest tile with at least 3
# resident blocks was the fastest tile, or within 4 % of it, at every
# measured point (PERF.md), while the largest tile that merely fits was up
# to 2x slower.
_MIN_BLOCKS_PER_SM = 3

_METRICS = (
    DistanceMetric.L2, DistanceMetric.INNER_PRODUCT, DistanceMetric.COSINE
)
# LutType of csrc/adc_scan.cuh
LUT_F32, LUT_BF16, LUT_INT8 = 0, 1, 2
_LUT_CODES = {torch.float32: LUT_F32, torch.bfloat16: LUT_BF16, torch.int8: LUT_INT8}
# Subspaces the lookup scan's 16-bit lanes of biased int8 entries add
# before they are widened (csrc/adc_scan.cuh's kLaneSpan: 255·256 < 2^16).
LANE_SPAN = 256
# Shape constants of csrc/adc_int8_mma_kernel.cu: the tile's queries per
# consumer warpgroup (the wgmma N), the bytes of K a chunk (8 subspaces of
# 16 columns), the most stages of the ring.
INT8_MMA_NW, INT8_MMA_CHUNK, INT8_MMA_MAX_STAGES = (16, 32, 64, 128), 128, 32
# ksub at or below which the int8 LUT is summed on the tensor cores.
INT8_MMA_KSUB = 16


def adc_lut(queries: torch.Tensor, codebooks: torch.Tensor,
            exact_lut: bool) -> torch.Tensor:
    """``[Q, m·ksub]`` lookup table of ``queries [Q, D]`` against
    ``codebooks [m, ksub, dsub]``: f32 (``exact_lut``) or bf16."""
    nq = queries.shape[0]
    m, ksub, dsub = codebooks.shape
    with full_f32_matmul():
        lut = torch.einsum("qmd,mkd->qmk",
                           queries.float().reshape(nq, m, dsub),
                           codebooks.float()).reshape(nq, m * ksub)
    return lut.contiguous() if exact_lut else lut.to(torch.bfloat16)


def quantize_lut(lut: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 LUT of an f32 ``lut [Q, m·ksub]`` and its per-query scale,
    as the reference quantizes it (``adc_kernel.py:431-436``): ``sq =
    max(max|lut|, 1e-30) / 127`` in f32, then ``clip(round_half_even(lut /
    sq), −127, 127)``. Returns ``(int8 [Q, m·ksub], sq [Q] f32)``."""
    amax = torch.clamp(lut.abs().amax(dim=1), min=1e-30)
    sq = amax / 127.0
    return (torch.clamp(torch.round(lut / sq[:, None]), -127, 127)
            .to(torch.int8).contiguous(), sq.contiguous())


INT8_LUT_EXCLUSIVE = "int8_lut is mutually exclusive with exact_lut and group_bias"


def adc_tables(queries: torch.Tensor, codebooks: torch.Tensor, exact_lut: bool,
               int8_lut: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The LUT a search scans and its per-query scale: ``(int8 LUT, sq)``
    with ``int8_lut``, else ``(f32 or bf16 LUT, None)``."""
    if int8_lut:
        return quantize_lut(adc_lut(queries, codebooks, True))
    return adc_lut(queries, codebooks, exact_lut), None


def _check_tables(lut, nq: int, codebooks: torch.Tensor) -> None:
    m, ksub, _ = codebooks.shape
    if tuple(lut[0].shape) != (nq, m * ksub):
        raise ValueError(f"lut holds {tuple(lut[0].shape)} entries; these queries and "
                         f"codebooks need ({nq}, {m * ksub})")


def lut_bias(group_bias: torch.Tensor, exact_lut: bool) -> torch.Tensor:
    """The bucket bias as the kernel adds it: f32, rounded through bf16
    (to nearest even) unless ``exact_lut``, as the reference casts it with
    the LUT it rides."""
    gb = group_bias.float()
    return gb.contiguous() if exact_lut else gb.to(torch.bfloat16).float()


# A bias (or a row's dots with it) at or below this marks an unprobed
# bucket: the row scores exactly -inf.
DEAD_BIAS = -1e28


def unpack_nibbles(packed: torch.Tensor, m: int) -> torch.Tensor:
    """Nibble-packed ``[N, ⌈m/2⌉]`` → ``[N, m]`` uint8 (even subspaces in
    the low nibble), on the tensor's device."""
    return torch.stack([packed & 15, packed >> 4], dim=2).reshape(
        packed.shape[0], -1)[:, :m]


def fused_adc_topk_reference(
    queries: torch.Tensor,
    codes: torch.Tensor,
    codebooks: torch.Tensor,
    recon_norms: torch.Tensor,
    num_valid: int,
    k: int,
    metric,
    valid_mask: torch.Tensor | None = None,
    exact_lut: bool = False,
    packed4: bool = False,
    group_bias: torch.Tensor | None = None,
    group_ids: torch.Tensor | None = None,
    block_rows: int = 65536,
    int8_lut: bool = False,
    group_rows: int = 0,
    lut: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_adc_topk` (same results): the torch
    twin of ``_adc_search``, the LUT gathered by code per row block, with a
    carried candidate list (ties to the lowest row). ``int8_lut``: the
    quantized entries summed in int64, then ``f32(sum)·sq``.
    ``group_rows``: the bias of ``group_ids = row // group_rows``. ``lut``:
    as :func:`fused_adc_topk`'s."""
    metric = DistanceMetric(metric)
    if group_rows:
        group_ids = torch.div(torch.arange(codes.shape[0], device=codes.device),
                              int(group_rows), rounding_mode="floor").to(torch.int32)
    m, ksub, _ = codebooks.shape
    if lut is None:
        lut = adc_tables(queries, codebooks, exact_lut, int8_lut)
    _check_tables(lut, queries.shape[0], codebooks)
    lut, sq = lut
    lut = lut.long() if int8_lut else lut.float()
    nq, n = lut.shape[0], codes.shape[0]
    gb = None if group_bias is None else lut_bias(group_bias, exact_lut)
    neg_inf = torch.tensor(float("-inf"), device=lut.device)
    best = empty_topk(nq, lut.device)
    for start in range(0, n, block_rows):
        stop = min(n, start + block_rows)
        blk = codes[start:stop]
        if packed4:
            blk = unpack_nibbles(blk, m)
        blk = blk.long()
        acc = torch.zeros((nq, stop - start), dtype=lut.dtype,
                          device=lut.device)
        for j in range(m):  # ascending j, in f32 (exact for int8), as the kernel adds
            acc = acc + lut[:, j * ksub + blk[:, j]]
        if sq is not None:
            acc = acc.float() * sq[:, None]
        keep = None
        if gb is not None:  # the bias after the m lookups, then the clamp
            gid = group_ids[start:stop].long()
            inb = (gid >= 0) & (gid < gb.shape[1])
            b = gb[:, gid.clamp(0, max(gb.shape[1] - 1, 0))]
            acc = torch.where(inb[None, :], acc + b, acc)
            keep = ~(inb[None, :] & ~(b > DEAD_BIAS)) & (acc > DEAD_BIAS)
        nrm = recon_norms[start:stop][None, :]
        if metric == DistanceMetric.L2:
            s = 2.0 * acc - nrm
        elif metric == DistanceMetric.COSINE:
            s = acc * (1.0 / torch.sqrt(torch.clamp(nrm, min=1e-30)))
        else:
            s = acc
        if keep is not None:
            s = torch.where(keep, s, neg_inf)
        vm = None if valid_mask is None else valid_mask[start:stop]
        best = carry_topk(best, mask_scores(s, start, num_valid, vm), start, k)
    return finish_topk(best, k)


def _shared_bytes(qt: int, mk: int, k: int, exact_lut: bool,
                  lists_in_smem: bool = True, gw: int = 0,
                  int8_lut: bool = False) -> int:
    """Dynamic shared memory of one scan block: the LUT of ``qt`` queries
    (4, 2 or, ``int8_lut``, 1 byte an entry; rounded up to 16 bytes), then
    per query the bar, two score rows and two sets of candidate words, the
    buffer and its fill, and the list (none above :data:`SMEM_K` or without
    ``lists_in_smem``: it lives in device memory); ``gw`` > 0: the bucket
    kernel's, which adds the two tiles' row ids and, for ``gw`` 32-bit words
    of buckets, the union's bits and the chunk prefix (``gw + 1``
    entries)."""
    esz = 1 if int8_lut else (4 if exact_lut else 2)
    lut = -(-qt * mk * esz // 16) * 16
    lists = k if lists_in_smem and k <= SMEM_K else 0
    base = lut + qt * (8 + 2 * (4 * _ROW_TILE + _ROW_TILE // 8) + 8 * _BUFFER + 4
                       + 8 * lists)
    return base + (2 * 4 * _ROW_TILE + 8 * gw + 4 if gw else 0)


def _fitting_tiles(mk: int, k: int, exact_lut: bool,
                   lists_in_smem: bool = True, gw: int = 0,
                   int8_lut: bool = False) -> list[int]:
    """The query tiles whose scan block fits in shared memory."""
    return [t for t in _QUERY_TILES
            if _shared_bytes(t, mk, k, exact_lut, lists_in_smem, gw, int8_lut)
            <= SMEM_LIMIT]


def _grid_tile(grid, occupancy: dict[int, int], own: int) -> int:
    """The lookup scan's query tile under ``grid``: ``own`` (the wrapper's
    pick) without a tile; its tile; or with ``grid.cap`` the largest tile
    that fits (``occupancy``) and is no larger (``own`` if none is)."""
    if grid is None or grid.tile is None:
        return own
    if not grid.cap:
        return grid.tile
    return max((t for t in occupancy if t <= grid.tile), default=own)


def _query_tile(nq: int, occupancy: dict[int, int]) -> int:
    """The query tile for a batch of ``nq``, given the scan blocks per SM
    of each tile that fits (``occupancy``): the smallest tile that holds
    the batch, but none larger than the largest tile with
    ``_MIN_BLOCKS_PER_SM`` blocks (or the smallest tile if none has)."""
    busy = [t for t, blocks in occupancy.items() if blocks >= _MIN_BLOCKS_PER_SM]
    cap = max(busy) if busy else min(occupancy)
    return min(cap, next((t for t in sorted(occupancy) if t >= nq), cap))


@functools.lru_cache(maxsize=None)
def _occupancy(device_index: int, lut_code: int, packed4: int, m: int,
               ksub: int, k: int, lists_in_smem: bool, gw: int = 0,
               tiles: tuple[int, ...] = _QUERY_TILES,
               ids: bool = True) -> tuple[tuple[int, int], ...]:
    """(tile, scan blocks per SM) for each of ``tiles`` that fits, from the
    runtime's occupancy calculator on the current device, for the LUT type
    ``lut_code`` (:data:`LUT_F32`, :data:`LUT_BF16`, :data:`LUT_INT8`); ``gw`` > 0: the
    bucket kernel with that many words of bucket bits (built for
    :data:`BUCKET_QT` alone unless ``-DMVT_K2B_ALL_TILES``) over a layout
    with row ids (``ids``) or without (``group_rows``), two forms of it."""
    from ._build import load, raise_for

    lib = load()
    smem_k = k if lists_in_smem and k <= SMEM_K else 0
    out = []
    for qt in _fitting_tiles(m * ksub, k, lut_code == 0, lists_in_smem, gw,
                             lut_code == LUT_INT8):
        if qt not in tiles:
            continue
        per_sm = ctypes.c_int(0)
        if gw:
            err = lib.mvt_adc_bucket_occupancy(lut_code, packed4, qt, m, ksub, smem_k,
                                               gw, int(ids), ctypes.byref(per_sm))
        else:
            err = lib.mvt_adc_topk_occupancy(lut_code, packed4, qt, m, ksub, smem_k,
                                             ctypes.byref(per_sm))
        raise_for(lib, err, "fused_adc_topk")
        out.append((qt, per_sm.value))
    return tuple(out)


def int8_lut_route(ksub: int, m: int, cols: int) -> str:
    """The kernel that sums an int8 LUT of m subspaces over codes of
    ``cols`` bytes a row on CUDA: ``"mma"`` for ksub ≤ :data:`INT8_MMA_KSUB`
    (pq4, packed or not) whose resident LUT fits the product's smallest
    tile (:func:`int8_mma_fits`), the exact int8 tensor-core product of the
    rows' one-hot codes (K = 16 m) and the LUT
    (``csrc/adc_int8_mma_kernel.cu``); ``"lookup"`` otherwise:
    ``csrc/adc_scan.cuh``'s scan, adding two queries' biased entries an
    integer add, for ksub > 16 (pq8, where a one-hot product would do
    ksub/16 times the lookups' work in zeros) and for a pq4 LUT too large
    for the product (m above 270 packed, 199 unpacked), which the lookup
    scan holds a query at a time. Both give the plain version's sums
    exactly."""
    return "mma" if ksub <= INT8_MMA_KSUB and int8_mma_fits(m, cols) else "lookup"


def _mma_row_blocks(nw: int) -> int:
    """``adc_int8_mma_kernel.cu::row_blocks``: 64-row blocks a tile, as
    many as keep a warpgroup's accumulators at 64 registers, at most 4."""
    return 1 if nw >= 128 else (2 if nw >= 64 else 4)


def _mma_stage_bytes(cols: int, nw: int) -> int:
    """``adc_int8_mma_kernel.cu::stage_bytes``: a tile's rows' codes
    (rounded up to 16 bytes) and 32 bytes of slack, their norms and mask
    values, rounded up to 1024."""
    rows = SCAN_ROWS * _mma_row_blocks(nw)
    code = -(-rows * cols // 16) * 16 + 32
    return -(-(code + 8 * rows) // 1024) * 1024


def _mma_chunks(m: int) -> int:
    """``adc_int8_mma_kernel.cu::lut_chunks``: 128-byte chunks of the
    resident LUT, a whole number of pairs (16 subspaces)."""
    return -(-m // 16) * 2


def _mma_q_bytes(qb: int, m: int) -> int:
    """``adc_int8_mma_kernel.cu::q_bytes``: the resident LUT of ``qb``
    queries, :func:`_mma_chunks` chunks of 128 bytes each, and their
    scales."""
    return _mma_chunks(m) * qb * INT8_MMA_CHUNK + 4 * qb


@functools.lru_cache(maxsize=1024)
def _mma_plan(nq: int, m: int, cols: int, k: int) -> ScanShape | None:
    """:func:`int8_mma_shape`, or None where not even 32 queries' LUT
    fits."""
    top = INT8_MMA_NW.index(_tile_nw(nq, INT8_MMA_NW))
    for big in ([False] if k <= SMEM_K else []) + [True]:
        k_smem = 0 if big else k
        for nw in INT8_MMA_NW[top::-1]:
            stage = _mma_stage_bytes(cols, nw)
            q_bytes = _mma_q_bytes(2 * nw, m)
            fixed = _scan_smem(0, 0, q_bytes, nw, k_smem)
            stages = min(INT8_MMA_MAX_STAGES, (SMEM_LIMIT - fixed) // (stage + 16))
            if stages >= MIN_STAGES:
                return ScanShape(nw, stages, True, big,
                                 _scan_smem(stage, stages, q_bytes, nw, k_smem))
    return None


def int8_mma_fits(m: int, cols: int) -> bool:
    """Whether the product's smallest tile (32 queries, the lists in device
    memory) fits shared memory for m subspaces over ``cols`` bytes a row:
    then :func:`int8_mma_shape` has a plan at every batch and k."""
    return _mma_plan(1, m, cols, SMEM_K + 1) is not None


def int8_mma_shape(nq: int, m: int, cols: int, k: int) -> ScanShape:
    """The plan of the tensor-core int8-LUT scan for a batch of ``nq``, m
    subspaces stored ``cols`` bytes a row, at ``k``: ``nw`` queries a
    consumer warpgroup (the wgmma N; a block takes 2 nw; a tile of rows is
    :func:`_mma_row_blocks` blocks of 64), the largest tile
    up to the one that holds the batch whose resident LUT and scales,
    selection state and a ring of at least :data:`.topk_kernel.MIN_STAGES`
    stages fit in :data:`SMEM_LIMIT`: first with the lists in shared memory
    (``k`` ≤ :data:`SMEM_K`), else in device memory (``big``);
    then as many stages as fit up to :data:`INT8_MMA_MAX_STAGES`. ``smem``
    is the block's dynamic shared memory (``wgmma_scan.cuh::scan_smem``).
    At m = 32 and k = 400 that is 32 queries a block with the lists in
    shared memory; at k = 10, 128 queries. Raises ValueError where not even
    32 queries' LUT fits (:func:`int8_lut_route` sends those shapes to the
    lookup scan)."""
    shape = _mma_plan(nq, m, cols, k)
    if shape is None:
        raise ValueError(
            f"m={m} with k={k}: the int8 LUT of {2 * INT8_MMA_NW[0]} queries "
            f"({_mma_q_bytes(2 * INT8_MMA_NW[0], m)} bytes) and a ring of "
            f"{MIN_STAGES} stages do not fit the {SMEM_LIMIT} bytes of shared "
            "memory a block may use"
        )
    return shape


def _check_shapes(queries, codes, codebooks, packed4, group_bias=None,
                  group_ids=None, buckets=None, group_rows=0) -> None:
    if codebooks.dim() != 3:
        raise ValueError("codebooks must be [m, ksub, dsub]")
    m, ksub, dsub = codebooks.shape
    if queries.dim() != 2 or queries.shape[1] != m * dsub:
        raise ValueError(
            f"queries must be [Q, {m * dsub}] for codebooks {tuple(codebooks.shape)}"
        )
    if ksub > 256:
        raise ValueError(f"ksub={ksub} does not fit uint8 codes")
    cols = codes.shape[1] if codes.dim() == 2 else -1
    if packed4:
        if ksub > 16:
            raise ValueError(f"packed4 requires ksub <= 16, got {ksub}")
        if cols != (m + 1) // 2:
            raise ValueError(
                f"packed4 codes must be [N, ceil(m/2)]: m={m}, got {cols} columns"
            )
    elif cols != m:
        raise ValueError(f"codes [N, {cols}] vs codebooks m={m}")
    if group_rows:
        if group_ids is not None or buckets is not None:
            raise ValueError("group_rows is the row-to-bucket map: no group_ids "
                             "or buckets with it")
        if group_bias is None:
            raise ValueError("group_rows goes with group_bias")
        if int(group_rows) < 1:
            raise ValueError(f"group_rows={group_rows} must be positive")
    elif (group_bias is None) != (group_ids is None):
        raise ValueError("group_bias and group_ids (or group_rows) come together")
    if buckets is not None and group_bias is None:
        raise ValueError("buckets lay out the rows of a group_bias call")
    if group_bias is not None:
        if (group_bias.dim() != 2 or group_bias.shape[0] != queries.shape[0]
                or group_bias.shape[1] < 1):
            raise ValueError(
                f"group_bias must be [Q={queries.shape[0]}, G >= 1], got "
                f"{tuple(group_bias.shape)}"
            )
        if group_ids is not None and tuple(group_ids.shape) != (codes.shape[0],):
            raise ValueError(f"group_ids must be [N={codes.shape[0]}]")
    if buckets is not None:
        bcodes, bids, bnorms, bfill = buckets
        g = group_bias.shape[1]
        if bcodes.dim() != 3 or bcodes.shape[0] != g or bcodes.shape[2] != cols:
            raise ValueError(
                f"bucket codes must be [G={g}, B, {cols}], got {tuple(bcodes.shape)}"
            )
        slots = tuple(bcodes.shape[:2])
        if tuple(bids.shape) != slots or tuple(bnorms.shape) != slots:
            raise ValueError(f"bucket ids and norms must be {list(slots)}")
        if tuple(bfill.shape) != (g,):
            raise ValueError(f"bucket fill must be [G={g}]")


def _check_cuda(queries, codes, codebooks, recon_norms, k, valid_mask,
                exact_lut, group_bias=None, group_ids=None, buckets=None,
                int8_lut=False) -> None:
    dev = queries.device
    named = [("codes", codes), ("codebooks", codebooks),
             ("recon_norms", recon_norms)]
    if valid_mask is not None:
        named.append(("valid_mask", valid_mask))
    grouped = [] if group_bias is None else [("group_bias", group_bias)]
    if group_ids is not None:
        grouped.append(("group_ids", group_ids))
    if buckets is not None:
        grouped += list(zip(("bucket codes", "bucket ids", "bucket norms",
                             "bucket fill"), buckets))
    for name, t in named + grouped:
        if t.device != dev:
            raise ValueError(
                f"{name} is on {t.device}, queries on {dev}: one device only"
            )
    if queries.dtype != torch.float32 or codebooks.dtype != torch.float32:
        raise ValueError("queries and codebooks must be float32")
    if codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8, got {codes.dtype}")
    n = codes.shape[0]
    if n >= 2**31:
        raise ValueError(f"N={n} rows: the kernel's row indices are int32")
    if k < 1 or (n and k > n):  # an empty corpus leaves every slot unfilled
        raise ValueError(f"k={k} is outside the kernel's limit 1 <= k <= N={n}")
    m, ksub, _ = codebooks.shape
    gw = 0  # the bucket kernel's buckets: the layout's, or G and the rows in none
    if group_bias is not None:
        gw = _group_words(group_bias.shape[1] + (buckets is None))
    if int8_lut and int8_lut_route(ksub, m, codes.shape[1]) == "mma":
        need = 0  # the route's plan fits at every batch and k
    else:
        need = _shared_bytes(1, m * ksub, k, exact_lut, lists_in_smem=False, gw=gw,
                             int8_lut=int8_lut)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"m*ksub={m * ksub} with k={k}"
            + (f" and {group_bias.shape[1]} buckets" if gw else "")
            + f" needs {need} bytes of shared memory for one query, above "
            f"the {SMEM_LIMIT} a block may use"
        )
    for name, t in named[2:]:
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be a [{n}] float32 tensor")
    if group_bias is not None:
        if group_bias.dtype != torch.float32 or (
                group_ids is not None and group_ids.dtype != torch.int32):
            raise ValueError("group_bias must be float32 and group_ids int32")
    if buckets is not None:
        want = (torch.uint8, torch.int32, torch.float32, torch.int32)
        if tuple(t.dtype for t in buckets) != want:
            raise ValueError("bucket codes, ids, norms and fill must be uint8, "
                             "int32, float32 and int32")
    for name, t in [("queries", queries)] + named + grouped:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _group_words(groups: int) -> int:
    """32-bit words of one query's bucket bits."""
    return -(-groups // 32)


# The bucket kernel's chunk (a warp's slots of one bucket), its query tile,
# the most splits it takes and the splits past which the merge tree folds
# their lists. On an H100 a query tile of 1, one wave of blocks up to 128
# splits and the tree past 8 splits were the fastest or within 7 % of it
# at batches 1 to 256 (PERF.md has the sweep).
CHUNK = 32
BUCKET_QT = 1
BUCKET_MAX_SPLITS = 128
BUCKET_TREE_SPLITS = 8


def bucket_splits(nq: int, qt: int, resident: int, k: int, lists_in_smem: bool) -> int:
    """Row splits of a bucket-kernel launch: enough blocks to fill the card
    once (``resident`` blocks at a time), at most
    :data:`BUCKET_MAX_SPLITS` (a query probes a few percent of the rows:
    past that a split holds under a tile of them); with lists in device
    memory, fewer while their scratch passes :data:`.select.SCRATCH_BYTES`.
    Any count gives the same answer."""
    fill = max(1, resident // -(-nq // qt))
    s = max(1, min(fill, BUCKET_MAX_SPLITS))
    while not lists_in_smem and s > 1 and nq * s * k * 8 > select.SCRATCH_BYTES:
        s = -(-s // 2)
    return s


def bucket_merge_by_tree(splits: int, k: int, lists_in_smem: bool) -> bool:
    """Whether the merge tree folds the bucket kernel's split lists: as
    :func:`.select.merge_by_tree`, and past :data:`BUCKET_TREE_SPLITS`
    splits at any k, where one block a query folding the lists one by one
    takes longer than the tree's ``log2 S`` launches."""
    return select.merge_by_tree(splits, k, lists_in_smem) or splits > BUCKET_TREE_SPLITS


def ivf_scan_plan(probed, counts, qt: int, splits: int) -> list[list[list[tuple]]]:
    """The bucket kernel's schedule in plain Python
    (``csrc/adc_bucket_kernel.cu``). ``probed [Q, nb]`` bool: query q scans
    bucket b (the row-order form's last bucket, rows in no bucket, for
    every query); ``counts [nb]``: each bucket's slots. For each tile of
    ``qt`` queries and each of its ``splits``, the chunks the split scores,
    in order, as ``(bucket, first slot, slots)``: the tile's list is every
    bucket some query of the tile probes, in ascending order, cut into
    chunks of :data:`CHUNK` slots; split s takes chunks ``[s·c, (s+1)·c)``
    of it with ``c = ceil(chunks / splits)``, and its warps score them 8 at
    a time."""
    probed = np.asarray(probed, bool)
    counts = np.asarray(counts, np.int64)
    plan = []
    for q0 in range(0, probed.shape[0], qt):
        chunks = [(int(b), j, int(min(CHUNK, counts[b] - j)))
                  for b in np.flatnonzero(probed[q0:q0 + qt].any(0))
                  for j in range(0, int(counts[b]), CHUNK)]
        per = -(-len(chunks) // splits)
        plan.append([chunks[s * per:(s + 1) * per] for s in range(splits)])
    return plan


def fused_adc_topk(
    queries: torch.Tensor,
    codes: torch.Tensor,
    codebooks: torch.Tensor,
    recon_norms: torch.Tensor,
    num_valid: int,
    k: int,
    metric,
    valid_mask: torch.Tensor | None = None,
    exact_lut: bool = False,
    packed4: bool = False,
    group_bias: torch.Tensor | None = None,
    group_ids: torch.Tensor | None = None,
    buckets: tuple[torch.Tensor, ...] | None = None,
    int8_lut: bool = False,
    group_rows: int = 0,
    grid=None,
    lut: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ADC top-k of ``queries [Q, D]`` f32 (pre-normalized for cosine)
    over PQ ``codes`` (uint8 ``[N, m]``, or ``[N, ⌈m/2⌉]`` with
    ``packed4``) with ``codebooks [m, ksub, dsub]`` f32 and reconstruction
    norms ``recon_norms [N]`` f32; rows ≥ ``num_valid`` and rows where
    ``valid_mask [N]`` (f32) is 0 never enter. ``group_bias [Q, G]`` f32
    with ``group_ids [N]`` int32: the IVF bucket bias (module docstring).
    ``buckets``: ``(codes [G, B, cols] uint8, ids [G, B] int32, norms
    [G, B] f32, fill [G] int32)``, the same rows by bucket: bucket g's
    first ``fill[g]`` slots hold the codes, norms and row ids of its rows
    (−1: no row), and every row that can enter (below ``num_valid``, mask
    not 0) sits in the bucket ``group_ids`` names. On CUDA the kernel then
    reads the rows from it (the plain version needs no layout); without
    it the rows are grouped on the device each call. Returns ``(scores
    [Q, k] f32, indices [Q, k] int32)`` by (score descending, row
    ascending); unfilled slots hold (−inf, −1). On CUDA ``1 ≤ k ≤ N``.
    ``int8_lut``: the LUT quantized per query (:func:`quantize_lut`);
    neither ``exact_lut`` nor a bucket bias goes with it. ``group_rows``
    (with ``group_bias``, instead of ``group_ids``): row r is in bucket
    ``r // group_rows`` (module docstring). ``grid``: a
    :class:`.grid.Grid` (module docstring), or None for one wave and the
    tile :func:`_query_tile` picks; the plain version ignores it. ``lut``:
    :func:`adc_tables`' result for these queries and codebooks, built once
    for several calls (a sharded search's shards on one device); None
    builds it here."""
    metric = DistanceMetric(metric)
    if metric not in _METRICS:
        raise NotImplementedError(f"metric {metric!r} has no built-in score kernel")
    grid = check_grid(grid, QUERY_TILES, "fused_adc_topk")
    if int8_lut and (exact_lut or group_bias is not None):
        raise ValueError(INT8_LUT_EXCLUSIVE)
    _check_shapes(queries, codes, codebooks, packed4, group_bias, group_ids, buckets,
                  group_rows)
    if queries.device.type == "cpu":
        return fused_adc_topk_reference(queries, codes, codebooks, recon_norms,
                                        num_valid, k, metric, valid_mask,
                                        exact_lut, packed4, group_bias, group_ids,
                                        int8_lut=int8_lut, group_rows=group_rows,
                                        lut=lut)
    if queries.device.type != "cuda":
        raise ValueError(f"fused_adc_topk runs on CUDA or CPU, not {queries.device}")
    _check_cuda(queries, codes, codebooks, recon_norms, k, valid_mask,
                exact_lut, group_bias, group_ids, buckets, int8_lut)
    from ._build import load

    lib = load()
    nq = queries.shape[0]
    n = codes.shape[0]
    m, ksub, _ = codebooks.shape
    dev = queries.device
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0 or n == 0:  # nothing to scan: every slot stays unfilled
        return out_s.fill_(float("-inf")), out_i.fill_(-1)
    if lut is None:
        lut = adc_tables(queries, codebooks, exact_lut, int8_lut)
    _check_tables(lut, nq, codebooks)
    lut, sq = lut
    lut_code = LUT_INT8 if int8_lut else LUT_F32 if exact_lut else LUT_BF16
    with torch.cuda.device(dev):
        if int8_lut and int8_lut_route(ksub, m, codes.shape[1]) == "mma":
            _launch_int8_mma(lib, lut, sq, codes, recon_norms, valid_mask, num_valid, k,
                             metric, packed4, m, ksub, out_s, out_i, grid=grid)
            fused_adc_topk.int8_launches += 1
            fused_adc_topk.int8_mma_launches += 1
        elif group_bias is None:
            occupancy = dict(_occupancy(dev.index, lut_code, int(packed4), m, ksub,
                                        min(k, SMEM_K + 1), True))
            qt = _grid_tile(grid, occupancy, _query_tile(nq, occupancy))
            if qt not in occupancy:
                raise ValueError(
                    f"fused_adc_topk: tile={qt} does not fit shared memory at "
                    f"m*ksub={m * ksub}, k={k} (tiles that fit: {sorted(occupancy)})")
            _launch(lib, lut, codes, recon_norms, valid_mask, num_valid, k, metric,
                    packed4, m, ksub, qt, k <= SMEM_K, occupancy[qt], out_s, out_i,
                    lut_scale=sq, grid=grid)
            if int8_lut:
                fused_adc_topk.int8_launches += 1
        else:
            groups = group_bias.shape[1]
            layout = (_rows_layout(codes, recon_norms, int(group_rows), groups)
                      if group_rows else
                      _group_layout(codes, recon_norms, group_ids, groups)
                      if buckets is None else _bucket_layout(buckets))
            per_sm = dict(_occupancy(dev.index, lut_code, int(packed4), m, ksub,
                                     min(k, SMEM_K + 1), True,
                                     _group_words(layout[-1].shape[0]),
                                     (BUCKET_QT,), layout[1] is not None))[BUCKET_QT]
            _launch_buckets(lib, lut, lut_bias(group_bias, exact_lut), layout,
                            valid_mask, min(int(num_valid), n), k, metric, packed4,
                            m, ksub, BUCKET_QT, k <= SMEM_K, per_sm, out_s, out_i,
                            grid=grid)
            fused_adc_topk.group_launches += 1
            if group_rows:
                fused_adc_topk.group_rows_launches += 1
    fused_adc_topk.launches += 1
    return out_s, out_i


def _group_layout(codes, recon_norms, group_ids, groups: int):
    """The row-order form's rows grouped by bucket on the device, as the
    bucket kernel reads a layout (:func:`_launch_buckets`): bucket g's rows
    in ascending row order, then the rows whose ``group_ids`` lies outside
    ``[0, G)`` as bucket G, which takes no bias and every query scans. No
    host synchronization."""
    key = group_ids.long()
    key = torch.where((key >= 0) & (key < groups), key, groups)
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(groups + 1, dtype=torch.int64, device=key.device)
    counts.index_add_(0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 0) - counts
    return (codes[order], order.to(torch.int32), recon_norms[order], starts, 0,
            counts.to(torch.int32))


def _rows_layout(codes, recon_norms, group_rows: int, groups: int):
    """The bucket-major form's rows as the bucket kernel reads a layout,
    where they stand: bucket g's slots start at g·group_rows and hold
    ``min(group_rows, N − g·group_rows)`` rows (none past N), the rows past
    G·group_rows are bucket G, and slot s is row s (no ids)."""
    n = codes.shape[0]
    first = torch.arange(groups + 1, dtype=torch.int64, device=codes.device) * group_rows
    counts = (n - first).clamp_(min=0)
    counts[:groups].clamp_(max=group_rows)
    return codes, None, recon_norms, None, group_rows, counts.to(torch.int32)


def _bucket_layout(buckets):
    """A caller's ``[G, B, ...]`` bucket layout as the kernel reads it:
    ``(codes [G·B, cols], ids, norms, None, B, fill)``, bucket g's slots
    starting at g·B."""
    bcodes, bids, bnorms, bfill = buckets
    return (bcodes.reshape(-1, bcodes.shape[2]), bids.reshape(-1), bnorms.reshape(-1),
            None, bcodes.shape[1], bfill)


def _launch(lib, lut, codes, recon_norms, valid_mask, num_valid, k, metric,
            packed4, m, ksub, qt, lists_in_smem, blocks_per_sm, out_s, out_i,
            splits=None, lut_scale=None, grid=None) -> None:
    """One launch of the scan and the merge for checked inputs and a LUT
    ``[Q, m·ksub]`` (f32, bf16, or int8 with its ``lut_scale [Q]`` f32)
    with query tile ``qt``, the lists in shared memory or not, into
    ``out_s``/``out_i``; ``splits`` (default: one wave of ``blocks_per_sm``
    blocks on every SM, times ``grid``'s waves) sets the row splits."""
    from ._build import raise_for

    nq = lut.shape[0]
    n, cols = codes.shape
    dev = lut.device
    if splits is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = max(1, wave_blocks(sms * max(1, blocks_per_sm), grid) // -(-nq // qt))
    splits, rows_per_split, length = select.row_splits(
        n, _ROW_TILE, splits, nq, k, lists_in_smem=lists_in_smem)
    tree = select.merge_by_tree(splits, k, lists_in_smem)
    part_s, part_i, tmp_s, tmp_i = select.scratch(nq, splits, length, k, dev,
                                                  tree=tree)
    slots = select.bar_slots(nq, splits, dev)
    err = lib.mvt_adc_topk(
        lut.data_ptr(), _LUT_CODES[lut.dtype],
        None if lut_scale is None else lut_scale.data_ptr(), codes.data_ptr(), cols,
        int(packed4), recon_norms.data_ptr(),
        None if valid_mask is None else valid_mask.data_ptr(),
        nq, n, m, ksub, max(0, min(int(num_valid), n)), k, int(metric),
        qt, splits, rows_per_split, 0 if lists_in_smem else length, int(tree),
        part_s.data_ptr(), part_i.data_ptr(),
        slots.data_ptr(),
        tmp_s.data_ptr(), tmp_i.data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_for(lib, err, "fused_adc_topk")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` where its base address is a multiple of 16 bytes (TMA's bulk
    copy reads it), else a copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_int8_mma(lib, lut8, sq, codes, recon_norms, valid_mask, num_valid, k,
                     metric, packed4, m, ksub, out_s, out_i, splits=None,
                     grid=None) -> None:
    """One launch of the tensor-core int8-LUT scan and the merge for checked
    inputs: ``lut8 [Q, m·ksub]`` int8 with its scales ``sq [Q]``, each
    subspace widened to 16 columns with zeros where ksub < 16, the shape of
    :func:`int8_mma_shape`, one wave of scan blocks times ``grid``'s waves
    (``splits`` overrides it, as :func:`.topk_kernel._plan`)."""
    from ._build import raise_for

    nq = lut8.shape[0]
    n, cols = codes.shape
    dev = lut8.device
    shape = int8_mma_shape(nq, m, cols, k)
    if ksub < INT8_MMA_KSUB:
        wide = torch.zeros((nq, m, INT8_MMA_KSUB), dtype=torch.int8, device=dev)
        wide[:, :, :ksub] = lut8.view(nq, m, ksub)
        lut8 = wide.view(nq, m * INT8_MMA_KSUB)
    splits, rows_per_split, length, tree, part_s, part_i, tmp_s, tmp_i, slots, _ = _scan_plan(
        dev, nq, n, k, 0 if shape.big else k,
        (2 * shape.nw, SCAN_ROWS * _mma_row_blocks(shape.nw)),
        _scan_occupancy(lib, lib.mvt_adc_int8_mma_occupancy, "fused_adc_topk[int8_mma]",
                        shape.nw, int(packed4), m, cols, shape.stages), splits,
        grid=grid)
    codes, recon_norms = _aligned16(codes), _aligned16(recon_norms)
    if valid_mask is not None:
        valid_mask = _aligned16(valid_mask)
    err = lib.mvt_adc_int8_mma(
        lut8.data_ptr(), sq.data_ptr(), codes.data_ptr(), cols, int(packed4),
        recon_norms.data_ptr(), None if valid_mask is None else valid_mask.data_ptr(),
        nq, n, m, max(0, min(int(num_valid), n)), k, int(metric),
        shape.nw, shape.stages, int(shape.big), splits, rows_per_split, length,
        int(tree), part_s.data_ptr(), part_i.data_ptr(), slots.data_ptr(),
        tmp_s.data_ptr(), tmp_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_for(lib, err, "fused_adc_topk[int8_mma]")


def _launch_buckets(lib, lut, gbias, layout, valid_mask, num_valid, k, metric,
                    packed4, m, ksub, qt, lists_in_smem, blocks_per_sm, out_s,
                    out_i, splits=None, tree=None, grid=None) -> None:
    """One launch of the bucket kernel and the merge: ``gbias [Q, G]`` as
    the kernel adds it, ``layout`` as :func:`_group_layout` or
    :func:`_bucket_layout` give it; ``splits`` (default
    :func:`bucket_splits` of one wave times ``grid``'s waves) sets the row splits and ``tree`` (default
    :func:`bucket_merge_by_tree`) whether the merge tree folds them; the
    rest as :func:`_launch`."""
    from ._build import raise_for

    bcodes, ids, norms, starts, stride, counts = layout
    nq = lut.shape[0]
    dev = lut.device
    if splits is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = bucket_splits(nq, qt, wave_blocks(sms * max(1, blocks_per_sm), grid),
                               k, lists_in_smem)
    if tree is None:
        tree = bucket_merge_by_tree(splits, k, lists_in_smem)
    tree = tree or not lists_in_smem
    part_s, part_i, tmp_s, tmp_i = select.scratch(nq, splits, k, k, dev, tree=tree)
    slots = select.bar_slots(nq, splits, dev)
    err = lib.mvt_adc_bucket_topk(
        lut.data_ptr(), int(lut.dtype != torch.float32), bcodes.data_ptr(),
        bcodes.shape[1], int(packed4), norms.data_ptr(),
        None if ids is None else ids.data_ptr(),
        None if starts is None else starts.data_ptr(), stride, counts.data_ptr(),
        counts.shape[0], None if valid_mask is None else valid_mask.data_ptr(),
        gbias.data_ptr(), gbias.shape[1], nq, m, ksub, max(0, int(num_valid)), k,
        int(metric), qt, splits, int(not lists_in_smem), int(tree),
        part_s.data_ptr(), part_i.data_ptr(), slots.data_ptr(),
        tmp_s.data_ptr(), tmp_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_for(lib, err, "fused_adc_topk")


fused_adc_topk.launches = 0
fused_adc_topk.group_launches = 0
fused_adc_topk.group_rows_launches = 0
fused_adc_topk.int8_launches = 0
fused_adc_topk.int8_mma_launches = 0
