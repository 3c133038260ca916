"""PQ asymmetric-distance scan + top-k: the wrapper of the Hopper kernel
``csrc/adc_kernel.cu`` and its plain PyTorch version.

Replaces ``metrovector_tpu/ops/adc_kernel.py::fused_adc_topk`` for uint8
codes ``[N, m]`` and nibble-packed codes ``[N, ⌈m/2⌉]`` (``packed4``), with
an f32 (``exact_lut``) or bf16 lookup table. A CUDA tensor goes to the
kernel or the call raises; a CPU tensor goes to
:func:`fused_adc_topk_reference`. ``fused_adc_topk.launches`` counts kernel
launches (scan and merge of one call count once).

The per-query table ``LUT[q, j·ksub + c] = q_j · C[j, c]`` is a small
einsum outside the kernel, as in the JAX package, in full f32 and then
rounded to bf16 unless ``exact_lut``. Both versions add the m looked-up
entries of a row in ascending j in f32, so they agree bit for bit. The int8
LUT and the IVF ``group_bias``/``group_rows``/``group_ids`` variants, and
the Mosaic knobs (``block_rows``, ``query_tile``, ``vmem_retry``), are not
ported. Any ``1 ≤ k ≤ N``: above k = 1024 the per-split lists live in
device memory and a merge tree folds them (:mod:`.select`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..format.constants import DistanceMetric

from . import select
from .distances import carry_topk, empty_topk, finish_topk, full_f32_matmul, mask_scores
from .topk_kernel import SMEM_LIMIT

SMEM_K = 1024  # lists in shared memory up to this k
# Shape constants of csrc/adc_kernel.cu
_QUERY_TILES = (1, 2, 4, 8, 16, 32)
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
    block_rows: int = 65536,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_adc_topk` (same results): the torch
    twin of ``_adc_search``, the LUT gathered by code per row block, with a
    carried candidate list (ties to the lowest row)."""
    metric = DistanceMetric(metric)
    m, ksub, _ = codebooks.shape
    lut = adc_lut(queries, codebooks, exact_lut).float()
    nq, n = lut.shape[0], codes.shape[0]
    best = empty_topk(nq, lut.device)
    for start in range(0, n, block_rows):
        stop = min(n, start + block_rows)
        blk = codes[start:stop]
        if packed4:
            blk = unpack_nibbles(blk, m)
        blk = blk.long()
        acc = torch.zeros((nq, stop - start), dtype=torch.float32,
                          device=lut.device)
        for j in range(m):  # ascending j, in f32, as the kernel adds
            acc = acc + lut[:, j * ksub + blk[:, j]]
        nrm = recon_norms[start:stop][None, :]
        if metric == DistanceMetric.L2:
            s = 2.0 * acc - nrm
        elif metric == DistanceMetric.COSINE:
            s = acc * (1.0 / torch.sqrt(torch.clamp(nrm, min=1e-30)))
        else:
            s = acc
        vm = None if valid_mask is None else valid_mask[start:stop]
        best = carry_topk(best, mask_scores(s, start, num_valid, vm), start, k)
    return finish_topk(best, k)


def _shared_bytes(qt: int, mk: int, k: int, exact_lut: bool,
                  lists_in_smem: bool = True) -> int:
    """Dynamic shared memory of one scan block: the LUT of ``qt`` queries
    (rounded up to 16 bytes), then per query the bar, two score rows and
    two sets of candidate words, the buffer and its fill, and the list (none above
    :data:`SMEM_K` or without ``lists_in_smem``: it lives in device
    memory)."""
    lut = -(-qt * mk * (4 if exact_lut else 2) // 16) * 16
    lists = k if lists_in_smem and k <= SMEM_K else 0
    return lut + qt * (8 + 2 * (4 * _ROW_TILE + _ROW_TILE // 8) + 8 * _BUFFER + 4
                       + 8 * lists)


def _fitting_tiles(mk: int, k: int, exact_lut: bool,
                   lists_in_smem: bool = True) -> list[int]:
    """The query tiles whose scan block fits in shared memory."""
    return [t for t in _QUERY_TILES
            if _shared_bytes(t, mk, k, exact_lut, lists_in_smem) <= SMEM_LIMIT]


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
               ksub: int, k: int, lists_in_smem: bool) -> tuple[tuple[int, int], ...]:
    """(tile, scan blocks per SM) for each tile that fits, from the
    runtime's occupancy calculator on the current device."""
    from ._build import load, raise_for

    lib = load()
    smem_k = k if lists_in_smem and k <= SMEM_K else 0
    out = []
    for qt in _fitting_tiles(m * ksub, k, lut_code == 0, lists_in_smem):
        per_sm = ctypes.c_int(0)
        raise_for(lib, lib.mvt_adc_topk_occupancy(
            lut_code, packed4, qt, m, ksub, smem_k, ctypes.byref(per_sm)),
            "fused_adc_topk")
        out.append((qt, per_sm.value))
    return tuple(out)


def _check_shapes(queries, codes, codebooks, packed4) -> None:
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


def _check_cuda(queries, codes, codebooks, recon_norms, k, valid_mask,
                exact_lut) -> None:
    dev = queries.device
    named = [("codes", codes), ("codebooks", codebooks),
             ("recon_norms", recon_norms)]
    if valid_mask is not None:
        named.append(("valid_mask", valid_mask))
    for name, t in named:
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
    need = _shared_bytes(1, m * ksub, k, exact_lut, lists_in_smem=False)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"m*ksub={m * ksub} with k={k} needs {need} bytes of shared "
            f"memory for one query, above the {SMEM_LIMIT} a block may use"
        )
    for name, t in named[2:]:
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be a [{n}] float32 tensor")
    for name, t in [("queries", queries)] + named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """ADC top-k of ``queries [Q, D]`` f32 (pre-normalized for cosine)
    over PQ ``codes`` (uint8 ``[N, m]``, or ``[N, ⌈m/2⌉]`` with
    ``packed4``) with ``codebooks [m, ksub, dsub]`` f32 and reconstruction
    norms ``recon_norms [N]`` f32; rows ≥ ``num_valid`` and rows where
    ``valid_mask [N]`` (f32) is 0 never enter. Returns ``(scores [Q, k]
    f32, indices [Q, k] int32)`` by (score descending, row ascending);
    unfilled slots hold (−inf, −1). On CUDA ``1 ≤ k ≤ N``."""
    metric = DistanceMetric(metric)
    if metric not in _METRICS:
        raise NotImplementedError(f"metric {metric!r} has no built-in score kernel")
    _check_shapes(queries, codes, codebooks, packed4)
    if queries.device.type == "cpu":
        return fused_adc_topk_reference(queries, codes, codebooks, recon_norms,
                                        num_valid, k, metric, valid_mask,
                                        exact_lut, packed4)
    if queries.device.type != "cuda":
        raise ValueError(f"fused_adc_topk runs on CUDA or CPU, not {queries.device}")
    _check_cuda(queries, codes, codebooks, recon_norms, k, valid_mask,
                exact_lut)
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
    lut = adc_lut(queries, codebooks, exact_lut)
    with torch.cuda.device(dev):
        occupancy = dict(_occupancy(dev.index, int(not exact_lut), int(packed4),
                                    m, ksub, min(k, SMEM_K + 1), True))
        qt = _query_tile(nq, occupancy)
        _launch(lib, lut, codes, recon_norms, valid_mask, num_valid, k, metric,
                packed4, m, ksub, qt, k <= SMEM_K, occupancy[qt], out_s, out_i)
    fused_adc_topk.launches += 1
    return out_s, out_i


def _launch(lib, lut, codes, recon_norms, valid_mask, num_valid, k, metric,
            packed4, m, ksub, qt, lists_in_smem, blocks_per_sm, out_s, out_i,
            splits=None) -> None:
    """One launch of the scan and the merge for checked inputs and a LUT
    ``[Q, m·ksub]`` (f32 or bf16) with query tile ``qt``, the lists in
    shared memory or not, into ``out_s``/``out_i``; ``splits`` (default: one
    wave of ``blocks_per_sm`` blocks on every SM) sets the row splits."""
    from ._build import raise_for

    nq = lut.shape[0]
    n, cols = codes.shape
    dev = lut.device
    if splits is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = max(1, sms * max(1, blocks_per_sm) // -(-nq // qt))
    splits, rows_per_split, length = select.row_splits(
        n, _ROW_TILE, splits, nq, k, lists_in_smem=lists_in_smem)
    tree = select.merge_by_tree(splits, k, lists_in_smem)
    part_s, part_i, tmp_s, tmp_i = select.scratch(nq, splits, length, k, dev,
                                                  tree=tree)
    slots = select.bar_slots(nq, splits, dev)
    err = lib.mvt_adc_topk(
        lut.data_ptr(), int(lut.dtype != torch.float32), codes.data_ptr(), cols,
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


fused_adc_topk.launches = 0
