"""Fused distance + top-k: the wrapper of the Hopper kernel
``csrc/topk_kernel.cu`` and its plain PyTorch version.

Replaces ``metrovector_tpu/ops/topk_kernel.py::fused_topk``. A CUDA tensor
goes to the kernel or the call raises; a CPU tensor goes to
:func:`fused_topk_reference`. ``fused_topk.launches`` counts kernel launches
(both passes of one call count once), so a run can show that its main path
went through the kernel.

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
from .distances import exact_topk

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

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fused_topk` (same signature and results):
    :func:`~.distances.exact_topk` with the kernel's cosine epilogue, which
    takes queries as already normalized."""
    metric = DistanceMetric(metric)
    inv_q = None
    if metric == DistanceMetric.COSINE:
        inv_q = torch.ones(queries.shape[0], device=queries.device)
    return exact_topk(queries, db, db_norms, int(num_valid), k, metric,
                      valid_mask=valid_mask, query_inv_norms=inv_q)


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


def _check(queries, db, db_norms, k, valid_mask) -> None:
    dev = queries.device
    named = [("db", db), ("db_norms", db_norms)]
    if valid_mask is not None:
        named.append(("valid_mask", valid_mask))
    for name, t in named:
        if t.device != dev:
            raise ValueError(
                f"{name} is on {t.device}, queries on {dev}: one device only"
            )
    if queries.dtype != torch.float32 or queries.dim() != 2:
        raise ValueError("queries must be a [Q, D] float32 tensor")
    if db.dim() != 2 or db.dtype not in _DTYPE_CODES:
        raise ValueError(
            "db must be a [N, D] float32, float16 or bfloat16 tensor, got "
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
    for name, t in [("queries", queries)] + named:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_topk(
    queries: torch.Tensor,
    db: torch.Tensor,
    db_norms: torch.Tensor,
    num_valid: int,
    k: int,
    metric,
    valid_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of ``queries [Q, D]`` f32 (pre-normalized for cosine)
    over ``db [N, D]`` (f32 / f16 / bf16) with squared norms
    ``db_norms [N]`` f32; rows ≥ ``num_valid`` and rows where
    ``valid_mask [N]`` (f32) is 0 never enter. Returns ``(scores [Q, k]
    f32, indices [Q, k] int32)`` by (score descending, index ascending);
    unfilled slots hold (−inf, −1). On CUDA ``1 ≤ k ≤ N``, any D."""
    metric = DistanceMetric(metric)
    if metric not in _METRICS:
        raise NotImplementedError(f"metric {metric!r} has no built-in score kernel")
    if queries.device.type == "cpu":
        return fused_topk_reference(queries, db, db_norms, num_valid, k,
                                    metric, valid_mask)
    if queries.device.type != "cuda":
        raise ValueError(f"fused_topk runs on CUDA or CPU, not {queries.device}")
    _check(queries, db, db_norms, k, valid_mask)
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
        _launch(lib, queries, db, db_norms, valid_mask, num_valid, k, metric,
                _TILE, out_s, out_i)
    fused_topk.launches += 1
    return out_s, out_i


def _launch(lib, queries, db, db_norms, valid_mask, num_valid, k, metric,
            tile, out_s, out_i, splits=None) -> None:
    """One launch of the scan and the merge for checked inputs with block
    tile ``tile`` (a tile the library was built with) into
    ``out_s``/``out_i``. ``splits`` (default: one wave, as many scan blocks
    as fit on the card at once) sets the row splits; above :data:`SMEM_K`
    fewer if the lists would pass the scratch bound."""
    from ._build import raise_for

    nq, d = queries.shape
    n = db.shape[0]
    dev = queries.device
    code = _DTYPE_CODES[db.dtype]
    big = k > SMEM_K
    if splits is None:
        per_sm = ctypes.c_int(0)
        raise_for(lib, lib.mvt_fused_topk_occupancy(
            code, tile, min(k, SMEM_K), int(big), ctypes.byref(per_sm)),
            "fused_topk")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = max(1, sms * max(1, per_sm.value) // -(-nq // _TILES[tile][0]))
    splits, rows_per_split, length = select.row_splits(
        n, _TILES[tile][1], splits, nq, k, lists_in_smem=not big)
    tree = select.merge_by_tree(splits, k, not big)
    part_s, part_i, tmp_s, tmp_i = select.scratch(nq, splits, length, k, dev,
                                                  tree=tree)
    slots = select.bar_slots(nq, splits, dev)
    err = lib.mvt_fused_topk(
        queries.data_ptr(), db.data_ptr(), code, db_norms.data_ptr(),
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
