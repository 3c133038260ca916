"""Fused distance + top-k: the wrapper of the Hopper kernel
``csrc/topk_kernel.cu`` and its plain PyTorch version.

Replaces ``metrovector_tpu/ops/topk_kernel.py::fused_topk``. A CUDA tensor
goes to the kernel or the call raises; a CPU tensor goes to
:func:`fused_topk_reference`. ``fused_topk.launches`` counts kernel launches
(both passes of one call count once), so a run can show that its main path
went through the kernel.

The Mosaic/VMEM tuning knobs of the TPU kernel (``block_rows``,
``query_tile``, ``merge``, ``vmem_retry``) have no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from metrovector_tpu.format.constants import DistanceMetric

from .distances import exact_topk

MAX_K = 256
MAX_DIM = 1024
MAX_SPLITS = 512
SMEM_LIMIT = 232_448  # bytes of shared memory a block may opt into (sm_90)
# Shape constants of csrc/topk_kernel.cu
_QUERY_TILE = 32
_ROW_TILE = 128
_DIM_CHUNK = 64
_WARPS = 8

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


def _shared_bytes(d: int, k: int) -> int:
    """Dynamic shared memory of one scan block: the query tile, the staged
    corpus chunk, one score row per warp and the candidate lists."""
    floats = (_QUERY_TILE * d + _ROW_TILE * (_DIM_CHUNK + 1)
              + _WARPS * _ROW_TILE + _QUERY_TILE * k)
    return 4 * floats + 4 * _QUERY_TILE * k


def _splits(lib, nq: int, n: int, d: int, k: int, dtype_code: int,
            device: torch.device) -> tuple[int, int]:
    """Row splits S and rows per split: as many scan blocks as fit on the
    card at once (one full wave), but at least one split."""
    from ._build import raise_for

    per_sm = ctypes.c_int(0)
    raise_for(lib, lib.mvt_fused_topk_occupancy(dtype_code, d, k,
                                                ctypes.byref(per_sm)),
              "fused_topk")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-nq // _QUERY_TILE)
    tiles = -(-n // _ROW_TILE)
    want = max(1, sms * max(1, per_sm.value) // q_tiles)
    splits = max(1, min(want, MAX_SPLITS, tiles))
    rows_per_split = -(-tiles // splits) * _ROW_TILE
    return -(-n // rows_per_split), rows_per_split


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
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} is outside the kernel's limit 1 <= k <= {MAX_K}")
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"D={d} is outside the kernel's limit 1 <= D <= {MAX_DIM}")
    if _shared_bytes(d, k) > SMEM_LIMIT:
        raise ValueError(
            f"D={d} with k={k} needs {_shared_bytes(d, k)} bytes of shared "
            f"memory, above the {SMEM_LIMIT} a block may use"
        )
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
    unfilled slots hold (−inf, −1)."""
    metric = DistanceMetric(metric)
    if metric not in _METRICS:
        raise NotImplementedError(f"metric {metric!r} has no built-in score kernel")
    if queries.device.type == "cpu":
        return fused_topk_reference(queries, db, db_norms, num_valid, k,
                                    metric, valid_mask)
    if queries.device.type != "cuda":
        raise ValueError(f"fused_topk runs on CUDA or CPU, not {queries.device}")
    _check(queries, db, db_norms, k, valid_mask)
    from ._build import load, raise_for

    lib = load()
    nq, d = queries.shape
    n = db.shape[0]
    dev = queries.device
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0 or n == 0:  # nothing to scan: every slot stays unfilled
        return out_s.fill_(float("-inf")), out_i.fill_(-1)
    code = _DTYPE_CODES[db.dtype]
    with torch.cuda.device(dev):
        splits, rows_per_split = _splits(lib, nq, n, d, k, code, dev)
        part_s = torch.empty((nq, splits, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((nq, splits, k), dtype=torch.int32, device=dev)
        err = lib.mvt_fused_topk(
            queries.data_ptr(), db.data_ptr(), code,
            db_norms.data_ptr(),
            None if valid_mask is None else valid_mask.data_ptr(),
            nq, n, d, max(0, min(int(num_valid), n)), k, int(metric),
            splits, rows_per_split,
            part_s.data_ptr(), part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_for(lib, err, "fused_topk")
    fused_topk.launches += 1
    return out_s, out_i


fused_topk.launches = 0
