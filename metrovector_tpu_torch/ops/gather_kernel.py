"""Row gather and the fused gather + exact rescore: the wrappers of the
Hopper kernels in ``csrc/gather_kernel.cu`` and their plain PyTorch
versions.

Replaces ``metrovector_tpu/ops/gather_kernel.py::gather_rows`` and the
re-rank it feeds: ``ops/distances.py::rescore_topk`` and
``index/pq.py::_rerank_impl``. A CUDA tensor goes to the kernel or the call
raises; a CPU tensor goes to the plain version. ``gather_rows.launches`` and
``rescore_candidates.launches`` count kernel launches.

The TPU kernel's strip fetch, its ``N % 8`` rule and ``auto_select``'s
routing region were Mosaic limits and have no counterpart here. The rescore
takes any number R of candidates: above 4096 it sorts chunks of 4096 and a
merge tree folds them (:mod:`.select`).
"""

from __future__ import annotations

import torch

from ..format.constants import DistanceMetric

from . import select
from .distances import full_f32_matmul
from .topk_kernel import SMEM_LIMIT

CHUNK = 4096  # candidates one block sorts in shared memory (csrc kChunk)
TIES = ("position", "row")
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_GATHER_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.int8,
                  torch.uint8, torch.int32)
_METRICS = (
    DistanceMetric.L2, DistanceMetric.INNER_PRODUCT, DistanceMetric.COSINE
)


def gather_rows_reference(db: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_rows`."""
    n = db.shape[0]
    return db[idx.long().clamp(0, n - 1)]


def gather_rows(db: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``db[idx]`` as ``[R, D]`` in ``db``'s dtype, bit-exact, with
    indices below 0 clamped to row 0 and indices ≥ N to row N−1 (the JAX
    kernel's ``clip``; callers mask ``-1`` slots themselves)."""
    if db.dim() != 2:
        raise ValueError(f"db must be [N, D], got shape {tuple(db.shape)}")
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError("idx must be a [R] int32 or int64 tensor")
    if db.shape[0] == 0 and idx.numel():
        raise ValueError("cannot gather rows of an empty db")
    if db.device.type == "cpu":
        return gather_rows_reference(db, idx)
    if db.device.type != "cuda":
        raise ValueError(f"gather_rows runs on CUDA or CPU, not {db.device}")
    if idx.device != db.device:
        raise ValueError(f"idx is on {idx.device}, db on {db.device}")
    if db.dtype not in _GATHER_DTYPES:
        raise ValueError(f"gather_rows does not take {db.dtype}")
    if not db.is_contiguous():
        raise ValueError("db must be contiguous")
    from ._build import load, raise_for

    lib = load()
    out = torch.empty((idx.shape[0], db.shape[1]), dtype=db.dtype,
                      device=db.device)
    if out.numel() == 0:
        return out
    idx64 = idx.to(torch.int64).contiguous()
    with torch.cuda.device(db.device):
        err = lib.mvt_gather_rows(
            db.data_ptr(), db.shape[0], db.shape[1] * db.element_size(),
            idx64.data_ptr(), idx64.shape[0], out.data_ptr(),
            torch.cuda.current_stream(db.device).cuda_stream,
        )
    raise_for(lib, err, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def rescore_candidates_reference(
    queries: torch.Tensor,
    db: torch.Tensor,
    db_norms: torch.Tensor,
    cand_idx: torch.Tensor,
    k: int,
    metric,
    tie: str = "position",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`rescore_candidates` (same signature and
    results)."""
    metric = DistanceMetric(metric)
    nq, r = cand_idx.shape
    cand = cand_idx.long()
    valid = cand >= 0
    rows = gather_rows_reference(db, cand.reshape(-1)).reshape(nq, r, -1)
    q = queries.float()
    with full_f32_matmul():
        dots = (rows.float() @ q[:, :, None])[:, :, 0]
    nrm = db_norms[cand.clamp(0, db.shape[0] - 1)]
    if metric == DistanceMetric.L2:
        s = 2.0 * dots - nrm
    elif metric == DistanceMetric.COSINE:
        qin = 1.0 / torch.sqrt(torch.clamp((q * q).sum(-1), min=1e-30))
        s = dots * (1.0 / torch.sqrt(torch.clamp(nrm, min=1e-30))) * qin[:, None]
    else:
        s = dots
    s = torch.where(valid, s, torch.tensor(float("-inf"), device=s.device))
    order = torch.arange(r, device=s.device).expand(nq, -1)
    if tie == "row":  # sort by row first; the stable sort on score keeps it
        key = torch.where(valid, cand, torch.iinfo(torch.int64).max)
        order = torch.sort(key, dim=1, stable=True).indices
    by_score = torch.sort(-torch.gather(s, 1, order), dim=1, stable=True).indices
    pos = torch.gather(order, 1, by_score)[:, :k]
    top_s = torch.gather(s, 1, pos)
    top_i = torch.gather(cand, 1, pos)
    return top_s, torch.where(torch.isneginf(top_s), -1, top_i).to(torch.int32)


def _rescore_smem(d: int, r: int) -> int:
    """Dynamic shared memory of one rescore block: the query and the sort
    of one chunk, padded to a power of two."""
    p = 1 << (min(r, CHUNK) - 1).bit_length()
    return 4 * (-(-d // 4) * 4 + 2 * p)


def _check_rescore(queries, db, db_norms, cand_idx, k) -> None:
    dev = queries.device
    for name, t in (("db", db), ("db_norms", db_norms), ("cand_idx", cand_idx)):
        if t.device != dev:
            raise ValueError(
                f"{name} is on {t.device}, queries on {dev}: one device only"
            )
    if queries.dtype != torch.float32 or queries.dim() != 2:
        raise ValueError("queries must be a [Q, D] float32 tensor")
    if db.dim() != 2 or db.dtype not in _DTYPE_CODES:
        raise ValueError("db must be a [N, D] float32, float16 or bfloat16 tensor")
    nq, d = queries.shape
    n = db.shape[0]
    if db.shape[1] != d:
        raise ValueError(f"queries have D={d}, db has D={db.shape[1]}")
    r = cand_idx.shape[1]
    if _rescore_smem(d, r) > SMEM_LIMIT:
        raise ValueError(
            f"D={d} needs {_rescore_smem(d, r)} bytes of shared memory beside "
            f"the sort, above the {SMEM_LIMIT} a block may use"
        )
    if -(-r // CHUNK) >= 2**16:
        raise ValueError(f"R={r} candidates: more chunks than a grid holds")
    if n >= 2**31:
        raise ValueError(f"N={n} rows: the kernel's row indices are int32")
    if db_norms.dtype != torch.float32 or tuple(db_norms.shape) != (n,):
        raise ValueError(f"db_norms must be a [{n}] float32 tensor")
    for name, t in (("queries", queries), ("db", db), ("db_norms", db_norms)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rescore_candidates(
    queries: torch.Tensor,
    db: torch.Tensor,
    db_norms: torch.Tensor,
    cand_idx: torch.Tensor,
    k: int,
    metric,
    tie: str = "position",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 rescore of ``cand_idx [Q, R]`` (rows of ``db [N, D]``,
    ``-1`` = no candidate) for raw ``queries [Q, D]`` f32, and the top
    ``k ≤ R``: ``(scores [Q, k] f32, rows [Q, k] int32)`` by score
    descending. ``tie="position"`` breaks ties by the candidate's position
    (``lax.top_k`` in ``_rerank_impl``); ``tie="row"`` by the lower row
    (``rescore_topk``). Cosine divides by both norms, the query's taken
    here. Invalid candidates come out as (−inf, −1)."""
    metric = DistanceMetric(metric)
    if metric not in _METRICS:
        raise NotImplementedError(f"metric {metric!r} has no built-in score kernel")
    if tie not in TIES:
        raise ValueError(f"tie must be one of {TIES}, got {tie!r}")
    if cand_idx.dim() != 2 or cand_idx.shape[0] != queries.shape[0]:
        raise ValueError("cand_idx must be [Q, R] for Q queries")
    r = cand_idx.shape[1]
    if not 1 <= k <= r:
        raise ValueError(f"k={k} must be in 1..R={r}")
    if queries.device.type == "cpu":
        return rescore_candidates_reference(queries, db, db_norms, cand_idx,
                                            k, metric, tie)
    if queries.device.type != "cuda":
        raise ValueError(f"rescore_candidates runs on CUDA or CPU, not {queries.device}")
    _check_rescore(queries, db, db_norms, cand_idx, k)
    from ._build import load, raise_for

    lib = load()
    nq, d = queries.shape
    dev = queries.device
    out_s = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=dev)
    if nq == 0:
        return out_s, out_i
    cand = cand_idx.to(torch.int32).contiguous()
    chunks = -(-r // CHUNK)
    with torch.cuda.device(dev):
        part_s, part_i, tmp_s, tmp_i = select.scratch(
            nq if chunks > 1 else 0, chunks, min(k, CHUNK), k, dev,
            tree=chunks > 1)
        err = lib.mvt_rescore(
            queries.data_ptr(), db.data_ptr(), _DTYPE_CODES[db.dtype],
            db_norms.data_ptr(), cand.data_ptr(), nq, db.shape[0], d, r, k,
            int(metric), int(tie == "row"),
            part_s.data_ptr(), part_i.data_ptr(),
            tmp_s.data_ptr(), tmp_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    raise_for(lib, err, "rescore_candidates")
    rescore_candidates.launches += 1
    return out_s, out_i


rescore_candidates.launches = 0
