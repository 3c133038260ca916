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
takes any number R of candidates: :func:`rescore_plan` splits a query's
candidates over enough blocks to fill the card, and the splits' lists are
folded by the block that finishes a query last (k ≤ :data:`WARP_LIST`, at
most :data:`MERGE_ENTRIES` list entries), else by the merge tree of
:mod:`.select`.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..format.constants import DistanceMetric

from . import _build, select
from .distances import full_f32_matmul
from .topk_kernel import SMEM_LIMIT

TIES = ("position", "row")
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_GATHER_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.int8,
                  torch.uint8, torch.int32)
_METRICS = (
    DistanceMetric.L2, DistanceMetric.INNER_PRODUCT, DistanceMetric.COSINE
)

# The rescore's split plan (csrc/gather_kernel.cu: kWarps, kWarpList, and
# the candidates a block of 128 threads scores in one pass).
WARPS, WARP_LIST, PASS = 4, 32, 32
BLOCKS_PER_SM = 4  # blocks the plan aims to give every SM
MAX_SPLITS = 64  # splits of one query that the last block folds
SPLIT_MAX = 4096  # candidates of one split (its sort in shared memory)
MERGE_ENTRIES = 4096  # list entries the last block folds in shared memory
MERGE_NONE, MERGE_BLOCK, MERGE_TREE = 0, 1, 2

_lib = None
_sms: dict[int, int] = {}
_arrivals: dict[tuple[int, int], torch.Tensor] = {}


def _kernels():
    """The kernels' library, resolved once (built at first use)."""
    global _lib
    if _lib is None:
        _lib = _build.load()
    return _lib


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
    out = torch.empty((idx.shape[0], db.shape[1]), dtype=db.dtype,
                      device=db.device)
    if out.numel() == 0:
        return out
    lib = _kernels()
    idx = idx.contiguous()
    with torch.cuda.device(db.device):
        err = lib.mvt_gather_rows(
            db.data_ptr(), db.shape[0], db.shape[1] * db.element_size(),
            idx.data_ptr(), idx.element_size(), idx.shape[0], out.data_ptr(),
            torch.cuda.current_stream(db.device).cuda_stream)
    _build.raise_for(lib, err, "gather_rows")
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


@dataclasses.dataclass(frozen=True)
class RescorePlan:
    """How :func:`rescore_candidates` lays out one launch: ``splits``
    blocks a query of ``split_len`` candidates each (the last may be
    shorter), each keeping a sorted list of ``list_len`` = min(k,
    split_len); ``merge`` says who folds the lists (none: one split; block:
    the block that finishes the query last, by warp selection, for k ≤
    :data:`WARP_LIST`; tree: the merge tree);
    ``sort_len`` and ``room`` are the entries of the split's scores and of
    the lists in shared memory, ``smem`` the block's dynamic shared memory
    in bytes; ``part`` and ``tmp`` are the scratch entries per query (f32
    score + i32 key each)."""

    splits: int
    split_len: int
    list_len: int
    merge: int
    sort_len: int
    room: int
    smem: int
    part: int
    tmp: int


@functools.lru_cache(maxsize=256)
def rescore_plan(nq: int, r: int, k: int, d: int, sms: int) -> RescorePlan:
    """The split plan of a rescore of ``nq`` queries' ``r`` candidates at
    dimension ``d`` for the top ``k`` on a card of ``sms`` SMs: enough
    splits that the ``nq * splits`` blocks give every SM
    :data:`BLOCKS_PER_SM`, but no more splits than scoring passes over
    the candidates (:data:`PASS` a pass), none longer than
    :data:`SPLIT_MAX`, and at most :data:`MAX_SPLITS` unless the length
    forces more. Lists of at most
    :data:`WARP_LIST` are selected by warps; longer ones sort the split, so
    the sort runs over a power of two. The last block folds the lists where
    k ≤ :data:`WARP_LIST` and they hold at most :data:`MERGE_ENTRIES`
    entries; the merge tree folds the rest."""
    want = -(-BLOCKS_PER_SM * sms // max(nq, 1))
    splits = max(1, min(want, MAX_SPLITS, -(-r // PASS)), -(-r // SPLIT_MAX))
    split_len = -(-r // splits)
    splits = -(-r // split_len)
    m = min(k, split_len)
    if splits == 1:
        merge = MERGE_NONE
    elif k <= WARP_LIST and splits <= MAX_SPLITS and splits * m <= MERGE_ENTRIES:
        merge = MERGE_BLOCK
    else:
        merge = MERGE_TREE
    warp_select = m <= WARP_LIST
    sort_len = split_len if warp_select else 1 << (split_len - 1).bit_length()
    room = ((WARPS * WARP_LIST if warp_select else 0)
            + (splits * m if merge == MERGE_BLOCK else 0))
    if merge == MERGE_TREE:
        part, tmp = select.merge_scratch(splits, m, k)
    else:
        part, tmp = (0 if merge == MERGE_NONE else splits * m), 0
    smem = 4 * (-(-d // 4) * 4 + split_len + 2 * sort_len + 2 * room)
    return RescorePlan(splits, split_len, m, merge, sort_len, room, smem,
                       part, tmp)


def _check_rescore(queries, db, db_norms, cand_idx, k,
                   sms: int = 132) -> RescorePlan:
    """Raise on what the kernel does not take; else its plan on a card of
    ``sms`` SMs."""
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
    plan = rescore_plan(nq, cand_idx.shape[1], k, d, sms)
    if plan.smem > SMEM_LIMIT:
        raise ValueError(
            f"D={d} needs {plan.smem} bytes of shared memory beside the "
            f"split's candidates, above the {SMEM_LIMIT} a block may use"
        )
    if nq * plan.splits >= 2**31:
        raise ValueError(f"{nq} queries x {plan.splits} splits: more blocks "
                         "than a grid holds")
    if n >= 2**31:
        raise ValueError(f"N={n} rows: the kernel's row indices are int32")
    if db_norms.dtype != torch.float32 or tuple(db_norms.shape) != (n,):
        raise ValueError(f"db_norms must be a [{n}] float32 tensor")
    for name, t in (("queries", queries), ("db", db), ("db_norms", db_norms)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return plan


def _arrivals_for(device: torch.device, stream: int, nq: int) -> torch.Tensor:
    """The per-query arrival counters of the last-block merge on one
    stream: zero before every launch, which leaves them zero again (launches
    on one stream run one after another). Grown, zeroed, when a batch is
    larger than any before."""
    key = (device.index, stream)
    have = _arrivals.get(key)
    if have is None or have.numel() < nq:
        have = torch.zeros(max(nq, 256), dtype=torch.int32, device=device)
        _arrivals[key] = have
    return have


def _sm_count(device: torch.device) -> int:
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device.index]


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
    dev = queries.device
    nq, d = queries.shape
    plan = _check_rescore(queries, db, db_norms, cand_idx, k, _sm_count(dev))
    # The outputs [2, nq, k] in one allocation, the scratch in another
    # (none at one split): the split lists [2, nq * part], then the merge
    # tree's room [2, nq * tmp]. The results pin only their own bytes.
    out_n = nq * k
    out = torch.empty(2 * out_n, dtype=torch.int32, device=dev)
    out_s = out[:out_n].view(torch.float32).view(nq, k)
    out_i = out[out_n:].view(nq, k)
    if nq == 0:
        return out_s, out_i
    lib = _kernels()
    cand = cand_idx.to(torch.int32).contiguous()
    part_s = part_i = tmp_s = tmp_i = 0
    if plan.merge != MERGE_NONE:
        scratch = torch.empty(2 * nq * (plan.part + plan.tmp),
                              dtype=torch.int32, device=dev)
        part_s = scratch.data_ptr()
        part_i = part_s + 4 * nq * plan.part
        tmp_s = part_i + 4 * nq * plan.part
        tmp_i = tmp_s + 4 * nq * plan.tmp
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        arrivals = (_arrivals_for(dev, stream, nq).data_ptr()
                    if plan.merge == MERGE_BLOCK else 0)
        err = lib.mvt_rescore(
            queries.data_ptr(), db.data_ptr(), _DTYPE_CODES[db.dtype],
            db_norms.data_ptr(), cand.data_ptr(), nq, db.shape[0], d, r, k,
            int(metric), int(tie == "row"), plan.splits, plan.split_len,
            plan.list_len, plan.merge, plan.sort_len, plan.room, plan.smem,
            part_s, part_i, tmp_s, tmp_i, arrivals, out.data_ptr(),
            out.data_ptr() + 4 * out_n, stream,
        )
    _build.raise_for(lib, err, "rescore_candidates")
    rescore_candidates.launches += 1
    return out_s, out_i


rescore_candidates.launches = 0
