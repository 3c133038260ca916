"""Exact search over SPARSE (CSR) vector spaces on one ``torch.device``.

The counterpart of :mod:`metrovector_tpu.sparse`, with the same two
formulations and the same rule for choosing between them:

**ELL + overflow (default).** Each row is padded to a fixed width R (the
95th percentile of the row lengths, rounded up to a multiple of 8), rows
to a multiple of 8192; the entries of rows wider than R form a per-row
overflow tail. A search is one launch of the fused ELL scan + top-k kernel
(:func:`~.ops.sparse_kernel.ell_topk`): the per-row sums, the overflow,
the metric epilogue, the masks and the selection, without a ``[Q, N]``
score matrix in device memory. The JAX package kept the overflow as COO
entries added by a second segment-sum pass; here it is a CSR tail that the
kernel adds after the row's ELL slots.

**CSR segment-sum scan** (``formulation="coo"``): plain PyTorch, as the
JAX package left it to XLA: ``index_add_`` segment sums into the ``[Q, N]``
dots, the epilogue, then a stable-sort selection with ties to the lowest
row.

``formulation="auto"`` picks ELL unless padding would more than triple the
entry count. Memory is O(nnz) either way.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import SearchResult, ids_for_rows, radius_from_topk, resolve_device
from .errors import DimensionMismatchError, InvalidVectorTypeError
from .format.constants import DistanceMetric, VectorType
from .ops.distances import distances_np
from .ops.grid import check_grid
from .ops.sparse_kernel import QUERY_TILES, ell_topk, row_scores
from .utils.filters import padded_filter_plane
from .utils.transfer import put_chunked
from .utils.tune import tune_grid, tuned_grid

ELL_ROW_PAD = 8192  # ELL row count padded to a multiple


def ell_width(counts: np.ndarray) -> int:
    """R: the 95th percentile of the row lengths rounded up to a multiple
    of 8 (at least 8), but no more than the longest row."""
    r95 = int(np.percentile(counts, 95))
    return int(min(counts.max(initial=1), max(8, -(-r95 // 8) * 8)))


def choose_formulation(counts: np.ndarray, nnz: int) -> str:
    """``"ell"`` unless ELL padding would more than triple the entries."""
    if nnz == 0:
        return "ell"
    r_cap = ell_width(counts)
    padded = len(counts) * r_cap + int(np.maximum(counts - r_cap, 0).sum())
    return "ell" if padded <= 3 * nnz else "coo"


def ell_layout(indptr: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               n: int, r_cap: int | None = None) -> dict:
    """Host arrays of the ELL layout of a CSR corpus: ``cols_ell`` /
    ``vals_ell`` ``[n_pad, R]`` and the overflow as a CSR tail
    (``ovf_ptr [n_pad + 1]``, ``ovf_cols``, ``ovf_vals``), entries in their
    CSR order. ``r_cap``: the width R (default :func:`ell_width` of these
    rows; a shard takes its whole corpus's)."""
    ip = indptr.astype(np.int64) - int(indptr[0])
    counts = np.diff(ip)
    nnz = int(cols.size)
    if r_cap is None:
        r_cap = ell_width(counts) if nnz else 1
    n_pad = max(ELL_ROW_PAD, -(-max(n, 1) // ELL_ROW_PAD) * ELL_ROW_PAD)
    cols_ell = np.zeros((n_pad, r_cap), np.int32)
    vals_ell = np.zeros((n_pad, r_cap), np.float32)
    ovf_counts = np.zeros(n_pad, np.int64)
    ovf = np.zeros(nnz, bool)
    if nnz:
        ranks = np.arange(nnz, dtype=np.int64) - np.repeat(ip[:-1], counts)
        rows = np.repeat(np.arange(n, dtype=np.int64), counts)
        in_ell = ranks < r_cap
        cols_ell[rows[in_ell], ranks[in_ell]] = cols[in_ell]
        vals_ell[rows[in_ell], ranks[in_ell]] = vals[in_ell]
        ovf = ~in_ell
        ovf_counts[:n] = np.maximum(counts - r_cap, 0)
    ovf_ptr = np.zeros(n_pad + 1, np.int64)
    np.cumsum(ovf_counts, out=ovf_ptr[1:])
    return {"cols_ell": cols_ell, "vals_ell": vals_ell, "ovf_ptr": ovf_ptr,
            "ovf_cols": np.ascontiguousarray(cols[ovf], np.int32),
            "ovf_vals": np.ascontiguousarray(vals[ovf], np.float32)}


def coo_topk(queries: torch.Tensor, cols: torch.Tensor, rows: torch.Tensor,
             vals: torch.Tensor, norms: torch.Tensor,
             valid: torch.Tensor | None, k: int, metric, num_rows: int,
             nnz_chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The CSR segment-sum scan in plain PyTorch, the twin of the JAX
    ``_sparse_topk``: per chunk of entries, ``queries[:, col] · val``
    summed into its row with ``index_add_``; the epilogue and the masks;
    a stable sort, ties to the lowest row. Returns ``(scores [Q, k],
    rows [Q, k] int32)``, unfilled slots (−inf, −1)."""
    metric = DistanceMetric(metric)
    nq = queries.shape[0]
    dots = torch.zeros((nq, num_rows), dtype=torch.float32, device=queries.device)
    for start in range(0, cols.shape[0], nnz_chunk):
        c = cols[start:start + nnz_chunk].long()
        contrib = queries[:, c] * vals[start:start + nnz_chunk][None, :]
        dots.index_add_(1, rows[start:start + nnz_chunk].long(), contrib)
    s = row_scores(dots.T, norms, metric).T
    if valid is not None:
        s = torch.where(valid[None, :] != 0, s, torch.tensor(
            float("-inf"), device=s.device))
    order = torch.sort(-s, dim=1, stable=True).indices[:, :k]
    top = torch.gather(s, 1, order)
    return top, torch.where(torch.isneginf(top), -1, order).to(torch.int32)


class SparseSearchEngine:
    """Exact top-k over one SPARSE space, corpus resident on ``device``
    (``"cuda"`` by default; asking for CUDA without CUDA raises). ELL +
    overflow through the fused kernel by default, or the CSR segment-sum
    scan with ``formulation="coo"``.

    ``grid``: the ELL kernel's launch grid (:class:`~.ops.grid.Grid`: its
    waves, and its tile of 32, 64, 128 or 256 queries a block); None adopts
    the grid :meth:`autotune` persisted in the file, if any, else one wave
    and the tile that holds the batch. The JAX package's ``block_rows`` hint
    is the tile of its XLA gather and belongs to neither formulation here:
    the CSR scan's chunking is ``nnz_chunk``, a memory bound, so it is not
    read."""

    def __init__(self, space, nnz_chunk: int = 1 << 20, device="cuda",
                 formulation: str = "auto", grid=None):
        if space.info.vector_type != VectorType.SPARSE:
            raise InvalidVectorTypeError(
                f"space {space.name!r} is dense; use SearchEngine"
            )
        if formulation not in ("auto", "ell", "coo"):
            raise ValueError(
                f"formulation must be 'auto', 'ell' or 'coo', got "
                f"{formulation!r}"
            )
        indptr, cols, vals = space.sparse_csr()
        n = space.num_vectors
        ip = indptr.astype(np.int64)
        cols = cols.astype(np.int32)
        vals = vals.astype(np.float32)
        if formulation == "auto":
            formulation = choose_formulation(np.diff(ip), int(cols.size))
        state = {"formulation": formulation, "metric": space.metric,
                 "dim": space.dim, "num_vectors": n, "host_ids": space.ids(),
                 "nnz_chunk": nnz_chunk}
        rows_cap = n
        if formulation == "ell":
            state.update(ell_layout(ip, cols, vals, n))
            rows_cap = state["cols_ell"].shape[0]
        else:
            state.update(cols=cols, vals=vals,
                         rows=np.repeat(np.arange(n, dtype=np.int32), np.diff(ip)))
        norms = np.zeros(rows_cap, np.float32)
        norms[:n] = np.asarray(space.norms()[:n], np.float32)
        state["norms"] = norms
        host_mask = space.tombstone_mask()
        if host_mask is not None:
            valid = np.zeros(rows_cap, np.float32)
            valid[:n] = ~host_mask[:n]
            state["valid"] = valid
        self._load(state, resolve_device(device))
        self.name = space.name
        self._host_space = space  # the file-backed origin, for persist
        if grid is None:
            grid = tuned_grid(space, "sparse")
        self.grid = check_grid(grid, QUERY_TILES, "SparseSearchEngine")

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "SparseSearchEngine":
        """Build from the host arrays of a reference ``SparseSearchEngine``:
        ``formulation``; for ELL ``cols_ell``, ``vals_ell`` and the overflow
        as COO entries ``ovf_cols``, ``ovf_rows``, ``ovf_vals`` (padding
        rows ≥ the row count dropped); for COO ``cols``, ``rows``, ``vals``
        (padding rows ≥ ``num_vectors`` dropped); ``norms``, the optional
        ``valid`` (1 = live) and ``host_ids``; ``metric``, ``dim``,
        ``num_vectors`` and the optional ``nnz_chunk``."""
        s = {key: state.get(key) for key in (
            "formulation", "metric", "dim", "num_vectors", "host_ids",
            "norms", "valid")}
        s["nnz_chunk"] = int(state.get("nnz_chunk") or 1 << 20)
        if s["formulation"] == "ell":
            cols_ell = np.ascontiguousarray(state["cols_ell"], np.int32)
            n_pad = cols_ell.shape[0]
            rows = np.asarray(state["ovf_rows"], np.int64)
            keep = rows < n_pad
            order = np.argsort(rows[keep], kind="stable")
            ovf_ptr = np.zeros(n_pad + 1, np.int64)
            np.cumsum(np.bincount(rows[keep], minlength=n_pad), out=ovf_ptr[1:])
            s.update(cols_ell=cols_ell,
                     vals_ell=np.asarray(state["vals_ell"], np.float32),
                     ovf_ptr=ovf_ptr,
                     ovf_cols=np.asarray(state["ovf_cols"], np.int32)[keep][order],
                     ovf_vals=np.asarray(state["ovf_vals"], np.float32)[keep][order])
        else:
            rows = np.asarray(state["rows"], np.int64)
            keep = rows < int(state["num_vectors"])
            s.update(cols=np.asarray(state["cols"], np.int32)[keep],
                     rows=rows[keep].astype(np.int32),
                     vals=np.asarray(state["vals"], np.float32)[keep])
        eng = cls.__new__(cls)
        eng._load(s, resolve_device(device))
        eng.name = str(state.get("name", ""))
        eng._host_space = eng.grid = None
        return eng

    def _load(self, state: dict, dev: torch.device) -> None:
        """Upload the host arrays of ``state`` to ``dev``."""

        def put(key, dtype):
            return torch.from_numpy(np.array(state[key], dtype)).to(dev)

        self.formulation = state["formulation"]
        self.metric = DistanceMetric(int(state["metric"]))
        self.dim = int(state["dim"])
        self.num_vectors = n = int(state["num_vectors"])
        self.nnz_chunk = int(state["nnz_chunk"])
        self.host_ids = state.get("host_ids")
        if self.formulation == "ell":
            self._cols_ell = put_chunked(np.ascontiguousarray(state["cols_ell"], np.int32), dev)
            self._vals_ell = put_chunked(np.ascontiguousarray(state["vals_ell"], np.float32), dev)
            self.r_cap = int(self._cols_ell.shape[1])
            self._has_ovf = int(np.asarray(state["ovf_ptr"])[-1]) > 0
            self._ovf_ptr = put("ovf_ptr", np.int64)
            self._ovf_cols = put("ovf_cols", np.int32)
            self._ovf_vals = put("ovf_vals", np.float32)
        else:
            self._cols = put("cols", np.int32)
            self._rows = put("rows", np.int32)
            self._vals = put("vals", np.float32)
        self._norms = put("norms", np.float32)
        valid = state.get("valid")
        self._valid = None if valid is None else put("valid", np.float32)
        # Searchable rows (tombstones excluded): bounds search_radius's
        # "more matches may exist" flag.
        self.num_valid = (n if valid is None
                          else int(np.count_nonzero(np.asarray(valid)[:n])))

    @property
    def device(self) -> torch.device:
        return self._norms.device

    @property
    def nbytes(self) -> int:
        """Summed device footprint of the resident corpus arrays."""
        arrs = ((self._cols_ell, self._vals_ell, self._ovf_ptr,
                 self._ovf_cols, self._ovf_vals)
                if self.formulation == "ell"
                else (self._cols, self._rows, self._vals))
        total = sum(a.nbytes for a in arrs) + self._norms.nbytes
        if self._valid is not None:
            total += self._valid.nbytes
        return total

    def search_radius(self, queries, radius: float, max_results: int = 128,
                      filter_mask=None):
        """Exact range query over the sparse corpus (same semantics as
        :meth:`SearchEngine.search_radius`)."""
        k = min(max_results, max(self.num_vectors, 1))
        res = self.search(queries, k=k, filter_mask=filter_mask)
        return radius_from_topk(res, radius, k, self.num_valid)

    def search(self, queries, k: int = 10, filter_mask=None, grid=None) -> SearchResult:
        """Batched exact top-k over the sparse corpus. ``queries`` are dense
        ``[Q, dim]`` float vectors (or a single vector). ``filter_mask``:
        optional ``[num_vectors]`` boolean/int row predicate, composed with
        tombstones; short results pad with ``-1``. ``grid``: the ELL
        kernel's launch grid for this search (default :attr:`grid`)."""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != self.dim:
            raise DimensionMismatchError(expected=self.dim, actual=q.shape[1])
        qnorms = None  # inner product needs no query norms
        qk = q
        if self.metric != DistanceMetric.INNER_PRODUCT:
            qnorms = np.einsum("ij,ij->i", q, q, dtype=np.float64).astype(np.float32)
        if self.metric == DistanceMetric.COSINE:
            qk = q / np.maximum(np.sqrt(qnorms)[:, None], 1e-30)
        nq = q.shape[0]
        if self.num_vectors == 0:
            return SearchResult(
                indices=np.full((nq, k), -1, np.int32),
                scores=np.full((nq, k), -np.inf, np.float32),
                distances=np.full(
                    (nq, k),
                    np.inf if self.metric == DistanceMetric.L2 else -np.inf,
                    np.float32,
                ),
                metric=self.metric,
            )
        k_eff = min(k, self.num_vectors)
        eff_valid = self._valid
        if filter_mask is not None:
            full = padded_filter_plane(filter_mask, self.num_vectors,
                                       self._norms.shape[0])
            fdev = torch.from_numpy(full).to(self.device)
            eff_valid = fdev if eff_valid is None else eff_valid * fdev
        if not (qk.flags.c_contiguous or qk.flags.f_contiguous):
            qk = np.ascontiguousarray(qk)
        # Uploaded in the caller's layout and transposed on the device: a
        # strided copy of [Q, dim] on the host cost more than the kernel
        # at batch 256 (PERF.md).
        qdev = torch.from_numpy(qk).to(self.device)
        if self.formulation == "ell":
            s, i = ell_topk(
                qdev.T.contiguous(), self._cols_ell, self._vals_ell,
                self._ovf_ptr if self._has_ovf else None,
                self._ovf_cols if self._has_ovf else None,
                self._ovf_vals if self._has_ovf else None,
                self._norms, self.num_vectors, k_eff, self.metric, eff_valid,
                self.grid if grid is None else grid,
            )
        else:
            s, i = coo_topk(qdev, self._cols, self._rows,
                            self._vals, self._norms, eff_valid, k_eff,
                            self.metric, self.num_vectors, self.nnz_chunk)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        dist = distances_np(s, self.metric, qnorms)
        if k_eff < k:
            pad = ((0, 0), (0, k - k_eff))
            i = np.pad(i, pad, constant_values=-1)
            s = np.pad(s, pad, constant_values=-np.inf)
            dist = np.pad(dist, pad, constant_values=np.inf
                          if self.metric == DistanceMetric.L2 else -np.inf)
        return SearchResult(indices=i, scores=s, distances=dist,
                            metric=self.metric,
                            ids=ids_for_rows(self.host_ids, i))

    def autotune(self, queries=None, k: int = 10, batch: int = 128,
                 waves_candidates=None, tile_candidates=None, iters: int = 3,
                 apply: bool = True, persist: bool = False) -> list[dict]:
        """Time the ELL kernel's launch grid with single-launch timings of
        :meth:`search` and, with ``apply``, set the fastest as
        :attr:`grid`. ELL formulation only (the CSR scan is plain PyTorch
        and has no grid). Candidates: ``waves_candidates`` (default
        :data:`~.ops.grid.WAVES`) times ``tile_candidates`` (default: None,
        the tile that holds the batch, and each of
        :data:`~.ops.sparse_kernel.QUERY_TILES`; a tile above the batch is
        reported ``skipped``). The report and ``persist`` (into
        ``hints["tuned"][space]["sparse"]["cuda"]``) follow
        :meth:`~.engine.SearchEngine.autotune`; on the CPU it raises
        ``ValueError``."""
        if self.formulation != "ell":
            raise ValueError("autotune applies to the ELL formulation only")
        def run_with(q, grid):
            return lambda: self.search(q, k=k, grid=grid)

        return tune_grid(self, "sparse", run_with, queries=queries, batch=batch,
                         dim=self.dim, waves=waves_candidates,
                         tiles=(None,) + QUERY_TILES if tile_candidates is None
                         else tile_candidates,
                         iters=iters, apply=apply, persist=persist)
