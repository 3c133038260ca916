"""Sharded exact search over SPARSE (CSR) spaces: the counterpart of
:mod:`metrovector_tpu.parallel.sparse_sharded`.

The rows split into ``S`` runs of ``ceil(n / S)`` logical rows; each shard
holds its run in the ELL layout of the resident engine (:func:`~..sparse.
ell_layout`) at the width R of the whole corpus, with its own overflow
tail, on its device. A search runs K4 (:func:`~..ops.sparse_kernel.
ell_topk`, which builds its query postings on the card) once per shard
and merges the lists once (:func:`.mesh.exchange_topk`). A row's sum
takes its ELL slots and then its overflow entries in the same order as in
the resident engine's layout, so the answer is the resident
:class:`~..sparse.SparseSearchEngine`'s, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import SearchResult, empty_result, ids_for_rows
from ..errors import DimensionMismatchError, InvalidVectorTypeError
from ..format.constants import DistanceMetric, VectorType
from ..ops.distances import distances_np
from ..ops.sparse_kernel import ell_topk
from ..sparse import ell_layout, ell_width
from .mesh import SHARD_AXIS, Mesh, exchange_topk, on_devices, pad_list, unfilled
from .sharded_search import _shard_devices, local_valid


def sharded_sparse_topk(queries, cols_ell, vals_ell, ovf_ptr, ovf_cols, ovf_vals, norms,
                        valid_mask, num_rows: int, k: int, metric, mesh: Mesh,
                        rows_per: int, axis: str = SHARD_AXIS):
    """Exact global top-k of dense ``queries [Q, dim]`` f32 (normalized for
    cosine) over a row-sharded ELL corpus. Each array argument is a list
    of this process's shards in shard order (None for a shard with no
    rows; ``ovf_*`` and ``valid_mask`` may be None throughout): shard
    ``s`` holds the rows ``[s·rows_per, (s+1)·rows_per)`` of the global
    ``num_rows``. Returns ``(scores [Q, k], rows [Q, k] int32)`` on the
    lead device, best first, ties to the lowest row."""
    metric = DistanceMetric(metric)
    devices = _shard_devices(mesh, axis)
    q = queries if isinstance(queries, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(queries, np.float32))
    qt_on = on_devices(q.T.contiguous(), devices)
    nq = q.shape[0]
    kl = min(k, rows_per)
    lists = []
    for j, dev in enumerate(devices):
        s = mesh.first_shard() + j
        nv = local_valid(num_rows, s, rows_per)
        if nv == 0:
            lists.append(unfilled(nq, kl, dev))
            continue

        def part(x):
            return None if x is None else x[j]

        sc, ix = ell_topk(qt_on[dev], cols_ell[j], vals_ell[j], part(ovf_ptr),
                          part(ovf_cols), part(ovf_vals), norms[j], nv, min(kl, nv),
                          metric, part(valid_mask))
        lists.append(pad_list(sc, torch.where(ix >= 0, ix + s * rows_per, ix), kl))
    return exchange_topk(lists, k, mesh)


class ShardedSparseSearchEngine:
    """Exact top-k over one SPARSE space row-sharded across a mesh: each
    shard holds its slice of the ELL layout (the corpus's width R) and its
    own overflow tail on its device, read from the file's CSR arrays for
    this process's shards only. Answers equal the resident
    :class:`~..sparse.SparseSearchEngine`'s."""

    def __init__(self, space, mesh: Mesh, axis: str = SHARD_AXIS):
        if space.info.vector_type != VectorType.SPARSE:
            raise InvalidVectorTypeError(
                f"space {space.name!r} is dense; use ShardedDeviceSpace")
        devices = _shard_devices(mesh, axis)
        self.mesh, self.axis = mesh, axis
        indptr, cols, vals = space.sparse_csr()
        ip = indptr.astype(np.int64)
        n = space.num_vectors
        self.r_cap = ell_width(np.diff(ip)) if cols.size else 1
        self.rows_per = -(-max(n, 1) // mesh.size(axis))
        host_norms = space.norms()
        dead = space.tombstone_mask()
        keys = ("cols_ell", "vals_ell", "ovf_ptr", "ovf_cols", "ovf_vals", "norms", "valid")
        shards = {key: [] for key in keys}
        for j, dev in enumerate(devices):
            lo = min((mesh.first_shard() + j) * self.rows_per, n)
            hi = min(lo + self.rows_per, n)
            if hi == lo:  # no rows: the search gives this shard unfilled slots
                for key in keys:
                    shards[key].append(None)
                continue
            lay = ell_layout(ip[lo:hi + 1], cols[ip[lo]:ip[hi]].astype(np.int32),
                             vals[ip[lo]:ip[hi]].astype(np.float32), hi - lo, self.r_cap)
            n_pad = lay["cols_ell"].shape[0]
            nrm = np.zeros(n_pad, np.float32)
            nrm[:hi - lo] = host_norms[lo:hi]
            lay["norms"] = nrm
            if dead is not None:
                valid = np.zeros(n_pad, np.float32)
                valid[:hi - lo] = ~dead[lo:hi]
                lay["valid"] = valid
            for key in keys:
                shards[key].append(None if key not in lay else torch.from_numpy(
                    np.ascontiguousarray(lay[key])).to(dev))
        self._has_ovf = any(p is not None and int(p[-1]) > 0 for p in shards["ovf_ptr"])
        self._shards = shards
        self.metric = DistanceMetric(space.metric)
        self.dim = space.dim
        self.num_vectors = n
        self.name = space.name
        self.host_ids = space.ids()

    def search(self, queries, k: int = 10) -> SearchResult:
        """Batched exact top-k, merged once: global rows and stable IDs,
        identical to the resident sparse engine's."""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != self.dim:
            raise DimensionMismatchError(expected=self.dim, actual=q.shape[1])
        qnorms = None  # inner product needs no query norms (a float64 pass)
        qk = q
        if self.metric != DistanceMetric.INNER_PRODUCT:
            qnorms = np.einsum("ij,ij->i", q, q, dtype=np.float64).astype(np.float32)
        if self.metric == DistanceMetric.COSINE:
            qk = q / np.maximum(np.sqrt(qnorms)[:, None], 1e-30)
        nq = q.shape[0]
        if self.num_vectors == 0:
            return empty_result(nq, k, self.metric)
        k_eff = min(k, self.num_vectors)
        sh = self._shards
        ovf = (sh["ovf_ptr"], sh["ovf_cols"], sh["ovf_vals"]) if self._has_ovf else (
            None, None, None)
        valid = sh["valid"] if any(v is not None for v in sh["valid"]) else None
        s, i = sharded_sparse_topk(
            torch.from_numpy(np.ascontiguousarray(qk)).to(self.mesh.lead),
            sh["cols_ell"], sh["vals_ell"], *ovf, sh["norms"], valid, self.num_vectors,
            k_eff, self.metric, self.mesh, self.rows_per, axis=self.axis)
        s, i = s.cpu().numpy(), i.cpu().numpy()
        dist = distances_np(s, self.metric, qnorms)
        if k_eff < k:
            pad = ((0, 0), (0, k - k_eff))
            i = np.pad(i, pad, constant_values=-1)
            s = np.pad(s, pad, constant_values=-np.inf)
            dist = np.pad(dist, pad, constant_values=np.inf
                          if self.metric == DistanceMetric.L2 else -np.inf)
        return SearchResult(indices=i, scores=s, distances=dist, metric=self.metric,
                            ids=ids_for_rows(self.host_ids, i))
