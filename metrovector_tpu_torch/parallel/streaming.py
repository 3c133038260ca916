"""Exact search over a space that stays in host memory, streamed to the
card in chunks of rows: the counterpart of
:class:`metrovector_tpu.parallel.streaming.StreamingSearcher`.

The corpus is the file's mapped block (nothing is decoded or held twice).
Each chunk is filled into one of two pinned staging buffers on the host,
copied to one of two device buffers on a side stream, and scanned by K1
(:func:`~..ops.topk_kernel.fused_topk`) on the compute stream, so that the
copy of chunk j+1 runs while K1 scans chunk j::

    host:    fill j+1 ─────────────┐ fill j+2 ...
    side:    copy j ───┐ copy j+1 ─┴──────┐
    compute: ... scan j-1 ┴ scan j ───────┴ scan j+1

Two CUDA events per buffer keep it safe: the host refills a staging
buffer only after the copy out of it has finished (``copied``), and a
copy overwrites a device buffer only after the scan of the chunk before
last has read it (``scanned``). Each chunk's top-k is merged into the
carried best list by a stable descending sort of ``[best, chunk]``:
earlier chunks hold lower rows, so ties keep the lowest row, K1's own
order, and the answer is the resident :class:`~..engine.SearchEngine`'s
whatever the chunk size.

What ships is what the resident engine holds on the card: f32, f16 and bf16
rows as stored (K1 reads f16 and bf16 itself; the TPU package upcast f16
on the host), int8 codes as stored (K1's integer variant), uint8 codes
recentred to ``c − 128`` with per-row code sums for L2 and inner product
(the integer variant with ``bias_row``) and without them for cosine (K1's
affine load, a quarter of the bytes of the host dequantization the TPU
package ships). A chunk shipped as stored fills its pinned buffer by one
``copy_`` on PyTorch's threads; uint8 chunks are recentred by the native
codec's threads (``native.prep_u8_offset``), or its numpy twin when the
codec is not built.

On a CPU device the same loop runs the plain version, with no streams.
"""

from __future__ import annotations

import threading
import time
import warnings

import numpy as np
import torch

from .. import native
from ..engine import (
    DeviceSpace,
    SearchResult,
    _check_supported,
    ids_for_rows,
    resolve_device,
)
from ..errors import InvalidVectorTypeError
from ..format.constants import DataType, DistanceMetric, VectorType, sublane_multiple
from ..ops.distances import deferred_scale, distances_np, f32_scalar
from ..ops.topk_kernel import fused_topk
from ..utils.filters import padded_filter_plane

DEFAULT_CHUNK_ROWS = 131_072
# The device dtype each route ships (bf16 goes as its uint16 bits, viewed
# as bfloat16 on the card).
_SHIP = {DataType.FLOAT32: torch.float32, DataType.FLOAT16: torch.float16,
         DataType.BFLOAT16: torch.int16, DataType.INT8: torch.int8,
         DataType.UINT8: torch.int8}


def merge_topk(best_s: torch.Tensor, best_i: torch.Tensor, s: torch.Tensor,
               i: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best of the carried list ``(best_s, best_i)`` and a chunk's
    ``(s, i)`` (global rows), by a stable descending sort of the
    concatenation: equal scores keep the carried entry first, and within
    each list K1's order (row ascending)."""
    cand_s = torch.cat([best_s, s], dim=1)
    cand_i = torch.cat([best_i, i], dim=1)
    top, pos = torch.sort(cand_s, dim=1, descending=True, stable=True)
    return top[:, :k].contiguous(), cand_i.gather(1, pos[:, :k])


def _timing_event(stream):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def _card_times(spans: dict) -> dict:
    """The card's side of one search from its ``spans`` (``"copy"`` and
    ``"scan"``: each a list of recorded (start, end) event pairs, ordered
    on their stream): the summed ms of each, the share of the copies' time
    during which a scan ran (``hidden``) and the time either ran
    (``card_ms``)."""
    ref = spans["copy"][0][0]
    at = {kind: [(ref.elapsed_time(a), ref.elapsed_time(b)) for a, b in pairs]
          for kind, pairs in spans.items()}
    copy_ms = sum(b - a for a, b in at["copy"])
    under = sum(max(0.0, min(c1, s1) - max(c0, s0))
                for c0, c1 in at["copy"] for s0, s1 in at["scan"])
    busy, end = 0.0, float("-inf")
    for a, b in sorted(at["copy"] + at["scan"]):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return {"copy_ms": copy_ms, "scan_ms": sum(b - a for a, b in at["scan"]),
            "hidden": under / copy_ms if copy_ms > 0 else 0.0, "card_ms": busy}


class _Slot:
    """One staging buffer on the host (pinned on CUDA), its device
    buffer, and the events of the copy and the scan that use them."""

    def __init__(self, rows: int, width: int, dtype, dev, mask: bool, bias: bool):
        cuda = dev.type == "cuda"

        def pair(shape, dt):
            host = torch.empty(shape, dtype=dt, pin_memory=cuda)
            return host, (torch.empty(shape, dtype=dt, device=dev) if cuda else host)

        self.blk, self.blk_dev = pair((rows, width), dtype)
        self.nrm, self.nrm_dev = pair((rows,), torch.float32)
        self.msk, self.msk_dev = pair((rows,), torch.float32) if mask else (None, None)
        self.bias, self.bias_dev = pair((rows,), torch.float32) if bias else (None, None)
        self.copied = torch.cuda.Event() if cuda else None
        self.scanned = torch.cuda.Event() if cuda else None
        self.rows = 0  # rows of the chunk the buffers hold
        self.masked = False  # whether that chunk carries a mask


class StreamingSearcher:
    """Exact top-k over a host-resident (mapped) dense space, streamed to
    ``device`` chunk by chunk (module docstring).

    ``chunk_rows``: rows a chunk; default the file's ``stream_chunk_rows``
    hint, else 131,072. It is clamped to the corpus and rounded down to the
    dtype's row multiple (at least one multiple). The card holds two
    chunks (``2 · chunk_rows · padded_dim · itemsize`` plus their norms,
    mask and sums) and so does pinned host memory; both are allocated at
    the first search and kept. ``device``: ``"cuda"`` by default, which
    raises without a card; ``"cpu"`` runs the plain version.

    :attr:`last_trace` holds, per search, the chunks, the bytes shipped,
    the host's time filling staging buffers (``fill_ms``), waiting for a
    copy out of one (``wait_ms``) and in the loop besides those waits
    (``host_ms``: the fills and every launch), and the sum of the chunks'
    scan times (``scan_ms``). On the card, from two CUDA events a copy and
    two a scan, also the copies' sum (``copy_ms``), the share of it during
    which a scan ran (``hidden``) and the time the card was copying or
    scanning (``card_ms``); on the CPU ``scan_ms`` is by the host clock.
    Results equal a resident :class:`~..engine.SearchEngine`'s of the same
    space (``precision="highest"``), bit for bit."""

    def __init__(self, space, chunk_rows: int | None = None, device="cuda"):
        if space.info.vector_type == VectorType.SPARSE:
            raise InvalidVectorTypeError(
                f"space {space.name!r} is sparse; StreamingSearcher streams dense rows")
        _check_supported(space.dtype, "highest")
        self.device = resolve_device(device)
        if chunk_rows is None:
            chunk_rows = int(space.reader.manifest.hints.get(
                "stream_chunk_rows", DEFAULT_CHUNK_ROWS))
        self.space = space
        self.metric = DistanceMetric(space.metric)
        self.dtype = DataType(space.dtype)
        self.dim = space.dim
        q = space.quantization
        self.scale = q.scale if q else 1.0
        self.zero_point = q.zero_point if q else 0.0
        sub = sublane_multiple(self.dtype)
        chunk_rows = min(int(chunk_rows), space.padded_rows)
        self.chunk_rows = max(sub, chunk_rows // sub * sub)
        self._block = space.padded_array()
        self._norms = np.asarray(space.norms(), dtype=np.float32)
        host_mask = space.tombstone_mask()
        self._mask = None
        if host_mask is not None:
            self._mask = np.ones(space.padded_rows, dtype=np.float32)
            self._mask[: space.num_vectors] = (~host_mask).astype(np.float32)
        self._host_ids = space.ids()
        u8 = self.dtype == DataType.UINT8
        self._affine = u8 and self.metric == DistanceMetric.COSINE
        self._offset = u8 and not self._affine
        self.last_trace: dict = {}
        self._slots: list[_Slot] | None = None
        self._side = None
        self._lock = threading.Lock()  # one search at a time owns the buffers

    # -- chunk prep -----------------------------------------------------------

    def _slots_for(self, masked: bool) -> list[_Slot]:
        if self._slots is None or (self._slots[0].msk is None and masked):
            dtype = _SHIP[self.dtype]
            self._slots = [_Slot(self.chunk_rows, self._block.shape[1], dtype, self.device,
                                 masked, self._offset) for _ in range(2)]
        return self._slots

    def _fill(self, slot: _Slot, lo: int, hi: int, mask_host) -> int:
        """Write rows ``[lo, hi)`` as they ship into ``slot``'s staging
        buffers; returns the bytes to copy."""
        n = hi - lo
        src = self._block[lo:hi]
        blk = slot.blk.numpy()[:n]
        if self.dtype == DataType.UINT8:
            bias = slot.bias.numpy()[:n] if self._offset else np.empty(n, np.float32)
            if native.prep_u8_offset(src, n, self.dim, n, out=(blk, bias)) is None:
                shifted = src.astype(np.int16) - 128  # c − 128, pad columns 0
                shifted[:, self.dim:] = 0
                bias[:] = shifted[:, : self.dim].sum(axis=1, dtype=np.int32)
                blk[:] = shifted
        else:
            with warnings.catch_warnings():  # the mapped file is read-only; read only
                warnings.filterwarnings("ignore", "The given NumPy array is not writable")
                slot.blk[:n].copy_(torch.from_numpy(src.view(blk.dtype)))
        slot.nrm.numpy()[:n] = self._norms[lo:hi]
        slot.rows, slot.masked = n, mask_host is not None
        if slot.masked:
            slot.msk.numpy()[:n] = mask_host[lo:hi]
        return blk.nbytes + 4 * n * (1 + slot.masked + self._offset)

    def _ship(self, slot: _Slot, side, spans: list) -> None:
        """Copy ``slot``'s staging buffers to its device buffers on the
        side stream, after the scan that last read them, and append the
        copy's start and end events (after that wait) to ``spans``."""
        n = slot.rows
        with torch.cuda.stream(side):
            side.wait_event(slot.scanned)
            c0 = _timing_event(side)
            for host, dev in ((slot.blk, slot.blk_dev), (slot.nrm, slot.nrm_dev),
                              (slot.msk if slot.masked else None, slot.msk_dev),
                              (slot.bias, slot.bias_dev)):
                if host is not None:
                    dev[:n].copy_(host[:n], non_blocking=True)
            slot.copied.record(side)
            spans.append((c0, _timing_event(side)))

    # -- search ---------------------------------------------------------------

    def _effective_mask(self, filter_mask):
        """The tombstone plane times a ``[num_vectors]`` host predicate,
        padded; sliced per chunk with the rows."""
        if filter_mask is None:
            return self._mask
        sp = self.space
        full = padded_filter_plane(filter_mask, sp.num_vectors, sp.padded_rows)
        return full if self._mask is None else self._mask * full

    def _scan(self, prep, slot: _Slot, kc: int, defer: bool):
        """K1 over the rows in ``slot``'s device buffers, as the resident
        engine's ``_launch`` calls it for this dtype."""
        n = slot.rows
        blk, nrm = slot.blk_dev[:n], slot.nrm_dev[:n]
        msk = slot.msk_dev[:n] if slot.masked else None
        if self.dtype == DataType.BFLOAT16:
            blk = blk.view(torch.bfloat16)
        if self._affine:
            return fused_topk(prep.qdev, blk, nrm, n, kc, self.metric, valid_mask=msk,
                              affine=(128.0 - self.zero_point, self.scale))
        if self.dtype in (DataType.INT8, DataType.UINT8):
            d = self.dim
            return fused_topk(prep.qdev[:, :d], blk[:, :d], nrm, n, kc, self.metric,
                              valid_mask=msk, scale=prep.dot_scale,
                              bias_row=None if slot.bias_dev is None else slot.bias_dev[:n],
                              bias_scale=prep.bias_scale, raw_scores=defer)
        return fused_topk(prep.qdev, blk, nrm, n, kc, self.metric, valid_mask=msk)

    def search(self, queries, k: int = 10, filter_mask=None) -> SearchResult:
        """Stream every chunk through K1 and return the exact top-k as a
        :class:`~..engine.SearchResult`. ``filter_mask``: optional
        ``[num_vectors]`` boolean/int host predicate, composed with the
        tombstones and shipped chunk by chunk with the rows; where fewer
        than ``k`` rows qualify (or ``k`` passes the corpus) the tail holds
        ``-1``/``−inf``."""
        with self._lock:
            return self._search(queries, k, filter_mask)

    def _search(self, queries, k, filter_mask) -> SearchResult:
        sp, dev = self.space, self.device
        helper = DeviceSpace(
            data=torch.empty((0, self._block.shape[1]), dtype=_SHIP[self.dtype],
                             device=dev),
            norms=torch.empty(0, dtype=torch.float32, device=dev),
            num_valid=sp.num_vectors, dim=sp.dim, metric=self.metric,
            dtype=self.dtype, scale=self.scale, zero_point=self.zero_point)
        prep = helper.prepare_queries(queries)
        nq = prep.qdev.shape[0]
        nv = sp.num_vectors
        self.last_trace = {"chunks": 0, "bytes": 0}
        if nv == 0:
            fill = np.inf if self.metric == DistanceMetric.L2 else -np.inf
            return SearchResult(
                indices=np.full((nq, k), -1, np.int32),
                scores=np.full((nq, k), -np.inf, np.float32),
                distances=np.full((nq, k), fill, np.float32), metric=self.metric,
                ids=np.full((nq, k), SearchResult.ID_SENTINEL, np.uint64))
        k_eff = min(k, nv)
        mask_host = self._effective_mask(filter_mask)
        slots = self._slots_for(mask_host is not None)
        defer = (self.dtype == DataType.INT8
                 and deferred_scale(slots[0].blk_dev, self.metric, None, prep.dot_scale))
        cuda = dev.type == "cuda"
        if cuda and self._side is None:
            self._side = torch.cuda.Stream(dev)
        compute = torch.cuda.current_stream(dev) if cuda else None
        cr = self.chunk_rows
        bounds = [(lo, min(lo + cr, nv)) for lo in range(0, nv, cr)]
        trace = {"chunks": len(bounds), "bytes": 0, "fill_ms": 0.0, "wait_ms": 0.0,
                 "scan_ms": 0.0}
        spans = {"copy": [], "scan": []}

        def stage(j):  # fill chunk j's staging buffers, then start its copy
            slot = slots[j % 2]
            t0 = time.perf_counter()
            if cuda:
                slot.copied.synchronize()  # the copy out of them has finished
                trace["wait_ms"] += (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            trace["bytes"] += self._fill(slot, *bounds[j], mask_host)
            trace["fill_ms"] += (time.perf_counter() - t0) * 1e3
            if cuda:
                self._ship(slot, self._side, spans["copy"])

        best_s = torch.full((nq, k_eff), float("-inf"), dtype=torch.float32, device=dev)
        best_i = torch.full((nq, k_eff), -1, dtype=torch.int32, device=dev)
        t_loop = time.perf_counter()
        stage(0)
        for j, (lo, hi) in enumerate(bounds):
            slot = slots[j % 2]
            if cuda:
                compute.wait_event(slot.copied)
                e0 = _timing_event(compute)
            t0 = time.perf_counter()
            s, i = self._scan(prep, slot, min(k_eff, hi - lo), defer)
            if cuda:
                slot.scanned.record(compute)
                spans["scan"].append((e0, _timing_event(compute)))
            else:
                trace["scan_ms"] += (time.perf_counter() - t0) * 1e3
            i = torch.where(i >= 0, i + lo, i)
            best_s, best_i = merge_topk(best_s, best_i, s, i, k_eff)
            if j + 1 < len(bounds):
                stage(j + 1)  # the host fills while the card scans chunk j
        trace["host_ms"] = (time.perf_counter() - t_loop) * 1e3 - trace["wait_ms"]
        s = best_s.cpu().numpy()
        i = best_i.cpu().numpy()
        if cuda:
            self._side.synchronize()  # the last copy's end event
            trace.update(_card_times(spans))
        self.last_trace = trace
        if defer:  # the raw dots' order was kept; scale as K1's epilogue does
            s = (torch.from_numpy(s) * f32_scalar(prep.dot_scale, "cpu")).numpy()
        if prep.const is not None:
            mult = 2.0 if self.metric == DistanceMetric.L2 else 1.0
            s = s + mult * prep.const[:, None]
        dist = distances_np(s, self.metric, prep.sq_norms)
        if k_eff < k:
            pad = ((0, 0), (0, k - k_eff))
            i = np.pad(i, pad, constant_values=-1)
            s = np.pad(s, pad, constant_values=-np.inf)
            dist = np.pad(dist, pad, constant_values=np.inf
                          if self.metric == DistanceMetric.L2 else -np.inf)
        return SearchResult(indices=i, scores=s, distances=dist, metric=self.metric,
                            ids=ids_for_rows(self._host_ids, i))
