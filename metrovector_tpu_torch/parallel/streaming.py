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

:class:`ShardedStreamingSearcher` streams a row-sharded corpus: shard ``s``
streams only its rows ``[s·per, (s+1)·per)`` through its device, each
distinct device with its own two staging buffers and side stream (a
*lane*); the lanes take turns chunk by chunk, so several cards scan at
once while the host fills. Each shard carries its own list across its
chunks, and the lists meet once at the end (:func:`.mesh.exchange_topk`).
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
    empty_result,
    host_result,
    resolve_device,
)
from ..errors import InvalidVectorTypeError
from ..format.constants import DataType, DistanceMetric, VectorType, sublane_multiple
from ..ops.distances import deferred_scale, f32_scalar
from ..ops.topk_kernel import fused_topk, kernel_precision
from ..utils.filters import padded_filter_plane
from .mesh import SHARD_AXIS, Mesh, exchange_topk, merge_topk, on_devices, unfilled
from .sharded_search import local_valid

DEFAULT_CHUNK_ROWS = 131_072
# The device dtype each route ships (bf16 goes as its uint16 bits, viewed
# as bfloat16 on the card).
_SHIP = {DataType.FLOAT32: torch.float32, DataType.FLOAT16: torch.float16,
         DataType.BFLOAT16: torch.int16, DataType.INT8: torch.int8,
         DataType.UINT8: torch.int8}


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




class _Lane:
    """One device's two staging slots and its side stream, allocated at
    the first search that uses the device and kept."""

    def __init__(self, device: torch.device):
        self.device = device
        self.slots: list[_Slot] | None = None
        self.side = None


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
        self._sub = sublane_multiple(self.dtype)
        self.chunk_rows = self._round_chunk(min(int(chunk_rows), space.padded_rows))
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
        self._lanes: dict[torch.device, _Lane] = {}
        self._lock = threading.Lock()  # one search at a time owns the buffers

    def _round_chunk(self, rows: int) -> int:
        """``rows`` rounded down to the dtype's row multiple, at least one."""
        return max(self._sub, rows // self._sub * self._sub)

    # -- chunk prep -----------------------------------------------------------

    def _slots_for(self, dev: torch.device, masked: bool) -> _Lane:
        lane = self._lanes.setdefault(dev, _Lane(dev))
        if lane.slots is None or (lane.slots[0].msk is None and masked):
            dtype = _SHIP[self.dtype]
            lane.slots = [_Slot(self.chunk_rows, self._block.shape[1], dtype, dev,
                                masked, self._offset) for _ in range(2)]
        if dev.type == "cuda" and lane.side is None:
            lane.side = torch.cuda.Stream(dev)
        return lane

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

    def _scan(self, qdev, prep, slot: _Slot, kc: int, defer: bool):
        """K1 over the rows in ``slot``'s device buffers for the queries
        ``qdev`` on that device, as the resident engine's ``_launch``
        calls it for this dtype."""
        n = slot.rows
        blk, nrm = slot.blk_dev[:n], slot.nrm_dev[:n]
        msk = slot.msk_dev[:n] if slot.masked else None
        if self.dtype == DataType.BFLOAT16:
            blk = blk.view(torch.bfloat16)
        if self._affine:
            return fused_topk(qdev, blk, nrm, n, kc, self.metric, valid_mask=msk,
                              affine=(128.0 - self.zero_point, self.scale))
        if self.dtype in (DataType.INT8, DataType.UINT8):
            d = self.dim
            return fused_topk(qdev[:, :d], blk[:, :d], nrm, n, kc, self.metric,
                              valid_mask=msk, scale=prep.dot_scale,
                              bias_row=None if slot.bias_dev is None else slot.bias_dev[:n],
                              bias_scale=prep.bias_scale, raw_scores=defer)
        return fused_topk(qdev, blk, nrm, n, kc, self.metric, valid_mask=msk,
                          precision=kernel_precision(self.dtype, "highest"))

    def _prepare(self, queries, dev: torch.device):
        """The batch prepared as the resident engine prepares it, on ``dev``
        (a :class:`~..engine.DeviceSpace` of no rows does it)."""
        helper = DeviceSpace(
            data=torch.empty((0, self._block.shape[1]), dtype=_SHIP[self.dtype],
                             device=dev),
            norms=torch.empty(0, dtype=torch.float32, device=dev),
            num_valid=self.space.num_vectors, dim=self.space.dim, metric=self.metric,
            dtype=self.dtype, scale=self.scale, zero_point=self.zero_point)
        return helper.prepare_queries(queries)

    def _deferred(self, prep) -> bool:
        """Whether K1 ranks raw int8 dots here (they stay raw through the
        merges and the merged k is scaled at the end)."""
        return self.dtype == DataType.INT8 and deferred_scale(
            torch.empty(0, dtype=torch.int8), self.metric, None, prep.dot_scale)

    def _stream(self, prep, work, mask_host, defer: bool) -> dict:
        """Stream ``work``: for each device, its row ranges ``(key, lo, hi,
        width)`` in order. Every chunk of a range is scanned on its device
        and merged into the range's carried list (``width`` wide, global
        rows); the devices' lanes take turns chunk by chunk. Returns the
        lists by key and sets :attr:`last_trace`."""
        nq = prep.qdev.shape[0]
        cr = self.chunk_rows
        q_on = on_devices(prep.qdev, [dev for dev, _ in work])
        trace = {"chunks": 0, "bytes": 0, "fill_ms": 0.0, "wait_ms": 0.0,
                 "scan_ms": 0.0}
        spans: dict = {}
        best, width, lanes = {}, {}, []
        for dev, ranges in work:
            lane = self._slots_for(dev, mask_host is not None)
            chunks = [(key, c, min(c + cr, hi)) for key, lo, hi, _ in ranges
                      for c in range(lo, hi, cr)]
            for key, _, _, w in ranges:
                best[key], width[key] = unfilled(nq, w, dev), w
            lanes.append((lane, chunks))
            spans.setdefault(dev, {"copy": [], "scan": []})
            trace["chunks"] += len(chunks)

        def stage(lane, chunks, j):  # fill chunk j's staging buffers, start its copy
            slot = lane.slots[j % 2]
            t0 = time.perf_counter()
            if lane.side is not None:
                slot.copied.synchronize()  # the copy out of them has finished
                trace["wait_ms"] += (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            trace["bytes"] += self._fill(slot, *chunks[j][1:], mask_host)
            trace["fill_ms"] += (time.perf_counter() - t0) * 1e3
            if lane.side is not None:
                self._ship(slot, lane.side, spans[lane.device]["copy"])

        t_loop = time.perf_counter()
        for lane, chunks in lanes:
            if chunks:
                stage(lane, chunks, 0)
        for j in range(max((len(c) for _, c in lanes), default=0)):
            for lane, chunks in lanes:
                if j >= len(chunks):
                    continue
                key, lo, hi = chunks[j]
                slot, dev = lane.slots[j % 2], lane.device
                if lane.side is not None:
                    compute = torch.cuda.current_stream(dev)
                    compute.wait_event(slot.copied)
                    e0 = _timing_event(compute)
                t0 = time.perf_counter()
                s, i = self._scan(q_on[dev], prep, slot, min(width[key], hi - lo), defer)
                if lane.side is not None:
                    slot.scanned.record(compute)
                    spans[dev]["scan"].append((e0, _timing_event(compute)))
                else:
                    trace["scan_ms"] += (time.perf_counter() - t0) * 1e3
                i = torch.where(i >= 0, i + lo, i)
                best[key] = merge_topk(*best[key], s, i, width[key])
                if j + 1 < len(chunks):
                    stage(lane, chunks, j + 1)  # the host fills while the card scans
        trace["host_ms"] = (time.perf_counter() - t_loop) * 1e3 - trace["wait_ms"]
        cards = {}
        for lane, chunks in lanes:
            if lane.side is not None and chunks:
                torch.cuda.current_stream(lane.device).synchronize()  # the last scan's
                lane.side.synchronize()  # and the last copy's end events
                cards[str(lane.device)] = _card_times(spans[lane.device])
        if len(cards) == 1:
            trace.update(next(iter(cards.values())))
        elif cards:
            trace["cards"] = cards
            trace["scan_ms"] = sum(c["scan_ms"] for c in cards.values())
        self.last_trace = trace
        return best

    def _answer(self, prep, s: torch.Tensor, i: torch.Tensor, k: int, defer: bool):
        s, i = s.cpu().numpy(), i.cpu().numpy()
        if defer:  # the raw dots' order was kept; scale as K1's epilogue does
            s = (torch.from_numpy(s) * f32_scalar(prep.dot_scale, "cpu")).numpy()
        return host_result(s, i, prep, k, self.metric, self._host_ids)

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
        prep = self._prepare(queries, self.device)
        nq, nv = prep.qdev.shape[0], self.space.num_vectors
        self.last_trace = {"chunks": 0, "bytes": 0}
        if nv == 0:
            return empty_result(nq, k, self.metric)
        k_eff = min(k, nv)
        defer = self._deferred(prep)
        best = self._stream(prep, [(self.device, [(0, 0, nv, k_eff)])],
                            self._effective_mask(filter_mask), defer)
        return self._answer(prep, *best[0], k, defer)


class ShardedStreamingSearcher(StreamingSearcher):
    """Exact top-k over a host-resident dense space whose rows shard over
    ``mesh`` (default :func:`.distributed.global_mesh`; under a process
    group each rank streams only its own shards): shard ``s`` streams its
    valid rows of ``[s·per, (s+1)·per)`` (``per`` as
    :func:`.distributed.load_space_sharded` has it) through its device,
    carries its list across its chunks, and the lists merge once at the
    end. ``chunk_rows`` (default as :class:`StreamingSearcher`) is clamped
    to ``per``. Results are the resident
    :class:`~.sharded_search.ShardedDeviceSpace`'s, bit for bit, and so the
    resident :class:`~..engine.SearchEngine`'s; :attr:`last_trace` as
    :class:`StreamingSearcher`'s (the card's times under ``"cards"`` by
    device when the shards span several)."""

    def __init__(self, space, mesh: Mesh | None = None, axis: str | None = None,
                 chunk_rows: int | None = None):
        from .distributed import global_mesh
        from .mesh import rows_per_shard

        axis = axis or SHARD_AXIS
        mesh = global_mesh(axis) if mesh is None else mesh
        if len(mesh.axis_names) != 1:
            raise ValueError(f"a 1-D mesh is needed, got axes {mesh.axis_names}")
        super().__init__(space, chunk_rows=chunk_rows, device=mesh.lead)
        self.mesh, self.axis = mesh, axis
        self.per = rows_per_shard(space.padded_rows, mesh.size(axis), self._sub)
        self.chunk_rows = self._round_chunk(min(self.chunk_rows, self.per))

    def _search(self, queries, k, filter_mask) -> SearchResult:
        prep = self._prepare(queries, self.mesh.lead)
        nq, nv = prep.qdev.shape[0], self.space.num_vectors
        self.last_trace = {"chunks": 0, "bytes": 0}
        if nv == 0:
            return empty_result(nq, k, self.metric)
        k_eff = min(k, nv)
        kl = min(k_eff, self.per)
        defer = self._deferred(prep)
        work: dict[torch.device, list] = {}
        first = self.mesh.first_shard()
        for j, dev in enumerate(self.mesh.devices):
            lo = (first + j) * self.per
            rows = local_valid(nv, first + j, self.per)
            if rows:
                work.setdefault(dev, []).append((j, lo, lo + rows, kl))
        best = self._stream(prep, list(work.items()), self._effective_mask(filter_mask),
                            defer)
        lists = [best.get(j) or unfilled(nq, kl, dev)
                 for j, dev in enumerate(self.mesh.devices)]
        s, i = exchange_topk(lists, k_eff, self.mesh)
        return self._answer(prep, s, i, k, defer)
