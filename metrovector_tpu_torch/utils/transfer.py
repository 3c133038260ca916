"""Copies between the host and the device.

:func:`put_chunked`, the counterpart of
:func:`metrovector_tpu.utils.transfer.put_chunked`, uploads a corpus block in
bounded chunks. The source is usually a read-only zero-copy view of the
mapped file. On a CUDA device each chunk (≤ 256 MB) is copied into one
pinned staging buffer and from there into a preallocated device tensor, so
the host never holds a second full-size copy and the device holds exactly
the result.

:func:`upload` and :class:`Readback` move a search's small per-batch
arrays (the queries up, the answer down) through pinned memory with
non-blocking copies on the current stream, so that neither direction waits
for work the card has queued after it. Their pinned blocks come from
torch's caching host allocator, which hands a block out again only once the
copies that used it are done, so a steady loop of batches allocates no
pinned memory after its first few.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK_BYTES = 256 << 20

_TORCH_DTYPES = {np.dtype("float32"): torch.float32,
                 np.dtype("float16"): torch.float16,
                 np.dtype("int32"): torch.int32,
                 np.dtype("int16"): torch.int16,
                 np.dtype("int8"): torch.int8}


def put_chunked(
    arr: np.ndarray,
    device: torch.device,
    dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Copy the f32, f16, int32, int16 or int8 array ``arr`` to ``device``
    in row chunks of at most ``CHUNK_BYTES``, converting to ``dtype``
    (default: the array's own) on the device. Returns a new contiguous tensor; ``arr`` is only
    read."""
    device = torch.device(device)
    try:
        src_dtype = _TORCH_DTYPES[arr.dtype]
    except KeyError:
        raise TypeError(
            f"put_chunked uploads f32, f16, int32, int16 or int8, not {arr.dtype}"
        ) from None
    out = torch.empty(arr.shape, dtype=dtype or src_dtype, device=device)
    if arr.size == 0:
        return out
    rows = arr.shape[0]
    row_bytes = max(1, arr.nbytes // rows)
    rows_per = max(1, min(rows, CHUNK_BYTES // row_bytes))
    pinned = device.type == "cuda"
    staging = torch.empty((rows_per,) + arr.shape[1:], dtype=src_dtype,
                          pin_memory=pinned)
    staging_np = staging.numpy()
    for s0 in range(0, rows, rows_per):
        m = min(rows_per, rows - s0)
        staging_np[:m] = arr[s0 : s0 + m]
        out[s0 : s0 + m].copy_(staging[:m], non_blocking=pinned)
        if pinned:  # the staging buffer is refilled next round
            torch.cuda.current_stream(device).synchronize()
    return out


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """``arr`` on ``device``. On a CUDA device it is staged into pinned host
    memory and copied from there without blocking, on the current stream:
    the call does not wait for the card's queued work, and ``arr`` is free
    to change as soon as it returns. Elsewhere a plain copy."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return src.to(device)
    return src.pin_memory().to(device, non_blocking=True)


class Readback:
    """CUDA tensors on their way to the host: non-blocking copies into pinned
    host memory, enqueued on the current stream when this is made, and an
    event recorded after them. :meth:`wait` waits for that event alone, so
    for the work enqueued before it, never for work enqueued later."""

    def __init__(self, *tensors: torch.Tensor):
        self.stream = torch.cuda.current_stream(tensors[0].device)
        self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     .copy_(t, non_blocking=True) for t in tensors]
        self.done = torch.cuda.Event()
        self.done.record(self.stream)

    def wait(self) -> tuple[list[np.ndarray], bool]:
        """The tensors as numpy arrays of their own (none shares the pinned
        blocks, which go back to the allocator with this object), and
        whether the stream was drained once they had arrived: False where
        later work was still queued on it."""
        self.done.synchronize()
        drained = self.stream.query()
        return [t.numpy().copy() for t in self.host], drained
