"""Host → device upload of a corpus block in bounded chunks.

The counterpart of :func:`metrovector_tpu.utils.transfer.put_chunked`. The
source is usually a read-only zero-copy view of the mapped file. On a CUDA
device each chunk (≤ 256 MB) is copied into one pinned staging buffer and
from there into a preallocated device tensor, so the host never holds a
second full-size copy and the device holds exactly the result.
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
