"""Shared predicate-plane plumbing for every filtered search surface.

Every surface that accepts ``filter_mask=`` (the dense engine, PQ /
IVF / IVF-PQ / HNSW indexes, the sharded space, both streaming
searchers) performs the same two host-side steps before its
surface-specific upload/compose:

1. validate a raw ``[num_valid]`` boolean/int predicate and pad it to
   the surface's physical capacity (:func:`padded_filter_plane`);
2. or, for an already-:class:`~metrovector_tpu_torch.engine.PreparedFilter`,
   check it still matches the surface's row count / padded capacity
   (:func:`checked_prepared_mask`).

Round 5 grew seven near-identical copies of this logic with drifting
details (dtype, which lengths were checked, how a stale capacity was
reported); this module is the single implementation. What stays
per-surface is only what genuinely differs: the plane dtype the kernel
consumes, the device placement (``device_put`` vs ``shard_rows`` vs
host-resident for streaming), and the tombstone composition.

Reference capability anchor: metadata columns exist to drive selection
(reference ``schema/core.fbs:16-25``); the reference itself never
filters.
"""

from __future__ import annotations

import numpy as np

from ..errors import DimensionMismatchError


def padded_filter_plane(
    filter_mask, num_valid: int, capacity: int, dtype=np.float32
) -> np.ndarray:
    """Validate a raw ``[num_valid]`` boolean/int row predicate and
    return the ``[capacity]`` host plane the kernels consume: passing
    rows 1, failing rows 0, padding rows 0 (padding can never win a
    selection). Raises :class:`DimensionMismatchError` on any other
    shape — at the API boundary, so a malformed mask never reaches a
    launch."""
    fm = np.asarray(filter_mask)
    if fm.shape != (int(num_valid),):
        raise DimensionMismatchError(
            expected=int(num_valid),
            actual=fm.shape[0] if fm.ndim == 1 else tuple(fm.shape),
        )
    full = np.zeros(int(capacity), dtype)
    full[: int(num_valid)] = fm.astype(bool)
    return full


def checked_prepared_mask(prepared, num_valid: int, capacity: int | None = None):
    """Return ``prepared.mask`` after checking the PreparedFilter still
    matches this surface: same logical row count, and (when the surface
    pads) the same physical capacity — a filter prepared before
    ``add_rows`` grew the padded storage is stale even at an unchanged
    row count, and is reported by its (stale) mask length rather than a
    confusing ``expected == actual`` row count."""
    if prepared.num_valid != int(num_valid):
        raise DimensionMismatchError(
            expected=int(num_valid), actual=prepared.num_valid
        )
    if capacity is not None and int(prepared.mask.shape[0]) != int(capacity):
        raise DimensionMismatchError(
            expected=int(capacity), actual=int(prepared.mask.shape[0])
        )
    return prepared.mask
