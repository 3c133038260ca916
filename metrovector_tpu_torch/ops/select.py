"""Host-side sizing of the top-k selection that ``csrc/select.cuh`` shares
between the kernels: how a scan splits its rows, how long each split's list
is, and how much scratch the merge tree needs.

A scan block keeps, for each of its queries, a sorted list of the best rows
of its split. While the lists fit in shared memory they hold k entries;
beyond that they live in the ``[Q, S, L]`` scratch with
``L = min(k, rows per split)`` (a split cannot fill more), and the number of
splits S is cut until the scratch stays under :data:`SCRATCH_BYTES` or S is
1. The merge tree then folds the S lists pairwise into the top k.

The splits of a query share a group bar (``select.cuh``): each publishes a
rank key to its slot of a zeroed ``[Q, S]`` int64 tensor (:func:`bar_slots`).
"""

from __future__ import annotations

import torch

MAX_SPLITS = 512
SCRATCH_BYTES = 1 << 30  # per call, for the [Q, S, L] lists (f32 + i32)
TREE_SPLITS = 64  # shared-memory lists past this many splits (and k) merge by tree


def row_splits(n: int, row_tile: int, want: int, nq: int, k: int,
               lists_in_smem: bool) -> tuple[int, int, int]:
    """``(splits, rows_per_split, list_len)`` for ``n`` rows walked in tiles
    of ``row_tile``: ``want`` splits if the rows and :data:`MAX_SPLITS`
    allow, fewer while lists in device memory would pass the scratch
    bound."""
    tiles = -(-n // row_tile)
    splits = max(1, min(want, MAX_SPLITS, tiles))
    while True:
        rows_per_split = -(-tiles // splits) * row_tile
        s = -(-n // rows_per_split)
        length = k if lists_in_smem else min(k, rows_per_split)
        if lists_in_smem or s == 1 or nq * s * length * 8 <= SCRATCH_BYTES:
            return s, rows_per_split, length
        splits = -(-splits // 2)


def merge_by_tree(splits: int, k: int, lists_in_smem: bool) -> bool:
    """Whether the split lists fold through the merge tree: always when
    they live in device memory, and for lists of more than 32 in shared
    memory past :data:`TREE_SPLITS` splits, where one block or warp per
    query folding the lists one by one takes longer than the tree's
    ``log2 S`` launches."""
    return not lists_in_smem or (splits > TREE_SPLITS and k > 32)


def bar_slots(nq: int, splits: int, device) -> torch.Tensor:
    """The zeroed ``[nq, splits]`` int64 slots of the group bars."""
    return torch.zeros((nq, splits), dtype=torch.int64, device=device)


def seed_lists(seed_k: int, length: int) -> int:
    """Lists of ``length`` that a seed of ``seed_k`` sorted entries fills
    beside the splits' (``select.cuh::seed_lists_kernel``): one while the
    lists hold k entries, more where they are shorter (device memory)."""
    return -(-seed_k // length) if seed_k else 0


def merge_scratch(lists: int, length: int, k: int) -> tuple[int, int]:
    """Entries per query that ``select.cuh::merge_tree`` needs in its two
    buffers (part, tmp) to fold ``lists`` sorted lists of ``length`` into k:
    level i writes ``ceil(lists / 2^(i+1))`` lists of ``min(2^(i+1) length,
    k)`` into tmp when i is even, into part when it is odd."""
    part, tmp, level = lists * length, 0, 0
    while lists > 1:
        lists, length = -(-lists // 2), min(2 * length, k)
        if level % 2 == 0:
            tmp = max(tmp, lists * length)
        else:
            part = max(part, lists * length)
        level += 1
    return part, tmp


def scratch(nq: int, lists: int, length: int, k: int, device,
            tree: bool) -> tuple[torch.Tensor, ...]:
    """``(part_s, part_i, tmp_s, tmp_i)``: the scan's ``[nq, lists, length]``
    lists and, with ``tree``, the merge tree's room (tmp is empty without
    it)."""
    part, tmp = merge_scratch(lists, length, k) if tree else (lists * length, 0)
    return (torch.empty(nq * part, dtype=torch.float32, device=device),
            torch.empty(nq * part, dtype=torch.int32, device=device),
            torch.empty(nq * tmp, dtype=torch.float32, device=device),
            torch.empty(nq * tmp, dtype=torch.int32, device=device))
