"""The launch-grid knob of the scan kernels' wrappers.

Every scan kernel splits the corpus's rows over as many blocks as fit on
the card at once (one wave, from the runtime's occupancy calculator),
divided among the batch's query tiles. :class:`Grid` moves that plan: its
``waves`` multiplies the one-wave block count, so a tuned value means the
same at batch 1 and at batch 256, and its ``tile`` picks the query tile
where the library is built with more than one (K2's lookup scan, K4's
``ell_topk``). ``grid=None`` is the plan the wrappers make without it, and
so is ``Grid(1.0, None)``; every grid gives the same answer.

Which of K2's tiles fit shared memory depends on the fetch and the LUT's
type, which a tuned grid does not record. A grid an index holds (adopted
from the file or applied by ``autotune``) therefore reaches the wrapper
with ``cap=True``: its tile is the largest to take, and a smaller one that
fits runs where it does not. A grid passed for one search is taken as it
is, and a tile that does not fit raises.

The JAX package's knobs (``block_rows``, ``query_tile``, ``merge``) sized
Mosaic tiles in VMEM; none of them has a counterpart here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

WAVES = (0.5, 1.0, 2.0, 4.0)  # autotune's default waves candidates


class Grid(NamedTuple):
    """``waves``: the multiple of one wave of scan blocks (a positive,
    finite number); ``tile``: the query tile, or None for the wrapper's
    own pick; ``cap``: ``tile`` is the largest tile to take (module
    docstring). A file's hints hold ``waves`` and ``tile``
    (:meth:`saved`)."""

    waves: float = 1.0
    tile: int | None = None
    cap: bool = False

    def saved(self) -> dict:
        """The grid as a file's hints hold it."""
        return {"waves": self.waves, "tile": self.tile}


def as_grid(value) -> Grid | None:
    """A :class:`Grid` from None, a Grid or a mapping with ``waves`` and
    ``tile`` (as persisted in a file's hints)."""
    if value is None or isinstance(value, Grid):
        return value
    if not isinstance(value, dict):
        raise TypeError(f"grid is a Grid or a mapping, not {type(value).__name__}")
    unknown = set(value) - {"waves", "tile"}
    if unknown:
        raise ValueError(f"grid takes waves and tile, not {sorted(unknown)}")
    tile = value.get("tile")
    return Grid(float(value.get("waves", 1.0)), None if tile is None else int(tile))


def check_grid(grid, tiles: tuple[int, ...], what: str) -> Grid | None:
    """``grid`` as a :class:`Grid` (or None), validated for a wrapper whose
    library holds the query ``tiles`` (empty: one tile, which takes no
    ``tile``)."""
    grid = as_grid(grid)
    if grid is None:
        return None
    if not (math.isfinite(grid.waves) and grid.waves > 0):
        raise ValueError(f"{what}: waves={grid.waves} must be positive and finite")
    if grid.tile is not None and grid.tile not in tiles:
        raise ValueError(
            f"{what}: tile={grid.tile} is not a tile the library holds"
            + (f" (one of {list(tiles)})" if tiles else " (it holds one)")
        )
    return grid


def wave_blocks(resident: int, grid: Grid | None) -> int:
    """The scan blocks of ``grid``'s waves, given the ``resident`` blocks
    of one wave: ``resident`` itself without a grid, else
    ``⌊resident · waves⌋``, at least 1."""
    if grid is None:
        return resident
    return max(1, int(resident * grid.waves))
