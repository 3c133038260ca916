"""Single-launch measurement shared by every autotune surface, and the
tuned grids persisted in a file's hints.

Why single-launch: one timed search with a forced host readback shows what
a grid costs a caller, launch and readback included; a pipelined
throughput figure hides a plan that serializes. Each candidate is run once
to warm up, then timed ``iters`` times, best of.

The knob is the kernels' launch grid (:class:`~..ops.grid.Grid`). It is
persisted under ``hints["tuned"][space][family]["cuda"]``: the JAX
package's knobs (``block_rows``, ``query_tile``, ``merge``) sit beside it
in the same family, and each package reads only its own.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np

__all__ = ["measure_once", "measure_candidates", "tuned_hints", "tuned_grid",
           "persist_tuned", "require_kernels", "grid_candidates", "tune_grid"]


def measure_once(run: Callable[[], Any]) -> float:
    """One timed invocation of ``run`` (which must force its own host
    readback — e.g. ``np.asarray`` of the result), in seconds. Separated
    out so tests can substitute deterministic timings."""
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def measure_candidates(
    candidates: list[dict],
    run_with: Callable[[dict], Callable[[], Any]],
    iters: int = 3,
) -> list[dict]:
    """Measure each candidate config and return the reports sorted
    fastest-first.

    ``candidates``: list of config dicts (copied into the report rows).
    ``run_with(cfg)``: returns the zero-arg launch closure for one config
    (called once to build, then once to warm/compile, then ``iters``
    timed runs — best-of wins, since tail noise only inflates). A
    candidate that raises (a tile that does not fit, a launch that fails)
    records ``ms=inf`` plus the error text instead of aborting the sweep; a
    candidate carrying a ``"skipped"`` note is passed through unmeasured
    so reports never imply coverage they don't have."""
    results: list[dict] = []
    for cfg in candidates:
        row = dict(cfg)
        if "skipped" in row:
            row["ms"] = float("inf")
            results.append(row)
            continue
        try:
            run = run_with(cfg)
            run()  # warm: pays the compile outside the timings
            best = float("inf")
            for _ in range(max(1, iters)):
                best = min(best, measure_once(run))
            row["ms"] = best * 1e3
        except Exception as exc:  # a launch that failed: record, move on
            row["ms"] = float("inf")
            row["error"] = str(exc)[:200]
        results.append(row)
    results.sort(key=lambda r: r["ms"])
    return results


def tuned_hints(space, family: str) -> dict:
    """Tuned knobs persisted for one kernel family of one space —
    ``manifest.hints["tuned"][space.name][family]`` — or ``{}``.
    Families: ``"dense"`` (SearchEngine), ``"adc"`` (PQIndex), ``"ivfpq"``
    (IVFPQIndex's scan), ``"sparse"`` (SparseSearchEngine, ELL). The port's
    grid is the family's ``"cuda"`` entry (:func:`tuned_grid`); the other
    entries are the JAX package's Mosaic tiles."""
    try:
        tuned = space.reader.manifest.hints.get("tuned", {})
        return dict(tuned.get(space.name, {}).get(family, {}))
    except (AttributeError, TypeError):
        return {}


def persist_tuned(space, family: str, cfg: dict) -> None:
    """Write one family's winning knobs into the space's file
    (``hints["tuned"][space.name][family]``, footer-only rewrite via
    :func:`~metrovector_tpu_torch.format.builder.rewrite_hints`) so future
    ``Reader.open`` → engine constructions adopt it by default."""
    from ..format.builder import rewrite_hints

    path = space.reader.path
    if not path or path == "<bytes>":
        raise ValueError(
            "persist requires a file-backed space (Reader.open, not "
            "Reader.from_bytes)"
        )
    rewrite_hints(path, {"tuned": {space.name: {family: dict(cfg)}}})


def tuned_grid(space, family: str):
    """The :class:`~..ops.grid.Grid` persisted for ``family`` of ``space``
    by :func:`tune_grid` (``hints["tuned"][space][family]["cuda"]``), or
    None. A family the JAX package tuned alone holds no ``"cuda"`` entry,
    so its Mosaic tiles are never adopted."""
    from ..ops.grid import as_grid

    return as_grid(tuned_hints(space, family).get("cuda"))


def require_kernels(device, what: str) -> None:
    """Refuse to tune anything but the CUDA kernels: ``ValueError`` when
    ``device`` is not a CUDA device (on the CPU the plain versions run, and
    they have no grid)."""
    if getattr(device, "type", str(device)) != "cuda":
        raise ValueError(
            f"{what}.autotune times the CUDA kernels' launch grid; this one is "
            f"on {device}, where the plain versions run"
        )


def grid_candidates(waves, tiles, batch: int) -> list[dict]:
    """``{"waves": w, "tile": t}`` for each tile of ``tiles`` (None: the
    wrapper's own pick) and each of ``waves``; a tile above
    ``max(batch, smallest tile)`` adds nothing to the batch and carries a
    ``"skipped"`` note instead of a time."""
    sized = [t for t in tiles if t is not None]
    floor = max(batch, min(sized)) if sized else batch
    out = []
    for tile in tiles:
        for w in waves:
            cfg = {"waves": float(w), "tile": None if tile is None else int(tile)}
            if tile is not None and tile > floor:
                cfg["skipped"] = f"tile {tile} > batch {batch}"
            out.append(cfg)
    return out


def tune_grid(owner, family: str, run_with, *, queries, batch: int, dim: int,
              waves, tiles, iters: int, apply: bool, persist: bool) -> list[dict]:
    """The measure / apply / persist loop of every ``autotune``. ``owner``
    has ``grid``, ``_host_space`` (the file-backed space, or None) and
    ``device``; ``run_with(queries, grid)`` returns the zero-argument
    search of one candidate. ``queries``: the sample batch, or None for
    ``[batch, dim]`` drawn N(0, 1) (seed 0). The candidates are
    :func:`grid_candidates` of ``waves`` (None: :data:`~..ops.grid.WAVES`)
    and ``tiles`` at the sample's batch. Returns the report sorted fastest
    first; with ``apply`` the finite winner becomes ``owner.grid``, and
    with ``persist`` it is also written to the file (which needs a
    file-backed space and a finite winner)."""
    from ..ops.grid import WAVES, Grid

    require_kernels(owner.device, type(owner).__name__)
    if persist and owner._host_space is None:
        raise ValueError(
            "persist requires an engine built from a file-backed VectorSpace "
            "(Reader.open / .open / .from_space)"
        )
    if queries is None:
        queries = np.random.default_rng(0).standard_normal((batch, dim)).astype(np.float32)
    nq = np.asarray(queries).reshape(-1, dim).shape[0]
    results = measure_candidates(
        grid_candidates(waves or WAVES, tiles, nq),
        lambda cfg: run_with(queries, Grid(cfg["waves"], cfg["tile"])), iters)
    if apply and results and results[0]["ms"] < float("inf"):
        owner.grid = Grid(results[0]["waves"], results[0]["tile"])
        if persist:
            persist_tuned(owner._host_space, family, {"cuda": owner.grid.saved()})
    elif persist:
        raise RuntimeError(
            f"nothing persisted: no finite-time winner to apply (apply={apply})"
        )
    return results
