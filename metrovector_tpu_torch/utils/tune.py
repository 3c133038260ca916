"""Single-launch tiling measurement shared by every autotune surface.

Why single-launch: a bad tile silently crosses a Mosaic VMEM-spill cliff
costing ~100× (measured: D=1024 f32 at ``block_rows=1536``; the ADC
4-bit path's auto ``block_rows=3072`` vs 1024 ran 77× slower —
``benchmarks/RESULTS.md``). Pipelined throughput numbers hide the cliff
until production; one timed launch with a forced host readback exposes
it immediately. Each candidate pays one compile, so tune once per
(corpus shape, dtype, k) and reuse.

Reference analog: none (the reference has no kernel to tune).
"""

from __future__ import annotations

import time
from typing import Any, Callable

__all__ = ["measure_once", "measure_candidates"]


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
    candidate that raises (Mosaic VMEM OOM and friends) records
    ``ms=inf`` plus the error text instead of aborting the sweep; a
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
        except Exception as exc:  # VMEM OOM etc.: record, move on
            row["ms"] = float("inf")
            row["error"] = str(exc)[:200]
        results.append(row)
    results.sort(key=lambda r: r["ms"])
    return results


def tuned_hints(space, family: str) -> dict:
    """Tuned tilings persisted for one kernel family of one space —
    ``manifest.hints["tuned"][space.name][family]`` — or ``{}``.
    Families: ``"dense"`` (SearchEngine ``block_rows``/``query_tile``/
    ``merge``), ``"adc"`` (PQIndex), ``"ivfpq"`` (IVFPQIndex masked
    scan), ``"sparse"`` (SparseSearchEngine ELL ``block_rows``)."""
    try:
        tuned = space.reader.manifest.hints.get("tuned", {})
        return dict(tuned.get(space.name, {}).get(family, {}))
    except (AttributeError, TypeError):
        return {}


def persist_tuned(space, family: str, cfg: dict) -> None:
    """Write one family's winning tiling into the space's file
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
