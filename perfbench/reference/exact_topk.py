"""Plain exact top-k, the yardstick that decides ``correct``, and its
lower-precision controls. Plain PyTorch in float64; imports nothing of the
program and takes nothing it made.

The rows (``rows[:n, :dim]``, f32 or int8 values) and the f32 queries are
taken as given. L2 ranks by the squared distance, smallest first; inner
product by the dot, largest first; the distance served is the L2 distance
or the dot times the configuration's ``scale``. The scores are worked out in
float64, which holds every product and sum of the data here exactly
(integer rows below 2**8 in magnitude, f32 queries); ties go to the lowest
row.

``precision`` other than ``"exact"`` is a control: the same search with its
operands in a lower precision. ``"tf32"`` and ``"bf16"`` round the operands
to 10 or 7 mantissa bits (to nearest, ties to even) and sum the exact
products; ``"int8"`` and ``"int4"`` quantize them symmetrically to 127 or 7
levels (the corpus by its largest magnitude; the queries of an L2 space by
the corpus's unit, so that L2 stays a distance; those of an inner-product
space by their batch's largest magnitude).
"""

import numpy as np
import torch

QUERY_CHUNK, ROW_BLOCK = 256, 1 << 20
PRECISIONS = ("exact", "tf32", "bf16", "int8", "int4")
_MANTISSA = {"tf32": 10, "bf16": 7}
_LEVELS = {"int8": 127, "int4": 7}


def round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """``t`` (float64) rounded to ``bits`` explicit mantissa bits."""
    m, e = torch.frexp(t)
    return torch.ldexp(torch.round(m * 2.0 ** (bits + 1)) / 2.0 ** (bits + 1), e)


def _metric(cfg) -> bool:
    """True for L2, False for inner product."""
    if cfg["metric"] not in ("L2", "INNER_PRODUCT"):
        raise ValueError(f"metric {cfg['metric']!r} is not L2 or INNER_PRODUCT")
    return cfg["metric"] == "L2"


def _operands(cfg, rows, batches, precision):
    """The corpus as a float64 block function, the queries as float64
    arrays, the corpus's unit and each batch's unit (what one step of the
    operands is worth in the served distance)."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    n, d = int(cfg["rows"]), int(cfg["dim"])
    x = rows[:n, :d]
    xs = float(cfg.get("scale", 1.0))
    qs = [np.asarray(b, dtype=np.float32).astype(np.float64) for b in batches]
    if precision in _LEVELS:
        levels = _LEVELS[precision]
        amax = max(float(x[s:s + ROW_BLOCK].abs().max()) for s in range(0, n, ROW_BLOCK))
        ux = amax * xs / levels or 1.0
        if _metric(cfg):
            uq = [ux] * len(qs)
        else:
            uq = [float(np.abs(q).max()) / levels or 1.0 for q in qs]
        qs = [np.clip(np.rint(q / u), -levels, levels) for q, u in zip(qs, uq)]

        def block(s, e):
            return torch.round(x[s:e].double() * (xs / ux)).clamp_(-levels, levels)

        return block, qs, ux, uq
    def values(s, e):
        return x[s:e].double() * xs

    if precision in _MANTISSA:
        bits = _MANTISSA[precision]
        qs = [round_mantissa(torch.from_numpy(q), bits).numpy() for q in qs]
        return (lambda s, e: round_mantissa(values(s, e), bits)), qs, 1.0, [1.0] * len(qs)
    return values, qs, 1.0, [1.0] * len(qs)


def _cost(q, xb, l2):
    """``[Q, B]`` float64 cost, smaller is better: the squared distance,
    or the negated dot."""
    dots = q @ xb.T
    if l2:
        return (q * q).sum(1)[:, None] + (xb * xb).sum(1)[None, :] - 2 * dots
    return -dots


def _smallest(cost, k: int, first_row: int):
    """The ``k`` smallest of each row of ``cost`` in the order (cost, row),
    so ties go to the lowest row: ``(costs [Q, k], rows [Q, k] int64)``."""
    nq = cost.shape[0]
    kk = min(k, cost.shape[1])
    bar = cost.topk(kk, dim=1, largest=False).values[:, -1:]
    qi, ri = torch.nonzero(cost <= bar, as_tuple=True)  # row-major: ri rises in each qi
    c = cost[qi, ri]
    o = torch.sort(c, stable=True).indices
    o = o[torch.sort(qi[o], stable=True).indices]
    qi, ri, c = qi[o], ri[o], c[o]
    counts = torch.bincount(qi, minlength=nq)
    take = (torch.cumsum(counts, 0) - counts)[:, None] + torch.arange(kk, device=cost.device)
    return c[take], ri[take] + first_row


def answers(cfg, rows: torch.Tensor, batches, k: int, precision: str = "exact"):
    """``[(row ids [B, k] int64, distances [B, k] float64)]``, one pair per
    batch of f32 queries in ``batches``, over the logical rows and dims of
    ``rows`` (on any device)."""
    n = int(cfg["rows"])
    l2 = _metric(cfg)
    block, qs, ux, uq = _operands(cfg, rows, batches, precision)
    dev = rows.device
    q_all = torch.from_numpy(np.concatenate(qs)).to(dev, torch.float64)
    chunks = [(s, min(len(q_all), s + QUERY_CHUNK)) for s in range(0, len(q_all), QUERY_CHUNK)]
    best = [None] * len(chunks)
    for r0 in range(0, n, ROW_BLOCK):
        r1 = min(n, r0 + ROW_BLOCK)
        xb = block(r0, r1)
        for c, (a, b) in enumerate(chunks):
            cost, ids = _smallest(_cost(q_all[a:b], xb, l2), k, r0)
            if best[c] is not None:  # earlier rows first, so a stable sort keeps ties low
                cost = torch.cat([best[c][0], cost], 1)
                ids = torch.cat([best[c][1], ids], 1)
                o = torch.argsort(cost, dim=1, stable=True)[:, :k]
                cost, ids = cost.gather(1, o), ids.gather(1, o)
            best[c] = (cost, ids)
        del xb
    cost = torch.cat([b[0] for b in best]).cpu()
    rid = torch.cat([b[1] for b in best]).cpu().numpy()
    unit = torch.from_numpy(np.repeat(np.array(uq), [len(q) for q in qs]))[:, None]
    dist = (torch.sqrt(cost.clamp(min=0)) * unit if l2 else -cost * unit * ux).numpy()
    out, a = [], 0
    for q in qs:
        out.append((rid[a:a + len(q)], dist[a:a + len(q)]))
        a += len(q)
    return out


def distances_of(cfg, rows: torch.Tensor, queries, ids) -> np.ndarray:
    """The exact distance of each query to each row that ``ids`` [B, k]
    names, float64; NaN where an id names no row."""
    n, d = int(cfg["rows"]), int(cfg["dim"])
    l2 = _metric(cfg)
    xs = float(cfg.get("scale", 1.0))
    ids = torch.from_numpy(np.asarray(ids, dtype=np.int64)).to(rows.device)
    ok = (ids >= 0) & (ids < n)
    x = rows[ids.clamp(0, n - 1), :d].double() * xs  # [B, k, d]
    q = torch.from_numpy(np.asarray(queries, dtype=np.float32)).to(rows.device, torch.float64)
    if l2:
        dist = ((x - q[:, None, :]) ** 2).sum(-1).sqrt()
    else:
        dist = (x * q[:, None, :]).sum(-1)
    return torch.where(ok, dist, torch.nan).cpu().numpy()


def compare(cfg, ids, dist, ref_ids, ref_dist, exact):
    """Per query of one answer: ``{check: values}``, each check's reading
    of each query. ``exact`` holds the exact distances of the served rows
    (:func:`distances_of`). The checks, each a share of the query's
    largest reference distance where it is a gap:

    - ``wrong_ids``: slots whose row differs from the reference's;
    - ``rank_gap``: the widest gap by which a served row's exact distance
      lies beyond the reference's at the same rank;
    - ``dist_gap``: the widest gap between a served distance and the
      exact distance of the row served with it;
    - ``dup_ids``: slots that name no row or repeat a row of an earlier
      slot.

    NaN reads as infinite."""
    ids = np.asarray(ids, dtype=np.int64)
    dist = np.asarray(dist, dtype=np.float64)
    scale = np.maximum(np.abs(ref_dist).max(1), 1e-300)[:, None]
    worse = exact - ref_dist if _metric(cfg) else ref_dist - exact
    srt = np.sort(ids, axis=1)
    dups = (srt[:, 1:] == srt[:, :-1]).sum(1) + np.isnan(exact).sum(1)

    def gap(g):
        g = (g / scale).max(1)
        return np.where(np.isnan(g), np.inf, g)

    return {"wrong_ids": (ids != ref_ids).sum(1),
            "rank_gap": gap(worse),
            "dist_gap": gap(np.abs(dist - exact)),
            "dup_ids": dups}
