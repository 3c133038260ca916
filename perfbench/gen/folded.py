"""Clustered real-valued rows, non-negative and not rounded: ``centres``
random centres with entries uniform in ``[0, hi)``, each row a centre plus
normal noise of deviation ``spread``, folded at zero (``|c + noise|``), so
that every entry is a non-negative real with no exact zero and, but for a
few, no value that bf16 holds exactly. The queries come from the same
centres with fresh noise, folded the same way. Rows are held as f32,
queries as f32.

Drawn on ``device`` from the seed, the corpus in chunks of a fixed row
count, then the queries, so a seed always gives the same rows and queries
whatever the block they are laid out in.
"""

import torch

CHUNK = 1 << 17


def _draw(centres, m: int, spread: float, g) -> torch.Tensor:
    pick = torch.randint(0, centres.shape[0], (m,), generator=g, device=centres.device)
    noise = torch.randn((m, centres.shape[1]), generator=g, device=centres.device)
    return (centres[pick] + noise * spread).abs_()


def make(cfg, seed: int, device, n_queries: int, rows_alloc: int, width: int):
    """``(rows [rows_alloc, width] f32 on device, zero past the logical
    rows and dims; queries [n_queries, dim] f32 numpy)``."""
    if cfg["dtype"] != "float32":
        raise ValueError(f"gen/folded draws float32 rows, not {cfg['dtype']}")
    n, d = int(cfg["rows"]), int(cfg["dim"])
    args = cfg["generator_args"]
    spread = float(args["spread"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**64)
    centres = torch.rand((int(args["centres"]), d), generator=g, device=device)
    centres *= float(args["hi"])
    out = torch.zeros((rows_alloc, width), dtype=torch.float32, device=device)
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        out[s:e, :d] = _draw(centres, e - s, spread, g)
    queries = _draw(centres, n_queries, spread, g)
    return out, queries.cpu().numpy()
