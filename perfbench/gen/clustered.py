"""Clustered integer rows: ``centres`` random integer centres in
``[lo, hi]``, each row a centre plus normal noise of deviation ``spread``,
rounded half to even and clipped to ``[lo, hi]`` (the pattern of
``_clustered_u8_corpus`` in the JAX package's benchmark suite, redrawn in
torch). The queries come from the same centres with fresh noise, clipped;
``round_queries`` says whether they are rounded to integers as the rows are
or keep their fractions. Rows are held in the configuration's ``dtype``
(``float32`` or ``int8``), queries as f32.

Drawn on ``device`` from the seed, the corpus in chunks of a fixed row
count, then the queries, so a seed always gives the same rows and queries.
"""

import torch

CHUNK = 1 << 17
DTYPES = {"float32": torch.float32, "int8": torch.int8}


def _draw(centres, m: int, args, g, rnd: bool) -> torch.Tensor:
    pick = torch.randint(0, centres.shape[0], (m,), generator=g, device=centres.device)
    noise = torch.randn((m, centres.shape[1]), generator=g, device=centres.device)
    v = centres[pick] + noise * float(args["spread"])
    if rnd:
        v = v.round_()
    return v.clamp_(float(args["lo"]), float(args["hi"]))


def make(cfg, seed: int, device, n_queries: int, rows_alloc: int, width: int):
    """``(rows [rows_alloc, width] in cfg's dtype on device, zero past the
    logical rows and dims; queries [n_queries, dim] f32 numpy)``."""
    n, d = int(cfg["rows"]), int(cfg["dim"])
    args = cfg["generator_args"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**64)
    centres = torch.randint(int(args["lo"]), int(args["hi"]) + 1, (int(args["centres"]), d),
                            generator=g, device=device).float()
    out = torch.zeros((rows_alloc, width), dtype=DTYPES[cfg["dtype"]], device=device)
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        out[s:e, :d] = _draw(centres, e - s, args, g, True).to(out.dtype)
    queries = _draw(centres, n_queries, args, g, bool(args["round_queries"]))
    return out, queries.cpu().numpy()
