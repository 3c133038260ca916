"""Command-line inspector for MVT files: ``python -m metrovector_tpu_torch``.

The counterpart of ``python -m metrovector_tpu``, with the same five
commands, flags and output. ``info``, ``validate`` and ``head`` read the
file on the host and load no torch; ``search`` and ``tune`` run the CUDA
kernels on ``--device`` (default ``cuda``: without a card they fail, as
every entry point of the port does; ``--device cpu`` runs the plain
versions, on which ``tune`` has nothing to time).

Commands::

    python -m metrovector_tpu_torch info FILE            # spaces, blocks, stats
    python -m metrovector_tpu_torch validate FILE [--checksum]
    python -m metrovector_tpu_torch head FILE [-s SPACE] [-n 5]
    python -m metrovector_tpu_torch search FILE -q Q.npy [-s SPACE] [-k 10]
    python -m metrovector_tpu_torch tune FILE [-s SPACE] [--index] [--save]
        [--waves 0.5,1,2,4] [--tiles auto,1,2,...]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _human(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n} B"


def _open(path):
    from .format.reader import Reader

    return Reader.open(path)


def _pick_space(r, name: str | None) -> str:
    names = r.vector_space_names
    if name is not None:
        if name not in names:
            sys.exit(f"error: no space {name!r}; file has {names}")
        return name
    if len(names) != 1:
        sys.exit(f"error: file has {len(names)} spaces; pass -s one of {names}")
    return names[0]


def cmd_info(args) -> int:
    from .format.constants import IndexKind

    r = _open(args.file)
    print(f"{args.file}: MVT v{r.version}, {_human(r.file_size)}, "
          f"{r.num_vector_spaces} space(s)")
    for name in r.vector_space_names:
        sp = r.vector_space(name)
        info = sp.info
        line = (f"  {name}: {sp.num_vectors} x {sp.dim} "
                f"{sp.dtype.name.lower()} {sp.vector_type.name.lower()}, "
                f"metric={sp.metric.name.lower()}")
        q = sp.quantization
        if q is not None:
            line += f", quant(scale={q.scale:.6g}, zero={q.zero_point:.6g})"
        print(line)
        cols = sp.metadata_column_names()
        if cols:
            print(f"    metadata: {', '.join(cols)}")
        if sp.ids() is not None:
            print("    stable u64 ids: yes")
        mask = sp.tombstone_mask()
        if mask is not None:
            print(f"    tombstones: {int(mask.sum())} deleted")
        feats = []
        if info.index.kind != IndexKind.NONE:
            feats.append(info.index.kind.name.lower())
        if info.pq is not None:
            feats.append("pq(residual)" if info.pq.residual else "pq")
            if info.pq.packed4:
                feats[-1] += "+4bit"
        if feats:
            print(f"    indexes: {', '.join(feats)}")
    if r.extension_names():
        print(f"  extensions: {', '.join(r.extension_names())}")
    if r.stats:
        print(f"  stats: {json.dumps(r.stats, default=str)}")
    return 0


def cmd_validate(args) -> int:
    r = _open(args.file)
    try:
        if args.checksum:
            r.validate_with_checksum()
        else:
            r.validate()
    except Exception as exc:  # the typed error's message, verbatim
        print(f"INVALID: {type(exc).__name__}: {exc}")
        return 1
    print("OK" + (" (checksums verified)" if args.checksum else ""))
    return 0


def cmd_head(args) -> int:
    r = _open(args.file)
    sp = r.vector_space(_pick_space(r, args.space))
    np.set_printoptions(precision=4, suppress=True, threshold=16)
    for i in range(min(args.n, sp.num_vectors)):
        v = sp.get_vector(i)
        print(f"[{i}] nnz={v.nnz}" if sp.is_sparse else f"[{i}] {v.as_f32()}")
    return 0


def cmd_search(args) -> int:
    """Exact top-k of the queries in a ``.npy`` on ``--device``: K4
    (``ell_topk``) for a sparse space, K1 (``fused_topk``) otherwise. One
    JSON line a query: its rows, stable ids and distances, best first."""
    r = _open(args.file)
    sp = r.vector_space(_pick_space(r, args.space))
    q = np.load(args.query)
    if q.ndim == 1:
        q = q[None]
    if sp.is_sparse:
        from .sparse import SparseSearchEngine

        eng = SparseSearchEngine(sp, device=args.device)
    else:
        from .engine import SearchEngine

        eng = SearchEngine(sp, device=args.device)
    res = eng.search(q.astype(np.float32), k=args.k)
    for qi in range(q.shape[0]):
        rows = [{"row": int(i), "id": int(res.ids[qi, j]),
                 "distance": float(res.distances[qi, j])}
                for j, i in enumerate(res.indices[qi]) if i >= 0]
        print(json.dumps({"query": qi, "results": rows}))
    return 0


def _candidates(text: str | None, parse):
    return None if text is None else [parse(v) for v in text.split(",")]


def _tile(v: str):
    return None if v.strip().lower() in ("auto", "none") else int(v)


def cmd_tune(args) -> int:
    """Time the launch grid of one space's kernel on ``--device`` and print
    the report (fastest first) as JSON lines, then the grid applied.
    Routes as the JAX CLI does: the dense engine (K1) by default, the ELL
    engine (K4) for a sparse space, the persisted PQ or IVF-PQ index (K2,
    its bucket kernel for IVF-PQ) with ``--index``. ``--save`` persists the
    winner into the file's hints, where later opens adopt it."""
    for flag, value in (("--block-rows", args.block_rows),
                        ("--query-tile", args.query_tile)):
        if value is not None:
            print(f"error: {flag} is a Mosaic tile of the JAX package's TPU kernels; "
                  "the port tunes --waves and --tiles", file=sys.stderr)
            return 1
    r = _open(args.file)
    name = _pick_space(r, args.space)
    sp = r.vector_space(name)
    kw = {"persist": bool(args.save)}
    waves = _candidates(args.waves, float)
    if waves:
        kw["waves_candidates"] = waves
    tiles = _candidates(args.tiles, _tile)
    if sp.is_sparse:
        from .sparse import SparseSearchEngine

        owner = SparseSearchEngine(sp, device=args.device)
        kw["tile_candidates"] = tiles
    elif args.index:
        from .database import Database

        db = Database(r, device=args.device)
        kind = db.index_kind(name)
        if kind not in ("pq", "ivfpq"):
            print(f"error: --index tunes PQ/IVF-PQ ADC scans; space {name!r} "
                  f"persists {kind or 'no'} index sidecar", file=sys.stderr)
            return 1
        owner = db.pq_index(name) if kind == "pq" else db.ivfpq_index(name)
        if kind == "pq":
            kw["tile_candidates"] = tiles
        elif tiles is not None:
            raise ValueError("IVF-PQ's bucket kernel holds one tile: pass --waves only")
    else:
        from .engine import SearchEngine

        if tiles is not None:
            raise ValueError("K1 holds one block tile: pass --waves only")
        owner = SearchEngine(sp, device=args.device)
    report = owner.autotune(k=args.k, batch=args.batch, **kw)
    for row in report:
        print(json.dumps(row))
    if report and np.isfinite(report[0]["ms"]):
        print(json.dumps({"applied": owner.grid.saved(), "saved": bool(args.save)}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m metrovector_tpu_torch",
        description="Inspect and query MVT vector files.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="file and per-space summary")
    p.add_argument("file")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("validate", help="structural validation")
    p.add_argument("file")
    p.add_argument("--checksum", action="store_true",
                   help="also recompute per-block CRC32 (reads all bytes)")
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("head", help="print the first vectors")
    p.add_argument("file")
    p.add_argument("-s", "--space", default=None)
    p.add_argument("-n", type=int, default=5)
    p.set_defaults(fn=cmd_head)

    p = sub.add_parser("search", help="exact top-k for queries in a .npy")
    p.add_argument("file")
    p.add_argument("-q", "--query", required=True,
                   help="path to a [Q, dim] (or [dim]) .npy float array")
    p.add_argument("-s", "--space", default=None)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("tune", help="single-launch-time kernel grids for a space")
    p.add_argument("file")
    p.add_argument("-s", "--space", default=None)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--batch", type=int, default=128,
                   help="sample query batch size (default 128)")
    p.add_argument("--waves", default=None,
                   help="comma-separated multiples of one wave of scan blocks "
                        "(default 0.5,1,2,4)")
    p.add_argument("--tiles", default=None,
                   help="comma-separated query tiles, 'auto' for the kernel's own "
                        "pick (PQ's lookup scan: 1-32; sparse: 32-256)")
    p.add_argument("--block-rows", default=None, help=argparse.SUPPRESS)
    p.add_argument("--query-tile", default=None, help=argparse.SUPPRESS)
    p.add_argument("--index", action="store_true",
                   help="tune the persisted PQ/IVF-PQ ADC scan instead of the "
                        "dense kernel")
    p.add_argument("--save", action="store_true",
                   help="persist the winner into the file's PerformanceHints "
                        "(footer rewrite; future opens adopt it)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; tuning needs one)")
    p.set_defaults(fn=cmd_tune)

    from .errors import MvtError

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError, RuntimeError, MvtError) as exc:
        # a bad path, a malformed file, a wrong query width, no card: one
        # line, not a traceback
        print("error: " + " ".join(str(exc).split()), file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
