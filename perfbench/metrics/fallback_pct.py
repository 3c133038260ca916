"""The share, in %, of the traced window's batches whose certificate
failed: of the batches with an ``engine.verify`` span (``high_verified``'s
check), those that also hold an ``engine.fallback`` span (the batch re-run
at ``"highest"``). Spans as in ``prepare_ms``; nothing where no batch of
the window was verified."""

from perfbench import core


def read(run):
    spans = core.load_module(run.cell.root, "metrics", "prepare_ms").window_spans(run)
    verified = {s.batch for s in spans if s.name == "engine.verify"}
    if not verified:
        return None
    fell = {s.batch for s in spans if s.name == "engine.fallback"} & verified
    return 100.0 * len(fell) / len(verified)
