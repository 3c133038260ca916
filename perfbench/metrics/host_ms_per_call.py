"""The engine's host path a call, in ms: the mean over the window's calls
of the call's span on the loop's own clock, less the card's busy time a
call from the trace (query preparation, launch, read-back and finalize,
where the card does not run). Only where each call waits for its answer, so
that all of the card's work lies inside the calls; nothing otherwise, and
nothing without a trace of the card."""


def read(run):
    w, tr = run.window, run.trace
    if not w.serial or tr is None or tr.busy_us <= 0 or not w.ready:
        return None
    spans = [b - a for a, b in zip(w.taken, w.ready)]
    return (sum(spans) - tr.busy_us * 1e-6) / len(spans) * 1e3
