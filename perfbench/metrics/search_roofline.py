"""The cell's roofline time of one batch as a share, in %, of the card's
busy time per batch in the traced window (every kernel and copy of the
window, over the batches the window took)."""


def read(run):
    tr, n = run.trace, len(run.window.taken)
    if tr is None or tr.busy_us <= 0 or n == 0:
        return None
    return 100.0 * run.roofline["seconds"] / (tr.busy_us * 1e-6 / n)
