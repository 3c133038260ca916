"""The bf16x3 scan's roofline share, in %: the configuration's roofline
time of one batch (``roofline/<roofline>.py``'s ``per_batch``) over the
card's time a batch in the kernels that its ``KERNELS`` names, summed from
the traced window's device operations by name, over the batches the window
took. Nothing where the roofline names no kernels or none of them ran."""

import re

from perfbench import core


def read(run):
    tr, n = run.trace, len(run.window.taken)
    if tr is None or n == 0:
        return None
    names = getattr(core.load_module(run.cell.root, "roofline",
                                     run.cell.config["roofline"]), "KERNELS", ())
    if not names:
        return None
    # a whole name, whatever the trace puts around it (``::``, ``<``, ``_``)
    mine = re.compile(r"(?<![A-Za-z0-9])(" + "|".join(map(re.escape, names))
                      + r")(?![A-Za-z0-9])")
    us = sum(t for name, t in tr.device_ops if mine.search(name))
    if us <= 0:
        return None
    return 100.0 * run.roofline["seconds"] / (us * 1e-6 / n)
