"""Seconds from the process's start to the window's first call: imports,
the card's context, the kernels' library (built in the first run of a
checkout), the inputs drawn on the card, the engine and the warm-up."""


def read(run):
    return run.setup_s
