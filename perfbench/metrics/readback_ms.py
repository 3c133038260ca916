"""The host blocked on the card's answer a batch, in ms: the program's span
``engine.readback`` (the read-backs of scores and ids, until they are on
the host) over the batches of the traced window (see ``prepare_ms``)."""

from perfbench import core


def read(run):
    spans = core.load_module(run.cell.root, "metrics", "prepare_ms")
    return spans.per_batch_ms(spans.window_spans(run), "engine.readback")
