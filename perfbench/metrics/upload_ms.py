"""The engine's copy of a batch's queries to the card from pageable memory,
in ms a batch: the program's span ``engine.upload`` over the batches of
the traced window (see ``prepare_ms``)."""

from perfbench import core


def read(run):
    spans = core.load_module(run.cell.root, "metrics", "prepare_ms")
    return spans.per_batch_ms(spans.window_spans(run), "engine.upload")
