"""The engine's host result a batch, in ms: the program's span
``engine.host_result`` (distances, padding, stable ids) over the batches
of the traced window (see ``prepare_ms``)."""

from perfbench import core


def read(run):
    spans = core.load_module(run.cell.root, "metrics", "prepare_ms")
    return spans.per_batch_ms(spans.window_spans(run), "engine.host_result")
