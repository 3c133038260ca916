"""The kernel layer's host wrapper a batch, in ms: the program's span
``ops.fused_topk`` (checks, the library's handle, the outputs, the ctypes
calls, up to the last enqueue) over the batches of the traced window (see
``prepare_ms``)."""

from perfbench import core


def read(run):
    spans = core.load_module(run.cell.root, "metrics", "prepare_ms")
    return spans.per_batch_ms(spans.window_spans(run), "ops.fused_topk")
