"""Host time a batch from a read-back's end to the next enqueue's end, in
ms: the mean, over the batches of the traced window, of the time from the
end of a batch's ``engine.readback`` to the end of the next
``ops.fused_topk`` that starts after it (the next batch's enqueue; in
``search_pipelined`` that is the batch after the one in flight, whose scan
the read-back waited for). It holds the host's ``host_result``, the
caller's loop and the next launch; it says nothing of what the card does
meanwhile. Spans as in ``prepare_ms``."""

import bisect

from perfbench import core


def read(run):
    spans = core.load_module(run.cell.root, "metrics", "prepare_ms").window_spans(run)
    enq = sorted((s.start_ns, s.end_ns) for s in spans if s.name == "ops.fused_topk")
    starts = [a for a, _ in enq]
    gaps = []
    for s in spans:
        if s.name == "engine.readback":
            j = bisect.bisect_left(starts, s.end_ns)
            if j < len(enq):
                gaps.append(enq[j][1] - s.end_ns)
    return sum(gaps) / len(gaps) / 1e6 if gaps else None
