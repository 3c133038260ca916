"""The engine's query preparation a batch, in ms: the self time of the
program's span ``engine.prepare_queries`` (validation, f64 norms, int8
quantization, padding), less its child ``engine.upload``, over the batches
of the traced window.

The program records its spans (``metrovector_tpu_torch.utils.timing``)
while a ``torch.profiler`` session runs, so in a ``--trace 1`` window
alone, on the ``perf_counter`` clock that the window is measured on. The
other readers of spans (``upload_ms``, ``enqueue_ms``, ``readback_ms``,
``result_ms``, ``host_gap_ms``) load this file for :func:`window_spans` and
:func:`per_batch_ms`. Nothing where the program records no spans, dropped
some, or the trace saw no card."""


def window_spans(run) -> list:
    """The program's spans of a batch that lie in the run's window; [] where
    the program has no recorder, the recorder dropped spans past its cap
    (the window's would be only its first part), or the trace saw no work
    on the card."""
    tr = run.trace
    if tr is None or tr.busy_us <= 0:
        return []
    try:
        from metrovector_tpu_torch.utils import timing
    except ImportError:
        return []
    read = getattr(timing, "spans", None)
    if read is None or timing.RECORDER.dropped:
        return []
    t0, t1 = run.start * 1e9, (run.start + run.seconds) * 1e9
    return [s for s in read() if s.batch is not None and t0 <= s.start_ns and s.end_ns <= t1]


def per_batch_ms(spans, name: str, less: str | None = None):
    """The time of the spans named ``name``, less that of their children
    named ``less``, in ms a batch they serve; None where there are none."""
    mine = [s for s in spans if s.name == name]
    if not mine:
        return None
    ns = sum(s.end_ns - s.start_ns for s in mine)
    if less is not None:
        ids = {s.id for s in mine}
        ns -= sum(s.end_ns - s.start_ns for s in spans if s.name == less and s.parent in ids)
    return ns / len({s.batch for s in mine}) / 1e6


def read(run):
    return per_batch_ms(window_spans(run), "engine.prepare_queries", less="engine.upload")
