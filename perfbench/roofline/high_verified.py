"""The least time the bf16x3 scan of ``high_verified`` can take for one
batch on the configuration's peak: the larger of its operations over the
peak rate and its bytes over the memory's rate. Operations: the three
products of the split (``q_hi·x_hi``, ``q_hi·x_lo``, ``q_lo·x_hi``), a
multiply and an add each for every query, row and logical dim, so 6·b·n·d
at the bf16 tensor-core rate. Bytes: the f32 rows read once, the squared
norms, the f32 queries, and the fetched lists written once (k +
``MARGIN`` candidates a query, a 4-byte row id and a 4-byte score each).

``KERNELS``: the kernels whose device time the bound is for, the bf16x3
path's own (``ops/csrc/topk_high_kernel.cu``: the queries' split, then
the scan with its selection). The merge of the scan's split lists runs in
kernels that the ``"highest"`` fallback shares, so the trace cannot tell
whose they are; they are left out."""

MARGIN = 8  # the engine's default ``verify_margin``
KERNELS = ("split_queries_kernel", "high_scan_kernel")


def per_batch(cfg, traffic) -> dict:
    """``{"ops", "bytes", "seconds", "bound"}`` for one batch."""
    if cfg["dtype"] != "float32" or cfg["metric"] != "L2":
        raise ValueError("the bf16x3 scan's roofline is priced for f32 rows by L2")
    b, k = int(traffic["batch"]), int(traffic["k"])
    n, d = int(cfg["rows"]), int(cfg["dim"])
    ops = 6 * b * n * d
    nbytes = n * d * 4 + 4 * n + b * d * 4 + b * (k + MARGIN) * 8
    peak = cfg["peak"]
    t_ops = ops / float(peak["ops_per_s"])
    t_bytes = nbytes / float(peak["bytes_per_s"])
    return {"ops": ops, "bytes": nbytes, "seconds": max(t_ops, t_bytes),
            "bound": "ops" if t_ops >= t_bytes else "bytes"}
