"""The least time one batch of exact top-k can take on the configuration's
peak: the larger of its operations over the peak rate and its bytes over the
memory's rate. The work is the answer's, not an implementation's: a
multiply and an add for each query, row and logical dim; each byte the
answer needs read once (the logical rows, the squared norms where the metric
is L2, the f32 queries) and each answer written once (a 4-byte row id and a
4-byte score)."""

ITEMSIZE = {"float32": 4, "float16": 2, "bfloat16": 2, "int8": 1, "uint8": 1}


def per_batch(cfg, traffic) -> dict:
    """``{"ops", "bytes", "seconds", "bound"}`` for one batch."""
    b, k = int(traffic["batch"]), int(traffic["k"])
    n, d = int(cfg["rows"]), int(cfg["dim"])
    ops = 2 * b * n * d
    nbytes = n * d * ITEMSIZE[cfg["dtype"]] + b * d * 4 + b * k * 8
    if cfg["metric"] == "L2":
        nbytes += 4 * n
    peak = cfg["peak"]
    t_ops = ops / float(peak["ops_per_s"])
    t_bytes = nbytes / float(peak["bytes_per_s"])
    return {"ops": ops, "bytes": nbytes, "seconds": max(t_ops, t_bytes),
            "bound": "ops" if t_ops >= t_bytes else "bytes"}
