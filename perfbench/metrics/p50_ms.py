"""Median, in ms, of the times of all batches answered within the window,
each from when the engine took it to its host result."""

import numpy as np


def read(run):
    lat = run.latencies_s()
    return float(np.percentile(lat, 50)) * 1e3 if lat.size else None
