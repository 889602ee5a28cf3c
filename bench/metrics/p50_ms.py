"""p50_ms: the median latency of every query of the window, from its
hand-over to the entry to its result on the host."""
import numpy as np


def read(ctx):
    lat = ctx.rec.latency_array()
    if lat.size == 0:
        return None
    return float(np.percentile(lat, 50))
