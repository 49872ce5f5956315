"""Median request latency (ms) over every request of the window, each
from the call into the entry to the synchronise after its answer."""

import numpy as np


def read(ctx):
    lat = ctx.get("latencies_s")
    return 1e3 * float(np.percentile(lat, 50)) if lat else None
