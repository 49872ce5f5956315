"""95th percentile of the request latency (ms) over every request of
the window (linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
    lat = ctx.get("latencies_s")
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
