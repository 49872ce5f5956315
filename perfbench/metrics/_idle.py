"""The device's idle share of a request: 1 - busy / wall. Busy comes
from the profiled stretch (CUDA activity only, the union of the device's
intervals that fall inside the requests' host spans, a request); the
wall is the mean request latency of the unprofiled first stretch of the
same run, so that neither the profiler's host work nor the benchmark's
own work between requests (a car's window and integration) counts as
the program's."""


def idle(ctx):
    t = ctx["trace"]
    lat = ctx.get("latencies_s")
    if not t or not t["profiled_requests"] or not lat or t.get("request_busy_s") is None:
        return None
    busy = t["request_busy_s"] / t["profiled_requests"]
    wall = sum(lat) / len(lat)
    return 100.0 * (1.0 - busy / wall)
