"""Mean host-clock ms from the call into ``Perceiver.perceive`` to a
synchronise after it, a frame (the traced run's first stretch)."""

import numpy as np


def read(ctx):
    spans = (ctx["trace"] or {}).get("spans") or {}
    s = spans.get("perception")
    return 1e3 * float(np.mean(s)) if s else None
