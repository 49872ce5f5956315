"""Mean host-clock ms from the call into the control step to its
command on the host, a step (the traced run's first stretch)."""

import numpy as np


def read(ctx):
    spans = (ctx["trace"] or {}).get("spans") or {}
    s = spans.get("control")
    return 1e3 * float(np.mean(s)) if s else None
