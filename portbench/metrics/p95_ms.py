"""p95_ms: the 95th percentile of the latency of every call in the window,
from the call to its results on the host (host clock)."""

import numpy as np


def read(ctx):
    lat = ctx.window["latencies"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
