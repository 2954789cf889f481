"""call_ms_p50: the median latency, in ms, of every call of the window,
each timed on the host clock around the call."""
import numpy as np


def read(ctx):
    lat = ctx.window.get("latencies")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 50))
