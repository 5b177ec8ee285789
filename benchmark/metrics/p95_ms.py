"""p95_ms: the 95th percentile of the latency of every request completed
in the window, from the client's call until its results are on the host."""

import numpy as np


def read(run):
    lat = [(d.t1 - d.t0) * 1e3 for d in run.window.done]
    return float(np.percentile(lat, 95)) if lat else None
