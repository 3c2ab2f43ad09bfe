"""``serve_p95_ms``: the 95th percentile, over every request due in the
window, of the time from when it was due to when its answer arrived (host
clock).  A request never answered counts with the time it was waited for."""

import numpy as np


def read(obs, name):
    if obs["kind"] != "serve" or not len(obs["latencies_ms"]):
        return None
    return float(np.percentile(obs["latencies_ms"], 95))
