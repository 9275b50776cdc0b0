"""95th percentile of every measured request's latency, due time to the
output on the host; a failed request counts at its cut (host clock)."""
import numpy as np


def read(run):
    lat = run.latencies_s()
    return float(np.percentile(lat, 95) * 1e3) if len(lat) else None
