"""Median of every measured request's latency, as ``latency_p95_ms``."""
import numpy as np


def read(run):
    lat = run.latencies_s()
    return float(np.percentile(lat, 50) * 1e3) if len(lat) else None
