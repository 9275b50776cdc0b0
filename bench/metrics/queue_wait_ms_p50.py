"""Median wait of a measured request from its due time to its batch's
dispatch, from the serving loop's own record (host clock)."""
import numpy as np


def read(run):
    waits = np.concatenate([s.dispatch - s.sched.due for s in run.sides])
    waits = waits[~np.isnan(waits)]
    return float(np.median(waits) * 1e3) if len(waits) else None
