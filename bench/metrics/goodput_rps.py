"""Requests of the measured set done within their model's SLO, a second
of the window (host clock)."""
import numpy as np


def read(run):
    met = sum(int(np.sum(s.done - s.sched.due <= s.slo_s)) for s in run.sides)
    return met / run.seconds
