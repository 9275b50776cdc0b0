"""``idle_in_step_pct`` in the cells whose end-to-end metrics leave
latency out: the same reader, moving ``goodput_rps`` there."""
from bench import spec

_read = spec.reader("idle_in_step_pct")


def read(run):
    return _read(run)
