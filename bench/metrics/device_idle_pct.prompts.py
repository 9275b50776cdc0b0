"""``device_idle_pct`` in the cells whose end-to-end metrics leave latency
out: the same reader, moving ``goodput_rps`` there."""
from bench import spec

_read = spec.reader("device_idle_pct")


def read(run):
    return _read(run)
