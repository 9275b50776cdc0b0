"""``device_idle_pct`` in granite.documents, moving
``goodput_rps`` there: the same reader."""
from bench import spec

_read = spec.reader("device_idle_pct")


def read(run):
    return _read(run)
