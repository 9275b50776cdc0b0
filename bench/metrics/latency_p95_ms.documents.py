"""``latency_p95_ms`` in granite.documents, moving
``goodput_rps`` there: the same reader."""
from bench import spec

_read = spec.reader("latency_p95_ms")


def read(run):
    return _read(run)
