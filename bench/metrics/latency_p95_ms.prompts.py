"""``latency_p95_ms`` in the cells whose end-to-end metrics leave latency
out: the same reader, moving ``goodput_rps`` there."""
from bench import spec

_read = spec.reader("latency_p95_ms")


def read(run):
    return _read(run)
