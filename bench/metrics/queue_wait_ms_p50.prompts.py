"""``queue_wait_ms_p50`` in the cells whose end-to-end metrics leave latency
out: the same reader, moving ``goodput_rps`` there."""
from bench import spec

_read = spec.reader("queue_wait_ms_p50")


def read(run):
    return _read(run)
