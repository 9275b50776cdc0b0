"""``queue_wait_ms_p50`` in granite.documents, moving
``goodput_rps`` there: the same reader."""
from bench import spec

_read = spec.reader("queue_wait_ms_p50")


def read(run):
    return _read(run)
