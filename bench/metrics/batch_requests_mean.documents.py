"""``batch_requests_mean`` in granite.documents, moving
``goodput_rps`` there: the same reader."""
from bench import spec

_read = spec.reader("batch_requests_mean")


def read(run):
    return _read(run)
