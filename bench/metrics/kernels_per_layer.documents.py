"""``kernels_per_layer`` in granite.documents, moving
``goodput_rps`` there: the same reader."""
from bench import spec

_read = spec.reader("kernels_per_layer")


def read(run):
    return _read(run)
