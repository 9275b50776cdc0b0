"""``flash_roofline`` in the cells whose end-to-end metrics leave latency
out: the same reader, moving ``goodput_rps`` there."""
from bench import spec

_read = spec.reader("flash_roofline")


def read(run):
    return _read(run)
