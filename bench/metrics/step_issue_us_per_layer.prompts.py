"""``step_issue_us_per_layer`` in the cells whose end-to-end metrics leave
latency out: the same reader, moving ``goodput_rps`` there."""
from bench import spec

_read = spec.reader("step_issue_us_per_layer")


def read(run):
    return _read(run)
