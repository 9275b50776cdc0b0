"""The GEMM kernels' (cuBLAS, matched by name) share of the card's busy
time in the traced window."""
from bench import trace


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    _, secs = trace.kernel_seconds(run.trace, trace.GEMM)
    return 100.0 * secs / run.trace.busy_s if secs else None
