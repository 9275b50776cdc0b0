"""The kernels' ``meta`` route: what a launch costs, on tensors that hold
no data.

A tensor on torch's ``meta`` device has a shape, a dtype and strides and
no memory.  ``kernels/ops.py`` hands one to the kernel module's ``*_meta``
function, which returns outputs of the kernel's shapes and dtypes, allocates
on ``meta`` the scratch the CUDA wrapper allocates, computes nothing, and
charges the launch's cost (operations, bytes: the module's ``cost`` formula)
to the ledger of the open ``pricing()`` block, if any.  The dry run
(``launch/dryrun.py``) prices a step this way.

``plain(fn)`` wraps a plain version, the CPU route of a kernel: while it
runs, the current thread is inside a kernel (``inside()``), and the dry
run's counters skip its aten ops, so a CPU run counts only the work
outside the kernels, as a meta run does (the CUDA and meta routes run no
aten op but their outputs' allocation).
"""
from __future__ import annotations

import contextlib
import functools
import threading

_ledger: list | None = None  # (kernel, operations, bytes) a call, if open


@contextlib.contextmanager
def pricing():
    """Collect the cost of every meta launch in the block: yields the list
    of (kernel, operations, bytes) it fills."""
    global _ledger
    outer, _ledger = _ledger, []
    try:
        yield _ledger
    finally:
        _ledger = outer


def charge(kernel: str, cost: tuple[int, int]):
    """Add one launch of ``kernel`` costing (operations, bytes)."""
    if _ledger is not None:
        _ledger.append((kernel, *cost))


class _Depth(threading.local):
    value = 0


_depth = _Depth()


def plain(fn):
    """``fn`` (a kernel's plain version), run inside a kernel."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        _depth.value += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _depth.value -= 1

    return run


def inside() -> bool:
    """Whether the current thread is inside a kernel's plain version."""
    return _depth.value > 0
