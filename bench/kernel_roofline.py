"""A kernel's share of its roofline over the batches a trace holds whole,
for the readers of one kernel in one cell (``metrics/*_roofline.*.py``).

A batch counts only where every call it makes of the kernel falls inside
it (dispatch to output on the host): ``calls(entry)`` of them, the number
of layers that launch the kernel, not the model's layers (granite's flash
kernel runs in 4 of its 40).  Its calls' least time (``bound_s(entry,
batch, length, peak)``: the larger of their bytes and their operations
over the card's peaks) is summed over those batches and divided by the
device time of the calls whose name matches ``pattern``.
"""
from __future__ import annotations

import bisect


def share(run, pattern, calls, bound_s):
    peak = run.peak
    if run.trace is None or peak is None:
        return None
    bound = secs = 0.0
    for s in run.sides:
        n = calls(s.entry_spec)
        if not n:
            continue
        found = sorted((a, b - a) for name, a, b in run.trace.activity
                       if pattern.search(name))
        starts = [a for a, _ in found]
        for b in s.batches:
            if b.dispatch < run.trace.start:
                continue
            lo = bisect.bisect_left(starts, b.dispatch)
            hi = bisect.bisect_right(starts, b.done)
            if hi - lo != n:
                continue
            bound += bound_s(s.entry_spec, len(b.rids), b.length, peak)
            secs += sum(d for _, d in found[lo:hi])
    return 100.0 * bound / secs if secs > 0 else None


def least_s(cost: tuple[int, int], peak: dict) -> float:
    """The least time of (operations, bytes) on the card."""
    ops, nbytes = cost
    return max(ops / peak["bf16_flops"], nbytes / peak["hbm_bytes_per_s"])


def kinds(entry: dict) -> list:
    return list(entry["fields"].get("layer_kinds", ()))
