"""The device trace of a ``--trace 1`` run, reduced to what readers need.

``torch.profiler`` records the card's activity (kernels, copies, sets) by
CUPTI from before the window opens until the backlog has drained; the
profiler is started and stopped only outside the window (started from
another thread while a loop served, it recorded no kernel on one run of
six).  The trace's clock is tied to the loop's by marker kernels
(``torch.cuda._sleep``) launched on an idle card before the window and
after the drain: a marker's device start is taken as the host time of its
launch, and the two fix the offset and the rate.  A window of 1.2-1.6
million activities can fill the profiler's buffer, which then drops what
comes after (one run of six lost its last marker): the traced span then
ends where the record ends, the start marker alone fixing the offset.
Busy time is the union of the activity intervals inside the span (as
``repro_torch.serving.profile`` takes it); the idle gaps between them are
named by what the host was doing at their middle, from the loop's own
record: sleeping until the next arrival, issuing a batch's launches,
waiting on the card, or between batches.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import re
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

MARKER = "spin_kernel"
GEMM = re.compile(r"gemm|nvjet|cutlass|xmma|splitkreduce|cublas", re.I)
FLASH = re.compile(r"::flash_(?:bf16|fp32)<(\d+)>")


@dataclasses.dataclass
class Trace:
    start: float           # the traced span, seconds from the window's start
    window_s: float        # its length
    busy_s: float
    by_name: dict          # kernel name -> [count, seconds]
    gaps: dict             # host activity -> idle seconds
    activity: list         # (name, start, end), seconds from the window's start


def _union(intervals) -> float:
    busy, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    return busy


class Tracer:
    """The profiler around a window; ``stop`` returns the activity as
    (name, start, end) in ``time.perf_counter`` seconds, and the host time
    at which the record ends."""

    def __init__(self):
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.marks = []
        self.stop_s = 0.0  # the profiler's stop, which parses its buffers

    def _mark(self):
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def start(self):
        self.prof.start()
        self._mark()

    def stop(self):
        self._mark()
        t = time.perf_counter()
        self.prof.stop()
        self.stop_s = time.perf_counter() - t
        cuda = DeviceType.CUDA
        events, marks = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            name = e.name()
            if MARKER in name:
                marks.append(e.start_ns())
            else:
                events.append((name, e.start_ns(), e.end_ns()))
        if not marks:
            raise RuntimeError("trace: no marker kernel recorded")
        # device ns -> host seconds: the offset from the first marker, the
        # rate from both when the record reaches the second
        marks.sort()
        d0, h0 = marks[0], self.marks[0]
        rate = 1.0
        if len(marks) == 2 and marks[1] > d0:
            rate = (self.marks[1] - h0) / ((marks[1] - d0) * 1e-9)
        scale = 1e-9 * rate
        activity = [(n, h0 + (a - d0) * scale, h0 + (b - d0) * scale)
                    for n, a, b in events]
        end = self.marks[1] if len(marks) == 2 else max(
            (a for _, a, _ in activity), default=h0)
        return activity, end


def _phases(sides, t0):
    """(start, end, what) of the host's activity, in perf_counter s."""
    out = []
    for s in sides:
        out += [(t0 + a, t0 + b, "waiting for arrivals") for a, b in s.waits]
        for bt in s.batches:
            out.append((t0 + bt.dispatch, t0 + bt.launched,
                        f"issuing {s.name} L{bt.length}"))
            out.append((t0 + bt.launched, t0 + bt.done,
                        f"waiting on the card {s.name}"))
    return sorted(out)


def reduce(activity, sides, t0: float, ts: float, t1: float) -> Trace:
    """The span [ts, t1) of ``Tracer.stop``'s activity, in a window that
    starts at ``t0``."""
    inside = [(n, max(a, ts), min(b, t1)) for n, a, b in activity
              if b > ts and a < t1]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for n, a, b in inside:
        by_name[n][0] += 1
        by_name[n][1] += b - a
    spans = sorted((a, b) for _, a, b in inside)
    busy = _union(spans)
    phases = _phases(sides, t0)
    starts = [p[0] for p in phases]
    gaps = collections.defaultdict(float)
    reach = ts
    for a, b in spans + [(t1, t1)]:
        if a > reach:
            mid = (reach + a) / 2
            k = bisect.bisect_right(starts, mid) - 1
            what = (phases[k][2] if k >= 0 and phases[k][1] >= mid
                    else "between batches")
            gaps[what] += a - reach
        reach = max(reach, b)
    return Trace(ts - t0, t1 - ts, busy, dict(by_name), dict(gaps),
                 [(n, a - t0, b - t0) for n, a, b in inside])


def kernel_seconds(trace: Trace, pattern) -> tuple[int, float]:
    """(calls, seconds) of the kernels whose name matches ``pattern``."""
    hits = [v for n, v in trace.by_name.items() if pattern.search(n)]
    return sum(c for c, _ in hits), sum(s for _, s in hits)
