"""The port's host spans of a traced window, on the device trace's clock.

The port records its spans (``repro_torch.obs.host``: ``step`` around each
call of ``Model.forward`` / ``prefill``, ``block`` around each layer, and
the parts of a layer inside it) exactly while a torch profiler records, so
a ``--trace 1`` run holds the window's spans beside its device trace and a
``--trace 0`` run holds none.  A program without the recorder gives no
spans, and every reader of them returns None.

Pairing: a side's loop runs on the thread named after the side, and its
k-th batch is that thread's k-th ``step``, so each side's ``step`` spans
pair in order with ``side.batches``; where the counts differ nothing
pairs.  Origin: the spans are ``time.perf_counter`` seconds, the loop's
record and the reduced trace seconds from the window's start.  That start
is the median over batches of ``step.end - batch.launched``: the loop
stamps ``launched`` just after it issued the argmax on the step's output,
so the origin errs early by that issue, some microseconds.

    python3 -m bench.spans --workload hubert.clips --seed 7 --seconds 51

(with ``PYTHONPATH=src``) runs one traced window of a cell, as ``run.py
--trace 1`` does less the output check, and prints one JSON line: the
cell's per-layer metrics and, per span name, the host's self time and the
card's idle time under it (``tables``).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import statistics

OUTSIDE = "outside any span"


@dataclasses.dataclass
class Window:
    origin: float   # the window's start, time.perf_counter seconds
    pairs: list     # (side, batch, its step span), every side's in order
    spans: list     # every span of the session


def recorded():
    """The port's spans of its newest profiled window, or None where the
    port has no recorder."""
    try:
        from repro_torch.obs import host
    except ImportError:
        return None
    return host.spans()


def window(run) -> Window | None:
    """The traced run's spans paired with its batches, or None without a
    trace, without spans, or where a side's steps and batches differ in
    number."""
    if run.trace is None:
        return None
    spans = recorded()
    if not spans or any(s.end is None for s in spans):
        return None
    pairs = []
    for side in run.sides:
        steps = [s for s in spans
                 if s.name == "step" and s.thread == side.name]
        if not steps or len(steps) != len(side.batches):
            return None
        pairs += list(zip([side] * len(steps), side.batches, steps))
    origin = statistics.median(st.end - b.launched for _, b, st in pairs)
    return Window(origin, pairs, spans)


def n_layers(side) -> int:
    return side.entry_spec["fields"]["n_layers"]


def idle_intervals(trace) -> list[tuple[float, float]]:
    """The traced span less the union of its activity, as sorted disjoint
    intervals (seconds from the window's start)."""
    out, reach = [], trace.start
    for a, b in sorted((a, b) for _, a, b in trace.activity):
        if a > reach:
            out.append((reach, a))
        reach = max(reach, b)
    end = trace.start + trace.window_s
    if end > reach:
        out.append((reach, end))
    return out


def overlap(intervals, segments) -> dict:
    """Seconds of the sorted disjoint ``intervals`` under each label of the
    sorted disjoint ``segments`` (start, end, label)."""
    out = collections.defaultdict(float)
    j = 0
    for a, b, label in segments:
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < b:
            out[label] += min(b, intervals[k][1]) - max(a, intervals[k][0])
            k += 1
    return dict(out)


def innermost(spans, thread: str, origin: float) -> list:
    """The thread's spans cut into the parts no child covers, as sorted
    disjoint (start, end, name) in seconds from the window's start: at
    each instant the innermost span open."""
    children = collections.defaultdict(list)
    mine = [i for i, s in enumerate(spans) if s.thread == thread]
    for i in mine:
        if spans[i].parent is not None:
            children[spans[i].parent].append(spans[i])
    out = []
    for i in mine:
        s, at = spans[i], spans[i].start
        for c in children[i]:
            out.append((at - origin, c.start - origin, s.name))
            at = c.end
        out.append((at - origin, s.end - origin, s.name))
    return sorted(seg for seg in out if seg[1] > seg[0])


def idle_by_span(run, side: int = 0) -> dict | None:
    """The traced span's idle seconds, each given to the innermost span
    open on side ``side``'s thread at that instant, and to ``OUTSIDE``
    where none is."""
    w = window(run)
    if w is None:
        return None
    idle = idle_intervals(run.trace)
    out = overlap(idle, innermost(w.spans, run.sides[side].name, w.origin))
    out[OUTSIDE] = sum(b - a for a, b in idle) - sum(out.values())
    return out


def self_seconds(run, side: int = 0) -> dict | None:
    """Each span name's host self time on side ``side``'s thread: its
    spans' durations less their children's."""
    w = window(run)
    if w is None:
        return None
    out = collections.defaultdict(float)
    for a, b, name in innermost(w.spans, run.sides[side].name, w.origin):
        out[name] += b - a
    return dict(out)


def busy_after_step(run) -> list[float] | None:
    """For each batch, the card's busy seconds after its ``step`` span
    closed: the launches still queued when the host stopped issuing."""
    w = window(run)
    if w is None:
        return None
    acts = sorted((a, b) for _, a, b in run.trace.activity)
    starts = [a for a, _ in acts]
    out = []
    for _, b, st in w.pairs:
        lo, hi = st.start - w.origin, st.end - w.origin
        busy, reach = 0.0, hi
        for a, e in acts[bisect.bisect_left(starts, lo):
                         bisect.bisect_right(starts, b.done)]:
            if e > reach:
                busy += e - max(a, reach)
                reach = e
        out.append(busy)
    return out


def span_cost_us(n: int = 20000) -> float | None:
    """Host microseconds to open and close one recorded span, inside a
    recorded step (the profiler on, recording the CPU).  Its spans join
    the record: read the window's first."""
    import time

    from torch.profiler import ProfilerActivity, profile
    try:
        from repro_torch.obs import host
    except ImportError:
        return None
    with profile(activities=[ProfilerActivity.CPU]):
        with host.step("forward", 0, 0):
            t = time.perf_counter()
            for _ in range(n):
                if host.on and host.open("norm"):
                    host.close()
            dt = time.perf_counter() - t
    return dt / n * 1e6


def tables(run) -> dict | None:
    """What the host issued while the card sat idle, for each side."""
    w = window(run)
    if w is None:
        return None
    offsets = [(st.end - b.launched - w.origin) * 1e6 for _, b, st in w.pairs]
    q = statistics.quantiles(offsets, n=4)
    after = busy_after_step(run)
    return {
        "origin_iqr_us": q[2] - q[0], "spans": len(w.spans),
        "batches": len(w.pairs),
        "busy_after_step_s": sum(after),
        "busy_after_step_ms_p50": statistics.median(after) * 1e3,
        "idle_s": sum(b - a for a, b in idle_intervals(run.trace)),
        "sides": {s.name: {"host_self_s": self_seconds(run, i),
                           "idle_s": idle_by_span(run, i)}
                  for i, s in enumerate(run.sides)}}


def main(argv=None):
    import argparse
    import json
    import sys
    import time

    t_start = time.perf_counter()
    import torch

    from bench import cell as cell_mod
    from bench import spec
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench/spans.py: no CUDA card")
    cell = spec.load_cell(args.workload)
    sides, _ = cell_mod.build(cell, args.seed, args.seconds)
    run = cell_mod.window(cell, sides, args.seconds, True, t_start)
    cell_mod.report(run)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "device": run.device_kind,
        "metrics": {k: v["value"] for k, v in
                    cell_mod.metrics(run, True).items()},
        "busy_s": run.trace.busy_s, "window_s": run.trace.window_s,
        "tables": tables(run),
        # last: its profiler session replaces the window's spans
        "span_cost_us": span_cost_us()}), flush=True)


if __name__ == "__main__":
    main()
