"""Schema validation for exported forensics artifacts (CI gate).

``python -m repro.obs.validate <trace-dir>`` checks every artifact a
``--trace-dir`` run produced:

* ``*.trace.json``       — loads as JSON; has a ``traceEvents`` list;
  every slice has finite ``ts >= 0`` and ``dur >= 0``; within each
  (pid, tid) track, slices are sequenced (non-decreasing ``ts``); at
  least one per-node process and per-let thread track exists.
* ``*.timeseries.jsonl`` — every line parses; required keys present;
  counters non-negative; rows time-sorted.
* ``*.attribution.json`` — loads; lifecycle closure holds (every
  terminal-status request carries a closing resolve stamp:
  ``closed == terminal``); the component-sum identity error is within
  float tolerance.

Exit status 0 = all artifacts valid; 1 otherwise, with one line per
failure.
"""
from __future__ import annotations

import glob
import json
import math
import os
import sys

TIMESERIES_KEYS = ("t_ms", "node", "queue_depth", "busy_ms",
                   "backlog_ms", "dispatched", "completed", "attained",
                   "drops", "preempts", "migrations")
IDENTITY_TOL_MS = 1e-6


def validate_trace_file(path: str) -> list[str]:
    errs: list[str] = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: not valid JSON ({e})"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return [f"{path}: missing traceEvents list"]
    last_ts: dict[tuple, float] = {}
    pids: set = set()
    let_tracks: set = set()
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        pids.add(ev.get("pid"))
        if ph == "M":
            if ev.get("name") == "thread_name" \
                    and "gpu-let" in str(ev.get("args", {}).get("name")):
                let_tracks.add((ev.get("pid"), ev.get("tid")))
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or not math.isfinite(ts) \
                or ts < 0:
            errs.append(f"{path}: event {i} has bad ts={ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) \
                    or not math.isfinite(dur) or dur < 0:
                errs.append(f"{path}: slice {i} has bad dur={dur!r}")
            key = (ev.get("pid"), ev.get("tid"))
            if ts + 1e-9 < last_ts.get(key, -math.inf):
                errs.append(f"{path}: slice {i} out of sequence on "
                            f"track {key} (ts={ts})")
            last_ts[key] = ts
    if not pids:
        errs.append(f"{path}: no per-node process tracks")
    if not let_tracks:
        errs.append(f"{path}: no per-let thread tracks")
    return errs


def validate_timeseries(path: str) -> list[str]:
    errs: list[str] = []
    prev_t = -math.inf
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            try:
                row = json.loads(line)
            except ValueError as e:
                errs.append(f"{path}:{ln}: bad JSON ({e})")
                continue
            missing = [k for k in TIMESERIES_KEYS if k not in row]
            if missing:
                errs.append(f"{path}:{ln}: missing keys {missing}")
                continue
            if row["t_ms"] < prev_t:
                errs.append(f"{path}:{ln}: rows not time-sorted")
            prev_t = row["t_ms"]
            for k in ("queue_depth", "dispatched", "completed",
                      "attained", "drops", "preempts", "migrations"):
                if row[k] < 0:
                    errs.append(f"{path}:{ln}: negative {k}={row[k]}")
    return errs


def validate_attribution(path: str) -> list[str]:
    errs: list[str] = []
    try:
        with open(path) as f:
            report = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: not valid JSON ({e})"]
    life = report.get("lifecycle", {})
    if life.get("closed") != life.get("terminal"):
        errs.append(
            f"{path}: lifecycle not closed — {life.get('closed')} closing "
            f"spans for {life.get('terminal')} terminal requests")
    err = report.get("identity_max_abs_err_ms", math.inf)
    if not (err <= IDENTITY_TOL_MS):
        errs.append(f"{path}: attribution identity error {err} ms "
                    f"exceeds {IDENTITY_TOL_MS}")
    return errs


def validate_dir(trace_dir: str) -> list[str]:
    errs: list[str] = []
    traces = glob.glob(os.path.join(trace_dir, "*.trace.json"))
    if not traces:
        return [f"{trace_dir}: no *.trace.json artifacts found"]
    for p in sorted(traces):
        errs.extend(validate_trace_file(p))
    for p in sorted(glob.glob(os.path.join(trace_dir,
                                           "*.timeseries.jsonl"))):
        errs.extend(validate_timeseries(p))
    for p in sorted(glob.glob(os.path.join(trace_dir,
                                           "*.attribution.json"))):
        errs.extend(validate_attribution(p))
    return errs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro.obs.validate <trace-dir>")
        return 2
    errs = validate_dir(argv[0])
    for e in errs:
        print(f"INVALID: {e}")
    if errs:
        return 1
    n = len(glob.glob(os.path.join(argv[0], "*.trace.json")))
    print(f"obs-validate OK: {n} trace(s) in {argv[0]} pass the span "
          f"schema (sequenced, non-negative durations, lifecycle closed)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
