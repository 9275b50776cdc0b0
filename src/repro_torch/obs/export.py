"""Chrome-trace / Perfetto export of gpu-let timelines + run artifacts.

``export_chrome_trace`` renders a served run as Trace Event Format JSON
(load it at https://ui.perfetto.dev or ``chrome://tracing``): one
*process* track per fabric node, one *thread* track per gpu-let, with
batch and decode launches as complete ("X") slices, preemptions /
drops / schedule installs / migrations as instant events.

``dump_run`` is the one-call forensics sink behind the benchmarks'
``--trace-dir`` flag: it writes three artifacts per run label —

* ``<label>.trace.json``       — the Chrome trace;
* ``<label>.timeseries.jsonl`` — the fleet sampler's cadence rows;
* ``<label>.attribution.json`` — the per-model SLO-miss attribution
  report (``collect_attribution``), including the lifecycle-closure
  counts the validator checks.
"""
from __future__ import annotations

import json
import os

#: tid for node-level instants (drops, applies, migrations) — far above
#: any real gpu-let index so the track sorts last within its process
EVENTS_TID = 9_999


def _span_events(nid: int, spans) -> list[dict]:
    events: list[dict] = []
    lets: set[int] = set()
    for e in spans:
        kind = e[0]
        if kind == "batch" or kind == "decode":
            let = int(e[2])
            lets.add(let)
            ev = {"name": e[5], "cat": kind, "ph": "X", "pid": nid,
                  "tid": let, "ts": e[3] * 1e3,
                  "dur": max(e[4] - e[3], 0.0) * 1e3,
                  "args": {"epoch": int(e[1]), "n": int(e[6])}}
            if kind == "decode":
                ev["args"]["steps"] = int(e[7])
            events.append(ev)
        elif kind == "preempt":
            let = int(e[2])
            lets.add(let)
            events.append({"name": f"preempt {e[3]}", "cat": "preempt",
                           "ph": "i", "s": "t", "pid": nid, "tid": let,
                           "ts": e[1] * 1e3, "args": {"n": int(e[4])}})
        elif kind == "drop":
            events.append({"name": f"drop {e[2]}", "cat": "drop",
                           "ph": "i", "s": "t", "pid": nid,
                           "tid": EVENTS_TID, "ts": e[1] * 1e3})
        elif kind == "apply":
            events.append({"name": "apply schedule", "cat": "apply",
                           "ph": "i", "s": "p", "pid": nid,
                           "tid": EVENTS_TID, "ts": e[1] * 1e3})
        elif kind == "tick":
            events.append({"name": "tick", "cat": "tick", "ph": "i",
                           "s": "t", "pid": nid, "tid": EVENTS_TID,
                           "ts": e[1] * 1e3,
                           "args": {"resched": bool(e[2])}})
    for let in sorted(lets):
        events.append({"name": "thread_name", "ph": "M", "pid": nid,
                       "tid": let,
                       "args": {"name": f"gpu-let {let}"}})
    events.append({"name": "thread_name", "ph": "M", "pid": nid,
                   "tid": EVENTS_TID, "args": {"name": "events"}})
    return events


def export_chrome_trace(nodes, migration_events=(), path=None) -> dict:
    """Build (and optionally write) the Chrome trace document.

    ``nodes`` carry a ``span_log`` (typed span records captured from
    their engines after the run); pass ``path`` to write the JSON.
    """
    events: list[dict] = []
    for node in nodes:
        nid = int(node.node_id)
        events.append({"name": "process_name", "ph": "M", "pid": nid,
                       "args": {"name": f"node {nid}"}})
        events.extend(_span_events(nid, getattr(node, "span_log", None)
                                   or []))
    for ev in migration_events:
        events.append({
            "name": f"migration +{len(ev.added)}/-{len(ev.removed)}",
            "cat": "migration", "ph": "i", "s": "g",
            "pid": int(ev.node_id), "tid": EVENTS_TID,
            "ts": ev.t_cut_ms * 1e3,
            "args": {"t_apply_ms": ev.t_apply_ms,
                     "added": [m for m, _ in ev.added],
                     "removed": list(ev.removed)}})
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
    return doc


def dump_run(trace_dir: str, label: str, trace, nodes, horizon_ms: float,
             migration_events=(), cadence_ms=None) -> dict[str, str]:
    """Write the full forensics artifact set for one run; returns paths."""
    from repro_torch.obs.attribution import collect_attribution
    from repro_torch.obs.sampler import DEFAULT_CADENCE_MS, sample_fleet, \
        write_jsonl

    os.makedirs(trace_dir, exist_ok=True)
    paths = {
        "trace": os.path.join(trace_dir, f"{label}.trace.json"),
        "timeseries": os.path.join(trace_dir,
                                   f"{label}.timeseries.jsonl"),
        "attribution": os.path.join(trace_dir,
                                    f"{label}.attribution.json"),
    }
    export_chrome_trace(nodes, migration_events, path=paths["trace"])
    rows = sample_fleet(trace, nodes, horizon_ms,
                        cadence_ms=cadence_ms or DEFAULT_CADENCE_MS,
                        migration_events=migration_events)
    write_jsonl(rows, paths["timeseries"])
    with open(paths["attribution"], "w") as f:
        json.dump(collect_attribution(trace), f, indent=2)
        f.write("\n")
    return paths
