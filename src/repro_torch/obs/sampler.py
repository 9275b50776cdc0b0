"""Fleet time-series sampler: per-node/per-let telemetry at a cadence.

Post-hoc sampling: the sampler reads the lifecycle timeline, the nodes'
typed span logs, and the router's fluid-backlog samples *after* a run
and bins them at ``cadence_ms`` — the serving hot path is never
perturbed (nothing runs per-event during simulation), yet the series
are exact because every underlying event carries its own timestamp.

One JSONL row per (time bin, node):

* ``queue_depth``      — requests at the node not yet launched/resolved
  at the bin's end (arrival → min(first_launch, resolve) occupancy).
* ``busy_ms``          — per-let dict of batch/decode execution overlap
  with the bin (``busy_ms[let] / cadence_ms`` = occupancy fraction).
* ``backlog_ms``       — router fluid-backlog estimate, last sample in
  or before the bin.
* ``dispatched`` / ``completed`` / ``attained`` — request counts whose
  dispatch / completion landed in the bin (``attained`` = completed
  within SLO).
* ``promised_req_s`` / ``attained_req_s`` — the placement's admitted
  rate vs what the node actually delivered this bin.
* ``drops`` / ``preempts`` / ``migrations`` — event counters.
"""
from __future__ import annotations

import json

import numpy as np

DEFAULT_CADENCE_MS = 250.0


def _bin_counts(times_ms: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Histogram of finite event times into the cadence bins."""
    t = times_ms[np.isfinite(times_ms)]
    if not t.size:
        return np.zeros(len(edges) - 1, dtype=np.int64)
    return np.histogram(t, bins=edges)[0]


def _busy_per_let(spans, edges: np.ndarray) -> dict[int, np.ndarray]:
    """Per-let execution-time overlap with each bin, from batch spans."""
    nbins = len(edges) - 1
    lo, hi = edges[0], edges[-1]
    width = edges[1] - edges[0] if nbins else 1.0
    out: dict[int, np.ndarray] = {}
    for e in spans:
        kind = e[0]
        if kind != "batch" and kind != "decode":
            continue
        let, launch, done = e[2], e[3], e[4]
        if done <= lo or launch >= hi:
            continue
        acc = out.get(let)
        if acc is None:
            acc = out[let] = np.zeros(nbins)
        b0 = max(int((launch - lo) // width), 0)
        b1 = min(int((done - lo) // width), nbins - 1)
        for b in range(b0, b1 + 1):
            acc[b] += max(0.0, min(done, edges[b + 1])
                          - max(launch, edges[b]))
    return out


def sample_fleet(trace, nodes, horizon_ms: float,
                 cadence_ms: float = DEFAULT_CADENCE_MS,
                 migration_events=()) -> list[dict]:
    """Bin the run's telemetry; returns JSON-ready rows sorted by time.

    ``nodes`` are fabric nodes (``node_id``, ``rate_by_model``,
    ``total_rate``, and a ``span_log`` captured from their engines);
    ``trace.obs`` must hold the run's timeline.
    """
    from repro_torch.simulator.trace import FIRST_DROP_STATUS

    tl = trace.obs
    if tl is None:
        raise ValueError("trace has no timeline attached")
    nbins = max(int(np.ceil(horizon_ms / cadence_ms)), 1)
    edges = np.arange(nbins + 1, dtype=np.float64) * cadence_ms
    cadence_s = cadence_ms / 1e3

    # router backlog samples, grouped per node, time-sorted
    rlog = sorted(tl.router_log)
    rl_t = np.array([s[0] for s in rlog])
    rl_node = np.array([s[1] for s in rlog], dtype=np.int64) \
        if rlog else np.empty(0, dtype=np.int64)
    rl_val = np.array([s[2] for s in rlog])

    mig_by_node: dict[int, np.ndarray] = {}
    for ev in migration_events:
        mig_by_node.setdefault(ev.node_id, [])
    for ev in migration_events:
        mig_by_node[ev.node_id].append(ev.t_cut_ms)

    ok = ~trace.violated()
    rows: list[dict] = []
    for node in nodes:
        nid = node.node_id
        mine = tl.node == nid
        arr = trace.arrival_ms[mine]
        start = np.where(np.isfinite(tl.t_dispatch_ms[mine]),
                         tl.t_dispatch_ms[mine], arr)
        stop = np.fmin(tl.first_launch_ms[mine], tl.resolve_ms[mine])
        stop = np.where(np.isfinite(stop), stop, horizon_ms)
        depth = np.cumsum(_bin_counts(start, edges)
                          - _bin_counts(stop, edges))

        done = trace.completion_ms[mine]
        completed = _bin_counts(done, edges)
        attained = _bin_counts(np.where(ok[mine], done, np.nan), edges)
        dispatched = _bin_counts(start, edges)
        dropped = trace.status[mine] >= FIRST_DROP_STATUS
        drops = _bin_counts(np.where(dropped, tl.resolve_ms[mine],
                                     np.nan), edges)

        spans = getattr(node, "span_log", None) or []
        busy = _busy_per_let(spans, edges)
        pre_t = np.array([e[1] for e in spans if e[0] == "preempt"])
        preempts = _bin_counts(pre_t, edges)

        node_rl = rl_node == nid
        nrt, nrv = rl_t[node_rl], rl_val[node_rl]
        migs = _bin_counts(np.asarray(mig_by_node.get(nid, []),
                                      dtype=np.float64), edges)
        promised = float(getattr(node, "total_rate", 0.0))
        for b in range(nbins):
            t_end = float(edges[b + 1])
            k = int(np.searchsorted(nrt, t_end, side="right")) - 1
            rows.append({
                "t_ms": t_end,
                "node": int(nid),
                "queue_depth": int(depth[b]),
                "busy_ms": {str(let): round(float(v[b]), 3)
                            for let, v in sorted(busy.items())},
                "backlog_ms": round(float(nrv[k]), 3) if k >= 0 else 0.0,
                "dispatched": int(dispatched[b]),
                "completed": int(completed[b]),
                "attained": int(attained[b]),
                "promised_req_s": promised,
                "attained_req_s": float(attained[b]) / cadence_s,
                "drops": int(drops[b]),
                "preempts": int(preempts[b]),
                "migrations": int(migs[b]),
            })
    rows.sort(key=lambda r: (r["t_ms"], r["node"]))
    return rows


def write_jsonl(rows: list[dict], path: str) -> None:
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
