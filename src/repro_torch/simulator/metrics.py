"""SLO/throughput accounting for simulated serving runs.

Two collection paths produce identical :class:`SimMetrics`:

* :func:`collect` — object edge: a Python loop over ``Request`` (or
  ``RequestView``) instances.  Fine for tests and small traces.
* :func:`collect_arrays` / :func:`collect_trace` — the hot path: O(1)
  vectorized accumulation (masked ``bincount`` reductions) over the
  struct-of-arrays trace, no per-request Python.  A million-request
  fleet reduces in milliseconds instead of seconds.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.simulator.events import Request

#: percentile levels reported everywhere a latency distribution reduces
PCT_LEVELS = (50, 95, 99)


def _pcts(values: np.ndarray) -> dict:
    """{"p50", "p95", "p99"} of ``values`` (empty -> zeros)."""
    if values.size == 0:
        return {f"p{q}": 0.0 for q in PCT_LEVELS}
    return {f"p{q}": float(np.percentile(values, q)) for q in PCT_LEVELS}


@dataclasses.dataclass
class SimMetrics:
    horizon_ms: float
    total: int = 0
    completed: int = 0
    dropped: int = 0
    slo_violations: int = 0       # completed late + dropped
    preempted: int = 0            # requests whose batch was ever preempted
    per_model: dict = dataclasses.field(default_factory=dict)
    #: priority level -> dict(total, completed, dropped, violations,
    #: preempted); single-class traces collapse to one level-0 entry.
    per_class: dict = dataclasses.field(default_factory=dict)
    busy_ms_per_gpulet: dict = dataclasses.field(default_factory=dict)
    #: model -> {"p50", "p95", "p99"} latency percentiles over completed
    #: requests (kept out of ``per_model`` so pre-existing golden records
    #: stay byte-identical)
    latency_ms_per_model: dict = dataclasses.field(default_factory=dict)

    def class_violation_rate(self, level: int) -> float:
        pc = self.per_class.get(level)
        if not pc or not pc["total"]:
            return 0.0
        return pc["violations"] / pc["total"]

    @property
    def violation_rate(self) -> float:
        return self.slo_violations / self.total if self.total else 0.0

    @property
    def goodput_req_s(self) -> float:
        """Requests completed within SLO, per second."""
        ok = self.completed - (self.slo_violations - self.dropped)
        return ok / (self.horizon_ms / 1e3) if self.horizon_ms else 0.0

    @property
    def throughput_req_s(self) -> float:
        return self.completed / (self.horizon_ms / 1e3) if self.horizon_ms else 0.0


def window_metrics(requests: list[Request], window_ms: float,
                   n_windows: int,
                   horizon_ms: float | None = None) -> list[SimMetrics]:
    """Per-window SimMetrics sliced out of one continuous event stream.

    Requests are bucketed by *arrival* window (a request arriving in window
    k counts there even if it completes in k+1 — with the event engine there
    is no per-window simulator restart, so windows share in-flight state).
    Arrivals beyond the last window boundary fold into the final window;
    pass ``horizon_ms`` so that window's rates are normalized by its true
    span (``horizon_ms - (n_windows - 1) * window_ms``) instead of one
    period.

    Arrivals *before* t=0 (replay rewinds, warm-up traffic) clamp into
    window 0 the same way — every request lands in exactly one window,
    so the window totals always sum to the run total.
    """
    buckets: list[list[Request]] = [[] for _ in range(n_windows)]
    for r in requests:
        k = int(r.arrival_ms // window_ms)
        if k < 0:
            # mirror the k >= n_windows fold: clamp instead of dropping,
            # so no request silently vanishes from every window
            k = 0
        elif k >= n_windows:
            k = n_windows - 1
        buckets[k].append(r)
    assert sum(len(b) for b in buckets) == len(requests), \
        "window bucketing must conserve requests"
    spans = [window_ms] * n_windows
    if horizon_ms is not None:
        spans[-1] = max(horizon_ms - (n_windows - 1) * window_ms, 1e-9)
    return [collect(b, s) for b, s in zip(buckets, spans)]


def collect_arrays(models: list[str], model_id: np.ndarray,
                   arrival_ms: np.ndarray, slo_ms: np.ndarray,
                   completion_ms: np.ndarray, status: np.ndarray,
                   priority: np.ndarray, preempted: np.ndarray,
                   horizon_ms: float,
                   busy_ms: dict | None = None) -> SimMetrics:
    """Vectorized :func:`collect` over parallel request arrays.

    Semantics match the object loop exactly: drops (``status >=
    DROPPED``) count as violations, completions count as violations only
    when they finish past the SLO, and per-model / per-class tallies
    cover every request.
    """
    from repro_torch.simulator.trace import COMPLETED, FIRST_DROP_STATUS
    m = SimMetrics(horizon_ms=horizon_ms)
    m.busy_ms_per_gpulet = busy_ms or {}
    n = len(status)
    m.total = n
    if n == 0:
        return m
    done_mask = status == COMPLETED
    drop_mask = status >= FIRST_DROP_STATUS
    late_mask = np.zeros(n, dtype=bool)
    late_mask[done_mask] = (completion_ms[done_mask]
                            - arrival_ms[done_mask]) > slo_ms[done_mask]
    viol_mask = drop_mask | late_mask
    m.completed = int(done_mask.sum())
    m.dropped = int(drop_mask.sum())
    m.slo_violations = int(viol_mask.sum())
    m.preempted = int(preempted.sum())

    def tally(keys: np.ndarray, nk: int, mask: np.ndarray) -> np.ndarray:
        return np.bincount(keys[mask], minlength=nk)

    nm = len(models)
    mid = model_id
    tot_m = np.bincount(mid, minlength=nm)
    viol_m = tally(mid, nm, viol_mask)
    drop_m = tally(mid, nm, drop_mask)
    done_m = tally(mid, nm, done_mask)
    pre_m = tally(mid, nm, preempted)
    for k in np.flatnonzero(tot_m).tolist():
        m.per_model[models[k]] = dict(
            total=int(tot_m[k]), violations=int(viol_m[k]),
            dropped=int(drop_m[k]), completed=int(done_m[k]),
            preempted=int(pre_m[k]))
    if m.completed:
        lat = completion_ms[done_mask] - arrival_ms[done_mask]
        lat_mid = mid[done_mask]
        for k in np.unique(lat_mid).tolist():
            m.latency_ms_per_model[models[k]] = _pcts(lat[lat_mid == k])
    levels, inv = np.unique(priority, return_inverse=True)
    nl = len(levels)
    tot_c = np.bincount(inv, minlength=nl)
    viol_c = tally(inv, nl, viol_mask)
    drop_c = tally(inv, nl, drop_mask)
    done_c = tally(inv, nl, done_mask)
    pre_c = tally(inv, nl, preempted)
    for k, lv in enumerate(levels.tolist()):
        m.per_class[int(lv)] = dict(
            total=int(tot_c[k]), violations=int(viol_c[k]),
            dropped=int(drop_c[k]), completed=int(done_c[k]),
            preempted=int(pre_c[k]))
    return m


def collect_trace(trace, horizon_ms: float, busy_ms: dict | None = None,
                  idx: np.ndarray | None = None) -> SimMetrics:
    """:func:`collect_arrays` over a ``RequestTrace`` (or a subset)."""
    if idx is None:
        return collect_arrays(trace.models, trace.model_id,
                              trace.arrival_ms, trace.slo_ms,
                              trace.completion_ms, trace.status,
                              trace.priority, trace.preempted,
                              horizon_ms, busy_ms)
    return collect_arrays(trace.models, trace.model_id[idx],
                          trace.arrival_ms[idx], trace.slo_ms[idx],
                          trace.completion_ms[idx], trace.status[idx],
                          trace.priority[idx], trace.preempted[idx],
                          horizon_ms, busy_ms)


@dataclasses.dataclass
class JobMetrics:
    """End-to-end accounting for task-graph (DAG) jobs.

    A job *completes* only when every stage completed; it meets its SLO
    only when the last stage's completion lands within ``job_slo_ms`` of
    the pristine client arrival (``job_arrival_ms`` — the trace snapshots
    it because the router mutates per-stage arrivals with network
    shifts).  Any stage dropped/shed/lost/unserved fails the whole job.
    Job latency is measured at the sink stage's node-side completion; the
    final response hop back to the client is not modeled (constant per
    job, identical across policies).
    """

    jobs: int = 0
    completed: int = 0            # all stages completed
    failed: int = 0               # >= 1 stage dropped/shed/lost/unserved
    violations: int = 0           # failed + completed past the job SLO
    latency_p50_ms: float = 0.0   # over completed jobs
    latency_p99_ms: float = 0.0

    @property
    def attainment(self) -> float:
        """Fraction of jobs that completed within their end-to-end SLO."""
        return 1.0 - self.violations / self.jobs if self.jobs else 1.0


def collect_jobs(trace) -> JobMetrics | None:
    """Reduce a staged trace's rows into per-job end-to-end metrics.

    Jobs are contiguous row groups (the trace builder lays stages out
    contiguously in topological order), so per-job reductions are
    ``reduceat`` over group boundaries — no per-job Python.  Returns
    None for traces without stage columns.
    """
    from repro_torch.simulator.trace import COMPLETED
    if not getattr(trace, "has_stages", False):
        return None
    rows = np.flatnonzero(trace.job_id >= 0)
    if not rows.size:
        return JobMetrics()
    jid = trace.job_id[rows]
    starts = np.flatnonzero(np.r_[True, jid[1:] != jid[:-1]])
    ok = (trace.status[rows] == COMPLETED)
    all_done = np.minimum.reduceat(ok.astype(np.int8), starts) == 1
    finish = np.maximum.reduceat(
        np.where(ok, trace.completion_ms[rows], -np.inf), starts)
    job_arr = trace.job_arrival_ms[rows][starts]
    job_slo = trace.job_slo_ms[rows][starts]
    late = all_done & ((finish - job_arr) > job_slo)
    m = JobMetrics(jobs=int(starts.size),
                   completed=int(all_done.sum()),
                   failed=int((~all_done).sum()))
    m.violations = m.failed + int(late.sum())
    if m.completed:
        lat = (finish - job_arr)[all_done]
        m.latency_p50_ms = float(np.percentile(lat, 50))
        m.latency_p99_ms = float(np.percentile(lat, 99))
    return m


@dataclasses.dataclass
class StreamMetrics:
    """Phase-level accounting for streaming (prefill/decode) traces.

    TTFT is measured from the pristine arrival to the first-token stamp;
    a stream *attains* its TTFT SLO when that gap is within
    ``ttft_slo_ms``.  TPOT is the realized steady cadence of a completed
    stream — ``(completion - first_token) / (output_len - 1)`` — so it
    reflects decode-pool contention, not the admission-time estimate.
    Dropped or unserved streams count against TTFT attainment (they
    never produced a first token).
    """

    streams: int = 0
    completed: int = 0            # emitted their full output_len
    ttft_attained: int = 0        # first token within ttft_slo_ms
    tokens_done: int = 0
    tokens_requested: int = 0
    ttft_ms: dict = dataclasses.field(default_factory=dict)   # p50/p95/p99
    tpot_ms: dict = dataclasses.field(default_factory=dict)   # p50/p95/p99
    #: model -> {"streams", "completed", "ttft_attainment", "ttft_ms",
    #: "tpot_ms"}
    per_model: dict = dataclasses.field(default_factory=dict)
    #: priority level -> same shape as ``per_model``
    per_class: dict = dataclasses.field(default_factory=dict)

    @property
    def ttft_attainment(self) -> float:
        return self.ttft_attained / self.streams if self.streams else 1.0

    @property
    def token_completion(self) -> float:
        return (self.tokens_done / self.tokens_requested
                if self.tokens_requested else 1.0)


def collect_streams(trace, idx: np.ndarray | None = None
                    ) -> StreamMetrics | None:
    """Reduce a streaming trace's rows into TTFT/TPOT metrics.

    Vectorized like :func:`collect_arrays` (masked reductions, one
    percentile pass per model/class group).  Returns None for traces
    without stream columns.
    """
    from repro_torch.simulator.trace import COMPLETED
    if not getattr(trace, "has_streams", False):
        return None
    if idx is None:
        idx = np.arange(len(trace), dtype=np.int64)
    arrival = trace.arrival_ms[idx]
    first = trace.first_token_ms[idx]
    done = trace.completion_ms[idx]
    status = trace.status[idx]
    olen = trace.output_len[idx].astype(np.float64)
    ttft_slo = trace.ttft_slo_ms[idx]
    mid = trace.model_id[idx]
    pri = trace.priority[idx]
    n = idx.size

    m = StreamMetrics(streams=int(n))
    if n == 0:
        return m
    got_first = ~np.isnan(first)
    ttft = np.where(got_first, first - arrival, np.inf)
    attained = got_first & (ttft <= ttft_slo)
    completed = status == COMPLETED
    multi = completed & (olen > 1)
    tpot = np.zeros(n)
    tpot[multi] = (done[multi] - first[multi]) / (olen[multi] - 1.0)

    m.completed = int(completed.sum())
    m.ttft_attained = int(attained.sum())
    m.tokens_done = int(trace.tokens_done[idx].sum())
    m.tokens_requested = int(trace.output_len[idx].sum())
    m.ttft_ms = _pcts(ttft[got_first])
    m.tpot_ms = _pcts(tpot[multi])

    def group(mask: np.ndarray) -> dict:
        tot = int(mask.sum())
        att = int((attained & mask).sum())
        return {
            "streams": tot,
            "completed": int((completed & mask).sum()),
            "ttft_attainment": att / tot if tot else 1.0,
            "ttft_ms": _pcts(ttft[got_first & mask]),
            "tpot_ms": _pcts(tpot[multi & mask]),
        }

    for k in np.unique(mid).tolist():
        m.per_model[trace.models[k]] = group(mid == k)
    for lv in np.unique(pri).tolist():
        m.per_class[int(lv)] = group(pri == lv)
    return m


def collect(requests: list[Request], horizon_ms: float,
            busy_ms: dict | None = None) -> SimMetrics:
    m = SimMetrics(horizon_ms=horizon_ms)
    m.busy_ms_per_gpulet = busy_ms or {}
    lat_by: dict[str, list[float]] = {}
    for r in requests:
        m.total += 1
        pm = m.per_model.setdefault(
            r.model, dict(total=0, violations=0, dropped=0, completed=0,
                          preempted=0))
        pc = m.per_class.setdefault(
            r.priority, dict(total=0, violations=0, dropped=0, completed=0,
                             preempted=0))
        pm["total"] += 1
        pc["total"] += 1
        if r.preempted:
            m.preempted += 1
            pm["preempted"] += 1
            pc["preempted"] += 1
        if r.dropped:
            m.dropped += 1
            m.slo_violations += 1
            pm["dropped"] += 1
            pm["violations"] += 1
            pc["dropped"] += 1
            pc["violations"] += 1
            continue
        if r.completion_ms is not None:
            m.completed += 1
            pm["completed"] += 1
            pc["completed"] += 1
            lat_by.setdefault(r.model, []).append(
                r.completion_ms - r.arrival_ms)
            if r.violated:
                m.slo_violations += 1
                pm["violations"] += 1
                pc["violations"] += 1
    for model, lats in lat_by.items():
        m.latency_ms_per_model[model] = _pcts(np.asarray(lats))
    return m
