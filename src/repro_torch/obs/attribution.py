"""SLO-miss attribution: decompose each overshoot into named components.

For every violated request the overshoot — how far past its SLO the
request resolved — is split into five components read off the
:class:`~repro.obs.timeline.Timeline` stamps:

* ``queueing_ms``     — signed residual of queue wait + nominal service
  against the *pristine* SLO budget (``slo0``).  Negative means the
  request had slack that other components consumed.
* ``interference_ms`` — execution inflation from co-located partitions
  (the surviving launch's ``exec - solo`` gap, plus accumulated decode-
  chunk inflation for streams).  Zero for drops: a dropped request's
  last launch never finished, so its inflation never materialized.
* ``preemption_ms``   — time lost to cancelled launches
  (``last_launch - first_launch``; for drops, ``resolve -
  first_launch``).
* ``migration_ms``    — SLO budget burned by migration hand-backs and
  failover replays (arrival shifted forward, budget shrunk).
* ``network_ms``      — SLO budget burned by router network-delay
  shifts (forward hop + return-hop charge).

The components are *independently stamped* (launch times by the engine,
budget burns by the router and fabric), yet for classic requests they
sum to the overshoot exactly:

    overshoot = resolve - arrival - slo
              = queueing + interference + preemption + migration + network

because ``network + migration == slo0 - slo`` holds by construction and
the launch stamps tile ``[arrival, resolve]``.  The acceptance test
asserts this identity to float tolerance — it fails if any layer forgets
a stamp.  For drops the "latency" is the resolve decision time, so a
request shed with budget remaining shows a *negative* overshoot (the
unused budget); its components still sum exactly.

Streaming rows additionally get TTFT and TPOT decompositions
(``ttft``/``tpot`` report sections): the TTFT identity
(``first_token - arrival - ttft_slo`` = queueing + interference +
preemption) is exact; end-to-end and TPOT use residual queueing because
decode-pool scheduling gaps are not individually stamped.

Imports of ``repro.simulator`` are function-local: the engine imports
``repro.obs.spans`` while ``repro.simulator`` is itself mid-import, so
module-level back-references would cycle.
"""
from __future__ import annotations

import numpy as np

COMPONENTS = ("queueing_ms", "interference_ms", "preemption_ms",
              "migration_ms", "network_ms")


def attribution_arrays(trace) -> dict[str, np.ndarray]:
    """Per-request component arrays over the full trace.

    Returns a dict with one float64 array per component plus
    ``overshoot_ms``, the ``miss`` bool mask (violated requests with a
    finite arrival — DAG stages whose parents failed before release
    never existed client-side and are excluded), and ``cause``.
    Requires ``trace.obs``.
    """
    from repro_torch.simulator.trace import COMPLETED

    tl = trace.obs
    if tl is None:
        raise ValueError("trace has no timeline attached "
                         "(repro.obs.attach_timeline)")
    n = len(trace)
    arr, slo = trace.arrival_ms, trace.slo_ms
    st, done = trace.status, trace.completion_ms
    finite = np.isfinite(arr) & np.isfinite(tl.arrival0_ms)
    completed = st == COMPLETED
    end = np.where(completed, done, tl.resolve_ms)
    overshoot = end - arr - slo

    launched = np.isfinite(tl.first_launch_ms)
    migration = tl.handback_ms + tl.failover_ms
    network = tl.net_ms.copy()
    preemption = np.zeros(n)
    interference = np.zeros(n)
    queueing = np.zeros(n)

    c = completed & finite
    if c.any():
        interference[c] = tl.intf_ms[c] + tl.decode_intf_ms[c]
        preemption[c] = tl.last_launch_ms[c] - tl.first_launch_ms[c]
        if trace.has_streams:
            # decode-pool gaps are not individually stamped: queueing is
            # the residual (exact by construction; the non-vacuous
            # identity for streams is the TTFT decomposition)
            queueing[c] = (overshoot[c] - interference[c] - preemption[c]
                           - migration[c] - network[c])
        else:
            queueing[c] = ((tl.first_launch_ms[c] - arr[c])
                           + (done[c] - tl.last_launch_ms[c]
                              - tl.intf_ms[c])
                           - tl.slo0_ms[c])

    d = ~completed & finite & np.isfinite(tl.resolve_ms)
    if d.any():
        # anchor = first launch when one happened, else the resolve point
        anchor = np.where(launched[d], tl.first_launch_ms[d],
                          tl.resolve_ms[d])
        preemption[d] = tl.resolve_ms[d] - anchor
        queueing[d] = anchor - arr[d] - tl.slo0_ms[d]

    miss = trace.violated() & finite
    return {
        "overshoot_ms": overshoot,
        "queueing_ms": queueing,
        "interference_ms": interference,
        "preemption_ms": preemption,
        "migration_ms": migration,
        "network_ms": network,
        "miss": miss,
        "cause": tl.cause.copy(),
    }


def _ttft_arrays(trace) -> dict[str, np.ndarray] | None:
    """TTFT decomposition: exact identity over rows with a first token."""
    tl = trace.obs
    if not trace.has_streams:
        return None
    ftok = trace.first_token_ms
    have = np.isfinite(ftok) & np.isfinite(trace.arrival_ms)
    overshoot = np.where(have, ftok - trace.arrival_ms - trace.ttft_slo_ms,
                         0.0)
    preemption = np.zeros(len(trace))
    interference = np.zeros(len(trace))
    queueing = np.zeros(len(trace))
    h = have
    preemption[h] = tl.last_launch_ms[h] - tl.first_launch_ms[h]
    interference[h] = tl.intf_ms[h]
    queueing[h] = ((tl.first_launch_ms[h] - trace.arrival_ms[h])
                   + (ftok[h] - tl.last_launch_ms[h] - tl.intf_ms[h])
                   - trace.ttft_slo_ms[h])
    return {
        "overshoot_ms": overshoot,
        "queueing_ms": queueing,
        "interference_ms": interference,
        "preemption_ms": preemption,
        "miss": have & (overshoot > 0),
    }


def _tpot_arrays(trace) -> dict[str, np.ndarray] | None:
    """TPOT decomposition: decode interference vs pool-scheduling residual."""
    from repro_torch.simulator.trace import COMPLETED

    tl = trace.obs
    if not trace.has_streams:
        return None
    n = len(trace)
    multi = ((trace.status == COMPLETED) & (trace.output_len > 1)
             & np.isfinite(trace.first_token_ms))
    steps = np.maximum(trace.output_len.astype(np.float64) - 1.0, 1.0)
    decode = np.where(multi, trace.completion_ms - trace.first_token_ms,
                      0.0)
    overshoot = np.where(multi, decode - steps * trace.tpot_slo_ms, 0.0)
    interference = np.where(multi, tl.decode_intf_ms, 0.0)
    queueing = np.zeros(n)
    queueing[multi] = overshoot[multi] - interference[multi]
    return {
        "overshoot_ms": overshoot,
        "queueing_ms": queueing,
        "interference_ms": interference,
        "miss": multi & (overshoot > 0),
    }


def _aggregate(comp: dict[str, np.ndarray], mask: np.ndarray,
               keys: tuple[str, ...]) -> dict[str, float]:
    return {k: float(comp[k][mask].sum()) for k in keys if k in comp}


def collect_attribution(trace) -> dict:
    """Per-model SLO-miss attribution report (JSON-ready dict).

    ``per_model[m]["dominant"]`` counts, over that model's missed
    requests, which component was the largest contributor — the
    headline "why is this model missing" signal.  ``lifecycle`` holds
    the closure invariant the trace validator checks: every terminal
    (non-PENDING) request must carry a finite resolve stamp.
    """
    from repro_torch.simulator.trace import COMPLETED, PENDING, STATUS_NAMES

    from repro_torch.obs.timeline import CAUSE_NAMES

    comp = attribution_arrays(trace)
    miss = comp["miss"]
    n = len(trace)
    st = trace.status
    mid = trace.model_id
    cause = comp["cause"]

    stack = np.stack([comp[k] for k in COMPONENTS])
    ident_err = np.zeros(n)
    if miss.any():
        ident_err[miss] = np.abs(stack[:, miss].sum(axis=0)
                                 - comp["overshoot_ms"][miss])
    dominant = np.asarray(COMPONENTS)[np.argmax(stack, axis=0)]

    per_model: dict[str, dict] = {}
    for k, m in enumerate(trace.models):
        rows = mid == k
        mrows = rows & miss
        nm = int(mrows.sum())
        by_cause: dict[str, int] = {}
        for code in np.unique(cause[mrows]).tolist():
            by_cause[CAUSE_NAMES.get(code, str(code))] = int(
                (cause[mrows] == code).sum())
        dom: dict[str, int] = {}
        for name in COMPONENTS:
            cnt = int((dominant[mrows] == name).sum())
            if cnt:
                dom[name] = cnt
        per_model[m] = {
            "total": int(rows.sum()),
            "missed": nm,
            "miss_rate": nm / max(int(rows.sum()), 1),
            "by_cause": by_cause,
            "components_ms": _aggregate(comp, mrows, COMPONENTS),
            "dominant": dom,
        }

    terminal = st != PENDING
    closed = terminal & (np.isfinite(trace.obs.resolve_ms)
                         | (st == COMPLETED))
    report = {
        "total": n,
        "missed": int(miss.sum()),
        "miss_rate": int(miss.sum()) / max(n, 1),
        "identity_max_abs_err_ms": float(ident_err.max()) if n else 0.0,
        "components_ms": _aggregate(comp, miss, COMPONENTS),
        "per_model": per_model,
        "lifecycle": {
            "terminal": int(terminal.sum()),
            "closed": int(closed.sum()),
            "by_status": {STATUS_NAMES[int(s)]: int((st == s).sum())
                          for s in np.unique(st).tolist()},
        },
    }
    ttft = _ttft_arrays(trace)
    if ttft is not None:
        tm = ttft["miss"]
        report["ttft"] = {
            "missed": int(tm.sum()),
            "components_ms": _aggregate(
                ttft, tm,
                ("queueing_ms", "interference_ms", "preemption_ms")),
            "identity_max_abs_err_ms": float(np.abs(
                ttft["queueing_ms"][tm] + ttft["interference_ms"][tm]
                + ttft["preemption_ms"][tm]
                - ttft["overshoot_ms"][tm]).max()) if tm.any() else 0.0,
        }
        tpot = _tpot_arrays(trace)
        pm = tpot["miss"]
        report["tpot"] = {
            "missed": int(pm.sum()),
            "components_ms": _aggregate(
                tpot, pm, ("queueing_ms", "interference_ms")),
        }
    return report
