"""Materialize a FabricScenario into a client request trace + a fabric.

core/scenarios.py describes multi-node experiments as pure data; this
module turns one into (a) a whole-horizon, priority-tagged Poisson trace
and (b) a ready-to-serve :class:`ServingFabric` provisioned for it.

:func:`build_trace_soa` is the hot path: it generates the trace straight
into :class:`~repro.simulator.trace.RequestTrace` arrays (no ``Request``
objects), which is how million-request fleet sweeps stay cheap.
:func:`build_trace` keeps the object-returning API for the edges; the
two produce the identical trace for a given scenario and seed (same rng
consumption order, same stable merge).
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np

from repro_torch.core.latency import AnalyticGPULatency, LatencyProvider
from repro_torch.core.profiles import ModelProfile
from repro_torch.core.scenarios import (DagScenario, FabricScenario,
                                  StreamScenario, critical_path_budgets)
from repro_torch.fabric.fabric import FabricConfig, ServingFabric
from repro_torch.fabric.priority import draw_priorities
from repro_torch.simulator.events import PoissonArrivals, Request
from repro_torch.simulator.trace import RequestTrace


def build_trace_soa(scn: FabricScenario,
                    profiles: Mapping[str, ModelProfile],
                    horizon_s: float, seed: int = 0) -> RequestTrace:
    """Fleet-total SoA arrival trace for one scenario, priorities assigned.

    Constant-rate models use the homogeneous generator; hot-spot models go
    through thinning against their burst peak.  Priorities are tagged
    i.i.d. from the scenario's mix, deterministically per seed.
    """
    gen = PoissonArrivals(seed=seed)
    scn.warn_if_failures_after(horizon_s)
    horizon_ms = horizon_s * 1e3
    streams = []
    # drift scenarios may introduce models whose t=0 rate is zero, so the
    # vocabulary is the union over phases, not just ``scn.rates``
    names = (scn.models() if scn.rate_phases is not None
             else sorted(scn.rates))
    for m in names:
        if m not in profiles:
            continue
        slo = profiles[m].slo_ms
        if scn.varies(m):
            fn = scn.rate_fn(m)
            peak = scn.peak_rate(m)
            if peak <= 0:
                continue
            times = gen.time_varying_times(
                lambda t, fn=fn: fn(t / 1e3), peak + 1e-9, horizon_ms)
        else:
            r = scn.rates.get(m, 0.0)
            if r <= 0:
                continue
            times = gen.constant_times(r, horizon_ms)
        streams.append((m, times, slo))
    trace = RequestTrace.from_streams(streams)
    levels = draw_priorities(len(trace), dict(scn.priority_mix),
                             seed=seed + 1)
    if levels is not None:
        trace.priority[:] = levels
    return trace


def build_trace(scn: FabricScenario,
                profiles: Mapping[str, ModelProfile],
                horizon_s: float, seed: int = 0) -> list[Request]:
    """Object-edge variant of :func:`build_trace_soa` (same trace)."""
    return build_trace_soa(scn, profiles, horizon_s, seed).to_requests()


def build_stream_trace_soa(scn: StreamScenario,
                           profiles: Mapping[str, ModelProfile],
                           horizon_s: float, seed: int = 0,
                           lat: LatencyProvider | None = None
                           ) -> RequestTrace:
    """Materialize a :class:`StreamScenario` into a *streaming* trace.

    Arrivals come from the classic builder over the wrapped scenario
    (same rng consumption, same stable merge — a streaming trace with
    all-default specs arrives exactly like its classic twin); then
    per-model geometric prompt/output lengths are drawn (a separate,
    seed-derived rng so arrival times are untouched) and the phase SLOs
    attached.  Each row's ``slo_ms`` becomes the derived end-to-end
    deadline ``ttft + output_len * tpot``.
    """
    trace = build_trace_soa(scn.base, profiles, horizon_s, seed)
    n = len(trace)
    lat = lat or AnalyticGPULatency()
    rng = np.random.default_rng(seed + 2)
    plen = np.ones(n, dtype=np.int32)
    olen = np.ones(n, dtype=np.int32)
    ttft = np.empty(n)
    tpot = np.empty(n)
    for mid, m in enumerate(trace.models):
        mask = trace.model_id == mid
        k = int(mask.sum())
        if not k:
            continue
        sp = scn.spec(m)
        prof = profiles[m]
        plen[mask] = np.minimum(
            rng.geometric(min(1.0 / max(sp.prompt_mean, 1.0), 1.0), k),
            sp.prompt_max).astype(np.int32)
        olen[mask] = np.minimum(
            rng.geometric(min(1.0 / max(sp.output_mean, 1.0), 1.0), k),
            sp.output_max).astype(np.int32)
        ttft[mask] = (prof.slo_ms if sp.ttft_slo_ms is None
                      else sp.ttft_slo_ms)
        tpot[mask] = sp.tpot_scale * lat.decode_step_ms(prof, 8, 1.0)
    trace.attach_streams(plen, olen, ttft, tpot)
    trace.slo_ms = ttft + olen * tpot
    return trace


def stream_occupancies(scn: StreamScenario,
                       profiles: Mapping[str, ModelProfile],
                       lat: LatencyProvider | None = None
                       ) -> dict[str, float]:
    """Per-model stream occupancy factors (>= 1) at the scenario's specs.

    The factor is how much busier one mean stream keeps a gpu-let than
    the single L(b, p) launch a phase-oblivious provisioner books — the
    decode tail's worth of extra service.  Phase-aware placement scales
    each model's booked rate by it.

    The decode amortization batch is bounded by the concurrency the
    model can actually sustain on one node (per-node rate times the
    decode lifetime at SLO cadence): a low-rate model's pool holds one
    or two streams, so its decode steps run near-solo even when the
    TPOT-feasible cap is large.
    """
    lat = lat or AnalyticGPULatency()
    occ = {}
    for m, rate in scn.rates.items():
        if m not in profiles:
            continue
        sp = scn.spec(m)
        prof = profiles[m]
        otok = min(sp.output_mean, sp.output_max)
        tpot = sp.tpot_scale * lat.decode_step_ms(prof, 8, 1.0)
        conc = (rate / max(scn.n_nodes, 1)) * \
            max(otok - 1.0, 0.0) * tpot / 1e3
        occ[m] = lat.stream_occupancy(
            prof, 1.0, min(sp.prompt_mean, sp.prompt_max), otok, tpot,
            decode_concurrency=max(conc, 1.0))
    return occ


def build_stream_fabric(scn: StreamScenario,
                        profiles: Mapping[str, ModelProfile],
                        cfg: FabricConfig | None = None,
                        phase_aware: bool = True,
                        lat: LatencyProvider | None = None,
                        **build_kwargs) -> ServingFabric:
    """Provision a fabric for a streaming scenario.

    ``phase_aware=False`` books the raw stream rates — the scheduler
    sees each stream as one opaque L(b, p) launch, so the decode tail
    steals cycle time it never provisioned for.  ``phase_aware=True``
    scales each model's booked rate by its stream occupancy (decode
    work counted) and hands the router the same factors so its backlog
    estimates weight streaming models by their true service.
    """
    rates = dict(scn.rates)
    occ = None
    if phase_aware:
        occ = stream_occupancies(scn, profiles, lat)
        rates = {m: r * occ.get(m, 1.0) for m, r in rates.items()}
    cfg = cfg or FabricConfig()
    cfg.stream_occupancy = occ
    return ServingFabric.build(profiles, scn.n_nodes, rates, cfg=cfg,
                               **build_kwargs)


def build_dag_trace_soa(scn: DagScenario,
                        profiles: Mapping[str, ModelProfile],
                        horizon_s: float, seed: int = 0) -> RequestTrace:
    """Materialize a :class:`DagScenario` into a *staged* request trace.

    Jobs arrive Poisson per template; each job's stages occupy one
    contiguous row block in topological order (stage ``s`` of job ``j``
    at ``base + j * n_stages + s``), so every stage's fan-in is a single
    parent row range and per-job reductions are ``reduceat``-shaped.
    Root stages carry the job's arrival; non-roots start at ``inf`` and
    are released by the fabric's frontier pass at ``max(parent
    completions)``.  Per-stage SLO budgets come from
    :func:`~repro.core.scenarios.critical_path_budgets` with the models'
    standalone SLOs as weights.  Background single-model traffic is
    appended with ``job_id = -1`` — the classic rows and stage rows
    share one trace and one fleet.  Priorities are drawn per *job*
    (stages inherit) and per background request.
    """
    gen = PoissonArrivals(seed=seed)
    horizon_ms = horizon_s * 1e3
    models: list[str] = []
    index: dict[str, int] = {}

    def mid_of(m: str) -> int:
        if m not in index:
            index[m] = len(models)
            models.append(m)
        return index[m]

    arr_p, slo_p, mid_p = [], [], []
    jid_p, sid_p, ps_p, npar_p, bud_p, jslo_p, jarr_p = \
        [], [], [], [], [], [], []
    stage_counts: list[np.ndarray] = []   # per-job stage count, layout order
    n_rows = n_jobs = bg_rows = 0
    for tpl, rate in scn.dag_rates:
        if rate <= 0:
            continue
        times = gen.constant_times(rate, horizon_ms)
        nj = len(times)
        if nj == 0:
            continue
        ns = tpl.n_stages
        weights = {m: profiles[m].slo_ms for m in set(tpl.stage_models)}
        job_slo, budgets = critical_path_budgets(tpl, weights)
        mids = np.array([mid_of(m) for m in tpl.stage_models],
                        dtype=np.int32)
        is_root = np.array([not p for p in tpl.parents])
        first = np.array([tpl.first_parent(s) for s in range(ns)],
                         dtype=np.int64)
        npar = np.array([len(p) for p in tpl.parents], dtype=np.int32)
        row0 = n_rows + np.arange(nj, dtype=np.int64) * ns
        arr_p.append(np.where(is_root[None, :], times[:, None],
                              np.inf).ravel())
        mid_p.append(np.tile(mids, nj))
        bud = np.tile(np.asarray(budgets, dtype=np.float64), nj)
        slo_p.append(bud)
        bud_p.append(bud.copy())
        jid_p.append(np.repeat(
            np.arange(n_jobs, n_jobs + nj, dtype=np.int64), ns))
        sid_p.append(np.tile(np.arange(ns, dtype=np.int32), nj))
        ps_p.append(np.where(first[None, :] >= 0,
                             row0[:, None] + first[None, :], -1).ravel())
        npar_p.append(np.tile(npar, nj))
        jslo_p.append(np.full(nj * ns, job_slo))
        jarr_p.append(np.repeat(times, ns))
        stage_counts.append(np.full(nj, ns, dtype=np.int64))
        n_rows += nj * ns
        n_jobs += nj
    for m in sorted(scn.background):
        r = scn.background[m]
        if r <= 0 or m not in profiles:
            continue
        times = gen.constant_times(r, horizon_ms)
        k = len(times)
        if k == 0:
            continue
        slo = profiles[m].slo_ms
        arr_p.append(times)
        mid_p.append(np.full(k, mid_of(m), dtype=np.int32))
        slo_p.append(np.full(k, slo))
        bud_p.append(np.full(k, slo))
        jid_p.append(np.full(k, -1, dtype=np.int64))
        sid_p.append(np.full(k, -1, dtype=np.int32))
        ps_p.append(np.full(k, -1, dtype=np.int64))
        npar_p.append(np.zeros(k, dtype=np.int32))
        jslo_p.append(np.full(k, slo))
        jarr_p.append(times.copy())
        n_rows += k
        bg_rows += k
    if n_rows == 0:
        return RequestTrace([], np.empty(0), np.empty(0),
                            np.empty(0, dtype=np.int32))
    trace = RequestTrace(models, np.concatenate(arr_p),
                         np.concatenate(slo_p), np.concatenate(mid_p))
    levels = draw_priorities(n_jobs + bg_rows, dict(scn.priority_mix),
                             seed=seed + 1)
    if levels is not None:
        counts = np.concatenate(
            stage_counts + [np.ones(bg_rows, dtype=np.int64)]
            if bg_rows else stage_counts)
        trace.priority[:] = np.repeat(levels, counts)
    trace.attach_stages(np.concatenate(jid_p), np.concatenate(sid_p),
                        np.concatenate(ps_p), np.concatenate(npar_p),
                        np.concatenate(bud_p), np.concatenate(jslo_p),
                        np.concatenate(jarr_p))
    return trace


def build_dag_fabric(scn: DagScenario,
                     profiles: Mapping[str, ModelProfile],
                     cfg: FabricConfig | None = None,
                     **build_kwargs) -> ServingFabric:
    """Provision a fabric for a DAG scenario's *effective* model streams.

    Stage multiplicities matter for capacity: a chain job of three
    models is three requests, so :meth:`DagScenario.fleet_rates` folds
    template rates into per-model req/s before the elastic partitioner
    sizes the fleet.
    """
    return ServingFabric.build(profiles, scn.n_nodes, scn.fleet_rates(),
                               cfg=cfg, **build_kwargs)


def build_fabric(scn: FabricScenario,
                 profiles: Mapping[str, ModelProfile],
                 cfg: FabricConfig | None = None,
                 **build_kwargs) -> ServingFabric:
    """Provision a fabric for the scenario's steady-state (non-burst) rates.

    Hot-spot surges and node failures are deliberately *not* provisioned
    for — absorbing them via shed/re-route/preempt is the experiment.
    """
    weights = None
    if scn.node_weights is not None:
        weights = {i: w for i, w in enumerate(scn.node_weights)}
    return ServingFabric.build(
        profiles, scn.n_nodes, scn.rates, cfg=cfg,
        fail_at_ms={i: t * 1e3 for i, t in scn.fail_at_s},
        affinity_weights=weights, placement=scn.placement,
        **build_kwargs)
