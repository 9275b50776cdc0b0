"""Multi-model serving plan: the paper's scheduler over h100-lets.

Takes an L(b, p) results file measured on SM partitions of an H100
(``launch/profile_partitions.py``; ``results/h100_lbp.jsonl``), or the
labelled synthetic table when none is given, and places the requested
model mix on a cluster of cards with Elastic Partitioning (Alg. 1).  With
``--max-scale`` it reports the largest schedulable multiple of the mix for
Elastic Partitioning and for Squishy Bin Packing (SBP, whole cards only,
the paper's baseline) and their ratio, then plans at 99% of the elastic
maximum.  It prints each model's SLO and L(32, 100%) and, per card, the
split with each gpu-let's models, batch, duty cycle and estimated latency.

``--max-scale`` also reports guided self-tuning (GSLICE) and the ideal
scheduler (``core/ideal.py``: every per-card partitioning, Fig. 15/16)
beside SBP, and the ideal's enumeration alone (``EnumeratedIdeal``): where
no enumerated partitioning admits a load, ``IdealScheduler`` falls back to
Elastic Partitioning's result, so its maximum is at least ``gpulet``'s by
construction.  With the card's measured interference (``--corun`` and
``--features``, from ``launch/profile_interference.py``) it fits the
paper's predictor and prints its error on a held-out split (Fig. 9;
``core.h100intf.fit_measured``), and ``--max-scale`` adds ``gpulet+int``
(Elastic Partitioning with the fitted predictor in its admission test);
with the ideal's, that makes the five schedulers of Fig. 12.

``--replay`` serves the placement through the event engine
(``simulator/h100engine.py``): Poisson arrivals from ``--seed`` over
``--horizon-s`` seconds.  With ``--corun`` it replays ``gpulet`` and
``gpulet+int``, each at 0.999 of its own maximum with ``--max-scale``
(Fig. 13), with the measured co-run factors as the ground truth, and
prints each one's violation rate, goodput and conservation.  A card's
catalog (``--results``) without ``--corun`` replays only with
``--no-interference``: Elastic Partitioning at 60% of its maximum,
interference off.  The labelled synthetic table replays without
interference.

``--fluctuate`` runs the serving controller (``serving/controller.py``,
Fig. 14) over the catalog: the mix's rates follow the load waves of the
JAX package's ``examples/fluctuating_rates.py`` for 900 s with the
example's seed, their base at the share of the elastic maximum that the
example's base is of its own scheduler's maximum (``EXAMPLE_SHARE``), and
the controller re-plans with Elastic Partitioning every 20 s.  Its engine
(``simulator/h100engine.py``, built here: the copied controller's own
``run`` would build one on the analytic 2080 Ti model) prices every batch
from the catalog's L(b, p).  With ``--corun`` it runs twice: on the
measured co-run factors, and with interference off as the contrast;
without, interference off only.  The controller plans with ``gpulet``, not
``gpulet+int``: on the committed tables no split side passes Alg. 1's
admission under the fitted factors, so ``gpulet+int`` places none of the
mix (its max scale is printed beside the run).  It prints the violations
per window, per model and in all.

``--fleet`` (node counts, default 1,2,4) serves the fleet layer
(``fabric/``, copied from the JAX package) on nodes of ``--gpus`` cards
priced from the catalog, the counterpart of the JAX package's
``benchmarks/fig_fabric_scaling.py::run_sweep`` and of ``fig_chaos``'s
storm: a weak-scaling sweep over the node counts, each node at
``SWEEP_SHARE`` of the most Elastic Partitioning places on it, 20 / 50 / 30
gold / silver / bronze traffic, preemption, the least-loaded router and a
0.15 ms one-way RPC; one node of the largest fleet dying at half the
horizon; and a seeded fault storm (``faults.chaos_plan``) on the largest
fleet.  Each node is planned with plain Elastic Partitioning, as the JAX
fleet's are.  With ``--corun`` every run is served twice: on measured
nodes (``fabric/h100node.py``: each node's engine is the measured one),
and with interference off as the contrast; without ``--corun``, with
interference off only.  Each run's JSON line says which
(``"interference": "measured"`` or ``"off"``).  A 1-node fleet with no
network and one class must give the metrics of the bare replay
(``serve_end_to_end``) on the same requests, with interference off and,
with ``--corun``, on the measured factors.

It prints one JSON line last and exits nonzero unless every request of
every replay, of the controller's run and of every fleet run completed or
was dropped, and the 1-node fleet is the bare replay.  The
cluster is the scheduler's arithmetic over one card's measured tables, so
it needs no card, and everything here runs on the CPU:

  python -m repro_torch.launch.serve --results results/h100_lbp.jsonl \\
      --corun results/h100_corun.jsonl \\
      --features results/h100_features.jsonl \\
      --gpus 4 --max-scale --replay --fluctuate

A card's catalog serves the JAX package's mix (``core.h100lets.MIX``:
yi-9b, chatglm3-6b, mamba2-780m, deepseek-moe-16b and recurrentgemma-2b
at 1 : 1 : 4 : 1 : 2) unless ``--rates`` names another, which may name
any arch of the catalog: hubert-xlarge, an encoder, is priced by its
``forward`` records.  Interference is priced only for archs of the co-run
table: asked for while ``--rates`` names another (the committed tables
have no encoder), the call refuses and names it.

The counterpart of the JAX package's ``launch/serve.py`` and of
``benchmarks/tpulet_serving.py::serve_end_to_end``.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import itertools
import json
import math
import sys
import time

from repro_torch.core.elastic import ElasticPartitioning
from repro_torch.core.gpulet import (GpuLet, GpuState,
                                     enumerate_gpu_partitionings)
from repro_torch.core.h100intf import (corun_summary, fit_measured,
                                       load_corun, load_features)
from repro_torch.core.h100lets import (H100_SXM, MIX, SLO_BATCH,
                                       SYNTHETIC_MIX, granted_sms,
                                       load_catalog, synthetic_catalog)
from repro_torch.core.hardware import ClusterSpec
from repro_torch.core.ideal import IdealScheduler
from repro_torch.core.sbp import SquishyBinPacking
from repro_torch.core.scheduler_base import ScheduleResult
from repro_torch.core.selftuning import GuidedSelfTuning
from repro_torch.launch.partition import target_sms

CARD_SMS = 132  # an H100 SXM
SEARCH_HI = 1 << 16
PLAN_SHARE = 0.99     # of the elastic maximum, for the printed plan
REPLAY_SHARE = 0.6    # of the elastic maximum, for the replay without a
#                       co-run table
AT_MAX_SHARE = 0.999  # of each scheduler's own maximum, for the replays
#                       under measured interference (Fig. 13)
#: the fleet's per-node load as a share of the most its node's scheduler
#: admits: the JAX package's fabric sweep runs each node at
#: ``core.scenarios.SWEEP_NODE_RATES``, 1 / 9.6875 of what plain Elastic
#: Partitioning places on the paper's four 2080 Ti (the analytic profiles;
#: tests/test_torch_fleet.py recomputes it through the JAX package): a
#: comfortably schedulable point, so that the sweep measures the fabric's
#: overhead, not overload
SWEEP_SHARE = 1 / 9.6875
FLEET_NODES = "1,2,4"
FLEET_NET_MS = 0.15  # the sweep's one-way RPC delay per dispatch
#: examples/fluctuating_rates.py: the paper's five models' base rates
#: (req/s), the seed of its arrivals and its horizon
EXAMPLE_BASE = {"le": 100, "goo": 60, "res": 40, "ssd": 30, "vgg": 25}
EXAMPLE_SEED = 11
FLUCT_HORIZON_S = 900.0
#: the example's base load as a share of the most its own scheduler admits:
#: Elastic Partitioning with the fitted interference model places at most
#: 15.75 x EXAMPLE_BASE on the paper's four 2080 Ti (the analytic profiles;
#: tests/test_torch_scheduler.py recomputes it through the JAX package)
EXAMPLE_SHARE = 1 / 15.75


def parse_rates(text: str) -> dict[str, float]:
    rates = {}
    for part in text.split(","):
        arch, r = part.split("=")
        rates[arch.strip()] = float(r)
    return rates


def catalog(results: str | None):
    """(profiles, provider, source)."""
    if results:
        profiles, provider = load_catalog(results)
        return profiles, provider, results
    profiles, provider = synthetic_catalog()
    return profiles, provider, "synthetic (not measured)"


def cluster_of(n_gpus: int) -> ClusterSpec:
    return ClusterSpec(accelerator=H100_SXM, n_devices=n_gpus)


def max_scales(profiles, provider, rates, n_gpus: int,
               intf_model=None) -> dict:
    """The largest schedulable multiple of ``rates`` for each scheduler:
    ``elastic`` (the paper's ``gpulet``), ``sbp``, ``self-tuning``,
    ``ideal``, ``ideal (enumeration)`` and, with an interference model,
    ``gpulet+int``."""
    schedulers = {"elastic": (ElasticPartitioning, None),
                  "sbp": (SquishyBinPacking, None),
                  "self-tuning": (GuidedSelfTuning, None),
                  "ideal": (IdealScheduler, None),
                  "ideal (enumeration)": (EnumeratedIdeal, None)}
    if intf_model is not None:
        schedulers["gpulet+int"] = (ElasticPartitioning, intf_model)
    out = {}
    for name, (cls, model) in schedulers.items():
        sched = cls({m: profiles[m] for m in rates}, cluster=cluster_of(
            n_gpus), lat=provider, intf_model=model)
        out[name] = sched.max_scale(rates, 0.0, SEARCH_HI)
    return out


class EnumeratedIdeal(IdealScheduler):
    """``IdealScheduler``'s enumeration alone: a load is schedulable only
    where one of the enumerated per-card partitionings admits it, without
    the fallback to Elastic Partitioning's result."""
    name = "ideal (enumeration)"

    def schedule(self, rates):
        for combo in itertools.product(enumerate_gpu_partitionings(),
                                       repeat=self.cluster.n_devices):
            gpus = [GpuState(gid, [GpuLet(gpu_id=gid, size=s,
                                          split_from=len(sizes) > 1)
                                   for s in sizes])
                    for gid, sizes in enumerate(combo)]
            res = self._assign_on_fixed(gpus, rates)
            if res.schedulable:
                return res
        return ScheduleResult(gpus=[], schedulable=False,
                              unplaced=dict(rates), scheduler=self.name)


def plan(profiles, provider, rates, n_gpus: int, intf_model=None):
    sched = ElasticPartitioning({m: profiles[m] for m in rates},
                                cluster=cluster_of(n_gpus), lat=provider,
                                intf_model=intf_model)
    return sched.schedule(rates)


def poisson_requests(profiles, rates, horizon_ms: float, seed: int):
    """Poisson arrivals of every model of ``rates`` over the horizon."""
    from repro_torch.simulator import PoissonArrivals
    from repro_torch.simulator.events import merge_sorted
    gen = PoissonArrivals(seed=seed)
    return merge_sorted([
        gen.constant(m, r, profiles[m].slo_ms, horizon_ms)
        for m, r in rates.items()])


def serve_end_to_end(profiles, provider, rates, *, n_gpus: int = 4,
                     horizon_s: float = 20.0, seed: int = 0, corun=None,
                     intf_model=None, requests=None):
    """Run an h100-let schedule (Elastic Partitioning, with
    ``intf_model`` in its admission test if given) through the event
    engine, with ``corun``'s measured co-run factors as the ground truth,
    or without interference if there is no table; returns (metrics,
    schedule).  ``requests`` replaces the Poisson arrivals drawn from
    ``seed``; their outcomes are written into them."""
    from repro_torch.simulator import EngineConfig
    from repro_torch.simulator.h100engine import MeasuredInterferenceEngine
    result = plan(profiles, provider, rates, n_gpus, intf_model)
    horizon_ms = horizon_s * 1e3
    reqs = (poisson_requests(profiles, rates, horizon_ms, seed)
            if requests is None else requests)
    eng = MeasuredInterferenceEngine(
        profiles,
        EngineConfig(horizon_ms=horizon_ms, acc=H100_SXM, lat=provider,
                     interference=corun is not None),
        schedule=result, corun=corun)
    eng.submit(reqs)
    return eng.run(), result


def fleet_per_node(profiles, provider, rates, n_gpus: int):
    """(per-node rates, Elastic Partitioning's maximum on a node):
    ``rates`` at :data:`SWEEP_SHARE` of the most that Elastic Partitioning
    places on one node of ``n_gpus`` cards."""
    lam = plan_max_scale(profiles, provider, rates, n_gpus)
    return {m: r * lam * SWEEP_SHARE for m, r in rates.items()}, lam


def fleet_config(provider, horizon_s: float, seed: int, *,
                 interference: bool, **kw):
    """The JAX fabric sweep's configuration, priced from ``provider``."""
    from repro_torch.fabric import FabricConfig, NetworkModel
    return FabricConfig(horizon_ms=horizon_s * 1e3, policy="least-loaded",
                        network=NetworkModel(base_ms=FLEET_NET_MS,
                                             seed=seed),
                        preemption=True, lat=provider,
                        interference=interference, **kw)


def intf_label(corun) -> str:
    return "off" if corun is None else "measured"


def contrasts(corun) -> list:
    """The tables a run is served on: ``corun`` if given (the measured
    factors), then none (interference off, the contrast)."""
    return ([] if corun is None else [corun]) + [None]


def fleet_summary(name: str, n_nodes: int, trace, fm, host_s: float,
                  interference: str = "off") -> dict:
    """One fleet run's line.  ``conserved``: the fleet's completed and
    dropped (the shed and the lost among them) make its total, the trace's
    length, and no request of the trace is left pending."""
    from repro_torch.fabric.priority import CLASS_NAMES
    from repro_torch.simulator.trace import PENDING
    f = fm.fleet
    shed, lost = fm.shed_total(), fm.lost_total()
    return {"run": name, "nodes": n_nodes, "interference": interference,
            "total": f.total,
            "completed": f.completed, "dropped": f.dropped, "shed": shed,
            "lost": lost, "goodput_per_node_req_s": fm.goodput_req_s
            / n_nodes, "violation_rate": f.violation_rate,
            "per_class": {CLASS_NAMES.get(lv, str(lv)): {
                "total": pc["total"], "violation_rate":
                pc["violations"] / max(pc["total"], 1)}
                for lv, pc in sorted(f.per_class.items())},
            "dispatched": sum(fm.stats.dispatched.values()),
            "failed_over": fm.failed_over, "host_s": host_s,
            "conserved": bool(
                f.total == len(trace) and f.completed + f.dropped == f.total
                and shed + lost <= f.dropped
                and not (trace.status == PENDING).any())}


def run_fleet(scn, profiles, cfg, *, n_gpus: int, horizon_s: float,
              seed: int, corun=None):
    """Build the fleet of ``scn`` on nodes of ``n_gpus`` cards, on
    ``corun``'s measured co-run factors if given (``cfg`` then has
    interference on), and serve its seeded trace: (metrics, trace)."""
    from repro_torch.fabric import build_fabric, build_trace_soa
    from repro_torch.fabric.h100node import measured
    profs = {m: profiles[m] for m in scn.rates}
    fabric = build_fabric(scn, profs, cfg, node_cluster=cluster_of(n_gpus))
    if corun is not None:
        measured(fabric, corun)
    trace = build_trace_soa(scn, profs, horizon_s, seed=seed)
    return fabric.serve_trace(trace), trace


def serve_fleet(name: str, scn, profiles, cfg, *, n_gpus: int,
                horizon_s: float, seed: int, corun=None) -> dict:
    """:func:`run_fleet`, summarised."""
    t0 = time.perf_counter()
    fm, trace = run_fleet(scn, profiles, cfg, n_gpus=n_gpus,
                          horizon_s=horizon_s, seed=seed, corun=corun)
    return fleet_summary(name, scn.n_nodes, trace, fm,
                         time.perf_counter() - t0, intf_label(corun))


def fleet_storm(n_nodes: int, horizon_s: float, seed: int):
    """``fig_chaos``'s storm: transient crashes and stragglers scaled with
    the fleet, one permanent crash where a node survives it, one lossy
    network window."""
    from repro_torch.faults import chaos_plan
    return chaos_plan(n_nodes, horizon_s * 1e3, seed=seed,
                      n_transient=max(1, n_nodes // 4),
                      n_permanent=min(1, n_nodes - 1),
                      n_stragglers=max(1, n_nodes // 4), n_net=1)


def fleet_scenarios(per_node, node_counts, horizon_s: float, seed: int
                    ) -> list[tuple]:
    """(name, scenario, extra ``FabricConfig`` fields) of each fleet run:
    the weak-scaling sweep over ``node_counts`` at ``per_node`` req/s a
    node, one node of the largest fleet dying at half the horizon, and a
    fault storm on it."""
    from repro_torch.core.scenarios import (fabric_node_sweep,
                                            failure_drain_scenario)
    n = max(node_counts)
    runs = [(scn.name, scn, {}) for scn in fabric_node_sweep(
        per_node, tuple(node_counts))]
    drain = failure_drain_scenario(n, per_node, fail_at_s=horizon_s / 2)
    storm = fabric_node_sweep(per_node, (n,))[0]
    return runs + [(drain.name, drain, {}),
                   (f"chaos-{n}n", storm,
                    {"faults": fleet_storm(n, horizon_s, seed)})]


def fleet(profiles, provider, per_node, node_counts, *, n_gpus: int = 4,
          horizon_s: float = 20.0, seed: int = 0, corun=None) -> list[dict]:
    """Each run of :func:`fleet_scenarios`, served on measured nodes when
    ``corun`` is given, then with interference off."""
    runs = []
    for name, scn, kw in fleet_scenarios(per_node, node_counts, horizon_s,
                                         seed):
        for table in contrasts(corun):
            runs.append(serve_fleet(
                name, scn, profiles,
                fleet_config(provider, horizon_s, seed,
                             interference=table is not None, **kw),
                n_gpus=n_gpus, horizon_s=horizon_s, seed=seed, corun=table))
    return runs


def bare_fleet(profiles, provider, rates, *, n_gpus: int = 4,
               horizon_s: float = 20.0, seed: int = 0, corun=None):
    """A 1-node fleet with no network delay and one class, and
    :func:`serve_end_to_end`, on the same Poisson requests, both on
    ``corun``'s measured co-run factors if given, else with interference
    off: (the fleet's metrics, the bare engine's, the two request
    lists)."""
    from repro_torch.fabric import FabricConfig, ServingFabric
    from repro_torch.fabric.h100node import measured
    reqs = poisson_requests(profiles, rates, horizon_s * 1e3, seed)
    theirs = copy.deepcopy(reqs)
    fabric = ServingFabric.build(
        {m: profiles[m] for m in rates}, 1, rates,
        FabricConfig(horizon_ms=horizon_s * 1e3, lat=provider,
                     interference=corun is not None),
        node_cluster=cluster_of(n_gpus))
    if corun is not None:
        measured(fabric, corun)
    fm = fabric.serve(theirs)
    met, _ = serve_end_to_end(profiles, provider, rates, n_gpus=n_gpus,
                              horizon_s=horizon_s, seed=seed, corun=corun,
                              requests=reqs)
    return fm, met, theirs, reqs


def same_metrics(a, b) -> bool:
    """Two ``SimMetrics`` field by field (NaN equal to NaN)."""
    return json.dumps(dataclasses.asdict(a), sort_keys=True) == json.dumps(
        dataclasses.asdict(b), sort_keys=True)


def is_bare(fm, met, fleet_reqs, bare_reqs) -> bool:
    """:func:`bare_fleet`'s two runs agree: the node's metrics are the
    engine's in every field, the fleet's too apart from the gpu-lets' busy
    time (which a fleet does not collect), and every request has the same
    outcome."""
    return (same_metrics(fm.per_node[0], met)
            and same_metrics(dataclasses.replace(
                fm.fleet, busy_ms_per_gpulet=met.busy_ms_per_gpulet), met)
            and [(r.model, r.arrival_ms, r.completion_ms, r.dropped)
                 for r in fleet_reqs]
            == [(r.model, r.arrival_ms, r.completion_ms, r.dropped)
                for r in bare_reqs])


def fluctuating_rates(rates) -> dict:
    """``examples/fluctuating_rates.py``'s load waves over ``rates`` (the
    base of each model, phased by its place in the mix): req/s at t s."""
    def wave(base, phase):
        def fn(t):
            w1 = math.exp(-((t - 200) / 90) ** 2) * 1.2
            w2 = math.exp(-((t - 650) / 110) ** 2) * 2.0
            return base * (0.5 + w1 + w2 + 0.1 * math.sin(t / 37 + phase))
        return fn
    return {m: wave(r, i) for i, (m, r) in enumerate(rates.items())}


def fluctuate(profiles, provider, rates, *, n_gpus: int = 4,
              seed: int = EXAMPLE_SEED, horizon_s: float = FLUCT_HORIZON_S,
              corun=None):
    """The serving controller (Fig. 14) re-planning with Elastic
    Partitioning over the catalog as the rates follow
    :func:`fluctuating_rates` around ``rates``.  The controller is the tick
    subscriber of an engine built here (its ``make_subscriber`` path), so
    that every batch is priced from ``provider``, and the engine's
    interference is ``corun``'s measured co-run factors, or off without a
    table.  Returns (one record per controller window, the run's metrics,
    the number of requests offered, the schedule deployed at t = 0)."""
    from repro_torch.serving.controller import ServingController
    from repro_torch.simulator import EngineConfig
    from repro_torch.simulator.events import merge_sorted
    from repro_torch.simulator.h100engine import MeasuredInterferenceEngine
    from repro_torch.simulator.metrics import window_metrics
    profs = {m: profiles[m] for m in rates}
    ctrl = ServingController(ElasticPartitioning(
        profs, cluster=cluster_of(n_gpus), lat=provider), profs, seed=seed)
    fns = fluctuating_rates(rates)
    horizon_ms = horizon_s * 1e3
    streams = []
    for m, fn in fns.items():
        peak = max(fn(k * horizon_s / 256) for k in range(257)) + 1e-9
        streams.append(ctrl.gen.time_varying(
            m, lambda t, fn=fn: fn(t / 1e3), peak, profs[m].slo_ms,
            horizon_ms))
    reqs = merge_sorted(streams)
    schedule, on_tick = ctrl.make_subscriber(
        {m: fn(0.0) for m, fn in fns.items()})
    engine = MeasuredInterferenceEngine(
        profs, EngineConfig(horizon_ms=horizon_ms, acc=H100_SXM,
                            lat=provider, interference=corun is not None,
                            period_ms=ctrl.period_s * 1e3,
                            reorg_ms=ctrl.reorg_s * 1e3,
                            reorg_policy=ctrl.reorg_policy, event_log=False),
        schedule=schedule, on_tick=on_tick, corun=corun)
    engine.submit(reqs)
    met = engine.run()
    n_windows = max(1, math.ceil(horizon_s / ctrl.period_s - 1e-9))
    decisions = ctrl._decisions  # (EWMA rates, rescheduled, partition %)
    records = []
    for k, win in enumerate(window_metrics(reqs, ctrl.period_s * 1e3,
                                           n_windows, horizon_ms=horizon_ms)):
        _, resched, used = decisions[min(k, len(decisions) - 1)]
        records.append({"t_s": k * ctrl.period_s, "requests": win.total,
                        "violations": win.slo_violations,
                        "rescheduled": resched, "partition_total": used})
    return records, met, len(reqs), schedule


def fluctuate_summary(records, met, offered: int,
                      interference: str = "off") -> dict:
    return {"total": met.total, "completed": met.completed,
            "dropped": met.dropped, "violation_rate": met.violation_rate,
            "reschedules": sum(r["rescheduled"] for r in records[1:]),
            "interference": interference,
            "per_model": {m: {"total": v["total"], "dropped": v["dropped"],
                              "violation_rate": v["violations"] / v["total"]}
                          for m, v in met.per_model.items()},
            "conserved": (met.completed + met.dropped == met.total == offered
                          == sum(r["requests"] for r in records))}


def plan_max_scale(profiles, provider, rates, n_gpus: int,
                   intf_model=None) -> float:
    """Elastic Partitioning's largest schedulable multiple of ``rates``,
    with ``intf_model`` in its admission test if given."""
    return ElasticPartitioning(
        {m: profiles[m] for m in rates}, cluster=cluster_of(n_gpus),
        lat=provider, intf_model=intf_model).max_scale(rates, 0.0, SEARCH_HI)


def run_fluctuate(profiles, provider, rates, share: float, n_gpus: int,
                  corun) -> dict:
    """:func:`fluctuate` around ``rates`` (``share`` of the mix), printed
    window by window and model by model; returns its summary."""
    label = intf_label(corun)
    records, met, offered, first = fluctuate(profiles, provider, rates,
                                             n_gpus=n_gpus, corun=corun)
    print(f"controller (Fig. 14), rates of examples/fluctuating_rates.py "
          f"at base {share:.3f}x of the mix (the example's base is "
          f"{EXAMPLE_SHARE:.5f} of its scheduler's maximum on the 2080 "
          f"Ti), seed {EXAMPLE_SEED}, {FLUCT_HORIZON_S:g} s, interference "
          f"{label}: t(s), requests, violations %, gpu-let % in use, "
          "rescheduled")
    print("the controller's plan at t = 0:")
    print_plan(first, provider, n_gpus)
    for r in records:
        pct = (100 * r["violations"] / r["requests"] if r["requests"]
               else 0.0)
        print(f"  {r['t_s']:5.0f} {r['requests']:8d} {pct:7.3f}% "
              f"{r['partition_total']:5d}%"
              + ("  <resched>" if r["rescheduled"] else ""))
    fl = dict(fluctuate_summary(records, met, offered, label), scale=share,
              example_share=EXAMPLE_SHARE, seed=EXAMPLE_SEED,
              horizon_s=FLUCT_HORIZON_S, planner="gpulet")
    for m, v in fl["per_model"].items():
        print(f"  {m:<20} {v['total']:8d} requests "
              f"{v['violation_rate'] * 100:7.3f}% violations, "
              f"{v['dropped']} dropped")
    print(f"controller: {fl['total']} requests, "
          f"{fl['violation_rate'] * 100:.3f}% violations, "
          f"{fl['reschedules']} reschedules, conserved {fl['conserved']}"
          f" (interference {label})")
    return fl


def replay_summary(met, result, rates) -> dict:
    return {"total": met.total, "completed": met.completed,
            "dropped": met.dropped,
            "violation_rate": met.violation_rate,
            "goodput_req_s": met.goodput_req_s,
            "offered_req_s": sum(rates.values()),
            "gpulets_used": sum(1 for let in result.gpulets
                                if not let.is_free),
            "conserved": met.completed + met.dropped == met.total}


def _sms(provider, percent: int, position: int) -> int:
    """SMs the gpu-let at ``position`` on its card runs on."""
    if provider.split_sms:
        return granted_sms(provider.split_sms, percent, position)
    return CARD_SMS if percent == 100 else target_sms(percent, CARD_SMS)


def print_plan(result, provider, n_gpus: int):
    print(f"schedulable: {result.schedulable}  unplaced: {result.unplaced}")
    for gpu in result.gpus:
        split = "+".join(f"{let.size}%" for let in gpu.lets)
        parts = []
        for position, let in enumerate(gpu.lets):
            where = f"{let.size}% = {_sms(provider, let.size, position)} SMs"
            if let.is_free:
                parts.append(f"[{where}: free]")
            else:
                ass = "; ".join(
                    f"{a.model} r={a.rate:.1f}/s b={a.batch} "
                    f"duty={a.duty_ms:.2f}ms L={a.est_latency_ms:.2f}ms"
                    for a in let.assignments)
                parts.append(f"[{where}: {ass}]")
        print(f"  card {gpu.gpu_id} ({split}): " + " ".join(parts))


def _rounded(medians: dict) -> dict:
    return {k: round(v, 3) for k, v in medians.items()}


def interference_tables(args, provider, rates):
    """(co-run table, fitted predictor) from ``--corun`` and
    ``--features``, or (None, None); refuses what the replay cannot use."""
    if not (args.corun or args.features):
        if args.results and args.replay and not args.no_interference:
            raise SystemExit(
                "a card's catalog replays with its measured interference: "
                "give --corun and --features (launch/profile_interference."
                "py), or --no-interference")
        return None, None
    if not (args.corun and args.features) or args.no_interference:
        raise SystemExit("--corun and --features go together, without "
                         "--no-interference")
    corun, features = load_corun(args.corun), load_features(args.features)
    cards = {provider.card, corun.card, features.card}
    if len(cards) != 1:
        raise SystemExit(f"the tables come from {len(cards)} cards: "
                         f"{sorted(cards)}")
    missing = sorted(set(rates) - (set(corun.archs) & set(features.archs)))
    if missing:
        raise SystemExit(
            f"no co-run rows or features for {', '.join(missing)}: measured "
            f"interference prices only {sorted(corun.archs)}; plan without "
            "--corun and --features (replay with --no-interference)")
    dist = corun_summary(corun)
    print(f"co-run factors (Fig. 6), {dist['sides']} sides: "
          f"{dist['share_under_1.18'] * 100:.1f}% under x1.18, p10 "
          f"x{dist['p10']:.3f}, median x{dist['median']:.3f}, p90 "
          f"x{dist['p90']:.3f}, worst {json.dumps(dist['worst'])}; median "
          f"by SMs {json.dumps(_rounded(dist['median_by_sms']))}, by arch "
          f"and batch {json.dumps(_rounded(dist['median_by_arch_batch']))}")
    model, stats = fit_measured(corun, features)
    print(f"interference predictor (Fig. 9), fitted on {stats['n_train']} "
          f"co-run sides, held out {stats['n_val']}: p90 rel. err "
          f"{stats['p90_rel_err']:.4f}, p95 {stats['p95_rel_err']:.4f}, "
          f"mean {stats['mean_rel_err']:.4f}, train RMS "
          f"{stats['rms_train']:.4f}; coefficients (l2 self, l2 other, dram "
          f"self, dram other, 1) {[round(float(c), 4) for c in model.coef]}")
    return corun, model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", default=None,
                    help="L(b, p) JSONL from profile_partitions (default: "
                         "the synthetic table)")
    ap.add_argument("--corun", default=None,
                    help="co-run JSONL from profile_interference")
    ap.add_argument("--features", default=None,
                    help="solo features JSONL from profile_interference")
    ap.add_argument("--no-interference", action="store_true",
                    help="replay a card's catalog without interference")
    ap.add_argument("--rates", default=None,
                    help="comma list arch=req_per_s (default: the JAX "
                         "package's mix with --results, else the synthetic "
                         "mix)")
    ap.add_argument("--gpus", type=int, default=4)
    ap.add_argument("--max-scale", action="store_true",
                    help="report the max schedulable multiple of --rates "
                         "for each scheduler")
    ap.add_argument("--replay", action="store_true",
                    help="serve the placement through the event engine")
    ap.add_argument("--fluctuate", action="store_true",
                    help="run the serving controller under fluctuating "
                         "rates (Fig. 14)")
    ap.add_argument("--fleet", nargs="?", const=FLEET_NODES, default=None,
                    help="serve the fleet layer on nodes of --gpus cards: "
                         "comma list of node counts (default "
                         f"{FLEET_NODES})")
    ap.add_argument("--horizon-s", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    profiles, provider, source = catalog(args.results)
    rates = (parse_rates(args.rates) if args.rates
             else dict(MIX if args.results else SYNTHETIC_MIX))
    unknown = sorted(set(rates) - set(profiles))
    if unknown or not rates:
        raise SystemExit(f"{unknown or 'no rates'}: not in {source} "
                         f"(have: {sorted(profiles)})")

    print(f"== h100-let serving plan: {args.gpus} card(s), {len(rates)} "
          f"model(s); L(b, p) from {source} ({provider.card}) ==")
    corun, intf_model = interference_tables(args, provider, rates)
    for arch in rates:
        prof = profiles[arch]
        print(f"  {arch:<20} SLO={prof.slo_ms:8.3f} ms  "
              f"L({SLO_BATCH},100%)="
              f"{provider.latency_ms(prof, SLO_BATCH, 1.0):8.3f} ms  "
              f"rate={rates[arch]:g}/s  ({provider.steps[arch]} step)")
    print("max rate (req/s) under SLO / 2 by partition, and the knee "
          "p_eff (Alg. 1's max efficient partition):")
    for arch in rates:
        prof = profiles[arch]
        curve = "  ".join(f"{p}%: {r:7.1f}"
                          for p, r in provider.rate_curve(prof))
        print(f"  {arch:<20} {curve}  p_eff="
              f"{provider.max_efficient_partition(prof)}%")
    summary, lam = {}, None
    if args.max_scale:
        lam = max_scales(profiles, provider, rates, args.gpus, intf_model)
        total = sum(rates.values())
        ratio = lam["elastic"] / lam["sbp"] if lam["sbp"] else None
        print(f"max schedulable scale: elastic {lam['elastic']:.3f}x "
              f"({lam['elastic'] * total:.1f} req/s), SBP "
              f"{lam['sbp']:.3f}x ({lam['sbp'] * total:.1f} req/s), "
              f"elastic / SBP "
              f"{'n/a (SBP admits none)' if ratio is None else f'{ratio:.3f}'}"
              " (paper, 2080 Ti: 2.026)")
        for name in ("self-tuning", "ideal", "ideal (enumeration)",
                     "gpulet+int"):
            if name in lam:
                over = (f"{lam[name] / lam['sbp']:.3f}" if lam["sbp"]
                        else "n/a")
                print(f"max schedulable scale: {name} {lam[name]:.3f}x "
                      f"({lam[name] * total:.1f} req/s), {name} / SBP "
                      f"{over}")
        summary = {"elastic_max_scale": lam["elastic"],
                   "sbp_max_scale": lam["sbp"], "elastic_over_sbp": ratio,
                   "selftuning_max_scale": lam["self-tuning"],
                   "ideal_max_scale": lam["ideal"],
                   "ideal_enumerated_max_scale": lam["ideal (enumeration)"]}
        if intf_model is not None:
            summary["gpulet_int_max_scale"] = lam["gpulet+int"]
        plan_rates = {m: r * lam["elastic"] * PLAN_SHARE
                      for m, r in rates.items()}
    else:
        plan_rates = rates
    print_plan(plan(profiles, provider, plan_rates, args.gpus), provider,
               args.gpus)
    line, ok = {"seed": args.seed, "source": source, **summary}, True
    if args.replay and corun is None:
        replay_rates = ({m: r * lam["elastic"] * REPLAY_SHARE
                         for m, r in rates.items()} if lam else rates)
        met, result = serve_end_to_end(
            profiles, provider, replay_rates, n_gpus=args.gpus,
            horizon_s=args.horizon_s, seed=args.seed)
        line.update(replay=replay_summary(met, result, replay_rates),
                    horizon_s=args.horizon_s)
        ok = line["replay"]["conserved"] and met.total > 0
    elif args.replay:
        replays = {}
        for name, model in (("gpulet", None), ("gpulet+int", intf_model)):
            share = (AT_MAX_SHARE * lam["elastic" if model is None
                                        else name] if lam else 1.0)
            replay_rates = {m: r * share for m, r in rates.items()}
            met, result = serve_end_to_end(
                profiles, provider, replay_rates, n_gpus=args.gpus,
                horizon_s=args.horizon_s, seed=args.seed, corun=corun,
                intf_model=model)
            replays[name] = rep = dict(
                replay_summary(met, result, replay_rates), scale=share)
            print(f"replay {name} at {share:.3f}x of the mix, measured "
                  f"interference: {rep['violation_rate'] * 100:.3f}% "
                  f"violations, goodput {rep['goodput_req_s']:.1f} req/s of "
                  f"{rep['offered_req_s']:.1f} offered, conserved "
                  f"{rep['conserved']}" + ("" if rep["offered_req_s"] else
                                           " (the scheduler admits no load)"))
        line.update(replays=replays, horizon_s=args.horizon_s,
                    corun=args.corun, features=args.features)
        # a replay of offered load must serve some; one of none has nothing
        ok = all(r["conserved"] and (r["total"] > 0 or not r["offered_req_s"])
                 for r in replays.values())
    if args.fluctuate:
        share = lam["elastic"] * EXAMPLE_SHARE if lam else 1.0
        base = {m: r * share for m, r in rates.items()}
        if corun is not None:
            int_lam = (lam["gpulet+int"] if lam else plan_max_scale(
                profiles, provider, rates, args.gpus, intf_model))
            print(f"controller: planned with gpulet, not gpulet+int: "
                  f"gpulet+int's max scale on these tables is {int_lam:g}x "
                  "(no split side passes Alg. 1's admission under the "
                  "fitted factors)")
        for table in contrasts(corun):
            fl = run_fluctuate(profiles, provider, base, share, args.gpus,
                               table)
            line["fluctuate" if table is corun else "fluctuate_off"] = fl
            ok = ok and fl["conserved"] and fl["total"] > 0
    if args.fleet:
        counts = sorted({int(n) for n in args.fleet.split(",")})
        if counts[0] < 1:
            raise SystemExit(f"--fleet {args.fleet}: a fleet has a node "
                             "or more")
        per_node, lam_node = fleet_per_node(profiles, provider, rates,
                                            args.gpus)
        print(f"fleet: nodes of {args.gpus} card(s) at {SWEEP_SHARE:.5f} "
              f"of elastic's maximum on a node ({lam_node:g}x the mix), "
              f"{sum(per_node.values()):.1f} req/s a node, 20/50/30 "
              f"gold/silver/bronze, least-loaded, {FLEET_NET_MS} ms RPC, "
              f"preemption, interference "
              f"{'measured, then off' if corun else 'off'}, "
              f"{args.horizon_s:g} s, seed {args.seed}; L(b, p) from "
              f"{source}")
        runs = fleet(profiles, provider, per_node, counts, n_gpus=args.gpus,
                     horizon_s=args.horizon_s, seed=args.seed, corun=corun)
        for run in runs:
            print(json.dumps(run))
        bare = {}
        for table in contrasts(corun):
            fm, met, fleet_reqs, bare_reqs = bare_fleet(
                profiles, provider, per_node, n_gpus=args.gpus,
                horizon_s=args.horizon_s, seed=args.seed, corun=table)
            bare[intf_label(table)] = is_bare(fm, met, fleet_reqs, bare_reqs)
            print(f"fleet: the 1-node fleet (no network, one class), "
                  f"interference {intf_label(table)}, is the bare replay on "
                  f"the same {met.total} requests: {bare[intf_label(table)]}")
        line["fleet"] = {"runs": runs, "bare_equal": bare,
                         "sweep_share": SWEEP_SHARE,
                         "node_max_scale": lam_node,
                         "per_node_req_s": sum(per_node.values()),
                         "interference": [intf_label(t)
                                          for t in contrasts(corun)],
                         "horizon_s": args.horizon_s}
        ok = ok and all(bare.values()) and all(
            r["conserved"] and r["total"] > 0 for r in runs)
    if args.replay or args.fluctuate or args.fleet:
        print(json.dumps(line))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
