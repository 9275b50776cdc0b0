"""The paper's evaluation workloads (§6.1, Tables 4-5, Figs. 10-11).

* Three request scenarios (Table 5): equal, long-only, short-skew.
* Two multi-model applications: ``game`` (6x LeNet + 1x ResNet50 per request,
  SLO 95 ms) and ``traffic`` (SSD -> {GoogLeNet, VGG-16}, SLO 136 ms).  The
  application request rate R expands to per-model rates via the dataflow
  multiplicities; application SLOs override the per-model SLOs.
* The 1,023-scenario schedulability population: rates drawn from
  {0, 200, 400, 600} req/s for each of the five models, minus the all-zero
  vector (4^5 - 1 = 1023).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import warnings

from repro_torch.core.profiles import ModelProfile

# Table 5 -------------------------------------------------------------------
REQUEST_SCENARIOS: dict[str, dict[str, float]] = {
    "equal":      {"le": 50, "goo": 50, "res": 50, "ssd": 50, "vgg": 50},
    "long-only":  {"le": 0, "goo": 0, "res": 100, "ssd": 100, "vgg": 100},
    "short-skew": {"le": 100, "goo": 100, "res": 100, "ssd": 50, "vgg": 50},
}


@dataclasses.dataclass(frozen=True)
class Application:
    """A multi-model application DAG (Figs. 10-11).

    ``streams`` lists the component inferences as *separate model streams*
    (the game app really runs six distinct LeNet digit recognizers, Fig. 10);
    each stream sees the full application request rate.  Modeling them as
    streams rather than one aggregated rate is what exposes the temporal-
    sharing advantage the paper reports for ``game``.
    """

    name: str
    slo_ms: float
    streams: tuple[tuple[str, str], ...]  # (stream_name, model)

    @property
    def n_inferences(self) -> int:
        return len(self.streams)

    def stream_rates(self, app_rate: float) -> dict[str, float]:
        return {s: app_rate for s, _ in self.streams}

    def profiles(self, base: dict[str, ModelProfile] | None = None
                 ) -> dict[str, ModelProfile]:
        """Per-stream profiles with the application SLO substituted.

        ``base`` must be the *calibrated* profile set; defaults to
        calibrating the paper models on the paper cluster.
        """
        if base is None:
            from repro_torch.core.profiles import calibrate_profiles
            base = calibrate_profiles()
        out = {}
        for s, m in self.streams:
            out[s] = dataclasses.replace(base[m], name=s, slo_ms=self.slo_ms)
        return out


APPLICATIONS: dict[str, Application] = {
    # Fig. 10: six LeNet digit recognizers + one ResNet-50, SLO 95 ms.
    "game": Application("game", 95.0, tuple(
        [(f"le{i}", "le") for i in range(6)] + [("res", "res")])),
    # Fig. 11: SSD detector feeding GoogLeNet + VGG-16 recognizers, SLO 136.
    "traffic": Application("traffic", 136.0,
                           (("ssd", "ssd"), ("goo", "goo"), ("vgg", "vgg"))),
}

SCHEDULABILITY_RATES = (0, 200, 400, 600)


# Multi-node fabric scenarios (beyond-paper; ROADMAP "cluster of clusters").
# These are pure *descriptions* — repro.fabric.workload materializes them
# into request traces, keeping core free of simulator imports.

#: default traffic tiering: 20% gold / 50% silver / 30% bronze
DEFAULT_PRIORITY_MIX: tuple[tuple[int, float], ...] = \
    ((0, 0.2), (1, 0.5), (2, 0.3))

#: per-node rates used by the fabric scaling sweep: ~500 req/s of mixed
#: paper models per 4-GPU node, a comfortably schedulable point so the
#: sweep measures fabric overhead rather than raw overload.
SWEEP_NODE_RATES: dict[str, float] = {
    "le": 200.0, "goo": 120.0, "res": 80.0, "ssd": 60.0, "vgg": 40.0}

#: the engine-scale benchmark ladder (benchmarks/bench_engine.py →
#: BENCH_engine.json): weak scaling at ~500 req/s per node over a 160 s
#: horizon, so the 64-node rung is a ≈5.1M-request fleet trace — the
#: struct-of-arrays hot path makes that a sub-minute simulation.
ENGINE_BENCH_NODE_COUNTS: tuple[int, ...] = (1, 8, 64)
ENGINE_BENCH_HORIZON_S: float = 160.0


@dataclasses.dataclass(frozen=True)
class FabricScenario:
    """One multi-node serving experiment.

    ``rates`` are *fleet-total* req/s per model.  ``hotspot`` multiplies
    the rates of ``hot_models`` by ``mult`` inside [t0_s, t1_s] (a flash
    crowd).  ``fail_at_s`` lists (node_id, t_s) node deaths.
    ``node_weights`` biases the router's model-affinity policy (skewed
    per-node popularity — sticky sessions concentrating on few nodes).

    ``rate_phases`` makes the fleet mix *drift*: a sorted tuple of
    ``(t_start_s, fleet_rates)`` segments; from each start instant the
    fleet rates step to that segment's map (models absent from a segment
    are at zero there).  ``rates`` stays the t=0 mix — it is what the
    fleet is provisioned for, so a drift away from it strands capacity
    unless placement moves too (the migration experiments).

    ``placement`` partitions the fleet: entry ``i`` is node ``i``'s
    provisioned ``{model: req/s}`` map.  ``None`` keeps the classic
    every-node-serves-every-model 1/N split.
    """

    name: str
    n_nodes: int
    rates: dict[str, float]
    priority_mix: tuple[tuple[int, float], ...] = ((0, 1.0),)
    node_weights: tuple[float, ...] | None = None
    hotspot: tuple[float, float, float] | None = None  # (t0_s, t1_s, mult)
    hot_models: tuple[str, ...] = ()
    fail_at_s: tuple[tuple[int, float], ...] = ()
    #: popularity drift: ((t_start_s, fleet_rates), ...), sorted by start.
    #: Mutually exclusive with ``hotspot`` (a burst is expressible as a
    #: phase segment; silently combining the two would drop one).
    rate_phases: tuple[tuple[float, dict[str, float]], ...] | None = None
    #: per-node provisioned rates (partitioned placement); None = 1/N split
    placement: tuple[dict[str, float], ...] | None = None

    def __post_init__(self):
        if self.rate_phases is not None and self.hotspot is not None:
            raise ValueError(
                "rate_phases and hotspot cannot be combined: express "
                "the burst as a phase segment instead")
        seen: set[int] = set()
        for node_id, t_s in self.fail_at_s:
            if t_s < 0:
                raise ValueError(
                    f"fail_at_s: negative failure instant {t_s} "
                    f"for node {node_id}")
            if not 0 <= node_id < self.n_nodes:
                raise ValueError(
                    f"fail_at_s names node {node_id}; scenario "
                    f"{self.name!r} has nodes 0..{self.n_nodes - 1}")
            if node_id in seen:
                raise ValueError(
                    f"fail_at_s lists node {node_id} twice — a node "
                    "dies at most once")
            seen.add(node_id)

    def warn_if_failures_after(self, horizon_s: float) -> None:
        """Warn about scheduled deaths that can never fire.

        Called by the trace builders, which know the horizon the
        scenario will actually run under; a failure at/after it makes
        the 'failure-drain' scenario silently failure-free.
        """
        for node_id, t_s in self.fail_at_s:
            if t_s >= horizon_s:
                warnings.warn(
                    f"scenario {self.name!r}: node {node_id} failure at "
                    f"{t_s} s is at/after the {horizon_s} s horizon and "
                    "never fires", stacklevel=3)

    def models(self) -> list[str]:
        """Every model named anywhere in the scenario (sorted)."""
        names = set(self.rates)
        for _t0, seg in self.rate_phases or ():
            names.update(seg)
        return sorted(names)

    def rate_fn(self, model: str):
        """Instantaneous fleet rate of ``model`` as a function of t (s)."""
        base = self.rates.get(model, 0.0)
        if self.rate_phases is not None:
            steps = sorted((t0, seg.get(model, 0.0))
                           for t0, seg in self.rate_phases)

            def fn(t: float) -> float:
                r = base
                for t0, seg_r in steps:
                    if t >= t0:
                        r = seg_r
                    else:
                        break
                return r
            return fn
        if self.hotspot is None or model not in self.hot_models:
            return lambda t: base
        t0, t1, mult = self.hotspot

        def fn(t: float) -> float:
            return base * mult if t0 <= t < t1 else base
        return fn

    def peak_rate(self, model: str) -> float:
        base = self.rates.get(model, 0.0)
        if self.rate_phases is not None:
            return max([base] + [seg.get(model, 0.0)
                                 for _t0, seg in self.rate_phases])
        if self.hotspot is not None and model in self.hot_models:
            return base * self.hotspot[2]
        return base

    def varies(self, model: str) -> bool:
        """True iff ``model``'s fleet rate changes over the horizon."""
        if self.rate_phases is not None:
            base = self.rates.get(model, 0.0)
            return any(seg.get(model, 0.0) != base
                       for _t0, seg in self.rate_phases)
        return self.hotspot is not None and model in self.hot_models


def fabric_node_sweep(per_node_rates: dict[str, float] | None = None,
                      node_counts: tuple[int, ...] = (1, 2, 4, 8, 16),
                      priority_mix: tuple[tuple[int, float], ...]
                      = DEFAULT_PRIORITY_MIX) -> list[FabricScenario]:
    """Weak-scaling sweep: fleet rates grow with the node count."""
    per_node = per_node_rates or SWEEP_NODE_RATES
    return [FabricScenario(
        name=f"sweep-{n}n", n_nodes=n,
        rates={m: r * n for m, r in per_node.items()},
        priority_mix=priority_mix) for n in node_counts]


def skewed_node_popularity(n_nodes: int, skew: float = 1.2
                           ) -> tuple[float, ...]:
    """Zipf(skew) per-node popularity weights, normalized to sum to 1.

    Feeds the router's model-affinity policy: with skew > 0 sticky
    sessions pile onto the first few nodes, creating exactly the hot-spot
    imbalance the shed/re-route machinery has to absorb.
    """
    w = [1.0 / (i + 1) ** skew for i in range(n_nodes)]
    total = sum(w)
    return tuple(x / total for x in w)


def hotspot_scenario(n_nodes: int,
                     per_node_rates: dict[str, float] | None = None,
                     hot_models: tuple[str, ...] = ("res",),
                     t0_s: float = 20.0, t1_s: float = 40.0,
                     mult: float = 3.0,
                     priority_mix: tuple[tuple[int, float], ...]
                     = DEFAULT_PRIORITY_MIX) -> FabricScenario:
    """A flash crowd: ``hot_models`` burst to ``mult``x inside [t0, t1]."""
    per_node = per_node_rates or SWEEP_NODE_RATES
    return FabricScenario(
        name=f"hotspot-{n_nodes}n", n_nodes=n_nodes,
        rates={m: r * n_nodes for m, r in per_node.items()},
        priority_mix=priority_mix, hotspot=(t0_s, t1_s, mult),
        hot_models=tuple(hot_models))


def failure_drain_scenario(n_nodes: int,
                           per_node_rates: dict[str, float] | None = None,
                           fail_node: int = 0, fail_at_s: float = 10.0,
                           priority_mix: tuple[tuple[int, float], ...]
                           = DEFAULT_PRIORITY_MIX) -> FabricScenario:
    """One node dies mid-horizon; survivors absorb its drained traffic."""
    per_node = per_node_rates or SWEEP_NODE_RATES
    return FabricScenario(
        name=f"faildrain-{n_nodes}n", n_nodes=n_nodes,
        rates={m: r * n_nodes for m, r in per_node.items()},
        priority_mix=priority_mix,
        fail_at_s=((fail_node, fail_at_s),))


# ---------------------------------------------------------------------------
# migration scenarios (ROADMAP "fabric-level global rescheduling"): the
# fleet mix drifts away from the provisioned placement, stranding capacity
# on nodes that serve yesterday's hot model unless placement moves too.
# ---------------------------------------------------------------------------

def unit_load(model: str, rate: float) -> float:
    """Heuristic node-capacity cost of serving ``model`` at ``rate``.

    Calibrated against :data:`SWEEP_NODE_RATES`: that mix is a known
    comfortably-schedulable full node, and treating each of its models as
    one equal share makes ``rate / (n_models * sweep_rate)`` the fraction
    of a node the stream costs.  Placement generators use this to
    bin-pack; :class:`~repro.core.elastic.ElasticPartitioning` remains
    the ground truth at build time.
    """
    ref = SWEEP_NODE_RATES.get(model)
    if ref is None:
        ref = sum(SWEEP_NODE_RATES.values()) / len(SWEEP_NODE_RATES)
    return rate / (len(SWEEP_NODE_RATES) * ref)


def zipf_model_rates(models: tuple[str, ...], total_load: float,
                     skew: float = 1.1, hot_index: int = 0
                     ) -> dict[str, float]:
    """Fleet rates with Zipf(``skew``) popularity over ``models``.

    ``models[hot_index]`` is rank 1; ranks rotate from there.  The zipf
    weights split ``total_load`` *node-capacity units* (see
    :func:`unit_load`), then convert to req/s per model — so the fleet's
    aggregate load is mix-independent and drifting the hot index moves
    demand without changing the total.
    """
    n = len(models)
    w = [1.0 / (((i - hot_index) % n) + 1) ** skew for i in range(n)]
    total_w = sum(w)
    out = {}
    for m, wi in zip(models, w):
        load_m = total_load * wi / total_w
        # invert unit_load: rate = load * n_models * sweep_rate
        ref = SWEEP_NODE_RATES.get(
            m, sum(SWEEP_NODE_RATES.values()) / len(SWEEP_NODE_RATES))
        out[m] = load_m * len(SWEEP_NODE_RATES) * ref
    return out


def partition_placement(rates: dict[str, float], n_nodes: int,
                        max_node_share: float = 0.5
                        ) -> tuple[dict[str, float], ...]:
    """Bin-pack fleet rates onto nodes: each model gets few *homes*.

    Each model's fleet rate is split across ``ceil(load / max_node_share)``
    homes (so no single node carries more than ``max_node_share`` of its
    capacity for one model) chosen greedily least-loaded-first.  Models
    are placed hottest-first, so the resulting placement concentrates
    cold models on few nodes — exactly the shape popularity drift breaks.
    """
    placement: list[dict[str, float]] = [{} for _ in range(n_nodes)]
    load = [0.0] * n_nodes
    for m, r in sorted(rates.items(), key=lambda kv: (-unit_load(*kv),
                                                      kv[0])):
        if r <= 0:
            continue
        lm = unit_load(m, r)
        homes = max(1, min(n_nodes, math.ceil(lm / max_node_share)))
        share = r / homes
        order = sorted(range(n_nodes), key=lambda i: (load[i], i))
        for i in order[:homes]:
            placement[i][m] = placement[i].get(m, 0.0) + share
            load[i] += lm / homes
    return tuple(placement)


PAPER_MODELS: tuple[str, ...] = ("le", "goo", "res", "ssd", "vgg")


def drifting_zipf_scenario(n_nodes: int,
                           models: tuple[str, ...] = PAPER_MODELS,
                           horizon_s: float = 48.0,
                           n_phases: int = 3,
                           skew: float = 1.1,
                           util: float = 0.75,
                           priority_mix: tuple[tuple[int, float], ...]
                           = DEFAULT_PRIORITY_MIX) -> FabricScenario:
    """Popularity drift: the Zipf rank-1 model migrates across the vocab.

    Phase 0's hot model is generously provisioned (partitioned
    placement); each subsequent phase hands rank 1 to what was the
    *coldest* model — the worst case for a frozen placement, because the
    new hot model has the fewest homes.  Fleet aggregate load stays at
    ``util * n_nodes`` capacity units throughout, so a re-route-only
    fabric is not globally overloaded — its capacity is merely stranded
    in the wrong place.
    """
    phase0 = zipf_model_rates(models, util * n_nodes, skew, hot_index=0)
    phases = []
    for k in range(1, n_phases):
        hot = (-k) % len(models)
        phases.append((k * horizon_s / n_phases,
                       zipf_model_rates(models, util * n_nodes, skew,
                                        hot_index=hot)))
    return FabricScenario(
        name=f"drift-zipf-{n_nodes}n", n_nodes=n_nodes, rates=phase0,
        priority_mix=priority_mix, rate_phases=tuple(phases),
        placement=partition_placement(phase0, n_nodes))


def hotspot_migration_scenario(n_nodes: int,
                               models: tuple[str, ...] = PAPER_MODELS,
                               t0_s: float = 8.0, t1_s: float = 30.0,
                               mult: float = 3.0,
                               skew: float = 1.1,
                               util: float = 0.7,
                               priority_mix: tuple[tuple[int, float], ...]
                               = DEFAULT_PRIORITY_MIX) -> FabricScenario:
    """Flash hotspot on the *coldest* (fewest-homes) model.

    Unlike :func:`hotspot_scenario` (uniform placement, burst absorbed by
    shed/re-route), here the burst lands on a model whose partitioned
    placement gives it the least capacity — only migrating it onto idle
    nodes helps.
    """
    rates = zipf_model_rates(models, util * n_nodes, skew, hot_index=0)
    coldest = min(rates, key=lambda m: (unit_load(m, rates[m]), m))
    return FabricScenario(
        name=f"hotspot-mig-{n_nodes}n", n_nodes=n_nodes, rates=rates,
        priority_mix=priority_mix, hotspot=(t0_s, t1_s, mult),
        hot_models=(coldest,),
        placement=partition_placement(rates, n_nodes))


def drift_failure_scenario(n_nodes: int,
                           fail_node: int = 0, fail_at_s: float = 18.0,
                           horizon_s: float = 36.0,
                           **kwargs) -> FabricScenario:
    """Popularity drift plus a node death mid-drift.

    Node 0 carries the phase-0 hot model (placement puts the hottest
    shares on the emptiest nodes first), so with the default arguments
    the failure hits a node the global rescheduler is actively reshaping
    — the donor-fails-mid-migration case.
    """
    scn = drifting_zipf_scenario(n_nodes, horizon_s=horizon_s, **kwargs)
    return dataclasses.replace(
        scn, name=f"drift-fail-{n_nodes}n",
        fail_at_s=((fail_node, fail_at_s),))


# ---------------------------------------------------------------------------
# autoscaling scenarios (ISSUE 10): fleet-*size* pressure, not just mix
# drift.  Diurnal cycles, flash crowds, and correlated zone-failure +
# crowd storms — the shapes where reacting to observed load is too late
# and forecast-driven pre-warming pays.  Pure descriptions as always;
# the zone-failure generator additionally returns the FaultPlan the
# chaos loop injects.
# ---------------------------------------------------------------------------

def diurnal_scenario(n_nodes: int,
                     models: tuple[str, ...] = PAPER_MODELS,
                     horizon_s: float = 64.0,
                     n_phases: int = 8,
                     low_util: float = 0.35,
                     peak_util: float = 0.95,
                     skew: float = 1.1,
                     priority_mix: tuple[tuple[int, float], ...]
                     = DEFAULT_PRIORITY_MIX) -> FabricScenario:
    """Two regions' day/night cycles sharing one fleet, half a cycle apart.

    The model vocab splits into two "regions" (front half / back half)
    whose aggregate loads follow one sinusoidal day each, offset by half
    a cycle — when region A peaks at ``peak_util`` of ``n_nodes``-worth
    of its share, region B is at ``low_util``.  A fixed fleet must be
    sized for the *sum of peaks*; an autoscaler can ride the wave.  The
    cycle is sampled into ``n_phases`` step segments (``rate_phases``).
    """
    half = (len(models) + 1) // 2
    region_a, region_b = models[:half], models[half:]
    mid = 0.5 * (low_util + peak_util)
    amp = 0.5 * (peak_util - low_util)

    def mix(frac: float) -> dict[str, float]:
        ua = mid + amp * math.sin(2.0 * math.pi * frac)
        ub = mid + amp * math.sin(2.0 * math.pi * frac + math.pi)
        out = zipf_model_rates(
            region_a, ua * n_nodes * len(region_a) / len(models), skew)
        if region_b:
            out.update(zipf_model_rates(
                region_b, ub * n_nodes * len(region_b) / len(models),
                skew))
        return out

    phases = tuple((k * horizon_s / n_phases, mix(k / n_phases))
                   for k in range(1, n_phases))
    return FabricScenario(
        name=f"diurnal-{n_nodes}n", n_nodes=n_nodes, rates=mix(0.0),
        priority_mix=priority_mix, rate_phases=phases)


def flash_crowd_scenario(n_nodes: int,
                         crowd_model: str = "vgg",
                         models: tuple[str, ...] = PAPER_MODELS,
                         horizon_s: float = 40.0,
                         t0_s: float = 12.0,
                         ramp_s: float = 4.0,
                         t1_s: float = 30.0,
                         base_util: float = 0.55,
                         crowd_units: float | None = None,
                         crowd_frac_start: float = 0.4,
                         cold_frac: float = 0.02,
                         skew: float = 1.1,
                         priority_mix: tuple[tuple[int, float], ...]
                         = DEFAULT_PRIORITY_MIX) -> FabricScenario:
    """Flash crowd on a (nearly) cold model: zero→ramp→peak→gone.

    The fleet serves a steady Zipf base mix at ``base_util`` of
    ``n_nodes`` capacity units, with ``crowd_model`` at only a
    ``cold_frac`` trickle of its coming peak.  At ``t0_s`` the crowd
    arrives at ``crowd_frac_start`` of its peak, ramps to the full
    ``crowd_units`` node-capacity units of extra load by
    ``t0_s + ramp_s``, and vanishes at ``t1_s``.  ``cold_frac=0`` makes
    the crowd model *fully* cold before ``t0_s`` — the first-seen-model
    forecasting case (``predict_target`` cold-start trend seeding) —
    at the price of un-provisioned dispatch while it has no home.
    """
    if crowd_model not in models:
        raise ValueError(f"crowd model {crowd_model!r} not in {models}")
    base_models = tuple(m for m in models if m != crowd_model)
    base = zipf_model_rates(base_models, base_util * n_nodes, skew)
    if crowd_units is None:
        crowd_units = 0.9 * n_nodes
    ref = SWEEP_NODE_RATES.get(
        crowd_model, sum(SWEEP_NODE_RATES.values()) / len(SWEEP_NODE_RATES))
    crowd_rate = crowd_units * len(SWEEP_NODE_RATES) * ref
    rates0 = dict(base)
    if cold_frac > 0.0:
        rates0[crowd_model] = cold_frac * crowd_rate
    phases = (
        (t0_s, {**base, crowd_model: crowd_frac_start * crowd_rate}),
        (t0_s + ramp_s, {**base, crowd_model: crowd_rate}),
        (t1_s, dict(rates0)),
    )
    return FabricScenario(
        name=f"flash-crowd-{n_nodes}n", n_nodes=n_nodes, rates=rates0,
        priority_mix=priority_mix, rate_phases=phases)


def zone_failure_crowd_scenario(n_nodes: int,
                                zone: tuple[int, ...] = (0,),
                                fail_at_s: float | None = None,
                                net_window_s: float = 4.0,
                                net_extra_ms: float = 3.0,
                                net_loss: float = 0.05,
                                seed: int = 0,
                                **crowd_kwargs):
    """Correlated zone failure + flash crowd: the worst hour on call.

    The availability zone ``zone`` (a node-id tuple) permanently crashes
    right as the flash crowd hits full strength (default: the end of the
    ramp), under a degraded lossy network — the correlated-failure shape
    where lost capacity and spiking demand compound.  Returns
    ``(scenario, fault_plan)``: the scenario drives trace + fleet
    construction, the plan goes into ``FabricConfig.faults`` so the
    chaos loop injects (and the health detector must *detect*) the zone
    loss.
    """
    from repro_torch.faults import (FaultPlan, NetworkDegradation,
                              PermanentCrash)
    scn = flash_crowd_scenario(n_nodes, **crowd_kwargs)
    bad = [i for i in zone if not 0 <= i < n_nodes]
    if bad:
        raise ValueError(f"zone names node(s) {bad}; "
                         f"fleet has nodes 0..{n_nodes - 1}")
    if fail_at_s is None:
        fail_at_s = crowd_kwargs.get("t0_s", 12.0) \
            + crowd_kwargs.get("ramp_s", 4.0)
    t_fail = fail_at_s * 1e3
    faults = tuple(PermanentCrash(node_id=int(i), t_ms=t_fail)
                   for i in sorted(set(zone)))
    faults += (NetworkDegradation(
        t0_ms=t_fail, t1_ms=t_fail + net_window_s * 1e3,
        extra_ms=net_extra_ms, loss_prob=net_loss),)
    scn = dataclasses.replace(scn, name=f"zone-crowd-{n_nodes}n")
    return scn, FaultPlan(faults, seed=seed)


# ---------------------------------------------------------------------------
# compound-inference (DAG) scenarios (ROADMAP "requests as model DAGs"):
# a client request is a task graph over several models with ONE end-to-end
# SLO — e.g. frontend -> detector -> per-region classifier fan-out ->
# fusion.  Pure descriptions again: repro.fabric.workload materializes
# them into staged RequestTraces (RequestTrace.attach_stages).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DagTemplate:
    """One job shape: a small model DAG every job of this type instances.

    ``stage_models[i]`` is stage ``i``'s model; ``parents[i]`` lists its
    parent stage ids.  Stages are numbered in topological order and each
    stage's parents must be *consecutive* ids — the trace encodes a
    stage's fan-in as one contiguous row range (first parent + count),
    and laying template stages out in this shape makes every job's
    parent ranges contiguous by construction.  Chains, fan-outs, and
    fan-ins all fit; an arbitrary DAG may need duplicate stages.

    ``slo_scale`` sizes the end-to-end job SLO as a multiple of the
    critical-path sum of the stage models' standalone SLOs (see
    :func:`critical_path_budgets`): 1.0 leaves zero slack for queueing,
    network hops, and release-frontier staleness; the defaults leave a
    realistic margin.
    """

    name: str
    stage_models: tuple[str, ...]
    parents: tuple[tuple[int, ...], ...]
    slo_scale: float = 1.25

    def __post_init__(self):
        if len(self.parents) != len(self.stage_models):
            raise ValueError("parents and stage_models length mismatch")
        if not self.stage_models:
            raise ValueError("a template needs at least one stage")
        for i, ps in enumerate(self.parents):
            if any(p < 0 or p >= i for p in ps):
                raise ValueError(
                    f"stage {i}: parents must be earlier stage ids")
            if ps and list(ps) != list(range(ps[0], ps[0] + len(ps))):
                raise ValueError(
                    f"stage {i}: parent ids must be consecutive")
        if self.parents[0] != ():
            raise ValueError("stage 0 must be a root")

    @property
    def n_stages(self) -> int:
        return len(self.stage_models)

    def first_parent(self, i: int) -> int:
        return self.parents[i][0] if self.parents[i] else -1


def critical_path_budgets(template: DagTemplate,
                          weights: dict[str, float]
                          ) -> tuple[float, tuple[float, ...]]:
    """Decompose one end-to-end job SLO into per-stage budgets.

    ``weights[m]`` is stage weight (the model's standalone SLO is the
    natural choice: it already encodes relative service demand).  The
    job SLO is ``slo_scale`` times the critical-path weight sum, and
    stage ``i`` gets ``job_slo * w_i / path_through(i)`` where
    ``path_through(i)`` is the heaviest root→leaf path containing ``i``
    — so budgets along the critical path sum *exactly* to the job SLO
    (each critical stage gets ``slo_scale * w_i``), and off-critical
    stages get proportionally more slack.
    """
    ms, ps = template.stage_models, template.parents
    n = len(ms)
    w = [float(weights[m]) for m in ms]
    to = [0.0] * n          # heaviest path ending at i (inclusive)
    for i in range(n):
        to[i] = w[i] + max((to[p] for p in ps[i]), default=0.0)
    children: list[list[int]] = [[] for _ in range(n)]
    for i, pp in enumerate(ps):
        for p in pp:
            children[p].append(i)
    frm = [0.0] * n         # heaviest path starting at i (inclusive)
    for i in range(n - 1, -1, -1):
        frm[i] = w[i] + max((frm[c] for c in children[i]), default=0.0)
    cpl = max(to)
    job_slo = template.slo_scale * cpl
    budgets = tuple(job_slo * w[i] / (to[i] + frm[i] - w[i])
                    for i in range(n))
    return job_slo, budgets


def chain_template(models: tuple[str, ...] = ("le", "ssd", "goo"),
                   slo_scale: float = 1.25,
                   name: str | None = None) -> DagTemplate:
    """A linear pipeline: every stage feeds the next."""
    parents = ((),) + tuple((i,) for i in range(len(models) - 1))
    return DagTemplate(name or "chain-" + "-".join(models),
                       tuple(models), parents, slo_scale)


def fanout_fanin_template(pre: tuple[str, ...] = ("le", "ssd"),
                          branch: str = "goo", n_branches: int = 3,
                          post: str = "le",
                          slo_scale: float = 1.25,
                          name: str | None = None) -> DagTemplate:
    """Frontend chain -> detector fan-out -> fusion fan-in.

    ``pre`` is a chain (frontend, detector); the last pre stage fans out
    to ``n_branches`` parallel ``branch`` classifiers (per-region crops),
    which a single ``post`` fusion stage joins.
    """
    if n_branches < 1:
        raise ValueError("need at least one branch")
    models = tuple(pre) + (branch,) * n_branches + (post,)
    parents: list[tuple[int, ...]] = [()]
    parents += [(i,) for i in range(len(pre) - 1)]
    fan_src = len(pre) - 1
    parents += [(fan_src,)] * n_branches
    parents.append(tuple(range(len(pre), len(pre) + n_branches)))
    return DagTemplate(
        name or f"fanout-{branch}x{n_branches}", models, tuple(parents),
        slo_scale)


@dataclasses.dataclass(frozen=True)
class DagScenario:
    """One compound-inference experiment: DAG jobs + background singles.

    ``dag_rates`` maps templates to fleet-total *job* arrival rates
    (jobs/s); every stage of a template sees the full job rate.
    ``background`` adds plain single-model traffic (fleet-total req/s) —
    the mixed-traffic case where stage rows and classic rows share one
    trace and one fleet.  Priorities are drawn per *job* (a job's stages
    share one class: shedding a silver stage kills a silver job, not a
    random stage of a gold one) and per background request.
    """

    name: str
    n_nodes: int
    dag_rates: tuple[tuple[DagTemplate, float], ...]
    background: dict[str, float] = dataclasses.field(default_factory=dict)
    priority_mix: tuple[tuple[int, float], ...] = ((0, 1.0),)

    def fleet_rates(self) -> dict[str, float]:
        """Per-model fleet req/s incl. stage multiplicities (for
        provisioning: ElasticPartitioning sees the model streams DAG
        traffic actually generates)."""
        out = dict(self.background)
        for tpl, rate in self.dag_rates:
            for m in tpl.stage_models:
                out[m] = out.get(m, 0.0) + rate
        return {m: r for m, r in out.items() if r > 0}


def chain_dag_scenario(n_nodes: int, jobs_per_node_s: float = 20.0,
                       models: tuple[str, ...] = ("le", "ssd", "goo"),
                       slo_scale: float = 1.25,
                       priority_mix: tuple[tuple[int, float], ...]
                       = ((0, 1.0),)) -> DagScenario:
    """Pure chain-job traffic (the simplest DAG rung)."""
    tpl = chain_template(models, slo_scale)
    return DagScenario(name=f"dag-chain-{n_nodes}n", n_nodes=n_nodes,
                       dag_rates=((tpl, jobs_per_node_s * n_nodes),),
                       priority_mix=priority_mix)


def fanout_fanin_scenario(n_nodes: int, jobs_per_node_s: float = 10.0,
                          n_branches: int = 3,
                          slo_scale: float = 1.25,
                          priority_mix: tuple[tuple[int, float], ...]
                          = ((0, 1.0),)) -> DagScenario:
    """Pure fan-out/fan-in traffic (parallel branches + fusion join)."""
    tpl = fanout_fanin_template(n_branches=n_branches, slo_scale=slo_scale)
    return DagScenario(name=f"dag-fanout-{n_nodes}n", n_nodes=n_nodes,
                       dag_rates=((tpl, jobs_per_node_s * n_nodes),),
                       priority_mix=priority_mix)


def mixed_dag_scenario(n_nodes: int,
                       chain_jobs_per_node_s: float = 15.0,
                       fanout_jobs_per_node_s: float = 8.0,
                       background_util: float = 0.4,
                       slo_scale: float = 1.25,
                       priority_mix: tuple[tuple[int, float], ...]
                       = DEFAULT_PRIORITY_MIX) -> DagScenario:
    """DAG jobs + classic single-model traffic on one fleet.

    Background singles at ``background_util`` of the sweep mix keep the
    fleet busy with stage-oblivious work, so the DAG rungs measure how
    compound jobs fare *among* ordinary traffic, not on an idle fleet.
    """
    chain = chain_template(("le", "ssd", "goo"), slo_scale)
    fanout = fanout_fanin_template(("le", "ssd"), "goo", 3, "le",
                                   slo_scale)
    bg = {m: r * background_util * n_nodes
          for m, r in SWEEP_NODE_RATES.items()}
    return DagScenario(
        name=f"dag-mixed-{n_nodes}n", n_nodes=n_nodes,
        dag_rates=((chain, chain_jobs_per_node_s * n_nodes),
                   (fanout, fanout_jobs_per_node_s * n_nodes)),
        background=bg, priority_mix=priority_mix)


# Streaming (prefill/decode) scenarios --------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Token-length distributions and phase SLOs for one model's streams.

    Prompt and output lengths draw from geometric distributions (the
    long-tail shape of generative traffic) clipped to ``[1, max]``.
    ``ttft_slo_ms=None`` reuses the model's standalone SLO as the TTFT
    deadline — the queueing+prefill budget the classic scenarios already
    grant a one-shot request.  The TPOT SLO is expressed as a multiple
    of the model's reference decode-step cost (batch 8 on a whole GPU),
    so the cadence target stays achievable per model without hand-tuned
    absolute numbers.
    """

    prompt_mean: float = 256.0
    prompt_max: int = 1024
    output_mean: float = 24.0
    output_max: int = 128
    ttft_slo_ms: float | None = None
    tpot_scale: float = 3.0


@dataclasses.dataclass(frozen=True)
class StreamScenario:
    """One streaming serving experiment.

    Wraps a classic :class:`FabricScenario` — the vocabulary, Zipf
    rate machinery, and priority mix are shared with the drift
    generators — plus a per-model :class:`StreamSpec`.  ``rates`` count
    *streams* per second; the decode work each stream drags behind its
    prefill is what phase-aware provisioning accounts for and
    phase-oblivious provisioning ignores.
    """

    base: FabricScenario
    specs: dict[str, StreamSpec] = dataclasses.field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.base.name

    @property
    def n_nodes(self) -> int:
        return self.base.n_nodes

    @property
    def rates(self) -> dict[str, float]:
        return self.base.rates

    def spec(self, model: str) -> StreamSpec:
        return self.specs.get(model, _DEFAULT_STREAM_SPEC)


_DEFAULT_STREAM_SPEC = StreamSpec()

#: chat-shaped models: short prompts, long decode streams, tight TTFT
INTERACTIVE_STREAM_SPEC = StreamSpec(
    prompt_mean=96.0, prompt_max=512, output_mean=40.0, output_max=160,
    tpot_scale=3.0)
#: summarization/embedding-shaped: long prompts, short outputs
BATCH_STREAM_SPEC = StreamSpec(
    prompt_mean=448.0, prompt_max=1024, output_mean=6.0, output_max=24,
    tpot_scale=6.0)


def streaming_zipf_scenario(n_nodes: int,
                            models: tuple[str, ...] = PAPER_MODELS,
                            skew: float = 1.1,
                            util: float = 0.55,
                            interactive: tuple[str, ...] = ("le", "goo"),
                            priority_mix: tuple[tuple[int, float], ...]
                            = DEFAULT_PRIORITY_MIX) -> StreamScenario:
    """Zipf-popular streaming mix over the paper vocabulary.

    Interactive (chat-shaped) models carry long decode tails; the rest
    are batch-shaped (prefill-heavy).  ``util`` counts only the *prefill*
    load — exactly what a phase-oblivious provisioner sees — so the
    decode tail is the unprovisioned surprise the phase-aware arm
    corrects for.
    """
    rates = zipf_model_rates(models, util * n_nodes, skew, hot_index=0)
    base = FabricScenario(name=f"stream-zipf-{n_nodes}n", n_nodes=n_nodes,
                          rates=rates, priority_mix=priority_mix)
    specs = {m: (INTERACTIVE_STREAM_SPEC if m in interactive
                 else BATCH_STREAM_SPEC) for m in models}
    return StreamScenario(base=base, specs=specs)


def schedulability_population(models: tuple[str, ...] = ("le", "goo", "res", "ssd", "vgg"),
                              ) -> list[dict[str, float]]:
    """All 4^5 - 1 = 1023 rate vectors of §3.1 / Fig. 4 / Fig. 15."""
    pop = []
    for combo in itertools.product(SCHEDULABILITY_RATES, repeat=len(models)):
        if all(c == 0 for c in combo):
            continue
        pop.append({m: float(r) for m, r in zip(models, combo) if r > 0})
    return pop
