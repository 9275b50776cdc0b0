"""The serving fabric: a cluster of single-server clusters.

``ServingFabric`` composes the pieces: N :class:`FabricNode`\\ s (each a
full PR-1 serving stack — own gpu-let partitioning, own event-heap engine,
optionally its own rescheduling controller) behind one
:class:`FabricRouter` with a network delay model.  One ``serve(trace)``
call routes the whole client trace, runs every node, handles node
failures by re-dispatching the casualties to survivors, and folds the
results into a :class:`FabricMetrics`.

Degenerate case, by construction: a 1-node fabric with zero network delay
and single-class traffic is event-for-event identical to running the bare
engine on the same schedule (property-tested in tests/test_fabric.py) —
the fabric is a strict superset, not a fork, of the single-server path.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import warnings
from collections.abc import Mapping, Sequence

import numpy as np

from repro_torch.core.elastic import ElasticPartitioning
from repro_torch.core.hardware import ClusterSpec, PAPER_CLUSTER
from repro_torch.core.latency import LatencyProvider
from repro_torch.core.profiles import ModelProfile
from repro_torch.fabric.network import NetworkModel
from repro_torch.fabric.node import FabricNode, NodeSpec
from repro_torch.fabric.router import DispatchStats, FabricRouter
from repro_torch.faults import (BrownoutController, BrownoutParams, FaultPlan,
                          HealthDetector, HealthParams, PermanentCrash,
                          RetryLedger, RetryPolicy, epoch_pressure)
from repro_torch.obs.timeline import (CAUSE_BROWNOUT, CAUSE_DROP_PARENT,
                                CAUSE_DROP_REPLAY, CAUSE_DROP_RETRY,
                                CAUSE_DROP_SHUTDOWN, attach_timeline)
from repro_torch.simulator.engine import EngineConfig
from repro_torch.simulator.events import Request
from repro_torch.simulator.metrics import (JobMetrics, SimMetrics, collect_jobs,
                                     collect_trace)
from repro_torch.simulator.trace import (COMPLETED, DROPPED, FIRST_DROP_STATUS,
                                   PENDING, SHED, UNSERVED, RequestTrace)


@dataclasses.dataclass
class FabricConfig:
    horizon_ms: float = 20_000.0
    #: router dispatch policy: least-loaded | slo-headroom | model-affinity
    policy: str = "least-loaded"
    network: NetworkModel = dataclasses.field(
        default_factory=NetworkModel.zero)
    #: priority-aware nodes: queue ordering + in-flight preemption
    preemption: bool = False
    preempt_cost_ms: float = 1.0
    #: router backlog (ms of queued work) beyond which low-priority
    #: traffic is re-routed / shed
    shed_backlog_ms: float = 500.0
    reroute_level: int = 1
    shed_level: int = 2
    #: detection + re-dispatch lag after a node failure
    failover_ms: float = 1_000.0
    #: per-node rescheduling controller period; None = static schedules
    period_s: float | None = None
    reorg_s: float = 2.0
    #: pluggable L(b, p) for the node engines (tpu-let path); None = GPU
    lat: LatencyProvider | None = None
    interference: bool = True
    #: run healthy nodes' engines across this many forked worker
    #: processes (nodes are independent once dispatched, so results are
    #: identical to the sequential order).  1 = in-process (default;
    #: keeps ``node.engine`` inspectable).  Needs ``os.fork``; silently
    #: falls back to sequential where unavailable.
    node_workers: int = 1
    # ---- fleet-level global rescheduling (live model migration) ----
    #: enable the migration epoch loop.  Off by default: a migration-
    #: blind fabric is byte-identical to the PR-4 serving path.
    migrations: bool = False
    #: migration-epoch length: the fleet controller observes one epoch,
    #: decides at its boundary, and the delta lands on the next
    migration_period_ms: float = 4_000.0
    #: placement-delta budget per epoch (model instances added + evicted)
    max_migrations_per_epoch: int = 2
    #: receiver-side load/warm-up charge before a migrated-in model's
    #: traffic retargets (plus seeded uniform jitter below)
    migration_warmup_ms: float = 400.0
    migration_warmup_jitter_ms: float = 0.0
    migration_seed: int = 0
    #: hysteresis: only chase a model whose forecast exceeds its fleet-
    #: provisioned rate by this relative margin AND this many req/s
    #: (the absolute floor keeps Poisson noise from churning placement)
    migration_min_deficit: float = 0.15
    migration_min_rate_req_s: float = 10.0
    #: consecutive over-threshold epochs before a model's deficit is
    #: acted on.  Re-partitioning a node is never free — it forfeits the
    #: incidental burst capacity of its old gpu-lets — so one noisy
    #: window must not reshape the fleet.
    migration_patience: int = 2
    #: router->new-home lag charged to requests a donor hands back
    handback_ms: float = 5.0
    # ---- fleet autoscaling (predictive pre-warming) ----
    #: enable the fleet-size epoch subscriber.  Off by default: an
    #: autoscaling-blind fabric replays every earlier golden byte-
    #: identically.  Decisions land on the migration-epoch grid
    #: (``migration_period_ms``), with or without migrations enabled.
    autoscale: bool = False
    #: "predictive" pre-warms ahead of the forecast trend; "reactive"
    #: zeroes the trend and scales on observed load only (contrast arm)
    autoscale_mode: str = "predictive"
    autoscale_min_nodes: int = 1
    autoscale_max_nodes: int = 16
    #: utilization headroom: fleet sized so the forecast fits in this
    #: fraction of the smallest schedulable node count
    autoscale_target_util: float = 0.75
    autoscale_max_add_per_epoch: int = 2
    #: consecutive over-provisioned epochs before one node drains
    autoscale_down_patience: int = 2
    #: checkpoint-restore warm-up pricing (a
    #: :class:`~repro.fabric.autoscaler.RestoreCostModel`): spawn and
    #: migration warm-ups are charged per model as bytes over storage
    #: bandwidth.  ``None`` keeps the flat ``migration_warmup_ms``.
    restore: object | None = None
    # ---- task-graph (DAG) serving ----
    #: release-frontier cadence for staged traces: nodes advance in
    #: segments of this length, and stage completions observed at each
    #: boundary release their children into dispatch.  A released child
    #: keeps its true arrival (= max parent completion, possibly inside
    #: the closing segment); the cadence only bounds how stale the
    #: frontier's knowledge may be — the same causality discipline as the
    #: migration epochs.
    stage_release_period_ms: float = 25.0
    #: critical-path-aware stage placement (router co-location hooks);
    #: False = stage-oblivious dispatch, the fig_dag contrast arm
    dag_colocation: bool = True
    # ---- streaming (prefill/decode) serving ----
    #: model -> stream occupancy factor (>= 1) handed to the router so
    #: its fluid backlog weights streaming models by their true service
    #: (prefill + decode tail).  None = phase-oblivious routing, the
    #: fig_streaming contrast arm.  Provisioning-side rate inflation is
    #: the workload builder's job (fabric.workload.build_stream_fabric).
    stream_occupancy: dict[str, float] | None = None
    # ---- fault injection + recovery (chaos serving) ----
    #: typed, seeded fault schedule.  Non-empty plans are served by the
    #: chaos epoch loop (``_serve_chaos``), where failures are *detected*
    #: from dispatch outcomes rather than known in advance; ``None`` (or
    #: an empty plan) keeps every legacy serving path byte-identical.
    faults: FaultPlan | None = None
    #: chaos epoch cadence: dispatch, crash eviction, health observation,
    #: retry replay, and brownout decisions all land on this grid (plus
    #: every fault-window edge, so no window straddles an observation gap)
    chaos_epoch_ms: float = 100.0
    #: a dispatch lost in transit is declared dead this long after send
    #: (its replay cannot be floored earlier — the router has to wait out
    #: the RPC timeout before it knows the request went nowhere)
    rpc_timeout_ms: float = 50.0
    #: the recovery stack: health detection + eviction on the router and
    #: the brownout ladder.  ``False`` is the naive-failover contrast arm
    #: — no detector, a single blind retry with the legacy failover lag.
    recovery: bool = True
    #: deadline-aware retry budget; ``None`` picks the arm default
    #: (``RetryPolicy()`` with recovery, single blind retry without)
    retry: RetryPolicy | None = None
    #: health-detector tuning; ``None`` = ``HealthParams()`` defaults
    health: HealthParams | None = None
    #: graceful degradation under sustained gold-class SLO pressure
    #: (only active together with ``recovery``)
    brownout: bool = True
    brownout_params: BrownoutParams | None = None


@dataclasses.dataclass
class FabricMetrics:
    """Fleet-wide client-perspective metrics + per-node breakdown.

    ``fleet`` is authoritative.  ``per_node`` entries are each node's
    *local* view, snapshotted when its engine finished.  Requests the
    fabric reset and replayed elsewhere — a dead node's casualties, a
    donor's hand-backs, chaos-loop evictions — are excluded from the
    tally of every node that lost them, so each request appears in at
    most one node's counts: the node that finally resolved it.  Summing
    ``per_node`` outcomes therefore partitions the node-touched rows;
    requests the *router* resolved (shed, lost, brownout denials) belong
    to no node and show up only in ``fleet`` / ``stats``.
    """

    fleet: SimMetrics
    per_node: dict[int, SimMetrics]
    stats: DispatchStats
    preemptions: int
    #: applied placement deltas, in decision order (empty when the
    #: migration loop is off or never fired)
    migration_events: list = dataclasses.field(default_factory=list)
    #: end-to-end job accounting for staged (DAG) traces; None otherwise
    jobs: JobMetrics | None = None
    #: chaos-serving diagnostics (retry/detector/brownout counters and
    #: event logs); ``None`` on the legacy serving paths
    chaos: dict | None = None
    #: applied fleet-size deltas (autoscaler joins/drains), in decision
    #: order; empty when autoscaling is off or never fired
    scale_events: list = dataclasses.field(default_factory=list)
    #: node-seconds of provisioned capacity (autoscaling runs only;
    #: None otherwise) — the goodput-per-node-hour denominator
    node_seconds: float | None = None

    @property
    def migrations(self) -> int:
        return len(self.migration_events)

    @property
    def goodput_req_s(self) -> float:
        return self.fleet.goodput_req_s

    @property
    def violation_rate(self) -> float:
        return self.fleet.violation_rate

    @property
    def handed_back(self) -> int:
        """Requests re-dispatched after a migration stranded them."""
        return self.stats.handed_back

    @property
    def failed_over(self) -> int:
        """Requests replayed on survivors after a node failure."""
        return self.stats.failed_over

    def shed_total(self) -> int:
        return sum(self.stats.shed.values())

    def rerouted_total(self) -> int:
        return sum(self.stats.rerouted.values())

    def lost_total(self) -> int:
        return sum(self.stats.lost.values())


class ServingFabric:
    def __init__(self, profiles: Mapping[str, ModelProfile],
                 nodes: Sequence[FabricNode],
                 cfg: FabricConfig | None = None,
                 affinity_weights: dict[int, float] | None = None):
        self.profiles = dict(profiles)
        self.cfg = cfg or FabricConfig()
        if self.cfg.migrations and self.cfg.period_s is not None:
            # a per-node controller reschedules from its own observed
            # rates, which never include a freshly-migrated-in model: its
            # next reorg would silently evict what the fleet just placed
            # (and un-pause migration cuts early).  Until the two
            # subscribers are reconciled, the combination is refused
            # rather than half-working.
            raise ValueError(
                "FabricConfig.migrations and per-node controllers "
                "(period_s) cannot be combined yet")
        if self.cfg.autoscale and self.cfg.period_s is not None:
            raise ValueError(
                "FabricConfig.autoscale and per-node controllers "
                "(period_s) cannot be combined yet — a node controller "
                "cannot reschedule a fleet whose membership changes")
        if self.cfg.autoscale and self.cfg.migration_period_ms <= 0:
            raise ValueError(
                "FabricConfig.autoscale needs a positive "
                "migration_period_ms (the shared epoch grid)")
        self.nodes = list(nodes)
        self._served = False
        #: applied placement deltas (filled by the migration epoch loop)
        self.migration_events: list = []
        #: index arrays re-dispatched after a reset (casualty replays and
        #: migration hand-backs) — the no-double-serve audit trail: a
        #: request index may appear in k+1 node slices only if it was
        #: reset and replayed k times
        self.replayed_ids: list[np.ndarray] = []
        self.global_scheduler = None
        #: injection seam: tests may pre-set a (scripted) FleetAutoscaler
        self.autoscaler = None
        self.router = FabricRouter(
            self.nodes, policy=self.cfg.policy, network=self.cfg.network,
            shed_backlog_ms=self.cfg.shed_backlog_ms,
            reroute_level=self.cfg.reroute_level,
            shed_level=self.cfg.shed_level,
            affinity_weights=affinity_weights,
            dag_colocation=self.cfg.dag_colocation,
            stream_occupancy=self.cfg.stream_occupancy)

    # ---- construction -----------------------------------------------------

    @classmethod
    def build(cls, profiles: Mapping[str, ModelProfile],
              n_nodes: int,
              rates: Mapping[str, float],
              cfg: FabricConfig | None = None,
              node_cluster: ClusterSpec = PAPER_CLUSTER,
              scheduler_factory=None,
              fail_at_ms: Mapping[int, float] | None = None,
              affinity_weights: dict[int, float] | None = None,
              placement: Sequence[Mapping[str, float]] | None = None
              ) -> "ServingFabric":
        """Stand up an N-node fabric provisioned for fleet-total ``rates``.

        Each node is scheduled independently for an equal 1/N share of the
        fleet rates (the router balances arrivals, so equal shares are the
        steady-state expectation) — unless ``placement`` partitions the
        fleet: entry ``i`` is then node ``i``'s own ``{model: req/s}``
        map (few homes per model; the shape the migration experiments
        start from).  ``scheduler_factory(profiles, cluster)`` returns a
        scheduler per node; defaults to plain
        :class:`ElasticPartitioning`.  ``fail_at_ms`` maps node_id -> the
        wall-clock instant that node dies (failure-drain scenarios): it
        is normalized through the typed fault taxonomy — a
        :class:`~repro.faults.FaultPlan` of permanent crashes — so both
        failure entry points share one validation path, then projected
        back onto ``NodeSpec.fail_at_ms`` for the legacy omniscient-drain
        loop.  Plans passed via ``cfg.faults`` instead are served by the
        chaos loop, where ``NodeSpec.fail_at_ms`` stays ``None`` and
        failures must be *detected*.
        """
        cfg = cfg or FabricConfig()
        chaos = cfg.faults is not None and not cfg.faults.is_empty
        if fail_at_ms and chaos:
            raise ValueError(
                "pass node failures either as build(fail_at_ms=...) or "
                "as cfg.faults, not both — the legacy drain loop and the "
                "chaos loop cannot share a fleet")
        plan = cfg.faults
        if fail_at_ms:
            plan = FaultPlan(tuple(
                PermanentCrash(node_id=int(i), t_ms=float(t))
                for i, t in sorted(dict(fail_at_ms).items())))
        crash_ms: dict[int, float] = {}
        if plan is not None:
            bad = [i for i in plan.node_ids() if not 0 <= i < n_nodes]
            if bad:
                raise ValueError(
                    f"fault schedule names node(s) {bad}; "
                    f"fleet has nodes 0..{n_nodes - 1}")
            for i, t in sorted(plan.permanent_crash_ms().items()):
                if t >= cfg.horizon_ms:
                    warnings.warn(
                        f"node {i} permanent crash at {t:.0f} ms is "
                        f"at/after the horizon ({cfg.horizon_ms:.0f} ms) "
                        "and never fires", stacklevel=2)
            if not chaos:
                crash_ms = plan.permanent_crash_ms()
        if placement is not None and len(placement) != n_nodes:
            raise ValueError(
                f"placement has {len(placement)} entries for "
                f"{n_nodes} nodes")
        # the default scheduler is deterministic, so identical nodes can
        # share one solved partitioning; custom factories might not be
        default_sched = scheduler_factory is None
        if scheduler_factory is None:
            def scheduler_factory(profs, cluster):
                return ElasticPartitioning(profs, cluster=cluster,
                                           lat=cfg.lat)
        share = {m: r / n_nodes for m, r in rates.items() if r > 0}
        nodes = []
        static_schedule = None
        for i in range(n_nodes):
            node_share = share if placement is None else \
                {m: r for m, r in placement[i].items() if r > 0}
            sched = scheduler_factory(profiles, node_cluster)
            on_tick = None
            period_ms = None
            reorg_ms = 0.0
            if cfg.period_s is not None:
                from repro_torch.serving.controller import ServingController
                ctrl = ServingController(sched, profiles,
                                         period_s=cfg.period_s,
                                         reorg_s=cfg.reorg_s)
                schedule, on_tick = ctrl.make_subscriber(node_share)
                period_ms = cfg.period_s * 1e3
                reorg_ms = cfg.reorg_s * 1e3
            elif default_sched and placement is None:
                # identical nodes get identical static schedules: solve
                # the partitioning once and share the (read-only) result
                # — at 64 nodes this is most of the fleet build time
                if static_schedule is None:
                    static_schedule = sched.schedule(share)
                schedule = static_schedule
            else:
                schedule = sched.schedule(node_share)
            ecfg = EngineConfig(
                horizon_ms=cfg.horizon_ms, acc=node_cluster.accelerator,
                period_ms=period_ms, reorg_ms=reorg_ms,
                lat=cfg.lat, interference=cfg.interference,
                preemption=cfg.preemption,
                preempt_cost_ms=cfg.preempt_cost_ms)
            spec = NodeSpec(node_id=i, cluster=node_cluster,
                            fail_at_ms=crash_ms.get(i))
            nodes.append(FabricNode(spec, profiles, schedule, ecfg,
                                    on_tick=on_tick))
        return cls(profiles, nodes, cfg, affinity_weights=affinity_weights)

    # ---- serving ----------------------------------------------------------

    def serve(self, requests: "list[Request] | RequestTrace"
              ) -> FabricMetrics:
        """Route and serve one whole-horizon client trace.

        Accepts either the SoA :class:`RequestTrace` (the hot path — no
        per-request objects anywhere) or a list of ``Request`` objects
        (API-edge adapter: converted in, results written back out).
        """
        if isinstance(requests, RequestTrace):
            return self.serve_trace(requests)
        trace = RequestTrace.from_requests(requests)
        fm = self.serve_trace(trace)
        trace.write_back(requests)
        return fm

    def serve_trace(self, trace: RequestTrace) -> FabricMetrics:
        # a fabric run consumes per-node dispatch slices, router load
        # state, and retirement flags: a second serve on the same
        # instance would silently mix traces — build a fresh fabric
        if self._served:
            raise RuntimeError(
                "ServingFabric.serve is single-shot; build a new fabric "
                "for another trace")
        self._served = True
        for node in self.nodes:
            node.trace = trace
        plan = self.cfg.faults
        if plan is not None and not plan.is_empty:
            return self._serve_chaos(trace)
        if trace.has_stages:
            if self.cfg.autoscale:
                raise ValueError(
                    "staged (DAG) traces cannot be autoscaled yet — the "
                    "release-frontier loop assumes a fixed fleet")
            return self._serve_dag(trace)
        if trace.has_streams:
            # the node engines refuse these combinations too (a mid-run
            # reschedule would cut decode pools it cannot carry); fail
            # here with the fleet-level story instead of deep in a node
            if self.cfg.migrations:
                raise ValueError(
                    "streaming traces cannot be combined with migrations "
                    "yet — a migration cut cannot carry a node's live "
                    "decode pools to the model's new home")
            if self.cfg.autoscale:
                raise ValueError(
                    "streaming traces cannot be autoscaled yet — a "
                    "drain cut cannot carry a node's live decode pools")
            if self.cfg.period_s is not None:
                raise ValueError(
                    "streaming traces cannot drive per-node controllers "
                    "(period_s) yet — a reorg cut would strand live "
                    "decode pools")
        if (self.cfg.migrations or self.cfg.autoscale) \
                and self.cfg.migration_period_ms > 0:
            self._dispatch_with_migrations(trace)
        else:
            self.router.dispatch(trace)
        # failing nodes run first (in failure order): their casualties are
        # re-dispatched to nodes that have not executed yet.
        failing = sorted((n for n in self.nodes if n.fails_in_run()),
                         key=lambda n: n.spec.fail_at_ms)
        for node in failing:
            node.run()
            node.retired = True   # router must not target it again
            lost = node.casualties()
            if len(lost):
                # detection lag: the fleet notices the failure, then
                # replays each request from the router.  The replay time
                # becomes the node-side arrival, and the SLO budget
                # shrinks by the time already burned waiting on the dead
                # node — so the survivor's SLO verdict stays
                # client-consistent (same trick as the network delay).
                self._replay(trace, lost, node.spec.fail_at_ms,
                             self.cfg.failover_ms)
                # the casualties now belong to whichever survivor
                # resolves them — re-collect this node's tally without
                # them so per_node outcome counts stay a partition of
                # the fleet totals instead of double-counting replays
                eng = node.engine
                keep = eng._gidx[~np.isin(eng._gidx, lost)]
                busy: dict[int, float] = {}
                for (_epoch, li), ms in eng.busy_ms.items():
                    busy[li] = busy.get(li, 0.0) + ms
                node.metrics = collect_trace(
                    trace, node.spec.fail_at_ms, busy, idx=keep)
        self._run_donors(trace)
        self._run_healthy(trace)
        fleet = collect_trace(trace, self.cfg.horizon_ms)
        per_node = {n.node_id: n.metrics for n in self.nodes
                    if n.metrics is not None}
        preemptions = sum(n.engine.preemptions if n.engine is not None
                          else n.preemptions for n in self.nodes)
        scale_events, node_seconds = self._scale_summary()
        return FabricMetrics(fleet=fleet, per_node=per_node,
                             stats=self.router.stats,
                             preemptions=preemptions,
                             migration_events=list(self.migration_events),
                             scale_events=scale_events,
                             node_seconds=node_seconds)

    def _scale_summary(self) -> tuple[list, float | None]:
        auto = self.autoscaler
        if auto is None:
            return [], None
        return list(auto.events), auto.node_seconds(self.cfg.horizon_ms)

    def _replay(self, trace: RequestTrace, lost: np.ndarray,
                t_floor_ms: float, lag_ms: float,
                handback: bool = False) -> None:
        """Re-dispatch reset requests from the router (casualty or
        hand-back): the replay time becomes the node-side arrival and the
        SLO budget shrinks by the time already burned, so the new home's
        verdict stays client-consistent; a request whose budget is gone
        drops immediately."""
        arr = trace.arrival_ms
        t_replay = np.maximum(arr[lost], t_floor_ms) + lag_ms
        burn = t_replay - arr[lost]
        new_slo = trace.slo_ms[lost] - burn
        trace.slo_ms[lost] = new_slo
        arr[lost] = t_replay
        hopeless = new_slo <= 0.0
        # already hopeless: count the loss
        trace.status[lost[hopeless]] = DROPPED
        ob = trace.obs
        if ob is not None:
            # the old node's launch stamps died with it: clear them so
            # replay wait is charged to migration/failover, not preemption
            ob.reset_rows(lost)
            ob.charge_replay(lost, burn, handback)
            hp = lost[hopeless]
            if len(hp):
                ob.resolve_ms[hp] = t_replay[hopeless]
                ob.cause[hp] = CAUSE_DROP_REPLAY
        replay = lost[~hopeless]
        if len(replay):
            self.replayed_ids.append(replay)
            self.router.dispatch(trace, replay, failover=not handback,
                                 handback=handback)

    # ---- chaos serving (fault injection + recovery, ISSUE 9) ---------------

    def _serve_chaos(self, trace: RequestTrace) -> FabricMetrics:
        """Epoch loop serving a trace under a typed fault schedule.

        Nodes run incrementally (``begin_stream`` / ``run_until``), so
        this path is sequential — ``node_workers`` does not apply.  At
        every boundary of the chaos grid (the ``chaos_epoch_ms`` cadence
        plus every fault-window edge) the loop:

        1. admits the boundary's arrivals through the brownout ladder
           and dispatches them (health-laddered candidate selection);
        2. advances every engine to the boundary;
        3. evicts everything a down node still owes (``crash_evict``)
           and declares in-transit dispatch losses dead once the RPC
           timeout has passed;
        4. folds the epoch's per-node outcomes into the health detector
           — eviction and reinstatement derive from *observed*
           completions and failures, never from the fault plan;
        5. replays the casualties under the deadline-aware retry budget
           (a replay that cannot meet its SLO anymore is shed with
           ``CAUSE_DROP_RETRY``, not re-dispatched);
        6. steps the brownout ladder on the epoch's gold-class miss
           pressure;
        7. lands due migration decisions and donor hand-backs.

        The naive arm (``recovery=False``) skips 4 and 6 and replays
        each casualty once with the flat legacy failover lag — the
        ``fig_chaos`` contrast.  The fault plan is read only to *inject*
        (engine outage/straggler windows, network degradation, eviction
        instants); routing never consults it.
        """
        cfg = self.cfg
        plan = cfg.faults
        horizon = cfg.horizon_ms
        if trace.has_stages:
            raise ValueError(
                "staged (DAG) traces cannot be served under a fault "
                "schedule yet — casualty replay is stage-oblivious")
        if cfg.period_s is not None:
            raise ValueError(
                "per-node controllers (period_s) cannot run under a "
                "fault schedule — incremental engines take no tick "
                "subscriber")
        if cfg.migrations and trace.has_streams:
            raise ValueError(
                "streaming traces cannot be combined with migrations "
                "yet — a migration cut cannot carry a node's live "
                "decode pools to the model's new home")
        if any(n.spec.fail_at_ms is not None for n in self.nodes):
            raise ValueError(
                "NodeSpec.fail_at_ms and cfg.faults cannot be combined "
                "— schedule the crash as a PermanentCrash fault")
        self._chaos_retries = 0
        self._chaos_retry_drops = 0
        policy = cfg.retry
        if policy is None:
            policy = RetryPolicy() if cfg.recovery else RetryPolicy(
                max_retries=1, backoff_base_ms=cfg.failover_ms,
                backoff_factor=1.0)
        ledger = RetryLedger()
        router = self.router
        router.faults_on = True
        det = None
        brown = None
        if cfg.recovery:
            det = HealthDetector([n.node_id for n in self.nodes],
                                 cfg.health or HealthParams())
            router.health = det
            if cfg.brownout:
                # the ladder reads terminal stamps off the timeline;
                # attach one now (pre-dispatch) if the caller didn't
                attach_timeline(trace)
                brown = BrownoutController(cfg.brownout_params
                                           or BrownoutParams())
        if plan.net_windows():
            router.network = cfg.network.with_degradations(
                plan.net_windows())
        for node in self.nodes:
            node.install_faults(plan.outage_windows(node.node_id),
                                plan.straggler_windows(node.node_id))
            node.begin_stream()
        # ---- the chaos epoch grid ----
        bset = {float(horizon)}
        mig_bounds: set[float] = set()
        gs = None
        if cfg.migrations and cfg.migration_period_ms > 0:
            from repro_torch.fabric.global_scheduler import GlobalScheduler
            gs = self.global_scheduler
            if gs is None:
                gs = self.global_scheduler = GlobalScheduler(
                    self.profiles, self.nodes, cfg)
            gs.health = det
        auto = self._make_autoscaler()
        if auto is not None:
            auto.health = det
        if (gs is not None or auto is not None) \
                and cfg.migration_period_ms > 0:
            k = 1
            while k * cfg.migration_period_ms < horizon - 1e-9:
                mig_bounds.add(k * cfg.migration_period_ms)
                k += 1
            bset |= mig_bounds
        if cfg.chaos_epoch_ms > 0:
            k = 1
            while k * cfg.chaos_epoch_ms < horizon - 1e-9:
                bset.add(k * cfg.chaos_epoch_ms)
                k += 1
        for b in plan.boundary_instants():
            if 0.0 < b < horizon:
                bset.add(float(b))
        boundaries = sorted(bset)
        # bucket by pristine client arrivals, before network shifts
        ep = np.searchsorted(np.asarray(boundaries), trace.arrival_ms,
                             side="right")
        ep = np.minimum(ep, len(boundaries) - 1)
        epoch_ids = [np.flatnonzero(ep == k)
                     for k in range(len(boundaries))]
        nm = len(trace.models)
        mig_counts = np.zeros(nm, dtype=np.int64)
        pend_len = [len(n.pending_idx) for n in self.nodes]
        last_mig = 0.0
        t_prev = 0.0
        for k, t1 in enumerate(boundaries):
            ids = epoch_ids[k]
            if len(ids):
                ids = self._brownout_admit(trace, ids, brown)
            if len(ids):
                router.dispatch(trace, ids)
                if gs is not None or auto is not None:
                    mig_counts += np.bincount(trace.model_id[ids],
                                              minlength=nm)
            for node in self.nodes:
                node.feed_pending()
            for node in self.nodes:
                node.run_until(t1)
            # -- casualty collection: crash evictions + transit losses --
            failed = {n.node_id: 0 for n in self.nodes}
            lost_parts: list[np.ndarray] = []
            floor_parts: list[np.ndarray] = []
            for node in self.nodes:
                if plan.down_at(node.node_id, t1):
                    ev = node.crash_evict(t1)
                    if len(ev):
                        failed[node.node_id] += len(ev)
                        lost_parts.append(ev)
                        floor_parts.append(np.full(len(ev), t1))
            if router.in_transit_lost:
                g = np.asarray([x[0] for x in router.in_transit_lost],
                               dtype=np.int64)
                fl = np.asarray([x[1] + cfg.rpc_timeout_ms
                                 for x in router.in_transit_lost])
                for _gid, _ts, nid in router.in_transit_lost:
                    failed[nid] += 1
                router.in_transit_lost.clear()
                lost_parts.append(g)
                floor_parts.append(np.minimum(fl, t1))
            # -- health: observed outcomes only, never the plan --
            if det is not None:
                for node in self.nodes:
                    det.observe(node.node_id, t1,
                                self._node_ok(node, t_prev, t1),
                                failed[node.node_id])
            if lost_parts:
                self._chaos_replay(trace, np.concatenate(lost_parts),
                                   np.concatenate(floor_parts),
                                   policy, ledger)
                for node in self.nodes:
                    node.feed_pending()
            if brown is not None:
                brown.on_epoch(t1, epoch_pressure(trace, t_prev, t1),
                               trace)
            # -- donor hand-backs: queues released by a staged apply --
            for node in self.nodes:
                if not node.removed_models:
                    continue
                due = [m for m, ta in node.removed_models.items()
                       if ta <= t1]
                if not due:
                    continue
                mids = [trace.model_index[m] for m in due
                        if m in trace.model_index]
                ev = node.evict_unrouted(mids) if mids else \
                    np.empty(0, dtype=np.int64)
                for m in due:
                    del node.removed_models[m]
                if len(ev):
                    self._replay(trace, ev, t1, cfg.handback_ms,
                                 handback=True)
                    for nd in self.nodes:
                        nd.feed_pending()
            # -- fleet-size + migration decisions at period boundaries --
            if (gs is not None or auto is not None) and t1 in mig_bounds:
                span_s = max((t1 - last_mig) / 1e3, 1e-9)
                demand = {trace.models[m]: c / span_s
                          for m, c in enumerate(mig_counts.tolist())
                          if c}
                mig_counts[:] = 0
                node_obs = []
                for j, node in enumerate(self.nodes):
                    new = node.pending_idx[pend_len[j]:]
                    pend_len[j] = len(node.pending_idx)
                    if new:
                        nc = np.bincount(
                            trace.model_id[np.asarray(new,
                                                      dtype=np.int64)],
                            minlength=nm)
                        node_obs.append(
                            {trace.models[m]: c / span_s
                             for m, c in enumerate(nc.tolist()) if c})
                    else:
                        node_obs.append({})
                if auto is not None:
                    self._autoscale_epoch(trace, auto, t1, demand,
                                          node_obs, pend_len,
                                          horizon - t1, det=det,
                                          chaos=True)
                if gs is not None:
                    # index over the same live set gs.on_epoch filters to
                    live = [j for j, n in enumerate(self.nodes)
                            if n.alive_at(t1) and not n.draining
                            and (det is None
                                 or det.routable(n.node_id, t1))]
                    backlogs = router.backlogs(t1)
                    ob = trace.obs
                    for u in gs.on_epoch(t1, demand,
                                         [node_obs[j] for j in live],
                                         [backlogs[j] for j in live],
                                         horizon - t1):
                        nd = self.nodes[u.node_id]
                        nd.apply_update(u.t_cut_ms, u.t_apply_ms,
                                        u.schedule, u.added, u.removed)
                        nd.engine.apply_schedule_at(u.t_apply_ms,
                                                    u.schedule)
                        if ob is not None:
                            ob.fleet_log.append(
                                ("migration", u.t_cut_ms, u.node_id,
                                 len(u.added), len(u.removed)))
                last_mig = t1
            t_prev = t1
        # ---- post-horizon drain: replay until the fleet runs dry ----
        ecfg = self.nodes[0].cfg
        max_clock = ecfg.horizon_ms * ecfg.drain_factor
        for _ in range(64):
            for node in self.nodes:
                node.run_until(max_clock)
            lost_parts, floor_parts = [], []
            for node in self.nodes:
                if plan.down_at(node.node_id, max_clock):
                    ev = node.crash_evict(max_clock)
                    if len(ev):
                        if det is not None:
                            det.observe(node.node_id, max_clock,
                                        0, len(ev))
                        lost_parts.append(ev)
                        floor_parts.append(np.full(len(ev), horizon))
            if router.in_transit_lost:
                g = np.asarray([x[0] for x in router.in_transit_lost],
                               dtype=np.int64)
                fl = np.asarray([x[1] + cfg.rpc_timeout_ms
                                 for x in router.in_transit_lost])
                router.in_transit_lost.clear()
                lost_parts.append(g)
                floor_parts.append(fl)
            if not lost_parts:
                break
            self._chaos_replay(trace, np.concatenate(lost_parts),
                               np.concatenate(floor_parts),
                               policy, ledger)
            for node in self.nodes:
                node.feed_pending()
        for node in self.nodes:
            node.finish_stream()
            node.retired = True
        fleet = collect_trace(trace, horizon)
        per_node = {n.node_id: n.metrics for n in self.nodes
                    if n.metrics is not None}
        preemptions = sum(n.engine.preemptions if n.engine is not None
                          else n.preemptions for n in self.nodes)
        if gs is not None:
            self.migration_events = list(gs.events)
        chaos = {
            "recovery": bool(cfg.recovery),
            "retries": self._chaos_retries,
            "retry_drops": self._chaos_retry_drops,
            "retry_attempts": ledger.total_attempts,
            "net_lost": int(router.stats.net_lost),
            "detector": det.summary() if det is not None else None,
            "brownout": brown.summary() if brown is not None else None,
        }
        scale_events, node_seconds = self._scale_summary()
        return FabricMetrics(fleet=fleet, per_node=per_node,
                             stats=router.stats,
                             preemptions=preemptions,
                             migration_events=list(self.migration_events),
                             chaos=chaos, scale_events=scale_events,
                             node_seconds=node_seconds)

    @staticmethod
    def _node_ok(node: FabricNode, t0: float, t1: float) -> int:
        """Completions node's engine stamped in ``(t0, t1]`` (final only).

        Reads the engine's *local* mirrors, not the shared trace, so a
        row another node completed is never credited here; stamps beyond
        ``t1`` belong to in-flight batches and are still revocable.
        """
        eng = node.engine
        st = np.asarray(eng._status_l)
        if not st.size:
            return 0
        dn = np.asarray(eng._done_l)
        return int(np.count_nonzero(
            (st == COMPLETED) & (dn > t0) & (dn <= t1)))

    def _brownout_admit(self, trace: RequestTrace, ids: np.ndarray,
                        brown) -> np.ndarray:
        """Filter one boundary's arrivals through the brownout ladder.

        Level 1 sheds bronze (priority >= 2) at admission, level 2 also
        truncates admitted non-gold stream rows to ``truncate_tokens``,
        level 3 denies everything but gold.  Denials resolve immediately
        with ``CAUSE_BROWNOUT`` — the client gets a fast rejection
        instead of a slow miss.
        """
        if brown is None or brown.level == 0:
            return ids
        pri = trace.priority[ids]
        deny = pri >= (1 if brown.level >= 3 else 2)
        denied = ids[deny]
        if len(denied):
            trace.status[denied] = SHED
            brown.denied += len(denied)
            ob = trace.obs
            if ob is not None:
                ob.resolve_ms[denied] = trace.arrival_ms[denied]
                ob.cause[denied] = CAUSE_BROWNOUT
        keep = ids[~deny]
        if brown.level >= 2 and trace.has_streams and len(keep):
            cap = brown.params.truncate_tokens
            tgt = keep[(trace.priority[keep] >= 1)
                       & (trace.output_len[keep] > cap)]
            if len(tgt):
                trace.output_len[tgt] = cap
                brown.truncated += len(tgt)
        return keep

    def _chaos_replay(self, trace: RequestTrace, lost: np.ndarray,
                      floor_ms, policy: RetryPolicy,
                      ledger: RetryLedger) -> None:
        """Replay casualties under the deadline-aware retry budget.

        Like :meth:`_replay`, the replay instant becomes the node-side
        arrival and the burned wait shrinks the SLO budget (charged to
        the failover column, so attribution still sums exactly).  Unlike
        it, each request carries an attempt counter: replay ``k`` backs
        off ``backoff_base * factor**k`` first, and a request whose
        budget is spent — or whose remaining SLO after the burn cannot
        clear ``min_headroom_ms`` — is shed with ``CAUSE_DROP_RETRY``
        instead of stealing survivor capacity it cannot use.
        """
        lost = np.asarray(lost, dtype=np.int64)
        if not lost.size:
            return
        # stale stamps synced before the eviction died with the node
        trace.completion_ms[lost] = np.nan
        trace.status[lost] = PENDING
        arr = trace.arrival_ms
        attempts = ledger.counts(lost)
        t_replay = np.maximum(arr[lost], floor_ms) \
            + policy.lag_ms(attempts)
        burn = t_replay - arr[lost]
        new_slo = trace.slo_ms[lost] - burn
        trace.slo_ms[lost] = new_slo
        arr[lost] = t_replay
        give_up = (attempts >= policy.max_retries) \
            | (new_slo <= policy.min_headroom_ms)
        trace.status[lost[give_up]] = DROPPED
        ob = trace.obs
        if ob is not None:
            ob.reset_rows(lost)
            ob.charge_replay(lost, burn, False)
            gu = lost[give_up]
            if len(gu):
                ob.resolve_ms[gu] = t_replay[give_up]
                ob.cause[gu] = CAUSE_DROP_RETRY
        self._chaos_retry_drops += int(np.count_nonzero(give_up))
        replay = lost[~give_up]
        if len(replay):
            self._chaos_retries += len(replay)
            ledger.bump(replay)
            self.replayed_ids.append(replay)
            self.router.dispatch(trace, replay, failover=True)

    # ---- task-graph (DAG) serving ------------------------------------------

    def _serve_dag(self, trace: RequestTrace) -> FabricMetrics:
        """Epoch-wave serving for staged traces: the release frontier.

        Roots (and plain single-model rows mixed into the trace) enter
        the arrival-ordered dispatch stream in their arrival segment.
        Non-root stages start unreleased (``arrival_ms = inf``); at each
        segment boundary the frontier scans completions the node engines
        have stamped so far and releases every stage whose parents all
        completed, at ``arrival = max(parent completions)`` — possibly
        *inside* the closing segment, which is legal: the engines ingest
        late arrivals with a monotonic clock clamp, so the stage queues
        from its true release instant and its SLO age is measured from
        there.  The cadence (``stage_release_period_ms``) only bounds how
        stale the frontier's knowledge can be, exactly like the migration
        epochs' observe-then-act discipline.  A stage with a failed
        parent (dropped/shed/lost/unserved) is dropped without dispatch
        and the failure cascades down its subtree — the job is already
        dead end-to-end.

        Node engines run incrementally (``begin_stream`` / ``run_until``
        / ``finish_stream``) and sequentially — completions on one node
        release stages onto another mid-horizon, so nodes are not
        independent and ``node_workers`` does not apply here.
        """
        cfg = self.cfg
        if cfg.migrations:
            raise ValueError(
                "staged (DAG) traces cannot be combined with migrations "
                "yet — the release frontier and the migration epoch loop "
                "both own the dispatch cadence")
        if cfg.period_s is not None:
            raise ValueError(
                "staged (DAG) traces cannot drive per-node controllers "
                "(period_s) yet — incremental engines take no tick "
                "subscriber")
        if any(n.fails_in_run() for n in self.nodes):
            raise ValueError(
                "staged (DAG) traces do not support scheduled node "
                "failures yet — casualty replay is stage-oblivious")
        period = cfg.stage_release_period_ms
        horizon = cfg.horizon_ms
        n_epochs = max(1, int(np.ceil(horizon / period - 1e-9)))
        for node in self.nodes:
            node.begin_stream()
        npar = trace.n_parents
        roots = np.flatnonzero(npar == 0)
        r_epoch = np.minimum(
            (trace.arrival_ms[roots] // period).astype(np.int64),
            n_epochs - 1)
        order = np.argsort(r_epoch, kind="stable")
        roots, r_epoch = roots[order], r_epoch[order]
        bounds = np.searchsorted(r_epoch, np.arange(n_epochs + 1))
        self._dag_unreleased = npar > 0
        self._dag_edges = trace.stage_edges()
        for k in range(n_epochs):
            t1 = min((k + 1) * period, horizon)
            ids = roots[bounds[k]:bounds[k + 1]]
            if k:
                # every engine has run to the previous boundary: stamps
                # at/before it are final (their COMPLETE events fired)
                rel = self._release_frontier(trace, min(k * period, horizon))
                if len(rel):
                    ids = np.concatenate([ids, rel]) if len(ids) else rel
            if len(ids):
                self.router.dispatch(trace, ids)
                for node in self.nodes:
                    node.feed_pending()
            for node in self.nodes:
                node.run_until(t1)
        # post-horizon: drain, then keep releasing until the frontier
        # runs dry (completions stamped in the drain can still free
        # children; each round strictly shrinks the unreleased set)
        ecfg = self.nodes[0].cfg
        max_clock = ecfg.horizon_ms * ecfg.drain_factor
        while True:
            for node in self.nodes:
                node.run_until(max_clock)
            rel = self._release_frontier(trace, max_clock)
            if not len(rel):
                break
            self.router.dispatch(trace, rel)
            for node in self.nodes:
                node.feed_pending()
        for node in self.nodes:
            node.finish_stream()
            node.retired = True
        # conservation: stages whose parents never resolved (stuck in a
        # queue at shutdown, now UNSERVED) were never released — close
        # them the same way so every row leaves PENDING
        left = np.flatnonzero(self._dag_unreleased)
        if len(left):
            trace.status[left] = UNSERVED
            self._dag_unreleased[left] = False
            if trace.obs is not None:
                trace.obs.resolve_ms[left] = max_clock
                trace.obs.cause[left] = CAUSE_DROP_SHUTDOWN
        fleet = collect_trace(trace, horizon)
        per_node = {n.node_id: n.metrics for n in self.nodes
                    if n.metrics is not None}
        preemptions = sum(n.engine.preemptions if n.engine is not None
                          else n.preemptions for n in self.nodes)
        return FabricMetrics(fleet=fleet, per_node=per_node,
                             stats=self.router.stats,
                             preemptions=preemptions,
                             jobs=collect_jobs(trace))

    def _release_frontier(self, trace: RequestTrace,
                          t_now: float) -> np.ndarray:
        """One frontier pass: cascade failures, release ready stages.

        Returns the newly released row indices (arrivals already stamped
        to ``max(parent completions)``).  Only completions at/before
        ``t_now`` count: engines stamp completion at batch *launch*, so a
        later stamp belongs to a batch still in flight at the boundary —
        revocable by preemption until its COMPLETE event fires.  Failure
        cascades run to a fixpoint inside the pass — a dropped stage's
        grandchildren drop in the same pass — while releases cannot
        enable further releases (a freshly released stage has not
        completed yet), so one scan per failure round suffices.  The live
        edge set shrinks as children resolve, keeping later passes cheap.
        """
        status = trace.status
        npar = trace.n_parents
        ob = trace.obs
        un = self._dag_unreleased
        child, parent = self._dag_edges
        n = len(trace)
        released: list[np.ndarray] = []
        while True:
            live = un[child]
            child, parent = child[live], parent[live]
            self._dag_edges = (child, parent)
            if not child.size:
                break
            pstat = status[parent]
            fail_cnt = np.bincount(child[pstat >= FIRST_DROP_STATUS],
                                   minlength=n)
            final = (pstat == COMPLETED) & \
                (trace.completion_ms[parent] <= t_now)
            done_cnt = np.bincount(child[final], minlength=n)
            failed = np.flatnonzero(un & (fail_cnt > 0))
            ready = np.flatnonzero(un & (fail_cnt == 0)
                                   & (done_cnt == npar))
            if not failed.size and not ready.size:
                break
            if failed.size:
                status[failed] = DROPPED
                un[failed] = False
                if ob is not None:
                    ob.resolve_ms[failed] = t_now
                    ob.cause[failed] = CAUSE_DROP_PARENT
            if ready.size:
                ps = trace.parent_start[ready]
                kk = npar[ready].astype(np.int64)
                starts = np.cumsum(kk) - kk
                par_rows = np.repeat(ps, kk) + (
                    np.arange(int(kk.sum()), dtype=np.int64)
                    - np.repeat(starts, kk))
                rel_t = np.maximum.reduceat(
                    trace.completion_ms[par_rows], starts)
                trace.arrival_ms[ready] = rel_t
                un[ready] = False
                released.append(ready)
            if not failed.size:
                break
        if not released:
            return np.empty(0, dtype=np.int64)
        return released[0] if len(released) == 1 else \
            np.concatenate(released)

    def _dispatch_with_migrations(self, trace: RequestTrace) -> None:
        """Route the trace epoch by epoch, migrating placement between.

        Each migration epoch is dispatched under the placement in force
        at its start; at every boundary the fleet-level subscribers see
        what the router could causally observe over the closing epoch
        (fleet arrival rates, per-node dispatch rates, fluid backlogs)
        and may answer with a bounded delta that lands before the next
        epoch routes.  The :class:`~repro.fabric.autoscaler.FleetAutoscaler`
        decides first (fleet size), then the
        :class:`~repro.fabric.global_scheduler.GlobalScheduler`
        (placement) — a freshly-spawned pre-warming node is immediately
        visible as a migration receiver.  Epoch membership is fixed by
        *client* arrival time, snapshotted before dispatch shifts
        arrivals by network delay.
        """
        cfg = self.cfg
        # injection seams: tests/experiments may pre-set (scripted)
        # fleet controllers; anything with on_epoch(...) + .events works
        gs = None
        if cfg.migrations:
            from repro_torch.fabric.global_scheduler import GlobalScheduler
            gs = self.global_scheduler
            if gs is None:
                gs = self.global_scheduler = GlobalScheduler(
                    self.profiles, self.nodes, cfg)
        auto = self._make_autoscaler()
        period = cfg.migration_period_ms
        horizon = cfg.horizon_ms
        n_epochs = max(1, int(np.ceil(horizon / period - 1e-9)))
        # bucket by pristine client arrivals, before any network shifts
        epoch_of = np.minimum(
            (trace.arrival_ms // period).astype(np.int64), n_epochs - 1)
        epoch_ids = [np.flatnonzero(epoch_of == k)
                     for k in range(n_epochs)]
        nm = len(trace.models)
        pend_len = [len(n.pending_idx) for n in self.nodes]
        for k in range(n_epochs):
            t0 = k * period
            for node in self.nodes:
                node.prune_activations(t0)
            ids = epoch_ids[k]
            if len(ids):
                self.router.dispatch(trace, ids)
            if k == n_epochs - 1:
                break             # no decision after the last epoch
            t1 = (k + 1) * period
            span_s = period / 1e3
            counts = np.bincount(trace.model_id[ids], minlength=nm) \
                if len(ids) else np.zeros(nm, dtype=np.int64)
            demand = {trace.models[m]: c / span_s
                      for m, c in enumerate(counts.tolist()) if c}
            node_obs = []
            for j, node in enumerate(self.nodes):
                new = node.pending_idx[pend_len[j]:]
                pend_len[j] = len(node.pending_idx)
                if new:
                    nc = np.bincount(
                        trace.model_id[np.asarray(new, dtype=np.int64)],
                        minlength=nm)
                    node_obs.append({trace.models[m]: c / span_s
                                     for m, c in enumerate(nc.tolist())
                                     if c})
                else:
                    node_obs.append({})
            if auto is not None:
                self._autoscale_epoch(trace, auto, t1, demand, node_obs,
                                      pend_len, horizon - t1)
            if gs is None:
                continue
            # GlobalScheduler indexes node_obs/backlogs over *live*
            # non-draining nodes (the same filter it applies internally)
            live = [j for j, n in enumerate(self.nodes)
                    if n.alive_at(t1) and not n.draining]
            backlogs = self.router.backlogs(t1)
            ob = trace.obs
            for u in gs.on_epoch(t1, demand,
                                 [node_obs[j] for j in live],
                                 [backlogs[j] for j in live],
                                 horizon - t1):
                self.nodes[u.node_id].apply_update(
                    u.t_cut_ms, u.t_apply_ms, u.schedule, u.added,
                    u.removed)
                if ob is not None:
                    ob.fleet_log.append(
                        ("migration", u.t_cut_ms, u.node_id,
                         len(u.added), len(u.removed)))
        if gs is not None:
            self.migration_events = list(gs.events)

    def _make_autoscaler(self):
        """Build (or reuse the injected) fleet autoscaler when enabled."""
        if not self.cfg.autoscale:
            return None
        auto = self.autoscaler
        if auto is None:
            from repro_torch.fabric.autoscaler import FleetAutoscaler
            auto = self.autoscaler = FleetAutoscaler(
                self.profiles, self.nodes, self.cfg)
        return auto

    def _autoscale_epoch(self, trace: RequestTrace, auto, t1: float,
                         demand: dict, node_obs: list,
                         pend_len: list, remaining_ms: float,
                         det=None, chaos: bool = False) -> None:
        """Land one autoscale decision and wire its deltas into the run.

        Joins are appended to the live node list and registered with the
        router (and, on the chaos path, the health detector + an
        incremental engine); the positional epoch-state lists grow in
        lockstep.  Drains were already staged on the victim by the
        autoscaler (donor protocol); the chaos path additionally stages
        the empty partitioning on the victim's live engine.
        """
        added, drained = auto.on_epoch(t1, demand, node_obs, remaining_ms)
        ob = trace.obs
        for node in added:
            node.trace = trace
            self.nodes.append(node)
            self.router.add_node(node)
            node_obs.append({})
            pend_len.append(0)
            if det is not None:
                det.add_node(node.node_id)
            if chaos:
                node.begin_stream()
            if ob is not None:
                ob.fleet_log.append(
                    ("scale", t1, node.node_id, "add",
                     node.model_active_ms.get(
                         next(iter(node.rate_by_model), ""), t1)))
        for node in drained:
            if chaos and node.engine is not None:
                t_apply, sched = node.schedule_plan[-1]
                node.engine.apply_schedule_at(t_apply, sched)
            if ob is not None:
                ob.fleet_log.append(
                    ("scale", t1, node.node_id, "drain", t1))

    def _run_donors(self, trace: RequestTrace) -> None:
        """Run donor nodes first and hand their stranded requests back.

        A donor (a node that stopped admitting a migrated-away model)
        can close requests as conservation drops that the model's new
        homes could still serve — so donors execute before the rest of
        the fleet, earliest cut first, and their hand-backs re-dispatch
        through the router (which only targets nodes that have not run).
        A hand-back landing on a later donor simply chains: that donor
        hands it back again after its own run.
        """
        donors = sorted((n for n in self.nodes
                         if n.removed_models and not n.fails_in_run()),
                        key=lambda n: (min(n.removed_models.values()),
                                       n.node_id))
        for node in donors:
            node.run()
            node.retired = True   # router must not target it again
            for _model, release, lost in node.handback():
                self._replay(trace, lost, release, self.cfg.handback_ms,
                             handback=True)

    def _run_healthy(self, trace: RequestTrace) -> None:
        """Run every healthy node's engine, optionally in parallel.

        Nodes share no mutable state once the router has filled their
        index slices, so running them across forked workers is a pure
        wall-clock win — each child stamps completions into its
        copy-on-write view and ships back only its own result arrays,
        which the parent scatters into the shared trace.  Results are
        bit-identical to the sequential order.
        """
        ks = [k for k, n in enumerate(self.nodes)
              if not n.fails_in_run() and not n.retired]
        w = min(self.cfg.node_workers, len(ks))
        if w > 1 and hasattr(os, "fork"):
            global _PAR_NODES
            _PAR_NODES = self.nodes
            try:
                ctx = multiprocessing.get_context("fork")
                with ctx.Pool(w) as pool:
                    for (k, gidx, done, status, preempted, met,
                         preempts, ftok, tok, spans,
                         obs_pack) in pool.map(_run_node_job, ks):
                        node = self.nodes[k]
                        trace.completion_ms[gidx] = done
                        trace.status[gidx] = status
                        trace.preempted[gidx] |= preempted
                        if ftok is not None:
                            trace.first_token_ms[gidx] = ftok
                            trace.tokens_done[gidx] = tok
                        if obs_pack is not None:
                            # node-side timeline columns were stamped in
                            # the child's copy-on-write view; merge them
                            trace.obs.unpack_rows(gidx, obs_pack)
                        node.metrics = met
                        node.preemptions = preempts
                        node.span_log = spans
            finally:
                _PAR_NODES = None
            return
        for k in ks:
            self.nodes[k].run()


#: nodes handed to forked workers (set only around the Pool.map call;
#: fork children inherit it, so no per-task trace pickling happens)
_PAR_NODES: list[FabricNode] | None = None


def _run_node_job(k: int):
    """Worker-side: run one node's engine, return its result arrays."""
    node = _PAR_NODES[k]
    node.run()
    eng = node.engine
    ftok = tok = None
    if eng._streams_on:
        # the stream mirrors live in the child's copy-on-write trace;
        # ship them back alongside the classic result arrays
        ftok = np.asarray(eng._ftok_l)
        tok = np.asarray(eng._tok_l, dtype=np.int32)
    tl = node.trace.obs
    obs_pack = tl.pack_rows(eng._gidx) if tl is not None else None
    return (k, eng._gidx, eng._done, eng._status, eng._preempted,
            node.metrics, eng.preemptions, ftok, tok, eng.log, obs_pack)
