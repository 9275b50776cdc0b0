"""One fabric node: a server wrapping its own event-heap engine.

A node owns a full single-server serving stack — its own gpu-let
partitioning (:class:`ScheduleResult`), its own
:class:`~repro.simulator.engine.EventHeapEngine`, and optionally its own
:class:`~repro.serving.ServingController` wired in as the engine's tick
subscriber — exactly the PR-1 single-cluster system, replicated per node.
The router (router.py) never reaches inside a node: it only appends to the
node's pending index slice and reads coarse load signals (provisioned
per-model rates, gpu-let count).

The hand-off is struct-of-arrays end to end: the fabric binds every node
to the shared :class:`~repro.simulator.trace.RequestTrace`, the router
fills ``pending_idx`` (global request indices, no objects), and the
node's engine stamps completions straight back into the shared arrays.

Node failure (the ROADMAP's failure-drain scenario) is modeled by running
the engine with its clock hard-capped at ``fail_at_ms``: requests completed
strictly before the failure survive; everything else (queued, in flight,
or "completed" after the cut) is a casualty the fabric re-dispatches to
surviving nodes.

Chaos serving (ISSUE 9) uses a different mechanism: the fabric compiles a
``FaultPlan`` into the engine's ``outages``/``slowdowns`` windows
(:meth:`FabricNode.install_faults`) and runs every node incrementally
(``begin_stream``/``feed_pending``/``run_until``).  At each crash
boundary the node's engine revokes what it still owes
(:meth:`FabricNode.crash_evict`) and the fabric replays those casualties
under a retry budget — no clock cap, no omniscient ``fail_at_ms``.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence

import numpy as np

from repro_torch.core.hardware import ClusterSpec, PAPER_CLUSTER
from repro_torch.core.scheduler_base import ScheduleResult
from repro_torch.simulator.engine import EngineConfig, EventHeapEngine, TickFn
from repro_torch.simulator.metrics import SimMetrics
from repro_torch.simulator.trace import COMPLETED, PENDING, UNSERVED, RequestTrace


@dataclasses.dataclass
class NodeSpec:
    """Static description of one node."""

    node_id: int
    cluster: ClusterSpec = PAPER_CLUSTER
    #: wall-clock (ms) at which this node dies, None = healthy forever
    fail_at_ms: float | None = None


class FabricNode:
    """Runtime state of one node: pending index slice + its engine."""

    def __init__(self, spec: NodeSpec, profiles, schedule: ScheduleResult,
                 cfg: EngineConfig, on_tick: TickFn | None = None):
        self.spec = spec
        self.profiles = dict(profiles)
        self.schedule = schedule
        self.cfg = cfg
        self.on_tick = on_tick
        #: shared fleet trace (bound by ServingFabric before dispatch)
        self.trace: RequestTrace | None = None
        #: global indices of requests routed here (the router appends)
        self.pending_idx: list[int] = []
        self.engine: EventHeapEngine | None = None
        self.metrics: SimMetrics | None = None
        #: preemption count when the engine ran in a forked worker (the
        #: parent has no engine object then)
        self.preemptions = 0
        #: this node's typed span records (engine ``log``), captured after
        #: the run so observability export works even when the engine ran
        #: in a forked worker; empty unless ``EngineConfig.event_log``
        self.span_log: list = []
        #: set by the fabric once this node has executed (failed nodes run
        #: first); the router must not dispatch anything more to it.
        self.retired = False
        #: set by the fleet autoscaler when this node is draining toward
        #: retirement: it serves out what it holds but is no longer
        #: capacity — not a migration receiver, not a drain victim twice
        self.draining = False
        #: pending_idx watermark for the incremental (DAG) feed
        self._fed = 0
        # router-visible load signals, derived from the partitioning
        self.rate_by_model: dict[str, float] = \
            schedule.assignments_by_model()
        self.n_servers = max(
            1, sum(1 for l in schedule.gpulets if not l.is_free))
        self.total_rate = sum(self.rate_by_model.values())
        # ---- live-migration state (global rescheduling) ----
        #: staged partition changes for this node's engine, in apply order
        self.schedule_plan: list[tuple[float, ScheduleResult]] = []
        #: model -> cut instant (ms) at which this node stopped admitting
        #: it (the donor side of a migration)
        self.removed_models: dict[str, float] = {}
        #: model -> activation instant (ms): a freshly-migrated-in model
        #: is routable only after its warm-up cut (the receiver side)
        self.model_active_ms: dict[str, float] = {}

    @property
    def node_id(self) -> int:
        return self.spec.node_id

    def alive_at(self, t_ms: float) -> bool:
        if self.retired:
            return False
        f = self.spec.fail_at_ms
        return f is None or t_ms < f

    def fails_in_run(self) -> bool:
        """True iff the scheduled failure lands inside the horizon — a
        failure at/after the horizon never happens in this run, and the
        node must behave exactly like a healthy one (no clock cap, no
        casualty collection)."""
        f = self.spec.fail_at_ms
        return f is not None and f < self.cfg.horizon_ms

    def serves(self, model: str, t_ms: float | None = None) -> bool:
        """Is ``model`` routable here (at instant ``t_ms``)?

        A migrated-in model only becomes routable at its warm-up cut;
        until then the model's previous homes keep absorbing its traffic
        (the receiver's engine is still loading weights).  Callers that
        pass no instant (static fleets) see the plain provisioned check.
        """
        if self.rate_by_model.get(model, 0.0) <= 0.0:
            return False
        if t_ms is None or not self.model_active_ms:
            return True
        return t_ms >= self.model_active_ms.get(model, 0.0)

    def service_ms(self, model: str) -> float:
        """Per-request occupancy for the router's fluid backlog model.

        Normalized so that inflow at exactly the provisioned aggregate
        rate balances the drain (``n_servers`` ms/ms): the node's
        provisioned rates ARE its admitted capacity, so the router's
        backlog only grows when a node genuinely runs hot.
        """
        if self.rate_by_model.get(model, 0.0) <= 0.0:
            return 1e6  # not provisioned here: effectively infinite cost
        return self.n_servers * 1e3 / max(self.total_rate, 1e-9)

    # ---- live migration (global rescheduling) ------------------------------

    def apply_update(self, t_cut_ms: float, t_apply_ms: float,
                     schedule: ScheduleResult,
                     added: Mapping[str, float],
                     removed: Sequence[str]) -> None:
        """Accept one placement delta from the global rescheduler.

        Router-visible signals flip at the cut (``t_cut_ms``): removed
        models stop admitting immediately, added models are registered
        but only become routable at ``t_apply_ms`` (the warm-up cut,
        enforced by :meth:`serves`).  The node's engine picks the new
        partitioning up via the staged :meth:`schedule_plan` when it
        runs.

        ``removed_models`` records ``t_apply_ms``, not the cut: the
        engine only releases an evicted model's queue when the staged
        partitioning installs, so that is the earliest instant a
        hand-back can physically leave this node (on a receiver-donor
        they differ by the warm-up charge; flooring replays at the cut
        would let a hand-back be served elsewhere while simulated-time
        it still sat here).
        """
        for m in removed:
            self.removed_models[m] = t_apply_ms
            self.model_active_ms.pop(m, None)
        for m in added:
            self.model_active_ms[m] = t_apply_ms
            self.removed_models.pop(m, None)
        self.schedule_plan.append((t_apply_ms, schedule))
        self.rate_by_model = schedule.assignments_by_model()
        self.n_servers = max(
            1, sum(1 for l in schedule.gpulets if not l.is_free))
        self.total_rate = sum(self.rate_by_model.values())

    def prune_activations(self, t_ms: float) -> None:
        """Forget warm-up gates that have passed (re-arms the router's
        clear-time fast path once the fleet is homogeneous again)."""
        if self.model_active_ms:
            self.model_active_ms = {m: t for m, t in
                                    self.model_active_ms.items()
                                    if t > t_ms}

    def handback(self) -> list[tuple[str, float, np.ndarray]]:
        """Requests stranded by this node's migrations, reset for replay.

        Only meaningful after :meth:`run` on a donor (a node with
        ``removed_models``).  A stranded request is one for a migrated-
        away model that was still queued at the cut: the engine carried
        it into ``unrouted`` at the apply (the new partitioning has no
        gpu-let for the model) and closed it as a conservation drop.
        In-flight batches at the cut drained to completion (their stamps
        stand), and requests the donor deliberately dropped for SLO
        expiry stay dropped — the client already saw that rejection.

        Returns ``(model, release_ms, global_indices)`` per migrated-
        away model — ``release_ms`` the instant the donor's engine
        actually let go of the queue (the staged apply) — with the
        requests' completion/status reset, ready for a hand-back
        dispatch to the model's new home.
        """
        if not self.removed_models or self.engine is None:
            return []
        own = self.engine._gidx
        tr = self.trace
        st = tr.status[own]
        mid = tr.model_id[own]
        out = []
        for m, cut in sorted(self.removed_models.items()):
            k = tr.model_index.get(m)
            if k is None:
                continue
            lost = own[(st == UNSERVED) & (mid == k)]
            if len(lost):
                tr.completion_ms[lost] = np.nan
                tr.status[lost] = PENDING
                out.append((m, cut, lost))
        return out

    # ---- execution ---------------------------------------------------------

    def run(self) -> SimMetrics:
        """Run this node's engine over its dispatched index slice."""
        cfg = self.cfg
        if self.fails_in_run():
            # hard-stop the node's clock at the failure instant; the fabric
            # collects the casualties afterwards (see ServingFabric.serve).
            cfg = dataclasses.replace(cfg, horizon_ms=self.spec.fail_at_ms,
                                      drain_factor=1.0)
        self.engine = EventHeapEngine(self.profiles, cfg,
                                      schedule=self.schedule,
                                      on_tick=self.on_tick)
        for t_apply, sched in self.schedule_plan:
            self.engine.apply_schedule_at(t_apply, sched)
        self.engine.submit_trace(
            self.trace, np.asarray(self.pending_idx, dtype=np.int64))
        self.metrics = self.engine.run()
        self.span_log = self.engine.log
        return self.metrics

    # ---- incremental execution (DAG release-frontier epochs) ---------------

    def begin_stream(self) -> None:
        """Create this node's engine for epoch-wave (DAG) serving.

        Instead of one whole-slice ``run()``, the fabric feeds released
        stages epoch by epoch (:meth:`feed_pending`) and advances the
        engine in bounded segments (:meth:`run_until`), so completions on
        one node can release child stages on another mid-horizon.
        """
        self.engine = EventHeapEngine(self.profiles, self.cfg,
                                      schedule=self.schedule, on_tick=None)
        self.engine.submit_trace(self.trace, np.empty(0, dtype=np.int64))
        self._fed = 0

    def feed_pending(self) -> None:
        """Hand newly-dispatched ``pending_idx`` entries to the engine."""
        new = self.pending_idx[self._fed:]
        if new:
            self.engine.add_arrivals(np.asarray(new, dtype=np.int64))
            self._fed = len(self.pending_idx)

    def run_until(self, t_ms: float) -> None:
        """Advance to ``t_ms`` and publish stamps for the frontier."""
        self.engine.run_until(t_ms)
        self.engine.sync_trace()

    def finish_stream(self) -> SimMetrics:
        """Drain the incremental engine and collect this node's metrics."""
        self.metrics = self.engine.finish()
        self.span_log = self.engine.log
        return self.metrics

    # ---- chaos serving (fault injection, ISSUE 9) --------------------------

    def install_faults(self, outages, slowdowns) -> None:
        """Wire this node's fault windows into its engine config.

        Must run before :meth:`begin_stream` builds the engine.  A node
        with no windows keeps its pristine config (and thus the pristine
        hot paths).
        """
        if outages or slowdowns:
            self.cfg = dataclasses.replace(
                self.cfg, outages=tuple(outages),
                slowdowns=tuple(slowdowns))

    def crash_evict(self, t_ms: float) -> np.ndarray:
        """Revoke everything this node still owes at a crash instant.

        Returns the global ids of the evicted rows (queued, pooled, or
        in flight at ``t_ms``); the fabric accounts them as casualties
        and replays under the retry budget.
        """
        return self.engine.crash_evict(t_ms)

    def evict_unrouted(self, mids) -> np.ndarray:
        """Pull queued rows of migrated-away models out of the engine."""
        return self.engine.evict_unrouted(mids)

    def casualties(self) -> np.ndarray:
        """Requests lost to this node's failure, reset for re-dispatch.

        Only meaningful after :meth:`run` on a node with ``fail_at_ms``.
        A casualty is a request that was *in the node's hands* when it
        died: still queued at the cut (``UNSERVED`` conservation drops),
        or in a batch whose completion the engine stamped at/after the
        cut.  Requests the node finished before dying survive as
        completions, and requests it *deliberately* dropped for SLO
        expiry while healthy stay dropped — the client already saw that
        rejection; replaying them would under-count violations.

        Returns the casualties' global indices (arrival order) with their
        completion/status state reset, ready for a failover dispatch.
        """
        fail = self.spec.fail_at_ms
        if not self.fails_in_run() or self.engine is None:
            return np.empty(0, dtype=np.int64)
        own = self.engine._gidx          # arrival-sorted global indices
        tr = self.trace
        st = tr.status[own]
        lost_mask = (st == UNSERVED) | (
            (st == COMPLETED) & (tr.completion_ms[own] >= fail))
        lost = own[lost_mask]
        if len(lost):
            tr.completion_ms[lost] = np.nan
            tr.status[lost] = PENDING
        return lost
