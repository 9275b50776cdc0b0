"""Fleet-level global rescheduling: live model migration between nodes.

The fabric's router can re-route *traffic*; this module moves the
*placement*.  :class:`GlobalScheduler` is the fleet-level tick subscriber
(the fabric fires it at every migration-epoch boundary, the same way a
node engine fires its per-node :class:`~repro.serving.ServingController`):
it watches causally-observable signals only — per-model fleet arrival
rates, per-node per-model dispatch rates, and the router's fluid backlog
— forecasts the next epoch with the same EWMA + trend predictor the
per-node controllers use (``serving.controller.predict_target``), and
answers with an *incremental placement delta*: at most
``max_migrations_per_epoch`` model instances added to or evicted from
nodes, each solved through :class:`ElasticPartitioning` so a node is
never promised an unschedulable mix.

Migration protocol (one :class:`NodeUpdate`)
--------------------------------------------
``t_cut_ms``  — the epoch boundary the decision lands on.  Router-side
admit-stop for evicted models is immediate at the cut; the node's engine
keeps serving what it already holds (drain-to-cut: in-flight batches run
out behind the generation fence, queued requests for evicted models
surface as hand-backs the fabric replays to the model's new homes).

``t_apply_ms = t_cut_ms + warmup`` — the instant the node's new
partitioning goes live.  ``warmup`` models the receiver's weight
load/warm-up charge: checkpoint-restore-priced per model when
``cfg.restore`` carries a :class:`~repro.fabric.autoscaler.RestoreCostModel`
(model bytes over storage bandwidth), else the flat
``migration_warmup_ms`` constant — plus seeded uniform jitter either way;
a freshly-migrated-in model is not *routable* until this cut, so its
previous homes keep absorbing the traffic while the receiver loads.
Pure re-rates (growing/shrinking a model the node already serves) are
free: no warm-up, no drain, and they do not count against the migration
budget.

Cost-awareness: a delta is only proposed when a model's forecast exceeds
its fleet-provisioned rate by ``min_deficit`` (hysteresis), when the
remaining horizon is long enough to amortize the warm-up, and an eviction
never orphans a model (it must keep at least one other live home and
enough fleet-provisioned rate to cover its own forecast).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence

import numpy as np

from repro_torch.core.elastic import ElasticPartitioning
from repro_torch.core.scheduler_base import ScheduleResult
from repro_torch.serving.controller import EWMARateTracker, predict_target

#: provisioned rates below this are treated as "not serving the model"
_EPS_RATE = 1e-6

#: add-size back-off ladder: try the full deficit first, then fractions,
#: so a receiver with partial room still takes a useful share
_ADD_FRACTIONS = (1.0, 0.5, 0.25)


@dataclasses.dataclass(frozen=True)
class MigrationEvent:
    """One applied placement delta (the auditable migration record)."""

    t_cut_ms: float
    t_apply_ms: float
    node_id: int
    #: (model, provisioned req/s) instances this node gained
    added: tuple[tuple[str, float], ...]
    #: models this node stopped admitting at the cut
    removed: tuple[str, ...]


@dataclasses.dataclass
class NodeUpdate:
    """A placement delta for one node, ready for the fabric to apply."""

    node_id: int
    t_cut_ms: float
    t_apply_ms: float
    rates: dict[str, float]
    schedule: ScheduleResult
    added: dict[str, float]
    removed: tuple[str, ...]

    def event(self) -> MigrationEvent:
        return MigrationEvent(
            t_cut_ms=self.t_cut_ms, t_apply_ms=self.t_apply_ms,
            node_id=self.node_id,
            added=tuple(sorted(self.added.items())),
            removed=tuple(sorted(self.removed)))


class GlobalScheduler:
    """Fleet-level epoch subscriber solving incremental placement deltas."""

    def __init__(self, profiles, nodes: Sequence, cfg,
                 scheduler_factory=None):
        self.profiles = dict(profiles)
        # hold the *live* node list when given one: the fabric's
        # autoscaler grows/shrinks it mid-run and freshly-joined nodes
        # must be visible as migration receivers at the next epoch
        self.nodes = nodes if isinstance(nodes, list) else list(nodes)
        self.cfg = cfg
        if scheduler_factory is None:
            def scheduler_factory(profs, cluster):
                return ElasticPartitioning(profs, cluster=cluster,
                                           lat=cfg.lat)
        self._sched_factory = scheduler_factory
        self._scheds: dict[int, object] = {}
        self.tracker = EWMARateTracker()
        #: model -> stream occupancy factor (>= 1).  Arrival counts under-
        #: state a streaming model's true service (the decode tail), so
        #: demand is scaled into booked-service units before forecasting —
        #: the same units phase-aware provisioning books node rates in.
        #: Empty = classic req/s forecasting.
        self.stream_occupancy = dict(
            getattr(cfg, "stream_occupancy", None) or {})
        self._prev_obs: dict[str, float] = {}
        #: model -> consecutive epochs its deficit stayed over threshold
        self._starved: dict[str, int] = {}
        self._rng = np.random.default_rng(cfg.migration_seed)
        #: every applied delta, in decision order (tests + benchmarks)
        self.events: list[MigrationEvent] = []
        #: chaos serving (ISSUE 9): a HealthDetector; nodes it has
        #: evicted are not migration receivers (None = legacy behavior)
        self.health = None

    # ---- helpers -----------------------------------------------------------

    def _sched(self, node):
        s = self._scheds.get(node.node_id)
        if s is None:
            s = self._scheds[node.node_id] = self._sched_factory(
                self.profiles, node.spec.cluster)
        return s

    def _warmup_ms(self, models: Sequence[str] = ()) -> float:
        """Warm-up charge for bringing ``models`` up on a receiver.

        With ``cfg.restore`` set (a :class:`RestoreCostModel`), the charge
        is priced from first principles — checkpoint bytes over storage
        bandwidth per model — otherwise the flat ``migration_warmup_ms``
        constant.  The seeded jitter draw happens unconditionally so the
        rng stream (and the jittered goldens) is independent of pricing.
        """
        restore = getattr(self.cfg, "restore", None)
        if restore is not None and models:
            w = restore.warmup_ms(models)
        else:
            w = self.cfg.migration_warmup_ms
        j = self.cfg.migration_warmup_jitter_ms
        if j > 0.0:
            w += float(self._rng.uniform(0.0, j))
        return w

    @staticmethod
    def _fleet_provisioned(nodes) -> dict[str, float]:
        out: dict[str, float] = {}
        for n in nodes:
            for m, r in n.rate_by_model.items():
                if r > _EPS_RATE:
                    out[m] = out.get(m, 0.0) + r
        return out

    # ---- the epoch decision ------------------------------------------------

    def on_epoch(self, t_ms: float, demand: Mapping[str, float],
                 node_obs: Sequence[Mapping[str, float]],
                 backlogs: Sequence[float],
                 remaining_ms: float) -> list[NodeUpdate]:
        """Decide this epoch's placement delta (possibly none).

        ``demand`` is the fleet arrival rate per model over the closing
        epoch (req/s); ``node_obs[k]`` the dispatch rate per model the
        router sent node ``k``; ``backlogs[k]`` the fluid backlog
        snapshot.  All three are things a real fleet controller can
        observe at the boundary — no node internals, no future.
        """
        cfg = self.cfg
        if self.stream_occupancy:
            occ = self.stream_occupancy
            demand = {m: r * occ.get(m, 1.0) for m, r in demand.items()}
        ewma = self.tracker.update(dict(demand))
        target = predict_target(ewma, demand, self._prev_obs)
        self._prev_obs = dict(demand)
        live = [n for n in self.nodes if n.alive_at(t_ms)
                and not n.draining
                and (self.health is None
                     or self.health.routable(n.node_id, t_ms))]
        if not live:
            return []   # nothing to place on
        prov = self._fleet_provisioned(live)
        starving = {}
        for m, want in target.items():
            have = prov.get(m, 0.0)
            gap = want - have
            if gap > cfg.migration_min_deficit * max(want, 1e-9) \
                    and gap > cfg.migration_min_rate_req_s:
                starving[m] = gap
        # persistence gate: a deficit must survive ``migration_patience``
        # consecutive epochs before placement moves for it
        for m in list(self._starved):
            if m not in starving:
                del self._starved[m]
        deficits = {}
        for m, gap in starving.items():
            streak = self._starved.get(m, 0) + 1
            self._starved[m] = streak
            if streak >= cfg.migration_patience:
                deficits[m] = gap
        if not deficits:
            return []
        # spare-capacity score: how hot is each node, by the router's own
        # signals (dispatch rate vs provisioned rate, plus fluid backlog)
        def util(k: int) -> float:
            n = live[k]
            u = sum(node_obs[k].values()) / max(n.total_rate, _EPS_RATE)
            return u + backlogs[k] / max(cfg.shed_backlog_ms, 1e-9)

        order = sorted(range(len(live)), key=lambda k: (util(k),
                                                        live[k].node_id))
        ops = 0
        updates: dict[int, NodeUpdate] = {}
        for m in sorted(deficits, key=lambda m: (-deficits[m], m)):
            need = deficits[m]
            for k in order:
                if ops >= cfg.max_migrations_per_epoch or need <= 0:
                    break
                node = live[k]
                if node.node_id in updates:
                    continue            # one delta per node per epoch
                already = node.rate_by_model.get(m, 0.0)
                rates, removed, evict_ops = self._shrink_cold(
                    node, m, node_obs[k], target, prov)
                if ops + evict_ops + (0 if already > _EPS_RATE else 1) \
                        > cfg.max_migrations_per_epoch:
                    continue
                grown = None
                for frac in _ADD_FRACTIONS:
                    trial = dict(rates)
                    trial[m] = already + need * frac
                    res = self._sched(node).schedule(trial)
                    if res.schedulable:
                        grown = (trial, res, need * frac)
                        break
                if grown is None:
                    continue
                trial, res, took = grown
                warm = self._warmup_ms((m,) if already <= _EPS_RATE else ())
                added = {} if already > _EPS_RATE else {m: took}
                # payback gate on the *actual* sampled/priced warm-up for
                # this candidate — the old epoch-global guard compared
                # the flat constant and undercharged jittered or
                # restore-priced placements near the horizon end.  Pure
                # re-rates are free and always allowed.
                if added and remaining_ms < 2.0 * warm:
                    continue
                # a pure re-rate applies at the cut; a genuinely new model
                # pays the seeded warm-up before its traffic retargets
                t_apply = t_ms + (warm if added else 0.0)
                upd = NodeUpdate(
                    node_id=node.node_id, t_cut_ms=t_ms,
                    t_apply_ms=t_apply, rates=trial, schedule=res,
                    added=added, removed=removed)
                updates[node.node_id] = upd
                ops += evict_ops + (1 if added else 0)
                need -= took
                # keep the fleet-provisioned view honest for later picks
                # in this same epoch: evictions *and* shrinks release rate
                for c in set(node.rate_by_model) | set(trial):
                    delta = trial.get(c, 0.0) \
                        - node.rate_by_model.get(c, 0.0)
                    if delta:
                        prov[c] = prov.get(c, 0.0) + delta
            if ops >= cfg.max_migrations_per_epoch:
                break
        out = [updates[nid] for nid in sorted(updates)]
        self.events.extend(u.event() for u in out)
        return out

    def _shrink_cold(self, node, hot: str,
                     obs: Mapping[str, float],
                     target: Mapping[str, float],
                     prov: Mapping[str, float]
                     ) -> tuple[dict[str, float], tuple[str, ...], int]:
        """Free capacity on a prospective receiver.

        Models whose fleet provisioning exceeds their forecast give back
        their share of the surplus; a model shrunk to (near) zero is
        evicted outright — but only if its other live homes still cover
        its own forecast, so an eviction never orphans demand.  Returns
        ``(new_rates, evicted_models, n_evictions)``.
        """
        rates = {m: r for m, r in node.rate_by_model.items()
                 if r > _EPS_RATE}
        removed = []
        for c in sorted(rates):
            if c == hot:
                continue
            have = prov.get(c, 0.0)
            want = target.get(c, 0.0)
            surplus = have - want
            if surplus <= 0:
                continue
            cut = min(rates[c], surplus)
            left = rates[c] - cut
            # eviction requires another live home unconditionally: a
            # model whose forecast decayed to zero (EWMA noise floor)
            # must not lose its last instance, or returning traffic has
            # nowhere to land until the deficit gate re-places it
            if left <= _EPS_RATE and have - rates[c] > _EPS_RATE \
                    and have - rates[c] >= want - 1e-9:
                removed.append(c)
                del rates[c]
            else:
                rates[c] = max(left, min(rates[c],
                                         obs.get(c, 0.0) * 1.05))
        return rates, tuple(removed), len(removed)
