"""Fleet autoscaling: grow/shrink node count at migration epochs.

The :class:`~repro.fabric.global_scheduler.GlobalScheduler` re-places
models across a *fixed* fleet; this module moves the other axis — the
fleet size itself.  :class:`FleetAutoscaler` is a second epoch
subscriber: at every migration-epoch boundary it folds the closing
epoch's fleet arrival rates into the same EWMA + trend forecast the
migration scheduler uses (``serving.controller.predict_target``), sizes
the fleet for the forecast, and answers with at most a few node joins or
one node drain.

Pre-warming (the predictive arm)
--------------------------------
A node is not capacity the instant it is asked for: its models' weights
must stream from checkpoint storage first.  ``predict_target``'s trend
extrapolation makes the autoscaler *pre-warm* — the spawn decision lands
one window ahead of the spike, the warm-up charge burns while the spike
is still building, and the node's models become routable
(``FabricNode.model_active_ms``) right as the traffic arrives.  The
reactive contrast arm (``autoscale_mode="reactive"``) zeroes the trend:
it scales on what it has already seen, and pays the warm-up *inside*
the spike.

Restore-cost pricing
--------------------
:class:`RestoreCostModel` replaces the flat ``migration_warmup_ms``
constant with a first-principles charge: one node bring-up latency plus
each model's checkpoint bytes over the shared storage link
(``checkpoint/store.py`` manifests supply real byte sizes via
:func:`~repro.checkpoint.store.manifest_nbytes`).  The same model prices
migration warm-ups when wired into ``FabricConfig.restore`` — a 528 MB
VGG16 costs ~3x a 27 MB GoogLeNet to bring up, which the old constant
could not see.

Scale-down reuses the PR-5 donor machinery verbatim: a drained node
stops admitting everything at the cut (``apply_update`` with an empty
partitioning), serves out what it already holds, and its stranded queue
hands back through the router to the surviving homes.  The fleet-level
EWMA decay (``EWMARateTracker``) is what makes this fire at all — a
model whose traffic stopped must decay out of the forecast before the
fleet looks over-provisioned.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence

import numpy as np

from repro_torch.core.elastic import ElasticPartitioning
from repro_torch.fabric.node import FabricNode, NodeSpec
from repro_torch.faults.health import EVICTED
from repro_torch.serving.controller import EWMARateTracker, predict_target
from repro_torch.simulator.engine import EngineConfig

_EPS_RATE = 1e-6

#: spawn-share back-off ladder: a new node is provisioned for an equal
#: slice of the forecast; if that slice does not fit its cluster, try
#: smaller slices before giving up (mirrors the migration add ladder)
_SPAWN_FRACTIONS = (1.0, 0.75, 0.5)

#: fp32 checkpoint sizes (bytes) of the paper's five CNNs — LeNet,
#: GoogLeNet, ResNet-50, SSD(-VGG), VGG-16.  Used when no real manifest
#: directory is wired in; the spread (0.25 MB .. 528 MB) is the point:
#: restore cost varies by three orders of magnitude across the catalog.
DEFAULT_MODEL_BYTES: dict[str, float] = {
    "le": 0.25e6,
    "goo": 27e6,
    "res": 102e6,
    "ssd": 105e6,
    "vgg": 528e6,
}


@dataclasses.dataclass(frozen=True)
class RestoreCostModel:
    """Checkpoint-restore warm-up pricing: bytes over storage bandwidth.

    ``warmup_ms(models)`` is one node bring-up charge (``base_ms`` —
    container start, runtime init) plus the models' checkpoint bytes
    streamed *sequentially* over the node's storage link (one shared
    ``read_gbps`` pipe, so restoring five models costs the sum of their
    transfers, not the max).
    """

    model_bytes: Mapping[str, float]
    #: effective checkpoint-storage read bandwidth per node (GB/s)
    read_gbps: float = 2.0
    #: fixed bring-up charge before any bytes flow (ms)
    base_ms: float = 150.0
    #: priced for models missing from ``model_bytes``
    fallback_bytes: float = 100e6

    def bytes_of(self, model: str) -> float:
        return float(self.model_bytes.get(model, self.fallback_bytes))

    def restore_ms(self, model: str) -> float:
        """Warm-up charge for bringing one model up on a fresh node."""
        return self.warmup_ms((model,))

    def warmup_ms(self, models: Sequence[str]) -> float:
        total = sum(self.bytes_of(m) for m in models)
        return self.base_ms + total / (self.read_gbps * 1e9) * 1e3

    @classmethod
    def paper_default(cls, **kwargs) -> "RestoreCostModel":
        """The paper catalog priced from real fp32 checkpoint sizes."""
        return cls(model_bytes=dict(DEFAULT_MODEL_BYTES), **kwargs)

    @classmethod
    def from_manifests(cls, manifest_dirs: Mapping[str, str],
                       **kwargs) -> "RestoreCostModel":
        """Price models from saved checkpoint manifests on disk.

        ``manifest_dirs[model]`` is a directory ``save_checkpoint`` wrote;
        the manifest's dtype/shape entries give the exact restore payload.
        """
        from repro_torch.checkpoint.store import manifest_nbytes
        return cls(model_bytes={m: float(manifest_nbytes(d))
                                for m, d in manifest_dirs.items()},
                   **kwargs)


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    """One applied fleet-size delta (the auditable autoscale record)."""

    t_ms: float
    #: "add" (node spawned, joins after warm-up) or "drain" (node stops
    #: admitting at the cut and retires once its queue runs out)
    action: str
    node_id: int
    #: instant the node becomes routable (add) / the admit-stop cut (drain)
    t_ready_ms: float
    #: restore-priced pre-warm charge (add); 0 for drains
    warmup_ms: float
    reason: str


class FleetAutoscaler:
    """Fleet-size epoch subscriber: forecast-driven joins and drains.

    Holds the fabric's *live* node list; joins append to it through the
    fabric (which also registers the node with the router, the health
    detector, and the chaos engines), drains are staged directly on the
    victim via the PR-5 donor protocol.  Owns its own EWMA tracker and
    rng stream (``migration_seed + 101``) so enabling autoscaling never
    perturbs the migration scheduler's seeded jitter draws.
    """

    def __init__(self, profiles, nodes: list, cfg, scheduler_factory=None):
        if cfg.autoscale_mode not in ("predictive", "reactive"):
            raise ValueError(
                f"unknown autoscale_mode {cfg.autoscale_mode!r}; "
                "one of 'predictive', 'reactive'")
        if cfg.autoscale_min_nodes < 1:
            raise ValueError("autoscale_min_nodes must be >= 1")
        if not nodes:
            raise ValueError("autoscaler needs a non-empty seed fleet")
        self.profiles = dict(profiles)
        self.nodes = nodes          # the fabric's live list, shared
        self.cfg = cfg
        self._cluster = nodes[0].spec.cluster
        if scheduler_factory is None:
            def scheduler_factory(profs, cluster):
                return ElasticPartitioning(profs, cluster=cluster,
                                           lat=cfg.lat)
        self._solver = scheduler_factory(self.profiles, self._cluster)
        self.tracker = EWMARateTracker()
        self._prev_obs: dict[str, float] = {}
        self._rng = np.random.default_rng(cfg.migration_seed + 101)
        self._down_streak = 0
        self._next_id = max(n.node_id for n in nodes) + 1
        #: every applied fleet-size delta, in decision order
        self.events: list[ScaleEvent] = []
        #: node_id -> instant it became (or will become) routable
        self.joined_ms: dict[int, float] = {n.node_id: 0.0 for n in nodes}
        #: node_id -> drain-cut instant (capacity released)
        self.retired_ms: dict[int, float] = {}
        #: chaos serving: a HealthDetector; nodes it has EVICTED are not
        #: capacity, so a crashed zone reads as a deficit the autoscaler
        #: replaces (None = legacy behavior)
        self.health = None

    def _is_up(self, node: FabricNode, t_ms: float) -> bool:
        if not node.alive_at(t_ms) or node.draining:
            return False
        if self.health is not None \
                and self.health.state.get(node.node_id) == EVICTED:
            return False
        return True

    # ---- capacity accounting ----------------------------------------------

    def node_seconds(self, horizon_ms: float) -> float:
        """Total node-seconds of provisioned capacity over the horizon.

        The denominator of goodput-per-node-hour: each node accrues from
        its join instant to its drain cut (or the horizon).  Warm-up time
        counts — a pre-warming node is paid for while it loads.
        """
        total = 0.0
        for nid, t_join in self.joined_ms.items():
            t_gone = self.retired_ms.get(nid, horizon_ms)
            total += max(0.0, min(t_gone, horizon_ms)
                         - min(t_join, horizon_ms))
        return total / 1e3

    def node_hours(self, horizon_ms: float) -> float:
        return self.node_seconds(horizon_ms) / 3600.0

    # ---- the epoch decision ------------------------------------------------

    def on_epoch(self, t_ms: float, demand: Mapping[str, float],
                 node_obs: Sequence[Mapping[str, float]],
                 remaining_ms: float
                 ) -> tuple[list[FabricNode], list[FabricNode]]:
        """Decide this epoch's fleet-size delta (possibly none).

        ``demand`` is the fleet arrival rate per model over the closing
        epoch; ``node_obs[k]`` the dispatch rate per model the router
        sent ``self.nodes[k]`` (full-list indexing, unlike the migration
        scheduler's live-filtered view).  Returns ``(added, drained)``:
        freshly-built nodes for the fabric to wire in, and live nodes
        the autoscaler just staged a drain on.
        """
        cfg = self.cfg
        target = self._forecast(demand)
        desired = self._desired(target)
        current = [n for n in self.nodes if self._is_up(n, t_ms)]
        added: list[FabricNode] = []
        drained: list[FabricNode] = []
        if desired > len(current):
            self._down_streak = 0
            room = min(desired - len(current),
                       cfg.autoscale_max_add_per_epoch,
                       cfg.autoscale_max_nodes - len(current))
            for _ in range(max(0, room)):
                node = self._spawn(t_ms, target, desired, remaining_ms)
                if node is None:
                    break
                added.append(node)
        elif desired < len(current) \
                and len(current) > cfg.autoscale_min_nodes:
            # hysteresis: the fleet must look over-provisioned for
            # ``autoscale_down_patience`` consecutive epochs — one quiet
            # window must not retire capacity a spike still needs
            self._down_streak += 1
            if self._down_streak >= cfg.autoscale_down_patience:
                victim = self._pick_victim(t_ms, current, node_obs)
                if victim is not None:
                    self._drain(victim, t_ms, desired, len(current))
                    drained.append(victim)
                    self._down_streak = 0
        else:
            self._down_streak = 0
        return added, drained

    # ---- forecast + sizing -------------------------------------------------

    def _forecast(self, demand: Mapping[str, float]) -> dict[str, float]:
        ewma = self.tracker.update(dict(demand))
        # reactive arm: no trend extrapolation — scale on what has been
        # seen (max of EWMA and the last window, plus margin); the
        # predictive arm extrapolates the window-over-window trend and
        # is what makes pre-warming land *ahead* of a spike
        tw = 1.5 if self.cfg.autoscale_mode == "predictive" else 0.0
        target = predict_target(ewma, demand, self._prev_obs,
                                trend_windows=tw)
        self._prev_obs = dict(demand)
        return target

    def _fits(self, target: Mapping[str, float], n: int) -> bool:
        share = {m: r / n for m, r in target.items() if r > _EPS_RATE}
        if not share:
            return True
        return self._solver.schedule(share).schedulable

    def _desired(self, target: Mapping[str, float]) -> int:
        """Fleet size for the forecast: the smallest node count whose
        equal shares are schedulable, inflated by the utilization
        headroom (``autoscale_target_util``)."""
        cfg = self.cfg
        if not target:
            return cfg.autoscale_min_nodes
        lo, hi = 1, cfg.autoscale_max_nodes
        if not self._fits(target, hi):
            n_fit = hi              # saturated: run at the cap
        else:
            while lo < hi:
                mid = (lo + hi) // 2
                if self._fits(target, mid):
                    hi = mid
                else:
                    lo = mid + 1
            n_fit = lo
        desired = int(np.ceil(
            n_fit / max(cfg.autoscale_target_util, 1e-6) - 1e-9))
        return min(max(desired, cfg.autoscale_min_nodes),
                   cfg.autoscale_max_nodes)

    def _warmup_ms(self, models: Sequence[str]) -> float:
        restore = getattr(self.cfg, "restore", None)
        if restore is not None and models:
            w = restore.warmup_ms(models)
        else:
            w = self.cfg.migration_warmup_ms
        j = self.cfg.migration_warmup_jitter_ms
        if j > 0.0:
            w += float(self._rng.uniform(0.0, j))
        return w

    # ---- scale up -----------------------------------------------------------

    def _spawn(self, t_ms: float, target: Mapping[str, float],
               desired: int, remaining_ms: float) -> FabricNode | None:
        """Build one pre-warming node provisioned for an equal forecast
        share; ``None`` if nothing schedulable fits or the restore-priced
        warm-up cannot pay back before the horizon."""
        cfg = self.cfg
        share = {m: r / desired for m, r in target.items()
                 if r > _EPS_RATE}
        if not share:
            return None
        grown = None
        for frac in _SPAWN_FRACTIONS:
            trial = {m: r * frac for m, r in share.items()}
            res = self._solver.schedule(trial)
            if res.schedulable:
                grown = (trial, res)
                break
        if grown is None:
            return None
        trial, schedule = grown
        warm = self._warmup_ms(sorted(trial))
        if remaining_ms < 2.0 * warm:
            return None     # joins too late to earn its restore cost back
        t_join = t_ms + warm
        spec = NodeSpec(node_id=self._next_id, cluster=self._cluster)
        self._next_id += 1
        # fresh engine config from the fabric knobs — never copied from a
        # sibling node, whose config may carry installed fault windows
        ecfg = EngineConfig(
            horizon_ms=cfg.horizon_ms,
            acc=self._cluster.accelerator,
            lat=cfg.lat, interference=cfg.interference,
            preemption=cfg.preemption,
            preempt_cost_ms=cfg.preempt_cost_ms)
        node = FabricNode(spec, self.profiles, schedule, ecfg)
        # pre-warm gate: provisioned now, routable only once the
        # checkpoint restore completes (the router's serves() honors this)
        node.model_active_ms = {m: t_join for m in trial}
        self.joined_ms[spec.node_id] = t_join
        self.events.append(ScaleEvent(
            t_ms=t_ms, action="add", node_id=spec.node_id,
            t_ready_ms=t_join, warmup_ms=warm,
            reason=f"desired {desired} nodes for "
                   f"{sum(target.values()):.0f} req/s forecast"))
        return node

    # ---- scale down ----------------------------------------------------------

    def _pick_victim(self, t_ms: float, current: Sequence[FabricNode],
                     node_obs: Sequence[Mapping[str, float]]
                     ) -> FabricNode | None:
        """Coolest drainable node: lowest observed dispatch utilization,
        newest first on ties; never a node that is the last live home of
        any model it serves (its hand-backs would have nowhere to land)."""
        obs_by_id = {}
        for k, n in enumerate(self.nodes):
            if k < len(node_obs):
                obs_by_id[n.node_id] = node_obs[k]
        homes: dict[str, int] = {}
        for n in current:
            for m, r in n.rate_by_model.items():
                if r > _EPS_RATE:
                    homes[m] = homes.get(m, 0) + 1
        best, best_key = None, None
        for n in current:
            served = [m for m, r in n.rate_by_model.items()
                      if r > _EPS_RATE]
            if any(homes.get(m, 0) <= 1 for m in served):
                continue
            obs = obs_by_id.get(n.node_id, {})
            util = sum(obs.values()) / max(n.total_rate, _EPS_RATE)
            key = (util, -n.node_id)
            if best_key is None or key < best_key:
                best, best_key = n, key
        return best

    def _drain(self, node: FabricNode, t_ms: float,
               desired: int, n_current: int) -> None:
        """Stage a full drain on ``node`` via the donor protocol: empty
        partitioning at the cut, every served model an admit-stop."""
        removed = tuple(sorted(
            m for m, r in node.rate_by_model.items() if r > _EPS_RATE))
        empty = self._solver.schedule({})
        node.apply_update(t_ms, t_ms, empty, {}, removed)
        node.draining = True
        self.retired_ms[node.node_id] = t_ms
        self.events.append(ScaleEvent(
            t_ms=t_ms, action="drain", node_id=node.node_id,
            t_ready_ms=t_ms, warmup_ms=0.0,
            reason=f"fleet of {n_current} over-provisioned for "
                   f"desired {desired}"))
