"""Typed, seeded fault plans for the serving fabric (ISSUE 9).

A :class:`FaultPlan` is a validated bag of fault events that the fabric
compiles into per-node engine knobs (outage / straggler windows), a
degraded :class:`~repro.fabric.network.NetworkModel`, and the epoch grid
of its chaos serving loop.  Four fault types:

* :class:`PermanentCrash` — the node goes down at ``t_ms`` and never
  comes back.  This is the typed refactor of the legacy
  ``NodeSpec.fail_at_ms`` path; the legacy failure-drain loop keeps its
  omniscient-replay semantics, while plans routed through
  ``FabricConfig.faults`` are served by the chaos loop where failures
  are *detected*, not known.
* :class:`TransientCrash` — down for ``[t_ms, t_ms + down_ms)``, then a
  re-warm charge of ``rewarm_ms`` during which the node is back up but
  not yet serving (folded into the outage window).
* :class:`StragglerWindow` — every launch on the node inside
  ``[t0_ms, t1_ms)`` runs ``factor``× slower (lands in the
  interference component of miss attribution, like co-location slowdown).
* :class:`NetworkDegradation` — fleet-wide RPC window with ``extra_ms``
  of added one-way delay and i.i.d. dispatch loss ``loss_prob``.

Windows on the same node must not overlap, and nothing may be scheduled
after a node's permanent crash.  All validation happens at construction
so the chaos loop can trust the plan.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "PermanentCrash", "TransientCrash", "StragglerWindow",
    "NetworkDegradation", "FaultPlan", "chaos_plan",
]

_INF = math.inf


@dataclasses.dataclass(frozen=True)
class PermanentCrash:
    """Node ``node_id`` dies at ``t_ms`` and stays dead."""
    node_id: int
    t_ms: float


@dataclasses.dataclass(frozen=True)
class TransientCrash:
    """Node down for ``down_ms``, then ``rewarm_ms`` of cold-cache charge.

    The re-warm charge models checkpoint restore + cache refill after a
    process restart: the node is indistinguishable from *down* for
    dispatch purposes, so the outage window the engine sees is
    ``[t_ms, t_ms + down_ms + rewarm_ms)``.
    """
    node_id: int
    t_ms: float
    down_ms: float
    rewarm_ms: float = 0.0


@dataclasses.dataclass(frozen=True)
class StragglerWindow:
    """Launches on ``node_id`` in ``[t0_ms, t1_ms)`` run ``factor``× slower."""
    node_id: int
    t0_ms: float
    t1_ms: float
    factor: float


@dataclasses.dataclass(frozen=True)
class NetworkDegradation:
    """Fleet-wide RPC degradation window: extra delay and dispatch loss."""
    t0_ms: float
    t1_ms: float
    extra_ms: float = 0.0
    loss_prob: float = 0.0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A validated, immutable schedule of fault events.

    ``seed`` feeds the seeded parts of injection (network loss draws);
    two runs with the same plan and trace are bit-reproducible.
    """
    faults: tuple = ()
    seed: int = 0

    def __post_init__(self):
        per_node: dict[int, list[tuple[float, float]]] = {}
        crash_at: dict[int, float] = {}
        for f in self.faults:
            if isinstance(f, PermanentCrash):
                if f.t_ms < 0:
                    raise ValueError(f"negative crash instant {f.t_ms}")
                if f.node_id in crash_at:
                    raise ValueError(
                        f"node {f.node_id} has two permanent crashes")
                crash_at[f.node_id] = f.t_ms
                per_node.setdefault(f.node_id, []).append((f.t_ms, _INF))
            elif isinstance(f, TransientCrash):
                if f.t_ms < 0 or f.down_ms <= 0 or f.rewarm_ms < 0:
                    raise ValueError(f"bad transient crash {f}")
                per_node.setdefault(f.node_id, []).append(
                    (f.t_ms, f.t_ms + f.down_ms + f.rewarm_ms))
            elif isinstance(f, StragglerWindow):
                if f.t0_ms < 0 or f.t1_ms <= f.t0_ms:
                    raise ValueError(f"bad straggler window {f}")
                if f.factor < 1.0:
                    raise ValueError(
                        f"straggler factor must be >= 1, got {f.factor}")
            elif isinstance(f, NetworkDegradation):
                if f.t0_ms < 0 or f.t1_ms <= f.t0_ms:
                    raise ValueError(f"bad degradation window {f}")
                if not (0.0 <= f.loss_prob < 1.0):
                    raise ValueError(
                        f"loss_prob must be in [0, 1), got {f.loss_prob}")
                if f.extra_ms < 0:
                    raise ValueError(f"negative extra_ms in {f}")
            else:
                raise TypeError(f"unknown fault type {type(f).__name__}")
        for nid, wins in per_node.items():
            wins.sort()
            for (a0, a1), (b0, _b1) in zip(wins, wins[1:]):
                if b0 < a1:
                    raise ValueError(
                        f"overlapping outage windows on node {nid}: "
                        f"[{a0}, {a1}) and [{b0}, ...)")
        for f in self.faults:
            nid = getattr(f, "node_id", None)
            if nid is None or nid not in crash_at:
                continue
            t0 = (f.t_ms if isinstance(f, (PermanentCrash, TransientCrash))
                  else f.t0_ms)
            if not isinstance(f, PermanentCrash) and t0 >= crash_at[nid]:
                raise ValueError(
                    f"fault {f} scheduled at/after node {nid}'s "
                    f"permanent crash ({crash_at[nid]} ms)")

    # -- queries -----------------------------------------------------------
    @property
    def is_empty(self) -> bool:
        return not self.faults

    def node_ids(self) -> tuple[int, ...]:
        return tuple(sorted({f.node_id for f in self.faults
                             if hasattr(f, "node_id")}))

    def outage_windows(self, node_id: int) -> tuple[tuple[float, float], ...]:
        """Sorted, non-overlapping ``(t0, t1)`` down-windows for a node."""
        wins = []
        for f in self.faults:
            if isinstance(f, PermanentCrash) and f.node_id == node_id:
                wins.append((f.t_ms, _INF))
            elif isinstance(f, TransientCrash) and f.node_id == node_id:
                wins.append((f.t_ms, f.t_ms + f.down_ms + f.rewarm_ms))
        return tuple(sorted(wins))

    def straggler_windows(
            self, node_id: int) -> tuple[tuple[float, float, float], ...]:
        return tuple(sorted((f.t0_ms, f.t1_ms, f.factor)
                            for f in self.faults
                            if isinstance(f, StragglerWindow)
                            and f.node_id == node_id))

    def net_windows(self) -> tuple[tuple[float, float, float, float], ...]:
        return tuple(sorted((f.t0_ms, f.t1_ms, f.extra_ms, f.loss_prob)
                            for f in self.faults
                            if isinstance(f, NetworkDegradation)))

    def permanent_crash_ms(self) -> dict[int, float]:
        return {f.node_id: f.t_ms for f in self.faults
                if isinstance(f, PermanentCrash)}

    def down_at(self, node_id: int, t_ms: float) -> bool:
        """True when ``t_ms`` falls inside one of the node's outages."""
        for t0, t1 in self.outage_windows(node_id):
            if t0 <= t_ms < t1:
                return True
        return False

    def boundary_instants(self) -> tuple[float, ...]:
        """Finite fault-window edges: the chaos loop's mandatory epoch cuts.

        Crash starts must be on the grid so in-flight eviction is
        unambiguous (everything still in flight at the cut died there);
        recovery instants keep re-probing prompt.
        """
        cuts: set[float] = set()
        for f in self.faults:
            if isinstance(f, PermanentCrash):
                cuts.add(f.t_ms)
            elif isinstance(f, TransientCrash):
                cuts.add(f.t_ms)
                cuts.add(f.t_ms + f.down_ms + f.rewarm_ms)
            elif isinstance(f, StragglerWindow):
                cuts.update((f.t0_ms, f.t1_ms))
            elif isinstance(f, NetworkDegradation):
                cuts.update((f.t0_ms, f.t1_ms))
        return tuple(sorted(c for c in cuts if math.isfinite(c)))


def chaos_plan(n_nodes: int, horizon_ms: float, seed: int = 0, *,
               n_transient: int = 1, n_permanent: int = 0,
               n_stragglers: int = 1, n_net: int = 1,
               rewarm_frac: float = 0.02) -> FaultPlan:
    """Seeded fault-storm generator for benchmarks and property tests.

    Picks distinct victim nodes for crashes, mid-horizon outage windows
    (so there is traffic both before and after), straggler factors in
    [1.5, 3]× and network windows with a few ms of extra delay plus a
    2–10% dispatch loss.  Everything derives from ``seed``.
    """
    if n_nodes < 1:
        raise ValueError("n_nodes must be >= 1")
    rng = np.random.default_rng(seed)
    faults: list = []
    n_crash = n_transient + n_permanent
    if n_crash > n_nodes:
        raise ValueError("more crashes than nodes")
    victims = rng.choice(n_nodes, size=n_crash, replace=False) \
        if n_crash else np.empty(0, dtype=int)
    k = 0
    for _ in range(n_transient):
        t0 = float(rng.uniform(0.15, 0.45)) * horizon_ms
        down = float(rng.uniform(0.10, 0.25)) * horizon_ms
        faults.append(TransientCrash(
            node_id=int(victims[k]), t_ms=t0, down_ms=down,
            rewarm_ms=rewarm_frac * horizon_ms))
        k += 1
    for _ in range(n_permanent):
        faults.append(PermanentCrash(
            node_id=int(victims[k]),
            t_ms=float(rng.uniform(0.3, 0.7)) * horizon_ms))
        k += 1
    for _ in range(n_stragglers):
        nid = int(rng.integers(0, n_nodes))
        t0 = float(rng.uniform(0.1, 0.6)) * horizon_ms
        span = float(rng.uniform(0.15, 0.3)) * horizon_ms
        faults.append(StragglerWindow(
            node_id=nid, t0_ms=t0, t1_ms=min(t0 + span, horizon_ms),
            factor=float(rng.uniform(1.5, 3.0))))
    for _ in range(n_net):
        t0 = float(rng.uniform(0.1, 0.7)) * horizon_ms
        span = float(rng.uniform(0.1, 0.2)) * horizon_ms
        faults.append(NetworkDegradation(
            t0_ms=t0, t1_ms=min(t0 + span, horizon_ms),
            extra_ms=float(rng.uniform(2.0, 10.0)),
            loss_prob=float(rng.uniform(0.02, 0.10))))
    # a straggler/degradation may collide with a crash window on the same
    # node; that is fine (they compose) except after a permanent crash,
    # which validation rejects — retry stragglers on such a collision
    plan = None
    while plan is None:
        try:
            plan = FaultPlan(tuple(faults), seed=seed)
        except ValueError:
            # move the offending straggler off the dead node
            fixed = []
            dead = {f.node_id for f in faults if isinstance(f, PermanentCrash)}
            for f in faults:
                if isinstance(f, StragglerWindow) and f.node_id in dead:
                    f = dataclasses.replace(
                        f, node_id=int((f.node_id + 1) % n_nodes))
                fixed.append(f)
            if fixed == faults:
                raise
            faults = fixed
    return plan
