"""Per-request lifecycle timeline: SoA columns for SLO forensics.

A :class:`Timeline` rides on a :class:`~repro.simulator.trace.RequestTrace`
(``trace.obs``) and records, per request, *where its latency went*:
dispatch, node assignment, network SLO burn, first/last batch launch,
interference inflation, migration/failover replay burn, and a terminal
``resolve`` stamp with a cause code.  Every layer that mutates request
state checks ``trace.obs is not None`` once per batch (engine) or once
per dispatch (router/fabric) — when no timeline is attached the hot
path pays a single ``is None`` branch, nothing per request.

Column semantics (all float64 ms unless noted, NaN = never stamped):

* ``arrival0_ms`` / ``slo0_ms`` — pristine client-side arrival and SLO,
  snapshotted at attach time *before* the router mutates them with
  network shifts.  ``slo0 - slo_ms == net_ms + handback_ms +
  failover_ms`` holds exactly at all times.
* ``t_dispatch_ms`` — when the router picked a node (the post-shift
  arrival the node sees).
* ``node`` (int32) — the node the request landed on; -1 = never routed.
* ``net_ms`` — SLO budget consumed by network hops (router delay
  shifts, including the return-hop charge).
* ``handback_ms`` / ``failover_ms`` — SLO budget consumed by migration
  donor-drain hand-backs / node-failure replays.
* ``first_launch_ms`` / ``last_launch_ms`` — first and most recent
  batch (or prefill) launch; they differ iff the request was preempted
  and relaunched.
* ``intf_ms`` — interference inflation of the *surviving* launch
  (exec_ms - solo exec); overwritten per launch so it always describes
  the batch that actually completed.
* ``decode_intf_ms`` — accumulated interference across streaming
  decode chunks.
* ``resolve_ms`` — terminal stamp: completion time for completed rows,
  drop/shed/loss decision time otherwise.  Finite for every terminal
  (non-PENDING) row — the "every terminal status has a closing span"
  invariant validated by ``repro.obs.validate``.
* ``cause`` (uint8) — why the request resolved; ``CAUSE_NAMES`` maps
  codes to the attribution taxonomy.

``router_log`` / ``fleet_log`` are append-only event lists (not
per-request): the router samples its fluid backlog per dispatch, the
fabric appends migration deltas — raw material for the fleet sampler.
"""
from __future__ import annotations

import numpy as np

# -- terminal cause codes (uint8) -------------------------------------------
CAUSE_NONE = 0           # still pending (or timeline never resolved)
CAUSE_COMPLETED = 1      # served to completion
CAUSE_DROP_DEADLINE = 2  # SLO expired at batch formation (engine drop)
CAUSE_DROP_SHUTDOWN = 3  # still queued when the clock stopped (unserved)
CAUSE_SHED = 4           # router overload valve
CAUSE_LOST = 5           # no live node at dispatch time
CAUSE_DROP_REPLAY = 6    # hopeless after failover/hand-back replay
CAUSE_DROP_PARENT = 7    # DAG cascade: a parent stage failed
CAUSE_DROP_RETRY = 8     # retry budget spent / deadline-aware shed (ISSUE 9)
CAUSE_BROWNOUT = 9       # brownout ladder denied admission (ISSUE 9)

CAUSE_NAMES = {
    CAUSE_NONE: "none",
    CAUSE_COMPLETED: "completed",
    CAUSE_DROP_DEADLINE: "drop_deadline",
    CAUSE_DROP_SHUTDOWN: "drop_shutdown",
    CAUSE_SHED: "shed",
    CAUSE_LOST: "lost",
    CAUSE_DROP_REPLAY: "drop_replay_budget",
    CAUSE_DROP_PARENT: "drop_parent_failed",
    CAUSE_DROP_RETRY: "drop_retry_budget",
    CAUSE_BROWNOUT: "brownout_shed",
}


class Timeline:
    """Lifecycle columns parallel to a ``RequestTrace``."""

    __slots__ = ("arrival0_ms", "slo0_ms", "t_dispatch_ms", "node",
                 "net_ms", "handback_ms", "failover_ms", "first_launch_ms",
                 "last_launch_ms", "intf_ms", "decode_intf_ms",
                 "resolve_ms", "cause", "router_log", "fleet_log")

    def __init__(self, n: int, arrival_ms: np.ndarray, slo_ms: np.ndarray):
        self.arrival0_ms = np.array(arrival_ms, dtype=np.float64)
        self.slo0_ms = np.array(slo_ms, dtype=np.float64)
        self.t_dispatch_ms = np.full(n, np.nan)
        self.node = np.full(n, -1, dtype=np.int32)
        self.net_ms = np.zeros(n)
        self.handback_ms = np.zeros(n)
        self.failover_ms = np.zeros(n)
        self.first_launch_ms = np.full(n, np.nan)
        self.last_launch_ms = np.full(n, np.nan)
        self.intf_ms = np.zeros(n)
        self.decode_intf_ms = np.zeros(n)
        self.resolve_ms = np.full(n, np.nan)
        self.cause = np.zeros(n, dtype=np.uint8)
        self.router_log: list[tuple] = []   # (t_ms, node, backlog_ms)
        self.fleet_log: list[tuple] = []    # (tag, t_ms, node, ...)

    def __len__(self) -> int:
        return len(self.arrival0_ms)

    # ---- forked node-worker ship-back -------------------------------------

    #: node-side columns a forked worker's engine stamps; the parent's
    #: copies of these rows are stale after the fork and must be merged
    #: from the child's pack (router-side columns stay parent-owned)
    SHIP_COLS = ("first_launch_ms", "last_launch_ms", "intf_ms",
                 "decode_intf_ms", "resolve_ms", "cause")

    def pack_rows(self, idx: np.ndarray) -> tuple:
        """Node-side column slices for ``idx``, for pickling to the parent."""
        return tuple(getattr(self, c)[idx] for c in self.SHIP_COLS)

    def unpack_rows(self, idx: np.ndarray, pack: tuple) -> None:
        """Merge a forked worker's :meth:`pack_rows` payload back in."""
        for c, vals in zip(self.SHIP_COLS, pack):
            getattr(self, c)[idx] = vals

    # ---- fabric replay hooks ----------------------------------------------

    def reset_rows(self, idx: np.ndarray) -> None:
        """Clear node-side stamps for rows about to be replayed.

        A failover / hand-back re-dispatches the request from scratch;
        stale launch stamps from the dead (or donor) node would otherwise
        double-count replay wait as preemption time.
        """
        self.first_launch_ms[idx] = np.nan
        self.last_launch_ms[idx] = np.nan
        self.intf_ms[idx] = 0.0
        self.decode_intf_ms[idx] = 0.0
        self.resolve_ms[idx] = np.nan
        self.cause[idx] = CAUSE_NONE

    def charge_replay(self, idx: np.ndarray, burn_ms: np.ndarray,
                      handback: bool) -> None:
        """Account SLO budget burned by a replay (arrival shifted forward)."""
        if handback:
            self.handback_ms[idx] += burn_ms
        else:
            self.failover_ms[idx] += burn_ms


def attach_timeline(trace) -> Timeline:
    """Create a :class:`Timeline` for ``trace`` and set ``trace.obs``.

    Must be called on the pristine trace, before any dispatch mutates
    ``arrival_ms``/``slo_ms`` — the snapshot anchors every attribution.
    Returns the existing timeline unchanged if one is already attached.
    """
    if getattr(trace, "obs", None) is not None:
        return trace.obs
    tl = Timeline(len(trace), trace.arrival_ms, trace.slo_ms)
    trace.obs = tl
    return tl
