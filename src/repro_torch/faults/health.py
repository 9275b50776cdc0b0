"""EWMA health detection from observed dispatch outcomes (ISSUE 9).

The legacy failure-drain path is omniscient: the fabric reads
``NodeSpec.fail_at_ms`` and replays casualties the instant a node dies.
Under the chaos loop the router only sees *outcomes* — completions
against dispatches, eviction storms, lost RPCs — and this detector
turns that stream into a per-node health state machine:

    HEALTHY --(score > suspect)--> SUSPECT --(score > evict)--> EVICTED
       ^                              |                            |
       +---(score < reinstate)--------+     (probe after cooldown) +

* ``observe(node, t, ok, failed)`` folds one epoch's outcomes into an
  exponentially-weighted failure fraction.  A *hard* signal (failures
  with zero successes) short-circuits straight to EVICTED — a crashed
  node should not need several epochs of dribbling evidence.
* ``routable(node, t)`` is what the router and global scheduler consult:
  EVICTED nodes receive no traffic until ``probe_after_ms`` has passed,
  after which a probe trickle is allowed so recovery can be observed
  (scores decay only through observations, so a recovered node earns
  its way back to HEALTHY via successful probes).

Epochs with no outcomes on a node carry no evidence and leave the score
untouched — an idle node is not a healthy node, merely an unobserved one.
"""
from __future__ import annotations

import dataclasses

__all__ = ["HealthParams", "HealthDetector",
           "HEALTHY", "SUSPECT", "EVICTED"]

HEALTHY, SUSPECT, EVICTED = 0, 1, 2
_STATE_NAMES = {HEALTHY: "healthy", SUSPECT: "suspect", EVICTED: "evicted"}


@dataclasses.dataclass(frozen=True)
class HealthParams:
    """Detector tuning.  Defaults evict after ~2 consecutive bad epochs."""
    alpha: float = 0.5            #: EWMA weight of the newest epoch
    suspect_score: float = 0.3    #: failure fraction entering SUSPECT
    evict_score: float = 0.7      #: failure fraction entering EVICTED
    reinstate_score: float = 0.1  #: fraction below which a node recovers
    probe_after_ms: float = 500.0  #: eviction cooldown before probing

    def __post_init__(self):
        if not (0.0 < self.alpha <= 1.0):
            raise ValueError("alpha must be in (0, 1]")
        if not (self.reinstate_score <= self.suspect_score
                <= self.evict_score):
            raise ValueError("need reinstate <= suspect <= evict thresholds")


class HealthDetector:
    """Per-node EWMA failure scores with a suspect/evict/reinstate ladder."""

    def __init__(self, node_ids, params: HealthParams | None = None):
        self.params = params or HealthParams()
        self.score = {int(n): 0.0 for n in node_ids}
        self.state = {int(n): HEALTHY for n in node_ids}
        self.evicted_at = {int(n): None for n in node_ids}
        #: (t_ms, node_id, transition) log, surfaced in FabricMetrics.chaos
        self.events: list[tuple[float, int, str]] = []

    def add_node(self, node_id: int) -> None:
        """Register a freshly-joined (autoscaled) node, clean slate.

        Idempotent: re-registering a known node keeps its history — a
        node that earned an eviction does not launder it by re-joining.
        """
        node_id = int(node_id)
        if node_id in self.score:
            return
        self.score[node_id] = 0.0
        self.state[node_id] = HEALTHY
        self.evicted_at[node_id] = None

    # -- evidence ----------------------------------------------------------
    def observe(self, node_id: int, t_ms: float,
                ok: int, failed: int) -> None:
        """Fold one epoch's dispatch outcomes on ``node_id`` into its score."""
        node_id = int(node_id)
        total = ok + failed
        if total <= 0:
            return
        p = self.params
        frac = failed / total
        score = (1.0 - p.alpha) * self.score[node_id] + p.alpha * frac
        # hard failure: outcomes observed, none of them successes
        if failed > 0 and ok == 0:
            score = max(score, p.evict_score)
        self.score[node_id] = score
        self._transition(node_id, t_ms, score)

    def _transition(self, node_id: int, t_ms: float, score: float) -> None:
        p, st = self.params, self.state[node_id]
        if score >= p.evict_score and st == EVICTED:
            # failed probe on a still-bad node: re-arm the cooldown so
            # "routable after probe_after_ms" doesn't become "routable
            # forever" once the first cooldown elapses
            self.evicted_at[node_id] = t_ms
            return
        if score >= p.evict_score:
            new = EVICTED
            self.evicted_at[node_id] = t_ms
        elif score >= p.suspect_score and st == HEALTHY:
            new = SUSPECT
        elif score < p.reinstate_score and st != HEALTHY:
            new = HEALTHY
            self.evicted_at[node_id] = None
        else:
            return
        self.state[node_id] = new
        self.events.append((t_ms, node_id, _STATE_NAMES[new]))

    # -- queries -----------------------------------------------------------
    def routable(self, node_id: int, t_ms: float) -> bool:
        """May the router send ordinary traffic to ``node_id`` at ``t_ms``?

        SUSPECT nodes stay routable (they are demoted, not drained);
        EVICTED nodes are off-limits until the probe cooldown elapses.
        """
        node_id = int(node_id)
        st = self.state.get(node_id, HEALTHY)
        if st != EVICTED:
            return True
        t0 = self.evicted_at[node_id]
        return t0 is not None and t_ms - t0 >= self.params.probe_after_ms

    def n_evicted(self) -> int:
        return sum(1 for s in self.state.values() if s == EVICTED)

    def summary(self) -> dict:
        return {
            "events": [[t, n, s] for t, n, s in self.events],
            "final_state": {str(n): _STATE_NAMES[s]
                            for n, s in sorted(self.state.items())},
        }
