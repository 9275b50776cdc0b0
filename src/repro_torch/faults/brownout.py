"""Brownout ladder: graceful degradation under sustained SLO pressure.

ISSUE 9's third recovery mechanism.  The controller watches the
gold-class miss pressure of each chaos epoch — computed from the same
per-request timeline the PR-8 attribution report reads — and climbs a
three-rung degradation ladder when pressure persists, stepping back down
once it clears:

=====  ==========================================================
level  effect on newly arriving requests
=====  ==========================================================
0      none (normal admission)
1      shed bronze at admission (``CAUSE_BROWNOUT``)
2      \\+ truncate stream ``output_len`` to ``truncate_tokens``
3      \\+ deny silver too: only gold is admitted
=====  ==========================================================

Escalation requires ``patience`` consecutive epochs at or above the
``enter`` pressure (hysteresis keeps one bad epoch from flapping the
fleet); de-escalation mirrors it against the lower ``exit`` threshold.
On every escalation the controller records the dominant miss-attribution
component over the window's missed gold requests, so the event log says
*why* the fleet browned out, not just when.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BrownoutParams", "BrownoutController", "epoch_pressure"]


@dataclasses.dataclass(frozen=True)
class BrownoutParams:
    enter: float = 0.10     #: gold miss rate that raises the ladder
    exit: float = 0.02      #: gold miss rate that lowers it
    patience: int = 3       #: consecutive epochs required either way
    truncate_tokens: int = 32  #: level-2 stream output_len cap
    max_level: int = 3

    def __post_init__(self):
        if not (0.0 <= self.exit <= self.enter <= 1.0):
            raise ValueError("need 0 <= exit <= enter <= 1")
        if self.patience < 1 or self.truncate_tokens < 1:
            raise ValueError("patience and truncate_tokens must be >= 1")


def epoch_pressure(trace, t0_ms: float, t1_ms: float) -> dict:
    """Gold-class miss pressure among requests resolved in ``(t0, t1]``.

    A request is *resolved in the window* when its terminal instant —
    completion for served requests, the obs ``resolve_ms`` for drops —
    lands inside it.  Returns gold totals/misses and the row mask of
    missed gold requests (for attribution on escalation).
    """
    from repro_torch.simulator.trace import COMPLETED, PENDING
    ob = trace.obs
    st = trace.status
    end = np.where(st == COMPLETED, trace.completion_ms,
                   ob.resolve_ms if ob is not None else np.nan)
    win = (st != PENDING) & np.isfinite(end) \
        & (end > t0_ms) & (end <= t1_ms)
    gold = win & (trace.priority == 0)
    missed = gold & trace.violated()
    n_gold = int(gold.sum())
    return {
        "gold_total": n_gold,
        "gold_missed": int(missed.sum()),
        "pressure": (float(missed.sum()) / n_gold) if n_gold else 0.0,
        "missed_mask": missed,
    }


class BrownoutController:
    """Hysteresis ladder over per-epoch gold miss pressure."""

    def __init__(self, params: BrownoutParams | None = None):
        self.params = params or BrownoutParams()
        self.level = 0
        self._hot = 0   # consecutive epochs at/above enter
        self._cool = 0  # consecutive epochs at/below exit
        #: (t_ms, level, pressure, dominant_cause) transitions
        self.events: list[tuple[float, int, float, str | None]] = []
        self.denied = 0
        self.truncated = 0

    def on_epoch(self, t_ms: float, pressure: dict, trace=None) -> int:
        """Fold one epoch's pressure; returns the (possibly new) level."""
        p = self.params
        x = pressure["pressure"]
        if pressure["gold_total"] == 0:
            # no gold evidence: decay toward normal, never escalate blind
            self._hot = 0
            self._cool += 1
        elif x >= p.enter:
            self._hot += 1
            self._cool = 0
        elif x <= p.exit:
            self._cool += 1
            self._hot = 0
        else:
            self._hot = 0
            self._cool = 0
        if self._hot >= p.patience and self.level < p.max_level:
            self.level += 1
            self._hot = 0
            self.events.append(
                (t_ms, self.level, x, self._dominant(pressure, trace)))
        elif self._cool >= p.patience and self.level > 0:
            self.level -= 1
            self._cool = 0
            self.events.append((t_ms, self.level, x, None))
        return self.level

    @staticmethod
    def _dominant(pressure: dict, trace) -> str | None:
        """Dominant attribution component over the window's gold misses.

        Only computed on escalation (full attribution is too heavy to run
        every epoch); this is the PR-8 report answering "why did we brown
        out" in the event log.
        """
        if trace is None or trace.obs is None:
            return None
        mask = pressure.get("missed_mask")
        if mask is None or not mask.any():
            return None
        from repro_torch.obs.attribution import COMPONENTS, attribution_arrays
        arrs = attribution_arrays(trace)
        sums = {c: float(np.nansum(arrs[c][mask])) for c in COMPONENTS}
        return max(sums, key=sums.get)

    def summary(self) -> dict:
        return {
            "final_level": self.level,
            "denied": self.denied,
            "truncated": self.truncated,
            "events": [[t, lvl, x, cause]
                       for t, lvl, x, cause in self.events],
        }
