"""The event engine with the card's measured interference as its ground
truth.

The copied ``EventHeapEngine`` slows a batch whose partner gpu-let has one
in flight by ``true_interference_factors``: a synthetic function of a 2080
Ti.  :class:`MeasuredInterferenceEngine` overrides only that lookup
(``_intf``): the factor is the measured one
(``core.h100intf.CorunTable.factor``) of the batch's (arch, side, batch)
beside the partner's in-flight (arch, side, batch).  A batch size between
measured ones takes the next size up; one outside the measured range
raises.  With interference on and no co-run table it refuses to start, so
the synthetic ground truth never reaches a replay of the card's catalog;
``EngineConfig(interference=False)`` replays without interference.
"""
from __future__ import annotations

from repro_torch.core.h100intf import CorunTable
from repro_torch.simulator.engine import EngineConfig, EventHeapEngine


class MeasuredInterferenceEngine(EventHeapEngine):
    """``EventHeapEngine`` whose interference is looked up in ``corun``."""

    def __init__(self, profiles, cfg: EngineConfig | None = None,
                 schedule=None, on_tick=None, *,
                 corun: CorunTable | None = None):
        cfg = cfg or EngineConfig()
        if cfg.interference and corun is None:
            raise ValueError("interference is on but there is no measured "
                             "co-run table; pass corun=, or "
                             "EngineConfig(interference=False)")
        super().__init__(profiles, cfg, schedule, on_tick)
        self.corun = corun
        self._measured: dict[tuple, float] = {}

    def _intf(self, rt, mid: int, b: int, t: float) -> float:
        """Measured slowdown if the partner has a batch in flight."""
        p = rt.partner
        if p is None or p.inflight is None or not self.cfg.interference:
            return 1.0
        pmid, pb, _ps, pe = p.inflight
        if pe <= t:
            return 1.0
        position = int(rt.idx > p.idx)  # the card's first gpu-let is 0
        key = (mid, rt.let.size, position, b, pmid, pb)
        f = self._measured.get(key)
        if f is None:
            f = self._measured[key] = self.corun.factor(
                self._prof_by_mid[mid].name, rt.let.size, b,
                self._prof_by_mid[pmid].name, pb, position)
        return f


__all__ = ["MeasuredInterferenceEngine"]
