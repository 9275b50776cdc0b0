"""Router <-> node network/RPC delay model.

The fabric's router and its nodes are separate machines: every dispatch
pays a one-way RPC latency, and the response pays it again on the way
back.  We model the one-way delay as ``base_ms`` plus optional uniform
jitter drawn from a seeded generator — deterministic for a fixed seed and
dispatch order, which keeps fabric runs reproducible.

``NetworkModel.zero()`` (the default) returns exactly 0.0 for every hop;
with it a 1-node fabric is event-for-event identical to a bare
:class:`~repro.simulator.engine.EventHeapEngine` (see tests/test_fabric.py).

Fault injection (ISSUE 9) adds *degradation windows* ``(t0, t1,
extra_ms, loss_prob)``: a dispatch inside a window pays ``extra_ms`` of
additional one-way delay and is lost in transit with probability
``loss_prob``.  Loss draws come from a second seeded generator so the
jitter stream — and with it every faults-off run — stays byte-identical
whether or not windows are configured.
"""
from __future__ import annotations

import numpy as np


class NetworkModel:
    """One-way router->node RPC delay: base + U[0, jitter) per message."""

    def __init__(self, base_ms: float = 0.0, jitter_ms: float = 0.0,
                 seed: int = 0, degradations: tuple = ()):
        self.base_ms = float(base_ms)
        self.jitter_ms = float(jitter_ms)
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        #: sorted ``(t0, t1, extra_ms, loss_prob)`` degradation windows
        self.degradations = tuple(sorted(degradations))
        self._loss_rng = np.random.default_rng(seed ^ 0x5EED)

    @classmethod
    def zero(cls) -> "NetworkModel":
        return cls(0.0, 0.0)

    def with_degradations(self, windows) -> "NetworkModel":
        """A fresh copy carrying fault windows (rng streams rewound)."""
        return NetworkModel(self.base_ms, self.jitter_ms, self.seed,
                            degradations=tuple(windows))

    @property
    def is_zero(self) -> bool:
        return self.base_ms == 0.0 and self.jitter_ms == 0.0

    def degraded(self, t_ms: float) -> tuple[float, float]:
        """``(extra_ms, loss_prob)`` in effect at ``t_ms``."""
        for t0, t1, extra, lp in self.degradations:
            if t0 <= t_ms < t1:
                return extra, lp
        return 0.0, 0.0

    def delay_ms(self, node_id: int, t_ms: float | None = None) -> float:
        """One-way delay for one message to/from ``node_id``.

        ``t_ms`` (chaos dispatch only) applies any degradation window
        covering the send instant; legacy callers omit it and see the
        historical behavior bit-for-bit.
        """
        extra = 0.0
        if t_ms is not None and self.degradations:
            extra, _ = self.degraded(t_ms)
        if self.is_zero:
            return extra
        if self.jitter_ms <= 0.0:
            return self.base_ms + extra
        return self.base_ms + extra \
            + float(self._rng.uniform(0.0, self.jitter_ms))

    def lost(self, t_ms: float) -> bool:
        """Seeded in-transit loss draw for a dispatch at ``t_ms``."""
        if not self.degradations:
            return False
        _, lp = self.degraded(t_ms)
        if lp <= 0.0:
            return False
        return bool(self._loss_rng.random() < lp)

    def reset(self) -> None:
        """Rewind the jitter stream (fresh dispatch pass)."""
        self._rng = np.random.default_rng(self.seed)
        self._loss_rng = np.random.default_rng(self.seed ^ 0x5EED)
