"""Deadline-aware retry budgets with exponential backoff (ISSUE 9).

Legacy failover replays every casualty exactly once with a flat
``failover_ms`` lag and drops only when the remaining SLO hits zero.
The chaos loop replaces that with a budgeted policy:

* each request carries an attempt counter (:class:`RetryLedger`);
* replay ``k`` waits ``backoff_base_ms * backoff_factor**k`` before
  re-dispatch (the burn is charged to the request's SLO budget via the
  obs ledger, so attribution still sums exactly);
* a replay is *shed* — dropped with ``CAUSE_DROP_RETRY``, never
  re-dispatched — once the attempt budget is spent or the remaining SLO
  after the backoff burn falls to ``min_headroom_ms`` or below.  Work
  that cannot meet its deadline should not steal capacity from work
  that still can.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RetryPolicy", "RetryLedger"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_retries: int = 2          #: replays allowed per request
    backoff_base_ms: float = 25.0
    backoff_factor: float = 2.0
    min_headroom_ms: float = 0.0  #: shed when remaining SLO <= this

    def __post_init__(self):
        if self.max_retries < 0 or self.backoff_base_ms < 0:
            raise ValueError("negative retry budget")
        if self.backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1")

    def lag_ms(self, attempts: np.ndarray) -> np.ndarray:
        """Backoff before replay ``attempts`` (0-based), vectorised."""
        return self.backoff_base_ms * np.power(
            self.backoff_factor, np.asarray(attempts, dtype=np.float64))


class RetryLedger:
    """Sparse per-request attempt counts (global request ids as keys)."""

    def __init__(self):
        self._n: dict[int, int] = {}

    def counts(self, ids) -> np.ndarray:
        get = self._n.get
        return np.asarray([get(int(i), 0) for i in ids], dtype=np.int64)

    def bump(self, ids) -> None:
        n = self._n
        for i in ids:
            i = int(i)
            n[i] = n.get(i, 0) + 1

    @property
    def total_attempts(self) -> int:
        return sum(self._n.values())
