"""Request arrival processes.

The paper samples inter-arrival times from a Poisson process per model
(§6.1, citing Treadmill [38]); rate-fluctuation experiments (Fig. 14) use a
time-varying rate, which we model as an inhomogeneous Poisson process via
per-interval thinning.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable, Sequence

import numpy as np


@dataclasses.dataclass(slots=True)
class Request:
    model: str
    arrival_ms: float
    slo_ms: float
    # filled by the simulator:
    completion_ms: float | None = None
    dropped: bool = False
    #: priority class level, 0 = most important (see fabric/priority.py).
    #: Single-tenant traces leave the default; only the fabric's preemptive
    #: path ever looks at it.
    priority: int = 0
    #: True if an in-flight batch holding this request was ever preempted
    #: (the request itself may still complete within SLO afterwards).
    preempted: bool = False
    #: True for conservation drops: still queued when the engine's clock
    #: stopped (horizon drain, or a fabric node dying), as opposed to a
    #: deliberate SLO-expiry drop at batch formation.  The fabric's
    #: failure-drain path replays only these.
    unserved: bool = False
    #: Full lifecycle status code (``simulator.trace`` enum) as stamped by
    #: the SoA path.  ``dropped``/``unserved`` are lossy projections of it
    #: — they cannot distinguish SHED/LOST from DROPPED — so ``write_back``
    #: records the code here and ``from_requests`` prefers it, making a
    #: trace→objects→trace round trip byte-identical.  -1 means "never
    #: touched by a trace": the code is then derived from the bools.
    status_code: int = -1

    @property
    def latency_ms(self) -> float | None:
        if self.completion_ms is None:
            return None
        return self.completion_ms - self.arrival_ms

    @property
    def violated(self) -> bool:
        if self.dropped:
            return True
        return self.completion_ms is not None and self.latency_ms > self.slo_ms


class PoissonArrivals:
    """Generates per-model Poisson request arrivals over a horizon.

    Inter-arrival gaps are drawn in vectorized chunks (``rng.exponential``
    over arrays, cumulative-summed) rather than one Python-loop draw per
    request, so 100k+-request traces generate in milliseconds.
    """

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def _arrival_times(self, rate_req_s: float, horizon_ms: float
                       ) -> np.ndarray:
        """Homogeneous Poisson arrival times in [0, horizon_ms)."""
        scale_ms = 1e3 / rate_req_s
        expected = horizon_ms / scale_ms
        chunks: list[np.ndarray] = []
        t = 0.0
        while t < horizon_ms:
            # overshoot the expected remaining count so one chunk almost
            # always suffices; loop covers the unlucky tail.
            n = int((horizon_ms - t) / scale_ms * 1.2) + 16
            ts = t + np.cumsum(self.rng.exponential(scale_ms, size=n))
            chunks.append(ts)
            t = float(ts[-1])
        times = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        return times[times < horizon_ms]

    def constant_times(self, rate_req_s: float,
                       horizon_ms: float) -> np.ndarray:
        """Arrival-time array for a homogeneous stream (SoA hot path)."""
        if rate_req_s <= 0:
            return np.empty(0)
        return self._arrival_times(rate_req_s, horizon_ms)

    def time_varying_times(self, rate_fn: Callable[[float], float],
                           peak_rate: float,
                           horizon_ms: float) -> np.ndarray:
        """Thinned arrival-time array for an inhomogeneous stream."""
        if peak_rate <= 0:
            return np.empty(0)
        times = self._arrival_times(peak_rate, horizon_ms)
        if times.size == 0:
            return times
        u = self.rng.uniform(size=times.size)
        rates = np.fromiter((rate_fn(float(t)) for t in times),
                            dtype=float, count=times.size)
        return times[u < rates / peak_rate]

    def constant(self, model: str, rate_req_s: float, slo_ms: float,
                 horizon_ms: float, start_ms: float = 0.0) -> list[Request]:
        return [Request(model=model, arrival_ms=start_ms + float(t),
                        slo_ms=slo_ms)
                for t in self.constant_times(rate_req_s, horizon_ms)]

    def time_varying(self, model: str, rate_fn: Callable[[float], float],
                     peak_rate: float, slo_ms: float,
                     horizon_ms: float) -> list[Request]:
        """Inhomogeneous Poisson via thinning against ``peak_rate``."""
        return [Request(model=model, arrival_ms=float(t), slo_ms=slo_ms)
                for t in self.time_varying_times(rate_fn, peak_rate,
                                                 horizon_ms)]


def merge_sorted(streams: Sequence[list[Request]]) -> list[Request]:
    reqs = [r for s in streams for r in s]
    reqs.sort(key=lambda r: r.arrival_ms)
    return reqs
