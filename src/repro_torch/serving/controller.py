"""Periodic rescheduling controller (paper §4.1, §5, Fig. 14).

The paper's prototype monitors incoming rates with an exponentially-weighted
moving average, and every 20 s (chosen so the 10-15 s partition-reorganization
cost hides inside the window) re-runs elastic partitioning if the rates
changed enough to either violate SLOs (rate increase) or leave gpu-lets
underutilized (rate decrease).

The controller is a *subscriber* of the event-heap engine
(``simulator/engine.py``): one engine owns queues and gpu-let state across
the whole horizon, fires a reschedule tick every period, and the controller
answers each tick with either ``None`` (keep the current partitioning) or a
new ``ScheduleResult`` that the engine applies mid-flight after the
configured reorganization delay.  There is no per-period simulator restart:
requests in flight or queued at a period boundary carry over, and requests
arriving during a reorganization queue up instead of vanishing.

Because the controller now only sees rates it has *observed* (the old loop
scheduled each window against that same window's arrivals, which was
acausal), the scheduling target adds a one-period linear trend extrapolation
on top of the EWMA — without it a rising load wave outruns the EWMA lag and
the paper's low violation rates are unreachable.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable, Mapping

from repro_torch.core.profiles import ModelProfile
from repro_torch.core.scheduler_base import SchedulerBase, ScheduleResult
from repro_torch.simulator.engine import EngineConfig, EventHeapEngine
from repro_torch.simulator.events import PoissonArrivals, merge_sorted
from repro_torch.simulator.metrics import SimMetrics, window_metrics


class EWMARateTracker:
    """Per-model EWMA of observed request rates.

    A model absent from the observed window counts as an observation of
    zero: its EWMA decays toward 0 and the entry is dropped once it falls
    below the 1e-6 req/s noise floor.  Without the decay a model whose
    traffic stops keeps its last EWMA forever and the controller keeps
    provisioning partitions for dead models.
    """

    #: rates below this are noise (sub-request-per-11-days), not load
    NOISE_FLOOR = 1e-6

    def __init__(self, alpha: float = 0.5):
        self.alpha = alpha
        self.rates: dict[str, float] = {}

    def update(self, observed: Mapping[str, float]) -> dict[str, float]:
        for m in list(self.rates):
            if m not in observed:
                self.rates[m] *= 1 - self.alpha
                if self.rates[m] < self.NOISE_FLOOR:
                    del self.rates[m]
        for m, r in observed.items():
            if m in self.rates:
                self.rates[m] = self.alpha * r + (1 - self.alpha) * self.rates[m]
            else:
                self.rates[m] = r
            # explicit zero observations must drain like absences: an
            # engine that reports {m: 0.0} every window would otherwise
            # pin a dead model's entry at 0.0 forever and scale-down
            # decisions keyed on "tracked models" would never release it.
            if self.rates[m] < self.NOISE_FLOOR:
                del self.rates[m]
        return dict(self.rates)


def predict_target(ewma: Mapping[str, float],
                   observed: Mapping[str, float],
                   prev_obs: Mapping[str, float],
                   margin: float = 1.05,
                   trend_windows: float = 1.5) -> dict[str, float]:
    """Predicted next-window peak rates, with safety margin.

    Rising load: extrapolate the last observation by ``trend_windows``
    windows of its trend (the observation is the *average* over a window;
    the schedule must cover the *end* of the next one).  Falling/steady
    load: the EWMA floor prevents thrash on window noise.

    Shared by the per-node :class:`ServingController` and the fabric's
    fleet-level :class:`~repro.fabric.global_scheduler.GlobalScheduler` —
    both subscribe to periodic ticks (engine TICKs / fabric epochs) and
    need the same causal rate forecast.
    """
    out = {}
    for m, r in ewma.items():
        obs = observed.get(m, r)
        # A model first seen *this* window (absent from a real previous
        # window) grew from zero within the window: seed the trend from
        # that within-window growth instead of defaulting prev to obs
        # (zero trend), which made a flash crowd on a cold model
        # extrapolate one window late.  When there is no previous window
        # at all (very first tick) every model is "first seen" and the
        # within-window growth is unknowable — keep the zero-trend
        # default rather than inflate the deployment-time estimate.
        prev = prev_obs.get(m, 0.0 if prev_obs else obs)
        trend = max(0.0, obs - prev)
        out[m] = max(r, obs + trend_windows * trend) * margin
    return {m: r for m, r in out.items() if r > 0}


@dataclasses.dataclass
class PeriodRecord:
    t_start_s: float
    ewma_rates: dict[str, float]      # EWMA in force at the window start
    observed_rates: dict[str, float]  # rates actually seen in the window
    rescheduled: bool
    used_partition_total: int     # sum of occupied gpu-let sizes (%)
    metrics: SimMetrics


class ServingController:
    """Reschedule-tick subscriber driving one event engine (Fig. 14)."""

    def __init__(self, scheduler: SchedulerBase,
                 profiles: Mapping[str, ModelProfile],
                 period_s: float = 20.0,
                 resched_threshold: float = 0.10,
                 seed: int = 0,
                 reorg_s: float = 2.0,
                 reorg_policy: str = "serve-old"):
        self.scheduler = scheduler
        self.profiles = dict(profiles)
        self.period_s = period_s
        self.resched_threshold = resched_threshold
        self.reorg_s = reorg_s
        self.reorg_policy = reorg_policy
        self.tracker = EWMARateTracker()
        self.schedule: ScheduleResult | None = None
        self.scheduled_rates: dict[str, float] = {}
        self.gen = PoissonArrivals(seed=seed)
        self._prev_obs: dict[str, float] = {}
        self._margin = 1.05
        # per-window decision trace, assembled into PeriodRecords after run()
        self._decisions: list[tuple[dict[str, float], bool, int]] = []

    def _needs_reschedule(self, rates: Mapping[str, float]) -> bool:
        if self.schedule is None:
            return True
        for m, r in rates.items():
            old = self.scheduled_rates.get(m, 0.0)
            base = max(old, 1e-6)
            if abs(r - old) / base > self.resched_threshold:
                return True
        return False

    def _target(self, ewma: Mapping[str, float],
                observed: Mapping[str, float]) -> dict[str, float]:
        """See :func:`predict_target` (the shared forecast core)."""
        return predict_target(ewma, observed, self._prev_obs,
                              margin=self._margin)

    def _reschedule(self, ewma: Mapping[str, float],
                    observed: Mapping[str, float]) -> ScheduleResult | None:
        """Shared decision logic for the initial schedule and each tick."""
        target = self._target(ewma, observed)
        result = self.scheduler.schedule(target)
        if result.schedulable or self.schedule is None:
            self.schedule = result
            # store what the live schedule was actually provisioned for —
            # _needs_reschedule compares future load against these, and
            # comparing against the (lower, margin-free) EWMA instead
            # triggers spurious re-partitions, each costing a reorg blackout.
            self.scheduled_rates = target
            return result
        return None  # keep the old schedule if the new rates don't fit

    def _on_tick(self, t_ms: float, observed: dict[str, float],
                 engine: EventHeapEngine) -> ScheduleResult | None:
        ewma = self.tracker.update(observed)
        applied = None
        check = {m: max(r, observed.get(m, 0.0)) for m, r in ewma.items()}
        if self._needs_reschedule(check):
            applied = self._reschedule(ewma, observed)
        self._prev_obs = dict(observed)
        self._decisions.append(
            (dict(ewma), applied is not None,
             self.schedule.used_partition_total()))
        return applied

    def make_subscriber(self, init_rates: Mapping[str, float]
                        ) -> tuple[ScheduleResult, Callable]:
        """Prime a deployment-time schedule; return (schedule, on_tick).

        For an externally-owned engine — the serving fabric wires one
        engine per node and needs each node's controller as a plain tick
        subscriber.  The caller installs the returned schedule and fires
        the ticks; :meth:`run` remains the self-contained single-server
        entry point on top of this.
        """
        init = dict(init_rates)
        ewma0 = self.tracker.update(init)
        self._prev_obs = dict(init)
        self._reschedule(ewma0, init)
        self._decisions = [(dict(ewma0), True,
                            self.schedule.used_partition_total())]
        return self.schedule, self._on_tick

    def run(self, rate_fns: Mapping[str, Callable[[float], float]],
            horizon_s: float, margin: float = 1.05) -> list[PeriodRecord]:
        """Simulate ``horizon_s`` seconds of serving with fluctuating rates.

        ``rate_fns[model](t_s)`` gives the instantaneous request rate.  The
        whole-horizon trace is generated up front (inhomogeneous Poisson via
        thinning); the engine then drives one continuous simulation, calling
        back into the controller at every reschedule tick.  ``margin``
        over-provisions the scheduled rate slightly to cover prediction
        error (the paper notes occasional violations from mis-prediction).
        """
        self._margin = margin
        horizon_ms = horizon_s * 1e3
        # one record per *engine* window: the engine flushes a window at
        # every tick (k * period < horizon) plus a short tail at the
        # horizon, i.e. ceil(horizon / period) windows.  round() here left
        # trailing engine windows without a record (or records without an
        # observation) whenever the horizon was not a multiple of the
        # period.
        n_windows = max(1, math.ceil(horizon_s / self.period_s - 1e-9))
        streams = []
        for m, fn in rate_fns.items():
            grid = [k * horizon_s / 256 for k in range(257)]
            peak = max(fn(t) for t in grid) + 1e-9
            streams.append(self.gen.time_varying(
                m, lambda t, fn=fn: fn(t / 1e3), peak,
                self.profiles[m].slo_ms, horizon_ms))
        reqs = merge_sorted(streams)

        # deployment-time estimate: schedule the t=0 instantaneous rates.
        self.make_subscriber({m: fn(0.0) for m, fn in rate_fns.items()})

        engine = EventHeapEngine(
            self.profiles,
            EngineConfig(horizon_ms=horizon_ms, acc=self.scheduler.acc,
                         period_ms=self.period_s * 1e3,
                         reorg_ms=self.reorg_s * 1e3,
                         reorg_policy=self.reorg_policy),
            schedule=self.schedule, on_tick=self._on_tick)
        engine.submit(reqs)
        engine.run()
        self.engine = engine

        per_window = window_metrics(reqs, self.period_s * 1e3, n_windows,
                                    horizon_ms=horizon_ms)
        records: list[PeriodRecord] = []
        for k in range(n_windows):
            ewma, resched, used = self._decisions[min(
                k, len(self._decisions) - 1)]
            obs = engine.window_obs[k] if k < len(engine.window_obs) else {}
            records.append(PeriodRecord(
                t_start_s=k * self.period_s, ewma_rates=ewma,
                observed_rates=obs, rescheduled=resched,
                used_partition_total=used, metrics=per_window[k]))
        return records
