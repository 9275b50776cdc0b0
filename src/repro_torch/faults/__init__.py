"""Fault injection and recovery for the serving fabric (ISSUE 9).

``plan``     — typed, seeded fault schedules (:class:`FaultPlan`) and the
               :func:`chaos_plan` storm generator.
``health``   — EWMA health detection replacing omniscient failure
               knowledge on the router.
``retry``    — deadline-aware retry budgets with exponential backoff.
``brownout`` — graceful-degradation ladder driven by the PR-8
               attribution report.
"""
from repro_torch.faults.brownout import (BrownoutController, BrownoutParams,
                                   epoch_pressure)
from repro_torch.faults.health import (EVICTED, HEALTHY, SUSPECT, HealthDetector,
                                 HealthParams)
from repro_torch.faults.plan import (FaultPlan, NetworkDegradation, PermanentCrash,
                               StragglerWindow, TransientCrash, chaos_plan)
from repro_torch.faults.retry import RetryLedger, RetryPolicy

__all__ = [
    "FaultPlan", "PermanentCrash", "TransientCrash", "StragglerWindow",
    "NetworkDegradation", "chaos_plan",
    "HealthDetector", "HealthParams", "HEALTHY", "SUSPECT", "EVICTED",
    "RetryPolicy", "RetryLedger",
    "BrownoutController", "BrownoutParams", "epoch_pressure",
]
