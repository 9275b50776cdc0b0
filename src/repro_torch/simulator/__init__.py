"""The event-heap serving engine, copied from the JAX package's
``simulator`` (imports rewritten to ``repro_torch``).  ``cluster.py``
(``simulate_schedule``) is left out: it reaches into the fabric, which
the port does not have."""
from repro_torch.simulator.engine import EngineConfig, EventHeapEngine
from repro_torch.simulator.events import PoissonArrivals, Request
from repro_torch.simulator.metrics import (JobMetrics, SimMetrics,
                                           StreamMetrics, collect_jobs,
                                           collect_streams, collect_trace,
                                           window_metrics)
from repro_torch.simulator.trace import RequestTrace, RequestView

__all__ = ["EngineConfig", "EventHeapEngine", "JobMetrics",
           "PoissonArrivals", "Request", "RequestTrace", "RequestView",
           "SimMetrics", "StreamMetrics", "collect_jobs", "collect_streams",
           "collect_trace", "window_metrics"]
