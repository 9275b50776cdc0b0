"""Discrete-event simulator of the paper's multi-GPU inference testbed."""
from repro_torch.simulator.cluster import SimConfig, simulate_schedule
from repro_torch.simulator.engine import EngineConfig, EventHeapEngine
from repro_torch.simulator.events import PoissonArrivals, Request
from repro_torch.simulator.metrics import (JobMetrics, SimMetrics, StreamMetrics,
                                     collect_jobs, collect_streams,
                                     collect_trace, window_metrics)
from repro_torch.simulator.trace import RequestTrace, RequestView

__all__ = ["EngineConfig", "EventHeapEngine", "JobMetrics",
           "PoissonArrivals", "Request", "RequestTrace", "RequestView",
           "SimConfig", "SimMetrics", "StreamMetrics", "collect_jobs",
           "collect_streams", "collect_trace", "simulate_schedule",
           "window_metrics"]
