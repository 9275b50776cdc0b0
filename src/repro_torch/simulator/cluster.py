"""Deprecated compatibility shim: one-shot simulation of a static schedule.

.. deprecated::
    ``simulate_schedule`` predates both the event-heap engine (PR 1) and
    the multi-node serving fabric (``repro.fabric``).  It is kept so the
    historical benchmarks/examples/tests keep running, but it is now a
    thin veneer over the fabric's single-node path — there is exactly one
    serving entry point (:class:`repro.fabric.ServingFabric`), and a
    1-node fabric with zero network delay is event-for-event identical to
    the bare engine (property-tested in tests/test_fabric.py).  New code
    should build a ``ServingFabric`` (multi-node) or an
    ``EventHeapEngine`` (single server) directly.

Simplifications vs. real hardware (inherited by the engine), recorded for
honesty:
  * batch launches are paced by the duty cycle; an overrunning cycle pushes
    the next one (no preemption, kernel-granularity as on real GPUs);
  * the interference factor applies when the partner gpu-let has a batch in
    flight at launch time (no sub-batch overlap integration);
  * requests whose queueing delay already exceeds the SLO are dropped at
    batch formation (the paper counts drops as violations too).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

from repro_torch.core.hardware import AcceleratorSpec, ClusterSpec, RTX_2080TI
from repro_torch.core.profiles import ModelProfile
from repro_torch.core.scheduler_base import ScheduleResult
from repro_torch.simulator.engine import EngineConfig
from repro_torch.simulator.events import Request
from repro_torch.simulator.metrics import SimMetrics


@dataclasses.dataclass
class SimConfig:
    horizon_ms: float = 20_000.0
    acc: AcceleratorSpec = RTX_2080TI


def simulate_schedule(result: ScheduleResult,
                      profiles: Mapping[str, ModelProfile],
                      requests: list[Request],
                      cfg: SimConfig | None = None) -> SimMetrics:
    """Serve ``requests`` on a static schedule via a 1-node fabric."""
    from repro_torch.fabric import FabricConfig, FabricNode, NodeSpec, ServingFabric
    cfg = cfg or SimConfig()
    node = FabricNode(
        NodeSpec(node_id=0, cluster=ClusterSpec(accelerator=cfg.acc)),
        profiles, result,
        EngineConfig(horizon_ms=cfg.horizon_ms, acc=cfg.acc))
    fabric = ServingFabric(profiles, [node],
                           FabricConfig(horizon_ms=cfg.horizon_ms))
    fabric.serve(requests)
    # the node's own metrics carry per-gpu-let busy time, which the
    # fleet-level aggregate does not — callers of this shim expect it.
    return node.metrics
