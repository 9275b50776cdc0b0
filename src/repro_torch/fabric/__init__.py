"""Multi-node serving fabric: cluster-of-clusters dispatch (see README.md).

Each node is a full single-server serving stack (gpu-let partitioning +
event-heap engine + optional rescheduling controller); a global router
dispatches the client trace across nodes under a pluggable policy, with
priority classes, preemption, and a network delay model layered on top.
"""
from repro_torch.fabric.autoscaler import (DEFAULT_MODEL_BYTES, FleetAutoscaler,
                                     RestoreCostModel, ScaleEvent)
from repro_torch.fabric.fabric import FabricConfig, FabricMetrics, ServingFabric
from repro_torch.faults import (FaultPlan, HealthDetector, HealthParams,
                          NetworkDegradation, PermanentCrash, RetryPolicy,
                          StragglerWindow, TransientCrash, chaos_plan)
from repro_torch.fabric.global_scheduler import (GlobalScheduler, MigrationEvent,
                                           NodeUpdate)
from repro_torch.fabric.network import NetworkModel
from repro_torch.fabric.node import FabricNode, NodeSpec
from repro_torch.fabric.priority import (BRONZE, GOLD, PRIORITY_CLASSES, SILVER,
                                   PriorityClass, assign_priorities,
                                   draw_priorities)
from repro_torch.fabric.router import POLICIES, DispatchStats, FabricRouter
from repro_torch.fabric.workload import (build_dag_fabric, build_dag_trace_soa,
                                   build_fabric, build_stream_fabric,
                                   build_stream_trace_soa, build_trace,
                                   build_trace_soa, stream_occupancies)

__all__ = [
    "BRONZE", "DEFAULT_MODEL_BYTES", "DispatchStats", "FabricConfig",
    "FabricMetrics", "FabricNode", "FabricRouter", "FaultPlan",
    "FleetAutoscaler", "GOLD", "GlobalScheduler",
    "HealthDetector", "HealthParams", "MigrationEvent", "NetworkDegradation",
    "NetworkModel", "NodeSpec", "NodeUpdate", "PermanentCrash",
    "POLICIES", "PRIORITY_CLASSES", "PriorityClass", "RestoreCostModel",
    "RetryPolicy", "SILVER", "ScaleEvent", "ServingFabric",
    "StragglerWindow", "TransientCrash",
    "assign_priorities", "build_dag_fabric", "build_dag_trace_soa",
    "build_fabric", "build_stream_fabric", "build_stream_trace_soa",
    "build_trace", "build_trace_soa", "chaos_plan", "draw_priorities",
    "stream_occupancies",
]
