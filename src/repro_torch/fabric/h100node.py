"""Fleet nodes on the card's measured co-run factors.

The copied ``FabricNode`` runs the copied ``EventHeapEngine``, whose
interference is ``true_interference_factors``: a synthetic function of a
2080 Ti.  :class:`MeasuredFabricNode` overrides only the two methods that
build a node's engine (``run``, and ``begin_stream`` for the chaos, DAG
and streaming paths) to build the measured one
(``simulator.h100engine.MeasuredInterferenceEngine``) on a co-run table
(``core.h100intf.CorunTable``); everything else is the copy's.
:class:`MeasuredFleetAutoscaler` makes a node that the autoscaler adds
mid-run a measured node too.

:func:`measured` turns a built fabric (``ServingFabric.build``,
``workload.build_fabric`` / ``build_dag_fabric`` / ``build_stream_fabric``)
into one of measured nodes before it serves.  It changes each node's class
in place, so that the router, which already holds the nodes, serves the
same objects; a forked node worker (``node_workers`` > 1) runs the
subclass's ``run`` as it runs the copy's.  The fleet is planned as the
copy plans it, with plain Elastic Partitioning on each node.

Nothing falls back: with interference on and no table, :func:`measured`
and the engine refuse; with ``interference=False`` a measured node runs
the copy's engine run exactly; a batch above the table's largest or an
arch it lacks raises in ``CorunTable.factor``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.fabric.autoscaler import FleetAutoscaler
from repro_torch.fabric.node import FabricNode
from repro_torch.simulator.h100engine import MeasuredInterferenceEngine


class MeasuredFabricNode(FabricNode):
    """``FabricNode`` whose engine looks its interference up in ``corun``."""

    def __init__(self, spec, profiles, schedule, cfg, on_tick=None, *,
                 corun=None):
        super().__init__(spec, profiles, schedule, cfg, on_tick)
        self.corun = corun

    def run(self):
        """``FabricNode.run`` on the measured engine."""
        cfg = self.cfg
        if self.fails_in_run():
            cfg = dataclasses.replace(cfg, horizon_ms=self.spec.fail_at_ms,
                                      drain_factor=1.0)
        self.engine = MeasuredInterferenceEngine(
            self.profiles, cfg, schedule=self.schedule, on_tick=self.on_tick,
            corun=self.corun)
        for t_apply, sched in self.schedule_plan:
            self.engine.apply_schedule_at(t_apply, sched)
        self.engine.submit_trace(
            self.trace, np.asarray(self.pending_idx, dtype=np.int64))
        self.metrics = self.engine.run()
        self.span_log = self.engine.log
        return self.metrics

    def begin_stream(self) -> None:
        """``FabricNode.begin_stream`` on the measured engine."""
        self.engine = MeasuredInterferenceEngine(
            self.profiles, self.cfg, schedule=self.schedule, on_tick=None,
            corun=self.corun)
        self.engine.submit_trace(self.trace, np.empty(0, dtype=np.int64))
        self._fed = 0


def _measure(node: FabricNode, corun) -> FabricNode:
    node.__class__ = MeasuredFabricNode
    node.corun = corun
    return node


class MeasuredFleetAutoscaler(FleetAutoscaler):
    """``FleetAutoscaler`` whose added nodes are measured nodes."""

    def __init__(self, profiles, nodes, cfg, *, corun):
        super().__init__(profiles, nodes, cfg)
        self.corun = corun

    def _spawn(self, t_ms, target, desired, remaining_ms):
        node = super()._spawn(t_ms, target, desired, remaining_ms)
        return None if node is None else _measure(node, self.corun)


def measured(fabric, corun):
    """``fabric`` with every node a :class:`MeasuredFabricNode` on
    ``corun`` and, when it autoscales, a :class:`MeasuredFleetAutoscaler`
    (``ServingFabric`` reuses an autoscaler it is given).  Call it after
    the fabric is built and before it serves."""
    if fabric.cfg.interference and corun is None:
        raise ValueError("interference is on but there is no measured "
                         "co-run table; pass one, or build the fabric with "
                         "FabricConfig(interference=False)")
    for node in fabric.nodes:
        _measure(node, corun)
    if fabric.cfg.autoscale:
        fabric.autoscaler = MeasuredFleetAutoscaler(
            fabric.profiles, fabric.nodes, fabric.cfg, corun=corun)
    return fabric


__all__ = ["MeasuredFabricNode", "MeasuredFleetAutoscaler", "measured"]
