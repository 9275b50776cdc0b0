"""The fleet layer's scenarios through both packages, shared by the port's
fleet tests (``test_torch_fleet.py``, ``test_torch_faults.py``,
``test_torch_obs.py``).

``JAX`` and ``PORT`` bundle one package's modules.  Each case builds its
scenario, fabric and trace from one side only, so a case run through
``JAX`` and through ``PORT`` runs the original and the copy on the same
inputs.  Horizons are seconds and fleets a few nodes, so that each case
costs about a second a side on the CPU.  No case pins a per-request
fingerprint of the JAX package's goldens: the two sides are compared with
each other.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np

import repro.core as jcore
import repro.core.scenarios as jscenarios
import repro.fabric as jfabric
import repro.faults as jfaults
import repro.obs as jobs
import repro.simulator as jsim
import repro_torch.core as tcore
import repro_torch.core.scenarios as tscenarios
import repro_torch.fabric as tfabric
import repro_torch.faults as tfaults
import repro_torch.obs as tobs
import repro_torch.simulator as tsim

JAX = SimpleNamespace(name="jax", core=jcore, scenarios=jscenarios,
                      fabric=jfabric, faults=jfaults, obs=jobs, sim=jsim,
                      profs=jcore.calibrate_profiles())
PORT = SimpleNamespace(name="port", core=tcore, scenarios=tscenarios,
                       fabric=tfabric, faults=tfaults, obs=tobs, sim=tsim,
                       profs=tcore.calibrate_profiles())
SIDES = (JAX, PORT)
PORT_ROOT = Path(__file__).resolve().parent.parent


def plain(obj):
    """Metrics as plain data: a dataclass of either package becomes its
    class name and fields, arrays lists, NaN a string (so that NaN equals
    NaN), dict keys their ``repr`` (so that 1 and "1" stay apart)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__class__": type(obj).__name__,
                **{f.name: plain(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {repr(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return plain(obj.tolist())
    if isinstance(obj, np.generic):
        return plain(obj.item())
    if isinstance(obj, float) and math.isnan(obj):
        return "nan"
    return obj


def assert_same_trace(a, b):
    """Every column of two ``RequestTrace`` s equal, NaN equal to NaN:
    statuses, finish times, arrivals, SLOs, priorities, nodes, and the
    stage and stream columns where they are attached."""
    assert a.models == b.models

    def columns(trace):
        return {k for k in type(trace).__slots__
                if isinstance(getattr(trace, k), np.ndarray)}
    cols = columns(a)
    assert cols == columns(b)
    assert {"status", "completion_ms"} <= cols
    for k in sorted(cols):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)


def assert_same_run(ja, tb):
    """Two ``(FabricMetrics, RequestTrace)`` runs are the same run: every
    field of the metrics (fleet, per node, router, migrations, jobs,
    chaos, scale events) and every column of the trace."""
    (jfm, jtrace), (tfm, ttrace) = ja, tb
    assert plain(jfm) == plain(tfm)
    assert_same_trace(jtrace, ttrace)


# --------------------------------------------------------------- cases ----
# each takes a side and returns its unserved (fabric, trace)


def sweep(n_nodes: int, horizon_s: float = 3.0, seed: int = 0,
          **cfg_kw):
    """The JAX fabric sweep's configuration (``fig_fabric_scaling``) at
    ``n_nodes``: the paper's mix at ``SWEEP_NODE_RATES`` a node, 20 / 50 /
    30 priorities, least-loaded, a 0.15 ms RPC, preemption."""
    def case(S):
        scn = S.scenarios.fabric_node_sweep(node_counts=(n_nodes,))[0]
        cfg = S.fabric.FabricConfig(
            horizon_ms=horizon_s * 1e3, policy="least-loaded",
            network=S.fabric.NetworkModel(base_ms=0.15, seed=seed),
            preemption=True, **cfg_kw)
        return (S.fabric.build_fabric(scn, S.profs, cfg),
                S.fabric.build_trace_soa(scn, S.profs, horizon_s,
                                         seed=seed))
    return case


def failure_drain(S):
    """One of three nodes dies at 2 s; a 10 ms failover lag, so that the
    casualties replay on the survivors (``test_fabric.py``'s point)."""
    scn = S.scenarios.failure_drain_scenario(3, fail_at_s=2.0)
    cfg = S.fabric.FabricConfig(horizon_ms=5_000.0, preemption=True,
                                failover_ms=10.0)
    return (S.fabric.build_fabric(scn, S.profs, cfg),
            S.fabric.build_trace_soa(scn, S.profs, 5.0, seed=7))


def chaos_storm(S):
    """A seeded storm with one transient and one permanent crash, a
    straggler and a lossy network window, on three nodes, recovery on."""
    scn = S.scenarios.fabric_node_sweep(node_counts=(3,))[0]
    plan = S.faults.chaos_plan(3, 5_000.0, seed=7, n_transient=1,
                               n_permanent=1)
    cfg = S.fabric.FabricConfig(horizon_ms=5_000.0, preemption=True,
                                faults=plan)
    return (S.fabric.build_fabric(scn, S.profs, cfg),
            S.fabric.build_trace_soa(scn, S.profs, 5.0, seed=3))


def migrations(S):
    """``drifting_zipf_scenario`` with the migration loop on
    (``test_migration.py``'s configuration, shorter: a patience of one
    epoch, so that the drift at 5 s moves placement within 10 s)."""
    scn = S.scenarios.drifting_zipf_scenario(3, horizon_s=10.0, n_phases=2,
                                             skew=2.4, util=1.1)
    cfg = S.fabric.FabricConfig(
        horizon_ms=10_000.0, preemption=True, migrations=True,
        migration_period_ms=2_000.0, max_migrations_per_epoch=3,
        migration_warmup_jitter_ms=60.0, migration_seed=5,
        migration_patience=1)
    return (S.fabric.build_fabric(scn, S.profs, cfg),
            S.fabric.build_trace_soa(scn, S.profs, 10.0, seed=11))


def autoscale(S):
    """``flash_crowd_scenario`` on two nodes with predictive autoscaling
    (``test_autoscale.py``'s configuration, shorter)."""
    horizon_s = 10.0
    scn = S.scenarios.flash_crowd_scenario(
        2, horizon_s=horizon_s, crowd_units=18.0, t0_s=0.3 * horizon_s,
        ramp_s=0.1 * horizon_s, t1_s=0.75 * horizon_s)
    cfg = S.fabric.FabricConfig(
        horizon_ms=horizon_s * 1e3, preemption=True, migrations=True,
        migration_period_ms=2_000.0, max_migrations_per_epoch=3,
        autoscale=True, autoscale_min_nodes=2, autoscale_max_nodes=8,
        restore=S.fabric.RestoreCostModel.paper_default())
    return (S.fabric.build_fabric(scn, S.profs, cfg),
            S.fabric.build_trace_soa(scn, S.profs, horizon_s, seed=11))


def mixed_dag(S):
    """``mixed_dag_scenario``: chain and fan-out / fan-in jobs beside
    single-model traffic, with a 1 ms RPC so that co-location matters."""
    scn = S.scenarios.mixed_dag_scenario(2)
    cfg = S.fabric.FabricConfig(horizon_ms=4_000.0,
                                network=S.fabric.NetworkModel(base_ms=1.0))
    return (S.fabric.build_dag_fabric(scn, S.profs, cfg=cfg),
            S.fabric.build_dag_trace_soa(scn, S.profs, 4.0, seed=3))


def streaming(S):
    """``streaming_zipf_scenario`` with phase-aware provisioning."""
    scn = S.scenarios.streaming_zipf_scenario(2, util=1.0)
    cfg = S.fabric.FabricConfig(horizon_ms=3_000.0)
    return (S.fabric.build_stream_fabric(scn, S.profs, cfg=cfg),
            S.fabric.build_stream_trace_soa(scn, S.profs, 3.0, seed=7))


# each case, and what it must have exercised on the port's side
CASES = {
    "sweep-1n": (sweep(1), lambda fm: fm.stats.dispatched),
    "sweep-2n": (sweep(2), lambda fm: len(fm.per_node) == 2),
    "failure-drain": (failure_drain, lambda fm: fm.failed_over > 0),
    "migrations": (migrations, lambda fm: fm.migrations > 0),
    "autoscale": (autoscale, lambda fm: any(
        e.action == "add" for e in fm.scale_events)),
    "mixed-dag": (mixed_dag, lambda fm: fm.jobs is not None
                  and fm.jobs.jobs > 0),
    "streaming": (streaming, lambda fm: fm.fleet.completed > 0),
}


def interference_off(S):
    """Side ``S`` whose every fabric is built with interference off."""
    fabric = SimpleNamespace(**vars(S.fabric))
    fabric.FabricConfig = functools.partial(S.fabric.FabricConfig,
                                            interference=False)
    return SimpleNamespace(**{**vars(S), "name": f"{S.name}, off",
                              "fabric": fabric})


def serve(S, case, node_workers: int | None = None, prepare=None):
    """(FabricMetrics, RequestTrace, fabric) of ``case`` on side ``S``;
    ``prepare(fabric)`` runs after the fabric is built, before it serves."""
    fabric, trace = case(S)
    if node_workers is not None:
        fabric.cfg.node_workers = node_workers
    if prepare is not None:
        prepare(fabric)
    fm = fabric.serve_trace(trace)
    return fm, trace, fabric
