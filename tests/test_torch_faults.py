"""The port's ``faults`` package: ``tests/test_chaos.py``'s unit cases
(plan validation, the health detector, the retry ledger, the brownout
ladder) through the port, and a seeded fault storm served through both
packages, which must give the same run exactly."""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch_fleet_cases as C  # noqa: E402
from repro_torch.core.scenarios import FabricScenario  # noqa: E402
from repro_torch.fabric import (FabricConfig, build_fabric,  # noqa: E402
                                build_trace_soa, chaos_plan)
from repro_torch.faults import (EVICTED, HEALTHY,  # noqa: E402
                                BrownoutController, BrownoutParams,
                                FaultPlan, HealthDetector, HealthParams,
                                NetworkDegradation, PermanentCrash,
                                RetryLedger, RetryPolicy, StragglerWindow,
                                TransientCrash)

PROFS = C.PORT.profs


# ---------------------------------------------------------------------------
# fault-plan construction and validation
# ---------------------------------------------------------------------------

def test_fault_plan_rejects_malformed_schedules():
    with pytest.raises(ValueError, match="negative crash"):
        FaultPlan((PermanentCrash(node_id=0, t_ms=-1.0),))
    with pytest.raises(ValueError, match="two permanent crashes"):
        FaultPlan((PermanentCrash(0, 100.0), PermanentCrash(0, 200.0)))
    with pytest.raises(ValueError, match="overlapping outage"):
        FaultPlan((TransientCrash(0, 100.0, down_ms=300.0),
                   TransientCrash(0, 200.0, down_ms=100.0)))
    with pytest.raises(ValueError, match="factor must be >= 1"):
        FaultPlan((StragglerWindow(0, 0.0, 100.0, factor=0.5),))
    with pytest.raises(ValueError, match="loss_prob"):
        FaultPlan((NetworkDegradation(0.0, 100.0, loss_prob=1.0),))
    with pytest.raises(ValueError, match="permanent crash"):
        FaultPlan((PermanentCrash(0, 100.0),
                   StragglerWindow(0, 200.0, 300.0, factor=2.0)))
    with pytest.raises(TypeError, match="unknown fault"):
        FaultPlan(("not-a-fault",))


def test_fault_plan_window_queries():
    plan = FaultPlan((
        TransientCrash(0, 1_000.0, down_ms=500.0, rewarm_ms=100.0),
        PermanentCrash(1, 3_000.0),
        StragglerWindow(2, 2_000.0, 4_000.0, factor=2.0),
        NetworkDegradation(500.0, 900.0, extra_ms=5.0, loss_prob=0.05),
    ))
    assert plan.outage_windows(0) == ((1_000.0, 1_600.0),)
    assert plan.outage_windows(1) == ((3_000.0, float("inf")),)
    assert plan.outage_windows(2) == ()
    assert plan.down_at(0, 1_000.0) and plan.down_at(0, 1_599.0)
    assert not plan.down_at(0, 1_600.0)
    assert plan.down_at(1, 1e12), "permanent crashes never end"
    assert plan.permanent_crash_ms() == {1: 3_000.0}
    assert plan.straggler_windows(2) == ((2_000.0, 4_000.0, 2.0),)
    assert plan.net_windows() == ((500.0, 900.0, 5.0, 0.05),)
    assert plan.boundary_instants() == (500.0, 900.0, 1_000.0, 1_600.0,
                                        2_000.0, 3_000.0, 4_000.0)


def test_chaos_plan_generator_is_seed_deterministic():
    a = chaos_plan(4, 10_000.0, seed=3, n_transient=2, n_permanent=1)
    b = chaos_plan(4, 10_000.0, seed=3, n_transient=2, n_permanent=1)
    assert a == b
    assert a != chaos_plan(4, 10_000.0, seed=4, n_transient=2,
                           n_permanent=1)
    with pytest.raises(ValueError, match="more crashes than nodes"):
        chaos_plan(1, 10_000.0, n_transient=1, n_permanent=1)
    # the JAX package's generator draws the same storm
    j = C.JAX.faults.chaos_plan(4, 10_000.0, seed=3, n_transient=2,
                                n_permanent=1)
    assert C.plain(j) == C.plain(a)


def test_scenario_rejects_malformed_failure_schedules():
    ok = dict(name="v", n_nodes=2, rates={"goo": 50.0})
    with pytest.raises(ValueError, match="negative"):
        FabricScenario(fail_at_s=((0, -1.0),), **ok)
    with pytest.raises(ValueError, match="node"):
        FabricScenario(fail_at_s=((5, 1.0),), **ok)
    with pytest.raises(ValueError, match="twice"):
        FabricScenario(fail_at_s=((0, 1.0), (0, 2.0)), **ok)
    scn = FabricScenario(fail_at_s=((0, 30.0),), **ok)
    with pytest.warns(UserWarning, match="never fires"):
        build_trace_soa(scn, PROFS, 10.0, seed=1)


# ---------------------------------------------------------------------------
# detector / retry / brownout unit behaviour
# ---------------------------------------------------------------------------

def test_health_detector_hard_failure_and_probe_rearm():
    det = HealthDetector([0, 1], HealthParams(probe_after_ms=500.0))
    det.observe(0, 1_000.0, ok=0, failed=8)
    assert det.state[0] == EVICTED and det.n_evicted() == 1
    assert not det.routable(0, 1_200.0)
    assert det.routable(0, 1_500.0), "probe allowed after the cooldown"
    det.observe(0, 1_600.0, ok=0, failed=1)
    assert not det.routable(0, 1_700.0)
    assert det.routable(0, 2_100.0)
    t = 2_100.0
    while det.state[0] == EVICTED:
        det.observe(0, t, ok=4, failed=0)
        t += 100.0
    assert det.state[0] == HEALTHY
    assert det.routable(0, t)
    kinds = [k for _, n, k in det.events if n == 0]
    assert kinds == ["evicted", "healthy"]
    assert det.state[1] == HEALTHY and det.score[1] == 0.0


def test_health_detector_idle_epochs_carry_no_evidence():
    det = HealthDetector([0])
    det.observe(0, 100.0, ok=0, failed=5)
    assert det.state[0] == EVICTED
    for t in range(200, 5_000, 100):
        det.observe(0, float(t), ok=0, failed=0)
    assert det.state[0] == EVICTED, "idle is not healthy, only unobserved"


def test_retry_policy_backoff_and_ledger():
    pol = RetryPolicy(max_retries=3, backoff_base_ms=10.0,
                      backoff_factor=2.0)
    np.testing.assert_allclose(pol.lag_ms(np.array([0, 1, 2])),
                               [10.0, 20.0, 40.0])
    with pytest.raises(ValueError):
        RetryPolicy(backoff_factor=0.5)
    with pytest.raises(ValueError):
        RetryPolicy(max_retries=-1)
    led = RetryLedger()
    assert led.counts([7, 9]).tolist() == [0, 0]
    led.bump(np.array([7, 9]))
    led.bump(np.array([7]))
    assert led.counts([7, 9, 11]).tolist() == [2, 1, 0]
    assert led.total_attempts == 3


def _pressure(x, n=10):
    missed = np.zeros(n, dtype=bool)
    missed[:int(round(x * n))] = True
    return {"gold_total": n, "gold_missed": int(missed.sum()),
            "pressure": x, "missed_mask": missed}


def test_brownout_ladder_hysteresis():
    ctl = BrownoutController(BrownoutParams(enter=0.10, exit=0.02,
                                            patience=3))
    assert ctl.on_epoch(100.0, _pressure(0.5)) == 0
    assert ctl.on_epoch(200.0, _pressure(0.5)) == 0
    assert ctl.on_epoch(300.0, _pressure(0.5)) == 1
    assert ctl.on_epoch(400.0, _pressure(0.05)) == 1
    assert ctl.on_epoch(500.0, _pressure(0.5)) == 1
    for k in range(20):
        ctl.on_epoch(600.0 + 100 * k, _pressure(0.5))
    assert ctl.level == ctl.params.max_level
    lvl = ctl.level
    for k in range(3):
        ctl.on_epoch(3_000.0 + 100 * k, _pressure(0.0))
    assert ctl.level == lvl - 1
    ctl2 = BrownoutController(BrownoutParams(patience=2))
    empty = {"gold_total": 0, "gold_missed": 0, "pressure": 0.0,
             "missed_mask": np.zeros(0, dtype=bool)}
    for k in range(10):
        ctl2.on_epoch(100.0 * k, empty)
    assert ctl2.level == 0


def test_epoch_pressure_counts_only_the_window():
    """Through both packages: the same pressure, window by window."""
    out = []
    for S in C.SIDES:
        fabric, trace = C.sweep(2, horizon_s=4.0, seed=2)(S)
        S.obs.attach_timeline(trace)
        fabric.serve_trace(trace)
        whole = S.faults.epoch_pressure(trace, 0.0, 1e12)
        halves = [S.faults.epoch_pressure(trace, 0.0, 2_000.0),
                  S.faults.epoch_pressure(trace, 2_000.0, 1e12)]
        out.append((whole, halves))
    assert C.plain(out[0]) == C.plain(out[1])
    whole, halves = out[1]
    assert whole["gold_total"] > 0
    assert sum(h["gold_total"] for h in halves) == whole["gold_total"]


# ---------------------------------------------------------------------------
# a fault storm through both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recovery", [True, False],
                         ids=["recovery", "naive"])
def test_chaos_storm_matches_jax(recovery):
    """``fig_chaos``'s two arms on one seeded storm (a transient and a
    permanent crash, a straggler, a lossy network window, three nodes):
    the same run through both packages, every request in a final state."""
    def case(S):
        fabric, trace = C.chaos_storm(S)
        fabric.cfg.recovery = recovery
        return fabric, trace
    runs = [C.serve(S, case)[:2] for S in C.SIDES]
    C.assert_same_run(*runs)
    fm, trace = runs[1]
    assert fm.fleet.total == len(trace)
    assert fm.fleet.completed + fm.fleet.dropped == fm.fleet.total
    assert not (trace.status == 0).any()
    assert fm.chaos["recovery"] is recovery
    # the storm reached the retry path: replays, or hopeless drops
    assert fm.chaos["retries"] + fm.chaos["retry_drops"] > 0
    assert (fm.chaos["detector"] is not None) is recovery


def test_build_refuses_failures_from_two_sources():
    """A fleet takes its failures from one place: ``fail_at_ms`` and a
    fault plan together are refused, through the port."""
    scn = FabricScenario(name="x", n_nodes=2, rates={"goo": 50.0},
                         fail_at_s=((0, 1.0),))
    cfg = FabricConfig(horizon_ms=2_000.0,
                       faults=chaos_plan(2, 2_000.0, seed=1))
    with pytest.raises(ValueError, match="not both"):
        build_fabric(scn, PROFS, cfg)
