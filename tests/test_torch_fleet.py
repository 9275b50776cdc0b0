"""The port's fleet layer (``repro_torch.fabric``, ``core/scenarios.py``,
``simulator/cluster.py``) against the JAX package's, and the fleet of
H100 nodes that ``launch/serve.py --fleet`` serves.

The fleet modules are copies (``test_torch_scheduler.py::COPIES`` holds
their text), so the same scenario and seed through both packages must
give the same run exactly: every field of the fabric's metrics and every
column of the request trace.  Each scenario is one case, at a horizon of
seconds on a few nodes (``torch_fleet_cases.py``).
"""
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

import torch_fleet_cases as C  # noqa: E402
from repro_torch.core.h100lets import (MIX, SYNTHETIC_MIX,  # noqa: E402
                                       load_catalog, synthetic_catalog)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.simulator.trace import PENDING  # noqa: E402

COMMITTED_LBP = C.PORT_ROOT / "results" / "h100_lbp.jsonl"


def _conserved(fm, trace) -> bool:
    f = fm.fleet
    return (f.total == len(trace) and f.completed + f.dropped == f.total
            and not (trace.status == PENDING).any())


CASES = C.CASES


@pytest.mark.parametrize("name", sorted(CASES))
def test_fleet_scenario_matches_jax(name):
    case, exercised = CASES[name]
    runs = [C.serve(S, case)[:2] for S in C.SIDES]
    C.assert_same_run(*runs)
    fm, trace = runs[1]
    assert _conserved(fm, trace)
    assert exercised(fm), f"{name} did not exercise its mechanism"


def test_streaming_trace_carries_its_stream_columns():
    fm, trace, _ = C.serve(C.PORT, C.streaming)
    assert trace.has_streams
    assert (trace.tokens_done[trace.status == 1]
            == trace.output_len[trace.status == 1]).all()


def test_simulate_schedule_matches_jax():
    """The deprecated one-shot shim (a 1-node fabric) through both
    packages: ``tests/test_simulator.py``'s run, metrics and requests."""
    rates = {"goo": 200.0, "res": 100.0, "vgg": 80.0}
    out = []
    for S in C.SIDES:
        res = S.core.ElasticPartitioning(S.profs).schedule(rates)
        gen = S.sim.PoissonArrivals(seed=4)
        reqs = S.sim.events.merge_sorted([
            gen.constant(m, r, S.profs[m].slo_ms, 4_000.0)
            for m, r in rates.items()])
        met = S.sim.simulate_schedule(res, S.profs, reqs,
                                      S.sim.SimConfig(horizon_ms=4_000.0))
        out.append((C.plain(met), [(r.model, r.arrival_ms, r.completion_ms,
                                    r.dropped) for r in reqs]))
    assert out[0] == out[1]
    met, reqs = out[1]
    assert met["total"] == len(reqs) > 1000
    assert met["completed"] + met["dropped"] == met["total"]
    assert met["busy_ms_per_gpulet"]


def test_parallel_node_workers_are_bit_identical():
    """Forked node engines (``node_workers=2``) give the sequential run,
    on the port's side, and the JAX package's sequential run."""
    case = C.sweep(4, horizon_s=2.0)
    seq = C.serve(C.PORT, case, node_workers=1)[:2]
    forked = C.serve(C.PORT, case, node_workers=2)[:2]
    C.assert_same_run(seq, forked)
    C.assert_same_run(C.serve(C.JAX, case, node_workers=1)[:2], forked)


# ------------------------------------------------------ the H100 fleet ----


CATALOGS = {"synthetic": lambda: (synthetic_catalog(), SYNTHETIC_MIX),
            "committed": lambda: (load_catalog(str(COMMITTED_LBP)), MIX)}


def test_sweep_share_is_the_jax_sweeps():
    """``SWEEP_SHARE`` is the JAX fabric sweep's per-node load over what
    its node's scheduler (plain Elastic Partitioning on the paper's four
    2080 Ti) admits, recomputed through the JAX package."""
    lam = C.JAX.core.ElasticPartitioning(C.JAX.profs).max_scale(
        C.JAX.scenarios.SWEEP_NODE_RATES, 0.0, serve.SEARCH_HI)
    assert serve.SWEEP_SHARE == 1.0 / lam
    assert (C.PORT.scenarios.SWEEP_NODE_RATES
            == C.JAX.scenarios.SWEEP_NODE_RATES)


@pytest.mark.parametrize("catalog", sorted(CATALOGS))
def test_fleet_rates_are_the_catalogs(catalog):
    """The fleet's per-node rates are the mix's, at ``SWEEP_SHARE`` of
    the node's elastic maximum: no rate of the paper's models reaches it."""
    (profiles, provider), mix = CATALOGS[catalog]()
    per_node, lam = serve.fleet_per_node(profiles, provider, mix, 4)
    assert lam > 0 and set(per_node) == set(mix)
    assert not set(per_node) & set(C.PORT.scenarios.SWEEP_NODE_RATES)
    for m, r in mix.items():
        assert per_node[m] == r * lam * serve.SWEEP_SHARE
    # the fleet's node admits its share: the scheduler places it
    assert serve.plan(profiles, provider, per_node, 4).schedulable


@pytest.mark.parametrize("catalog", sorted(CATALOGS))
def test_single_node_fleet_is_the_bare_replay(catalog):
    """A 1-node fleet with no network and one class, priced from the
    catalog, is ``serve_end_to_end`` with interference off on the same
    requests: the node's metrics in every field, the fleet's apart from
    the busy time it does not collect, every request's outcome.  The
    port's ``test_fabric.py::test_single_node_fabric_is_the_bare_engine``."""
    (profiles, provider), mix = CATALOGS[catalog]()
    per_node, _ = serve.fleet_per_node(profiles, provider, mix, 4)
    fm, met, fleet_reqs, bare_reqs = serve.bare_fleet(
        profiles, provider, per_node, horizon_s=3.0, seed=5)
    assert met.total > 500 and met.completed > 0
    assert serve.is_bare(fm, met, fleet_reqs, bare_reqs)
    assert fm.shed_total() == 0 and not fm.stats.rerouted
    # and the check is not vacuous: the bare replay of another seed is
    # not this fleet's run
    _, other_met, _, other_reqs = serve.bare_fleet(
        profiles, provider, per_node, horizon_s=3.0, seed=6)
    assert not serve.is_bare(fm, other_met, fleet_reqs, other_reqs)


def test_fleet_storm_scales_with_the_fleet():
    one, four = serve.fleet_storm(1, 20.0, 0), serve.fleet_storm(4, 20.0, 0)
    assert not one.permanent_crash_ms()
    assert len(four.permanent_crash_ms()) == 1
    assert four == serve.fleet_storm(4, 20.0, 0)


def _fleet_lines(capsys, argv):
    rc = serve.main(argv)
    out = capsys.readouterr().out.splitlines()
    runs = [json.loads(line) for line in out if line.startswith('{"run"')]
    last = json.loads(out[-1])
    for run in runs + last["fleet"]["runs"]:
        run.pop("host_s")
    return rc, runs, last


@pytest.mark.parametrize("catalog", ["synthetic", "committed"])
def test_fleet_cli_conserves_and_is_seed_deterministic(catalog, capsys):
    """``serve --fleet 1,2 --horizon-s 3``: the sweep at 1 and 2 nodes,
    the failure drain and the storm on 2, each conserving its requests,
    the 1-node fleet the bare replay; the same seed prints the same
    runs, another seed others."""
    argv = ["--fleet", "1,2", "--horizon-s", "3"]
    if catalog == "committed":
        argv += ["--results", str(COMMITTED_LBP)]
    rc, runs, last = _fleet_lines(capsys, argv)
    assert rc == 0
    assert [r["run"] for r in runs] == ["sweep-1n", "sweep-2n",
                                        "faildrain-2n", "chaos-2n"]
    assert runs == last["fleet"]["runs"]
    assert last["fleet"]["bare_equal"] == {"off": True}
    assert last["fleet"]["interference"] == ["off"]
    for r in runs:
        assert r["interference"] == "off"
        assert r["conserved"] and r["total"] > 0
        assert r["completed"] + r["dropped"] == r["total"]
        assert r["shed"] + r["lost"] <= r["dropped"]
        assert set(r["per_class"]) == {"gold", "silver", "bronze"}
    assert _fleet_lines(capsys, argv) == (rc, runs, last)
    assert _fleet_lines(capsys, argv + ["--seed", "1"])[1] != runs


def test_fleet_cli_refuses_an_empty_fleet():
    with pytest.raises(SystemExit, match="a node or more"):
        serve.main(["--fleet", "0,2", "--horizon-s", "1"])


def test_fleet_summary_flags_a_pending_request():
    """A run that leaves a request pending is not conserved."""
    case = C.sweep(1, horizon_s=1.0)
    fm, trace, _ = C.serve(C.PORT, case)
    assert serve.fleet_summary("x", 1, trace, fm, 0.0)["conserved"]
    trace.status[0] = PENDING
    assert not serve.fleet_summary("x", 1, trace, fm, 0.0)["conserved"]
    broken = dataclasses.replace(fm.fleet, completed=fm.fleet.completed - 1)
    trace.status[0] = 1
    assert not serve.fleet_summary(
        "x", 1, trace, dataclasses.replace(fm, fleet=broken),
        0.0)["conserved"]
    assert np.isfinite(fm.fleet.violation_rate)
