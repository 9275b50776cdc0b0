"""Fleet nodes on the card's measured co-run factors
(``repro_torch.fabric.h100node``) and the serving controller on them
(``launch/serve.py --fleet`` / ``--fluctuate`` with ``--corun``).

A measured node differs from the copied ``FabricNode`` only in where its
engine finds a co-run factor.  So with a table whose every factor is 1 a
fleet of measured nodes must be the copy's fleet with interference off,
and with a table that answers with the copied analytic ground truth
(``true_interference_factors``) it must be the JAX package's fleet with
interference on: every field of the metrics and every column of the trace
(``torch_fleet_cases.py``'s scenarios).  Then the committed H100 tables:
the 1-node fleet against the bare measured replay, an all-ones table
against interference off, the CLI, forked node workers, the refusals, and
the controller.
"""
import json

import pytest

pytest.importorskip("torch")

import torch_fleet_cases as C  # noqa: E402
from repro_torch.core.h100intf import CorunTable, load_corun  # noqa: E402
from repro_torch.core.h100lets import MIX, load_catalog  # noqa: E402
from repro_torch.core.interference import (  # noqa: E402
    true_interference_factors)
from repro_torch.fabric import FabricConfig, ServingFabric  # noqa: E402
from repro_torch.fabric.h100node import (MeasuredFabricNode,  # noqa: E402
                                         measured)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.simulator.h100engine import (  # noqa: E402
    MeasuredInterferenceEngine)

RESULTS = C.PORT_ROOT / "results"
LBP, CORUN, FEATURES = (str(RESULTS / f"h100_{n}.jsonl")
                        for n in ("lbp", "corun", "features"))

CASES = {**C.CASES, "chaos-storm": (
    C.chaos_storm, lambda fm: fm.chaos["retries"]
    + fm.chaos["retry_drops"] > 0)}


class Ones:
    """A co-run table whose every factor is 1; counts its lookups."""

    def __init__(self):
        self.calls = 0

    def factor(self, arch, percent, batch, partner, partner_batch,
               position=0):
        self.calls += 1
        return 1.0


class Synthetic(Ones):
    """The copied analytic ground truth behind the co-run table's lookup:
    ``arch`` on ``percent`` of its card beside ``partner`` on the rest."""

    def __init__(self, profiles, acc):
        super().__init__()
        self.profiles, self.acc = profiles, acc

    def factor(self, arch, percent, batch, partner, partner_batch,
               position=0):
        self.calls += 1
        return true_interference_factors(
            self.profiles[arch], percent / 100, batch,
            self.profiles[partner], (100 - percent) / 100, partner_batch,
            self.acc)[0]


def split_cards_are_pairs(fabric):
    """Every card of every node's partitionings (the first and each staged
    one) holds at most two gpu-lets, two of them 100% together: a measured
    node's partner share is 100 - its own."""
    for node in fabric.nodes:
        for sched in [node.schedule] + [s for _, s in node.schedule_plan]:
            for gpu in sched.gpus:
                sizes = [let.size for let in gpu.lets]
                assert len(sizes) == 1 or (len(sizes) == 2
                                           and sum(sizes) == 100), sizes


def serve_measured(case, table_of):
    """``case`` on the port's side on measured nodes, the table made from
    the built fabric: (metrics, trace), the fabric and the table."""
    made = {}

    def prepare(fabric):
        made["table"] = table_of(fabric)
        measured(fabric, made["table"])
    fm, trace, fabric = C.serve(C.PORT, case, prepare=prepare)
    assert fabric.nodes and all(type(n) is MeasuredFabricNode
                                for n in fabric.nodes)
    assert all(type(n.engine) is MeasuredInterferenceEngine
               for n in fabric.nodes if n.engine is not None)
    return (fm, trace), fabric, made["table"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ones_table_is_the_copys_run_without_interference(name):
    """Every factor 1: the copy's run with interference off, exactly;
    the nodes an autoscaler adds are measured nodes too."""
    case, exercised = CASES[name]
    got, fabric, table = serve_measured(case, lambda f: Ones())
    C.assert_same_run(C.serve(C.interference_off(C.PORT), case)[:2], got)
    assert exercised(got[0]), f"{name} did not exercise its mechanism"
    assert table.calls > 0, "no batch ran beside a partner's"


@pytest.mark.parametrize("name", sorted(CASES))
def test_synthetic_table_is_the_jax_run_with_interference(name):
    """The analytic ground truth behind the lookup: the JAX package's run
    with interference on, exactly."""
    case, exercised = CASES[name]
    got, fabric, table = serve_measured(case, lambda f: Synthetic(
        f.profiles, f.nodes[0].cfg.acc))
    split_cards_are_pairs(fabric)
    C.assert_same_run(C.serve(C.JAX, case)[:2], got)
    assert table.calls > 0, "no batch ran beside a partner's"


def test_measured_nodes_refuse_interference_without_a_table():
    fabric, _ = C.sweep(1)(C.PORT)
    with pytest.raises(ValueError, match="no measured co-run table"):
        measured(fabric, None)
    node = fabric.nodes[0]
    bare = MeasuredFabricNode(node.spec, node.profiles, node.schedule,
                              node.cfg)
    with pytest.raises(ValueError, match="no measured co-run table"):
        bare.begin_stream()


# ------------------------------------------------ the committed tables ----


@pytest.fixture(scope="module")
def h100():
    """(profiles, provider, the mix's per-node rates, co-run table)."""
    profiles, provider = load_catalog(LBP)
    per_node, _ = serve.fleet_per_node(profiles, provider, dict(MIX), 4)
    return profiles, provider, per_node, load_corun(CORUN)


def ones_like(table: CorunTable) -> CorunTable:
    return CorunTable([dict(r, factor=[1.0, 1.0]) for r in table.records])


def test_measured_single_node_fleet_is_the_measured_bare_replay(h100):
    """A 1-node fleet of a measured node is ``serve_end_to_end`` on the
    same table and requests; the measured factors change the run."""
    profiles, provider, per_node, corun = h100
    fm, met, fleet_reqs, bare_reqs = serve.bare_fleet(
        profiles, provider, per_node, horizon_s=3.0, seed=5, corun=corun)
    assert met.total > 500 and met.completed > 0
    assert serve.is_bare(fm, met, fleet_reqs, bare_reqs)
    _, off, _, _ = serve.bare_fleet(profiles, provider, per_node,
                                    horizon_s=3.0, seed=5)
    assert off.total == met.total
    assert off.slo_violations < met.slo_violations


@pytest.mark.parametrize("run", ["sweep-2n", "faildrain-2n", "chaos-2n"])
def test_committed_table_of_ones_is_the_fleet_without_interference(
        h100, run):
    """The committed co-run records with every factor 1 give each fleet
    run of ``serve --fleet`` with interference off; the committed factors
    themselves give another run."""
    profiles, provider, per_node, corun = h100
    name, scn, kw = next(r for r in serve.fleet_scenarios(
        per_node, (1, 2), 4.0, 0) if r[0] == run)

    def served(table):
        cfg = serve.fleet_config(provider, 4.0, 0,
                                 interference=table is not None, **kw)
        return serve.run_fleet(scn, profiles, cfg, n_gpus=4, horizon_s=4.0,
                               seed=0, corun=table)
    off = served(None)
    C.assert_same_run(off, served(ones_like(corun)))
    assert C.plain(served(corun)[0]) != C.plain(off[0])


def test_measured_fleet_node_workers_are_bit_identical(h100):
    """Forked node workers run measured nodes: ``node_workers=2`` gives
    the sequential run."""
    profiles, provider, per_node, corun = h100
    _, scn, _ = serve.fleet_scenarios(per_node, (4,), 2.0, 0)[0]
    runs = [serve.run_fleet(scn, profiles, serve.fleet_config(
        provider, 2.0, 0, interference=True, node_workers=w), n_gpus=4,
        horizon_s=2.0, seed=0, corun=corun) for w in (1, 2)]
    C.assert_same_run(*runs)


def test_measured_fleet_refuses_an_arch_the_table_lacks(h100):
    """A co-run table without recurrentgemma-2b: the fleet of the mix
    raises where that model runs beside a partner, and falls back to no
    other factor."""
    profiles, provider, per_node, corun = h100
    short = CorunTable([r for r in corun.records
                        if "recurrentgemma-2b" not in r["arch"]])
    fabric = ServingFabric.build(
        {m: profiles[m] for m in per_node}, 1, per_node,
        FabricConfig(horizon_ms=3e3, lat=provider),
        node_cluster=serve.cluster_of(4))
    measured(fabric, short)
    reqs = serve.poisson_requests(profiles, per_node, 3e3, 0)
    with pytest.raises(KeyError, match="recurrentgemma-2b"):
        fabric.serve(reqs)


def _main(capsys, argv):
    rc = serve.main(argv)
    out = capsys.readouterr().out.splitlines()
    last = json.loads(out[-1])
    for run in last["fleet"]["runs"]:
        run.pop("host_s")
    return rc, last


def test_measured_fleet_cli_conserves_and_is_seed_deterministic(capsys):
    """``serve --fleet 1,2 --corun ...``: each run on measured nodes, then
    with interference off, labelled, each conserving its requests; both
    1-node checks hold; a seed gives the same lines, another seed
    others."""
    argv = ["--results", LBP, "--corun", CORUN, "--features", FEATURES,
            "--fleet", "1,2", "--horizon-s", "3"]
    rc, last = _main(capsys, argv)
    assert rc == 0
    fleet = last["fleet"]
    runs = fleet["runs"]
    assert [(r["run"], r["interference"]) for r in runs] == [
        (name, label) for name in ("sweep-1n", "sweep-2n", "faildrain-2n",
                                   "chaos-2n")
        for label in ("measured", "off")]
    assert fleet["bare_equal"] == {"measured": True, "off": True}
    assert fleet["interference"] == ["measured", "off"]
    for r in runs:
        assert r["conserved"] and r["total"] > 0
        assert r["completed"] + r["dropped"] == r["total"]
    for measured_run, off_run in zip(runs[::2], runs[1::2]):
        assert measured_run["total"] == off_run["total"]
    assert _main(capsys, argv) == (rc, last)
    assert _main(capsys, argv + ["--seed", "1"])[1]["fleet"]["runs"] != runs


def test_controller_on_a_table_of_ones_is_the_run_without_interference(
        h100):
    """``--fluctuate --corun``'s engine with every factor 1 is the run with
    interference off, window by window; the committed factors add
    violations."""
    profiles, provider, _, corun = h100
    lam = serve.plan_max_scale(profiles, provider, dict(MIX), 4)
    rates = {m: r * lam * serve.EXAMPLE_SHARE for m, r in MIX.items()}

    def run(table):
        records, met, offered, first = serve.fluctuate(
            profiles, provider, rates, horizon_s=120.0, corun=table)
        return records, met, offered, C.plain(first)
    off, ones, real = run(None), run(ones_like(corun)), run(corun)
    assert off[0] == ones[0] and off[2:] == ones[2:]
    assert serve.same_metrics(off[1], ones[1])
    assert off[2] == real[2] == off[1].total == real[1].total > 0
    assert real[1].slo_violations > off[1].slo_violations
    assert real[1].completed + real[1].dropped == real[1].total
