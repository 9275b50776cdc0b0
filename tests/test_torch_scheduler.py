"""The port's copy of the gpu-let control plane against the JAX package's.

``repro_torch.core`` and ``repro_torch.simulator`` are copies of
``repro.core`` and ``repro.simulator`` with their imports rewritten.  The
same inputs go through both packages, and the results must be identical:
schedules (splits, assignments, batches, duty cycles), the latency
quantities of ``LatencyProvider``, gpu-let splits, and an event-engine run
field by field and per request.  A last test holds the port to its rule:
no module of it imports ``jax`` or ``repro``.
"""
import dataclasses
import re
from pathlib import Path

import pytest
from hypothesis import given, settings, strategies as st

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core import gpulet as jgpulet  # noqa: E402
from repro.core import latency as jlat  # noqa: E402
from repro.core.hardware import ClusterSpec as JCluster  # noqa: E402
from repro.core.hardware import RTX_2080TI as JRTX  # noqa: E402
from repro_torch.core import gpulet as tgpulet  # noqa: E402
from repro_torch.core import latency as tlat  # noqa: E402
from repro_torch.core.hardware import ClusterSpec as TCluster  # noqa: E402
from repro_torch.core.hardware import RTX_2080TI as TRTX  # noqa: E402

JPROFS = jcore.calibrate_profiles()
TPROFS = tcore.calibrate_profiles()
MODELS = sorted(JPROFS)
JINTF, _ = jcore.fit_default_model(JPROFS)
TINTF, _ = tcore.fit_default_model(TPROFS)
PORT = Path(__file__).resolve().parent.parent / "src" / "repro_torch"


def plain(obj):
    """A schedule result as plain data: dataclasses of either package
    become dicts (class names differ by package only)."""
    return dataclasses.asdict(obj)


def test_profiles_are_the_same():
    assert set(JPROFS) == set(TPROFS)
    for m in MODELS:
        assert plain(JPROFS[m]) == plain(TPROFS[m])
    assert {m: plain(p) for m, p in jcore.PAPER_MODELS.items()} == {
        m: plain(p) for m, p in tcore.PAPER_MODELS.items()}


SCHEDULERS = {
    "elastic": (lambda: jcore.ElasticPartitioning(JPROFS),
                lambda: tcore.ElasticPartitioning(TPROFS)),
    "elastic+int": (lambda: jcore.ElasticPartitioning(JPROFS,
                                                      intf_model=JINTF),
                    lambda: tcore.ElasticPartitioning(TPROFS,
                                                      intf_model=TINTF)),
    "sbp": (lambda: jcore.SquishyBinPacking(JPROFS),
            lambda: tcore.SquishyBinPacking(TPROFS)),
    "self-tuning": (lambda: jcore.GuidedSelfTuning(JPROFS),
                    lambda: tcore.GuidedSelfTuning(TPROFS)),
    "self-tuning+int": (lambda: jcore.GuidedSelfTuning(JPROFS,
                                                       intf_model=JINTF),
                        lambda: tcore.GuidedSelfTuning(TPROFS,
                                                       intf_model=TINTF)),
}
PAPER_RATES = {"le": 300.0, "goo": 200.0, "res": 150.0, "ssd": 60.0,
               "vgg": 80.0}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_schedule_and_max_scale_identical_on_paper_models(name):
    mk_j, mk_t = SCHEDULERS[name]
    for scale in (0.5, 1.0, 2.0):
        rates = {m: r * scale for m, r in PAPER_RATES.items()}
        assert plain(mk_j().schedule(rates)) == plain(mk_t().schedule(rates))
    assert mk_j().max_scale(PAPER_RATES) == mk_t().max_scale(PAPER_RATES)


rate_strategy = st.dictionaries(
    st.sampled_from(MODELS), st.floats(min_value=0.0, max_value=800.0),
    min_size=1, max_size=5)


@given(rates=rate_strategy)
@settings(max_examples=25, deadline=None)
def test_elastic_identical_on_random_rates(rates):
    j = jcore.ElasticPartitioning(JPROFS, intf_model=JINTF).schedule(rates)
    t = tcore.ElasticPartitioning(TPROFS, intf_model=TINTF).schedule(rates)
    assert plain(j) == plain(t)


@given(rates=rate_strategy)
@settings(max_examples=15, deadline=None)
def test_sbp_identical_on_random_rates(rates):
    j = jcore.SquishyBinPacking(JPROFS).schedule(rates)
    t = tcore.SquishyBinPacking(TPROFS).schedule(rates)
    assert plain(j) == plain(t)


def test_latency_provider_quantities_identical():
    jp, tp = jlat.AnalyticGPULatency(JRTX), tlat.AnalyticGPULatency(TRTX)
    assert jp.partition_sizes == tp.partition_sizes
    assert jp.split_pairs == tp.split_pairs
    for m in MODELS:
        j, t = JPROFS[m], TPROFS[m]
        for p in jlat.PARTITION_SIZES:
            f = p / 100
            for b in (1, 2, 7, 16, 32):
                assert jp.latency_ms(j, b, f) == tp.latency_ms(t, b, f)
            assert jp.max_batch_under_slo(j, f, j.slo_ms) == \
                tp.max_batch_under_slo(t, f, t.slo_ms)
            assert jp.max_rate(j, f) == tp.max_rate(t, f)
        assert jp.rate_curve(j) == tp.rate_curve(t)
        assert jp.max_efficient_partition(j) == tp.max_efficient_partition(t)
        for rate in (10.0, 100.0, 1000.0):
            assert jp.min_required_partition(j, rate) == \
                tp.min_required_partition(t, rate)
        entries_j = [(j, 50.0), (JPROFS[MODELS[0]], 20.0)]
        entries_t = [(t, 50.0), (TPROFS[MODELS[0]], 20.0)]
        assert plain(jp.admit(entries_j, 0.5)) == plain(
            tp.admit(entries_t, 0.5))


@pytest.mark.parametrize("want", [20, 25, 40, 50, 55, 60, 80])
def test_gpulet_split_identical(want):
    jg, tg = jgpulet.fresh_cluster(1)[0], tgpulet.fresh_cluster(1)[0]
    ja, jb = jgpulet.split(jg, want)
    ta, tb = tgpulet.split(tg, want)
    assert (ja.size, jb.size) == (ta.size, tb.size)
    assert plain(jg) == plain(tg)
    assert plain(jgpulet.revert_split(jg)) == plain(tgpulet.revert_split(tg))


def test_enumerate_gpu_partitionings_identical():
    assert (jgpulet.enumerate_gpu_partitionings()
            == tgpulet.enumerate_gpu_partitionings())


def _engine_run(core, simulator, events, hardware, profs, intf):
    cluster = hardware.ClusterSpec(accelerator=hardware.RTX_2080TI,
                                   n_devices=2)
    sched = core.ElasticPartitioning(profs, cluster=cluster,
                                     intf_model=intf)
    rates = {"res": 150.0, "goo": 120.0, "le": 200.0}
    result = sched.schedule(rates)
    gen = simulator.PoissonArrivals(seed=7)
    horizon = 4_000.0
    reqs = events.merge_sorted([gen.constant(m, r, profs[m].slo_ms, horizon)
                                for m, r in rates.items()])
    eng = simulator.EventHeapEngine(
        profs, simulator.EngineConfig(horizon_ms=horizon,
                                      acc=hardware.RTX_2080TI),
        schedule=result)
    eng.submit(reqs)
    met = eng.run()
    per_request = [(r.model, r.arrival_ms, r.completion_ms, r.dropped,
                    r.unserved, r.status_code) for r in reqs]
    return met, per_request


def test_event_engine_run_identical():
    import repro.core.hardware as jhw
    import repro.simulator as jsim
    import repro.simulator.events as jev
    import repro_torch.core.hardware as thw
    import repro_torch.simulator as tsim
    import repro_torch.simulator.events as tev
    jm, jreq = _engine_run(jcore, jsim, jev, jhw, JPROFS, JINTF)
    tm, treq = _engine_run(tcore, tsim, tev, thw, TPROFS, TINTF)
    assert jm.total > 1000 and jm.completed + jm.dropped == jm.total
    for f in dataclasses.fields(jm):
        assert getattr(jm, f.name) == getattr(tm, f.name), f.name
    assert jreq == treq


def test_ideal_at_least_elastic():
    """``tests/test_schedulers.py::test_ideal_at_least_elastic`` through
    both packages: the same max scale of the exhaustive scheduler, at
    least elastic's."""
    from repro_torch.core.scenarios import REQUEST_SCENARIOS
    rates = REQUEST_SCENARIOS["equal"]
    lam_e = tcore.ElasticPartitioning(TPROFS, intf_model=TINTF).max_scale(
        rates)
    lam_i = tcore.IdealScheduler(TPROFS, intf_model=TINTF).max_scale(rates)
    assert lam_i >= lam_e * 0.99
    assert lam_i == jcore.IdealScheduler(JPROFS,
                                         intf_model=JINTF).max_scale(rates)
    half = {m: r * lam_i / 2 for m, r in rates.items()}
    assert plain(jcore.IdealScheduler(JPROFS, intf_model=JINTF).schedule(
        half)) == plain(tcore.IdealScheduler(TPROFS,
                                             intf_model=TINTF).schedule(half))


def test_enumerated_ideal_is_the_ideal_without_its_fallback():
    """``launch/serve.py``'s ``EnumeratedIdeal`` places a load exactly as
    ``IdealScheduler`` does where an enumerated partitioning admits it, and
    refuses one that only the ideal's fallback to Elastic Partitioning
    places."""
    from repro.core.scenarios import REQUEST_SCENARIOS
    from repro_torch.launch import serve
    rates = REQUEST_SCENARIOS["equal"]
    enum = serve.EnumeratedIdeal(TPROFS, intf_model=TINTF)
    ideal = tcore.IdealScheduler(TPROFS, intf_model=TINTF)
    lam = enum.max_scale(rates)
    assert 0 < lam <= ideal.max_scale(rates)
    at = {m: r * lam for m, r in rates.items()}
    got, want = plain(enum.schedule(at)), plain(ideal.schedule(at))
    assert got["schedulable"] and want["schedulable"]
    assert (got["gpus"], got["unplaced"]) == (want["gpus"], want["unplaced"])
    beyond = {m: r * lam * 1.5 for m, r in rates.items()}
    assert not enum.schedule(beyond).schedulable


def test_fluctuating_load_is_the_examples():
    """``launch/serve.py --fluctuate`` takes the base rates, seed and
    horizon of ``examples/fluctuating_rates.py``, and its load share is the
    example's base over what the example's scheduler (Elastic Partitioning
    with the fitted interference model, on the paper's cluster) admits,
    computed through the JAX package."""
    import ast
    from repro_torch.launch import serve
    example = PORT.parent.parent / "examples" / "fluctuating_rates.py"
    tree = ast.parse(example.read_text())
    base = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "base")
    kw = {k.arg: ast.literal_eval(k.value) for n in ast.walk(tree)
          if isinstance(n, ast.Call) for k in n.keywords
          if k.arg in ("seed", "horizon_s")}
    assert base == serve.EXAMPLE_BASE
    assert kw == {"seed": serve.EXAMPLE_SEED,
                  "horizon_s": serve.FLUCT_HORIZON_S}
    lam = jcore.ElasticPartitioning(JPROFS, intf_model=JINTF).max_scale(
        base, 0.0, serve.SEARCH_HI)
    assert serve.EXAMPLE_SHARE == 1.0 / lam


# the behaviours of tests/test_controller.py, each through both packages


def test_ewma_identical():
    import repro.serving as jserving
    import repro_torch.serving as tserving
    out = []
    for serving in (jserving, tserving):
        t = serving.EWMARateTracker(alpha=0.5)
        out.append([t.update({"a": 100.0}), t.update({"a": 200.0}),
                     t.rates])
    assert out[0] == out[1] and out[1][-1]["a"] == 150.0


def test_ewma_decays_absent_models_to_zero_identical():
    import repro.serving as jserving
    import repro_torch.serving as tserving
    out = []
    for serving in (jserving, tserving):
        t = serving.EWMARateTracker(alpha=0.5)
        out.append([t.update({"a": 100.0, "b": 64.0}),
                    t.update({"a": 100.0})]
                   + [t.update({"a": 100.0}) for _ in range(40)])
    assert out[0] == out[1]
    assert out[1][1]["b"] == 32.0
    assert "b" not in out[1][-1] and out[1][-1]["a"] == 100.0


def _controller(core, serving, profs, intf, seed=0):
    return serving.ServingController(
        core.ElasticPartitioning(profs, intf_model=intf), profs, seed=seed)


def test_reschedule_stores_provisioned_target_identical():
    import repro.serving as jserving
    import repro_torch.serving as tserving
    out = []
    for core, serving, profs, intf in ((jcore, jserving, JPROFS, JINTF),
                                       (tcore, tserving, TPROFS, TINTF)):
        ctrl = _controller(core, serving, profs, intf)
        res = ctrl._reschedule({"res": 100.0}, {"res": 100.0})
        out.append((plain(res), dict(ctrl.scheduled_rates),
                    ctrl._needs_reschedule({"res": 112.0}),
                    ctrl._needs_reschedule({"res": 130.0})))
    assert out[0] == out[1]
    _, rates, at_112, at_130 = out[1]
    assert rates["res"] >= 100.0 * 1.05 - 1e-9
    assert not at_112 and at_130


def _records(recs):
    return [(r.t_start_s, r.ewma_rates, r.observed_rates, r.rescheduled,
             r.used_partition_total, dataclasses.asdict(r.metrics))
            for r in recs]


def test_period_records_align_with_engine_windows_identical():
    import repro.serving as jserving
    import repro_torch.serving as tserving
    out = []
    for core, serving, profs, intf in ((jcore, jserving, JPROFS, JINTF),
                                       (tcore, tserving, TPROFS, TINTF)):
        ctrl = _controller(core, serving, profs, intf, seed=7)
        recs = ctrl.run({"res": lambda t: 100.0}, horizon_s=50.0)
        out.append((_records(recs), ctrl.engine.window_obs))
    assert out[0] == out[1]
    recs, obs = out[1]
    assert len(recs) == len(obs) == 3 and recs[-1][0] == 40.0
    assert all(r[2].get("res", 0.0) > 0.0 for r in recs)


def test_controller_adapts_partitions_identical():
    import math

    import repro.serving as jserving
    import repro_torch.serving as tserving

    def wave(t):
        return 120.0 + 500.0 * math.exp(-((t - 150) / 60) ** 2)

    out = []
    for core, serving, profs, intf in ((jcore, jserving, JPROFS, JINTF),
                                       (tcore, tserving, TPROFS, TINTF)):
        ctrl = _controller(core, serving, profs, intf, seed=3)
        out.append(_records(ctrl.run({"res": wave, "goo": lambda t: 80.0},
                                     horizon_s=300)))
    assert out[0] == out[1]
    recs = out[1]
    used = [r[4] for r in recs]
    assert len(recs) == 15 and max(used) > used[0]
    tot = sum(r[5]["total"] for r in recs)
    assert sum(r[5]["slo_violations"] for r in recs) / tot < 0.03
    assert any(r[3] for r in recs[1:])


#: modules copied byte for byte apart from their imports
COPIES = ("core/profiles.py", "core/latency.py", "core/gpulet.py",
          "core/interference.py", "core/scheduler_base.py", "core/elastic.py",
          "core/sbp.py", "core/selftuning.py", "core/ideal.py",
          "simulator/events.py", "simulator/metrics.py",
          "serving/controller.py", "data/pipeline.py", "data/__init__.py",
          "simulator/engine.py", "simulator/trace.py", "obs/spans.py",
          "obs/timeline.py", "core/hardware.py",
          # the fleet layer
          "core/scenarios.py", "faults/plan.py", "faults/health.py",
          "faults/retry.py", "faults/brownout.py", "faults/__init__.py",
          "obs/attribution.py", "obs/sampler.py", "obs/export.py",
          "obs/validate.py", "obs/__init__.py", "fabric/network.py",
          "fabric/priority.py", "fabric/node.py", "fabric/router.py",
          "fabric/global_scheduler.py", "fabric/autoscaler.py",
          "fabric/fabric.py", "fabric/workload.py", "fabric/__init__.py",
          "simulator/cluster.py", "simulator/__init__.py")
_IMPORT = re.compile(r"^(\s*)(from|import) repro\b", re.M)


@pytest.mark.parametrize("path", COPIES)
def test_copies_are_identical_apart_from_imports(path):
    original = (PORT.parent / "repro" / path).read_text()
    assert (PORT / path).read_text() == _IMPORT.sub(
        r"\1\2 repro_torch", original)


def test_cluster_spec_names_match():
    assert JCluster(JRTX, 4).name == TCluster(TRTX, 4).name


_FORBIDDEN = re.compile(r"^\s*(import jax\b|from jax\b|import repro\b"
                        r"|from repro\b(?!_torch)|import repro\.|"
                        r"from repro\.)", re.M)


def test_port_imports_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [PORT.parent.parent
                                          / "chip_smoke.py"]
    assert len(files) > 30
    offending = [f"{f}: {m.group(0).strip()}" for f in files
                 for m in _FORBIDDEN.finditer(f.read_text())]
    assert not offending, offending
