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


#: modules copied byte for byte apart from their imports
COPIES = ("core/profiles.py", "core/latency.py", "core/gpulet.py",
          "core/interference.py", "core/scheduler_base.py", "core/elastic.py",
          "core/sbp.py", "core/selftuning.py", "simulator/events.py",
          "simulator/metrics.py")
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
