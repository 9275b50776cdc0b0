"""The port's SLO forensics (``obs/attribution.py``, ``sampler.py``,
``export.py``, ``validate.py``) against the JAX package's, on fleet runs
served through both packages (``torch_fleet_cases.py``): the miss
attribution sums to each overshoot and is the JAX package's report, and
``dump_run`` writes the JAX package's files byte for byte, which
``validate_dir`` passes."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import torch_fleet_cases as C  # noqa: E402


def _traced(S, case, event_log: bool = True):
    """``case`` on side ``S`` with a timeline attached and the nodes'
    span records on: (FabricMetrics, trace, fabric)."""
    fabric, trace = case(S)
    if event_log:
        for node in fabric.nodes:
            node.cfg = dataclasses.replace(node.cfg, event_log=True)
    S.obs.attach_timeline(trace)
    fm = fabric.serve_trace(trace)
    return fm, trace, fabric


OBS_CASES = {"migrations": C.migrations, "failure-drain": C.failure_drain,
             "sweep-2n": C.sweep(2)}


@pytest.mark.parametrize("name", sorted(OBS_CASES))
def test_attribution_sums_to_each_overshoot(name):
    """Every missed request's five components (queueing, interference,
    preemption, migration, network) sum to its overshoot, and the report
    is the JAX package's."""
    runs = [_traced(S, OBS_CASES[name]) for S in C.SIDES]
    C.assert_same_run(runs[0][:2], runs[1][:2])
    fm, trace, _ = runs[1]
    arrs = C.PORT.obs.attribution_arrays(trace)
    miss = arrs["miss"]
    assert miss.any(), f"{name} must miss some SLOs"
    total = sum(arrs[k] for k in C.PORT.obs.COMPONENTS)
    assert np.abs(total[miss] - arrs["overshoot_ms"][miss]).max() < 1e-6
    reports = [S.obs.collect_attribution(r[1])
               for S, r in zip(C.SIDES, runs)]
    assert C.plain(reports[0]) == C.plain(reports[1])
    report = reports[1]
    assert report["lifecycle"]["closed"] == report["lifecycle"]["terminal"]
    assert report["identity_max_abs_err_ms"] < 1e-6
    assert set(report["per_model"]) == set(trace.models)


def test_tracing_attached_is_inert():
    """The port's run with a timeline attached is the run without one."""
    plain = C.serve(C.PORT, C.migrations)[:2]
    traced = _traced(C.PORT, C.migrations, event_log=False)[:2]
    fm_a, trace_a = plain
    fm_b, trace_b = traced
    assert C.plain(fm_a) == C.plain(fm_b)
    for col in ("status", "completion_ms", "arrival_ms"):
        np.testing.assert_array_equal(getattr(trace_a, col),
                                      getattr(trace_b, col))


def test_dump_run_is_the_jax_packages_and_validates(tmp_path):
    """``dump_run`` of the same migrating fleet run through both packages:
    the Perfetto trace, the time series and the attribution report are
    byte-equal, and both packages' ``validate_dir`` pass them."""
    dirs = []
    for S in C.SIDES:
        fm, trace, fabric = _traced(S, C.migrations)
        assert fm.migrations > 0 and all(n.span_log for n in fabric.nodes)
        out = tmp_path / S.name
        paths = S.obs.dump_run(str(out), "drift", trace, fabric.nodes,
                               fabric.cfg.horizon_ms,
                               migration_events=fm.migration_events)
        assert sorted(paths) == ["attribution", "timeseries", "trace"]
        dirs.append(out)
    names = sorted(p.name for p in dirs[0].iterdir())
    assert names == sorted(p.name for p in dirs[1].iterdir())
    assert len(names) == 3
    for name in names:
        assert (dirs[0] / name).read_bytes() == (dirs[1] / name).read_bytes()
    for S in C.SIDES:
        for d in dirs:
            assert S.obs.validate_dir(str(d)) == []


def test_validate_dir_flags_a_broken_artifact(tmp_path):
    """The port's schema gate is not vacuous: a time series with a
    missing key fails it."""
    fm, trace, fabric = _traced(C.PORT, C.sweep(2, horizon_s=1.0))
    C.PORT.obs.dump_run(str(tmp_path), "x", trace, fabric.nodes,
                        fabric.cfg.horizon_ms)
    assert C.PORT.obs.validate_dir(str(tmp_path)) == []
    ts = tmp_path / "x.timeseries.jsonl"
    ts.write_text(ts.read_text().replace('"queue_depth"', '"queue"', 1))
    assert C.PORT.obs.validate_dir(str(tmp_path))
