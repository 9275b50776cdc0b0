"""Interference on the H100 (``repro_torch.core.h100intf``,
``repro_torch.simulator.h100engine``, ``launch/serve.py --corun``) on the
CPU.

Tables in the port's file format are made here from the JAX package's
analytic ground truth and features (``repro.core.interference``) over its
paper profiles, so that the measured-table code can be held against the
JAX predictor and engine: the fit gives the JAX coefficients, and the
engine the JAX metrics.  The committed tables measured on the card are
checked for completeness and replayed.
"""
import dataclasses
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
from repro.core import interference as jintf  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import h100intf  # noqa: E402
from repro_torch.core.h100intf import (CorunTable, FeatureTable,  # noqa: E402
                                       MeasuredInterferenceModel,
                                       fit_measured, load_corun,
                                       load_features, step_bytes)
from repro_torch.core.h100lets import CARVES, granted_sms, load_catalog  # noqa: E402
from repro_torch.core.interference import InterferenceModel  # noqa: E402
from repro_torch.core.latency import PARTITION_SIZES, SPLIT_PAIRS  # noqa: E402
from repro_torch.launch import profile_interference as pi  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.simulator.engine import EngineConfig  # noqa: E402
from repro_torch.simulator.h100engine import MeasuredInterferenceEngine  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RESULTS = ROOT / "results"
LBP, CORUN, FEATURES = (RESULTS / f"h100_{n}.jsonl"
                        for n in ("lbp", "corun", "features"))
MIX = ("yi-9b=1,chatglm3-6b=1,mamba2-780m=4,deepseek-moe-16b=1,"
       "recurrentgemma-2b=2")
ARCHS = ("yi-9b", "chatglm3-6b", "mamba2-780m", "deepseek-moe-16b",
         "recurrentgemma-2b")
JPROFS = jcore.calibrate_profiles()
TPROFS = tcore.calibrate_profiles()
CARD = {"card": "JAX reference (analytic 2080 Ti)", "power_limit_w": None}


def _corun_records(names, batches, perspective=False):
    """A co-run table from the JAX ground truth.  With ``perspective``
    each side's factor is the ground truth called from that side, as the
    JAX engine calls it; otherwise the pair's two factors of one call."""
    recs = []
    for carve in CARVES:
        pl, pr = carve, 100 - carve
        for a in names:
            for b in names:
                for ba in batches:
                    for bb in batches:
                        fa, fb = jintf.true_interference_factors(
                            JPROFS[a], pl / 100, ba, JPROFS[b], pr / 100, bb)
                        if perspective:
                            fb, _ = jintf.true_interference_factors(
                                JPROFS[b], pr / 100, bb, JPROFS[a], pl / 100,
                                ba)
                        recs.append(dict(
                            CARD, carve=carve, arch=[a, b], percent=[pl, pr],
                            sms=[None, None], batch=[ba, bb],
                            solo_ms=[1.0, 1.0], corun_ms=[fa, fb],
                            factor=[fa, fb]))
    return recs


def _feature_records(names, batches=(1, 8, 16, 32)):
    return [dict(CARD, arch=a, percent=p, sms=None, batch=b,
                 l2=jintf.solo_features(JPROFS[a], p / 100, b)[0],
                 dram_share=jintf.solo_features(JPROFS[a], p / 100, b)[1])
            for a in names for p in PARTITION_SIZES for b in batches]


def _write(tmp_path, name, records):
    path = tmp_path / name
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    return str(path)


# ------------------------------------------------------ fit and engine ----


def test_fit_measured_matches_the_jax_fit_on_the_same_split(tmp_path):
    names = sorted(JPROFS)
    corun = load_corun(_write(tmp_path, "corun.jsonl",
                              _corun_records(names, (1, 8, 32))))
    feats = load_features(_write(tmp_path, "features.jsonl",
                                 _feature_records(names)))
    model, stats = fit_measured(corun, feats)
    # the JAX side: the same samples, from the JAX functions, in the same
    # order (two a co-run), split and fitted as fit_default_model does
    x, y = [], []
    for r in corun.records:
        (a, b), (ba, bb), (pa, pb) = r["arch"], r["batch"], r["percent"]
        l2a, mema = jintf.solo_features(JPROFS[a], pa / 100, ba)
        l2b, memb = jintf.solo_features(JPROFS[b], pb / 100, bb)
        fa, fb = jintf.true_interference_factors(JPROFS[a], pa / 100, ba,
                                                 JPROFS[b], pb / 100, bb)
        x += [[l2a, l2b, mema, memb], [l2b, l2a, memb, mema]]
        y += [fa, fb]
    x, y = np.asarray(x), np.asarray(y)
    idx = np.random.default_rng(0).permutation(len(x))
    n_train = int(len(x) * 0.7)
    jm = jintf.InterferenceModel()
    rms = jm.fit(x[idx[:n_train]], y[idx[:n_train]])
    np.testing.assert_allclose(model.coef, jm.coef, rtol=1e-9)
    assert stats["rms_train"] == pytest.approx(rms, rel=1e-9)
    assert (stats["n_train"], stats["n_val"]) == (n_train, len(x) - n_train)
    va = idx[n_train:]
    rel = np.abs([jm.predict(*f) for f in x[va]] - y[va]) / y[va]
    assert stats["p90_rel_err"] == pytest.approx(np.percentile(rel, 90),
                                                 rel=1e-9)
    # the predictor reads the features at FEATURE_BATCH, as the JAX one
    # computes them there
    for a, b, pa in (("res", "vgg", 20), ("le", "le", 50), ("ssd", "goo", 60)):
        assert model.predict_pair(TPROFS[a], pa / 100, TPROFS[b],
                                  1 - pa / 100) == pytest.approx(
            jm.predict_pair(JPROFS[a], pa / 100, JPROFS[b], 1 - pa / 100),
            rel=1e-9)


def test_measured_model_overrides_only_predict_pair():
    for name in ("fit", "predict"):
        assert getattr(MeasuredInterferenceModel, name) is getattr(
            InterferenceModel, name)
    assert (MeasuredInterferenceModel.predict_pair
            is not InterferenceModel.predict_pair)
    assert issubclass(MeasuredInterferenceModel, InterferenceModel)


def _engine_metrics(core, sim, profs, intf, make_engine):
    cluster = core.ClusterSpec(accelerator=core.RTX_2080TI, n_devices=2)
    rates = {"res": 150.0, "goo": 120.0, "le": 200.0}
    result = core.ElasticPartitioning(profs, cluster=cluster,
                                      intf_model=intf).schedule(rates)
    horizon = 4_000.0
    gen = sim.PoissonArrivals(seed=7)
    from itertools import chain
    reqs = sorted(chain.from_iterable(
        gen.constant(m, r, profs[m].slo_ms, horizon)
        for m, r in rates.items()), key=lambda r: r.arrival_ms)
    eng = make_engine(profs, sim.EngineConfig(horizon_ms=horizon,
                                              acc=core.RTX_2080TI), result)
    eng.submit(reqs)
    met = eng.run()
    return met, [(r.model, r.arrival_ms, r.completion_ms, r.dropped)
                 for r in reqs], eng


def test_measured_engine_matches_the_jax_engine(tmp_path):
    """Fed the JAX ground truth at every batch 1-32 on every partition
    size, the measured engine replays exactly as the JAX engine with
    interference on (one paper scenario, one seed)."""
    import repro.simulator as jsim
    import repro_torch.simulator as tsim
    names = ("goo", "le", "res")
    corun = load_corun(_write(tmp_path, "corun.jsonl", _corun_records(
        names, tuple(range(1, 33)), perspective=True)))
    jintf_model, _ = jcore.fit_default_model(JPROFS)
    tintf_model, _ = tcore.fit_default_model(TPROFS)
    jm, jreq, _ = _engine_metrics(
        jcore, jsim, JPROFS, jintf_model,
        lambda p, cfg, res: jsim.EventHeapEngine(p, cfg, schedule=res))
    tm, treq, teng = _engine_metrics(
        tcore, tsim, TPROFS, tintf_model,
        lambda p, cfg, res: MeasuredInterferenceEngine(p, cfg, schedule=res,
                                                       corun=corun))
    assert jm.total > 1000 and jm.completed + jm.dropped == jm.total
    for f in dataclasses.fields(jm):
        assert getattr(jm, f.name) == getattr(tm, f.name), f.name
    assert jreq == treq
    # the scenario co-locates gpu-lets: the table's factors were applied
    assert sum(f > 1.0 for f in teng._measured.values()) > 10


def test_measured_engine_never_calls_the_synthetic_ground_truth(
        tmp_path, monkeypatch):
    import repro_torch.simulator.engine as teng

    def boom(*args, **kw):
        raise AssertionError("the 2080 Ti ground truth was called")

    monkeypatch.setattr(teng, "true_interference_factors", boom)
    test_measured_engine_matches_the_jax_engine(tmp_path)


# ------------------------------------------------------------ refusals ----


@pytest.mark.parametrize("what", ["two cards", "twice", "missing"])
def test_load_corun_refuses(tmp_path, what):
    recs = _corun_records(("le", "res"), (1, 8))
    if what == "two cards":
        recs[3] = dict(recs[3], power_limit_w=500.0)
    elif what == "twice":
        recs.append(recs[5])
    else:
        del recs[9]
    with pytest.raises(ValueError, match={"two cards": "2 cards",
                                          "twice": "twice",
                                          "missing": "missing"}[what]):
        load_corun(_write(tmp_path, "c.jsonl", recs))


@pytest.mark.parametrize("what", ["two cards", "twice", "missing",
                                  "no feature batch"])
def test_load_features_refuses(tmp_path, what):
    recs = _feature_records(("le", "res"))
    if what == "two cards":
        recs[0] = dict(recs[0], card="NVIDIA H100 PCIe")
    elif what == "twice":
        recs.append(recs[2])
    elif what == "missing":
        del recs[7]
    else:
        recs = _feature_records(("le", "res"), (1, 8, 32))
    with pytest.raises(ValueError, match={"two cards": "2 cards",
                                          "twice": "twice",
                                          "missing": "missing",
                                          "no feature batch": "batch 16"}[
                                              what]):
        load_features(_write(tmp_path, "f.jsonl", recs))


def test_lookups_take_the_next_measured_batch_and_raise_above(tmp_path):
    corun = CorunTable(_corun_records(("le", "res"), (1, 8, 32)))
    feats = FeatureTable(_feature_records(("le", "res")))
    cell = corun.cells[40, "le", 8, "res", 32]
    assert corun.factor("le", 40, 5, "res", 17) == cell["factor"][0]
    # the right side of the same carve, named 60, reads index 1
    assert corun.factor("res", 60, 32, "le", 8, position=1) == \
        cell["factor"][1]
    assert corun.factor("res", 60, 32, "le", 8, position=0) == \
        cell["factor"][1]
    # 50/50: the card's second gpu-let is the carve's right side
    c50 = corun.cells[50, "res", 1, "le", 8]
    assert corun.factor("le", 50, 8, "res", 1, position=1) == \
        c50["factor"][1]
    assert feats.at("le", 40, 9) == feats.at("le", 40, 16)
    for bad in (33, 0):
        with pytest.raises(ValueError, match="outside the measured"):
            corun.factor("le", 40, bad, "res", 1)
        with pytest.raises(ValueError, match="outside the measured"):
            corun.factor("le", 40, 1, "res", bad)
        with pytest.raises(ValueError, match="outside the measured"):
            feats.at("le", 40, bad)


def test_engine_refuses_interference_without_a_table():
    with pytest.raises(ValueError, match="co-run table"):
        MeasuredInterferenceEngine(TPROFS, EngineConfig())
    MeasuredInterferenceEngine(TPROFS, EngineConfig(interference=False))


def _main(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = serve.main(argv)
    return rc, out.getvalue().splitlines()


def test_serve_refuses_interference_on_a_card_catalog_without_corun():
    with pytest.raises(SystemExit, match="--corun"):
        _main(["--results", str(LBP), "--rates", MIX, "--replay"])
    with pytest.raises(SystemExit, match="go together"):
        _main(["--results", str(LBP), "--rates", MIX, "--corun",
               str(CORUN)])
    with pytest.raises(SystemExit, match="go together"):
        _main(["--results", str(LBP), "--rates", MIX, "--corun",
               str(CORUN), "--features", str(FEATURES),
               "--no-interference"])


# --------------------------------------------------------------- bytes ----


PORTED = ("yi-9b", "chatglm3-6b", "mamba2-780m", "recurrentgemma-2b",
          "stablelm-12b", "command-r-35b", "deepseek-moe-16b", "arctic-480b",
          "internvl2-76b")


@pytest.mark.parametrize("arch", PORTED)
def test_step_bytes_match_the_model(arch):
    """The reckoned bytes against each config's model, built on the meta
    device: its parameters, and the cache tensors a decode step reads and
    writes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch)
    model = Model(cfg, device="meta")
    params = list(model.parameters())
    assert h100intf.param_count(cfg) == (
        sum(p.numel() for p in params if p.dtype == torch.bfloat16),
        sum(p.numel() for p in params if p.dtype == torch.float32))
    ctx, slots = 1024, 1032
    got = step_bytes(cfg, 4, ctx)
    tok = model.embed.tok
    assert got["weights"] == sum(p.numel() * p.element_size()
                                 for p in params) - tok.numel() * 2
    per_req = tok.shape[1] * tok.element_size()
    cache = model.init_cache(1, slots)
    for kind, layer in zip(cfg.layer_types(), cache["layers"]):
        nbytes = {k: t.numel() * t.element_size() for k, t in layer.items()}
        if "k" in layer:
            size = layer["k"].shape[1]
            slot = (nbytes["k"] + nbytes["v"]) // size
            per_req += slot * (min(ctx + 1, size) + 1)
        else:
            per_req += 2 * sum(nbytes.values())
    assert got["per_request"] == per_req
    assert got["total"] == got["weights"] + 4 * per_req


def test_features_from_grid_are_bytes_over_time():
    rec = {"card": "c", "power_limit_w": 1.0, "arch": "a", "percent": 40,
           "sms": 56, "carve": 40, "side": "left", "batch": 8,
           "step_ms": 10.0, "weight_bytes": 3.0e9, "bytes_per_req": 1.0e8}
    out, = pi.features_from_grid([rec, dict(rec, batch=2)], (8,),
                                 l2_reason="why")
    assert out["bytes"] == 3.8e9
    assert out["dram_share"] == pytest.approx(3.8e9 / 1e-2 / 3.35e12)
    assert out["l2"] is None and out["l2_reason"] == "why"


def test_profile_interference_summary(tmp_path):
    names = ("le", "res")
    corun = CorunTable(_corun_records(names, (1, 8, 32)))
    out = pi.summary(corun, FeatureTable(_feature_records(names)))
    factors = [f for r in corun.records for f in r["factor"]]
    assert out["sides"] == len(factors) == 2 * 3 * 4 * 9
    assert out["worst"]["factor"] == max(factors)
    assert out["share_under_1.18"] == pytest.approx(
        np.mean(np.asarray(factors) < 1.18))
    assert out["median"] == pytest.approx(np.median(factors))
    assert out["p10"] <= out["median"] <= out["p90"] <= max(factors)
    assert out["median_by_arch_batch"]["le b8"] == pytest.approx(np.median(
        [f for r in corun.records for i, f in enumerate(r["factor"])
         if (r["arch"][i], r["batch"][i]) == ("le", 8)]))
    assert set(out["fit"]) == {"rms_train", "n_train", "n_val",
                               "p90_rel_err", "p95_rel_err", "mean_rel_err"}


def test_corun_grid_holds_at_most_the_two_models_of_a_pair(monkeypatch):
    """The co-run grid's loop on the CPU, with the card's steps stubbed:
    every ordered pair of archs on every carve at every pair of batches,
    one record each, and never more than two models alive (the five of
    the mix do not fit one card beside their graphs)."""
    import gc
    import weakref

    import repro_torch.launch.partition as part_mod
    from repro_torch.launch import profile_partitions as pp

    alive, most = weakref.WeakSet(), [0]

    class Built:
        def __init__(self, arch):
            self.arch = arch

    class Graph:
        def reset(self):
            pass

    def build(arch, *, device, seed):
        gc.collect()
        model = Built(arch)
        alive.add(model)
        most[0] = max(most[0], len(alive))
        return model

    def split(carve):
        return [pp._WholeCPU(carve), pp._WholeCPU(100 - carve)]

    monkeypatch.setattr(pp, "build", build)
    monkeypatch.setattr(pp, "captured",
                        lambda model, b, part, seed: (Graph(), None, None))
    monkeypatch.setattr(pp, "corun", lambda *a: {
        "solo_ms": [1.0, 2.0], "corun_ms": [1.5, 2.5], "factor": [1.5, 1.25],
        "launch_ms": 0.1, "span_ms": [3.0, 3.0]})
    monkeypatch.setattr(part_mod, "split", split)
    monkeypatch.setattr(pi.torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(pi.torch.cuda, "memory_allocated", lambda: 0)
    monkeypatch.setattr(pi.torch.cuda, "max_memory_allocated", lambda: 0)
    archs = ("a", "b", "c")
    recs = pi.corun_grid(archs, (20, 40), (1, 8), seed=0,
                         ident=("card", 700.0), log=lambda line: None)
    assert len(recs) == 9 * 2 * 4
    assert {(r["carve"], *r["arch"], *r["batch"]) for r in recs} == {
        (c, a, b, x, y) for c in (20, 40) for a in archs for b in archs
        for x in (1, 8) for y in (1, 8)}
    assert most[0] == 2


# ------------------------------------------------- the committed files ----


def test_committed_lbp_prices_no_side_from_more_sms_than_it_gets():
    recs = [json.loads(line) for line in LBP.read_text().splitlines()]
    split_sms = {int(c): tuple(v) for c, v in recs[0]["split_sms"].items()}
    assert set(split_sms) == set(CARVES)
    priced = {r["percent"]: r["sms"] for r in recs}
    for pair in SPLIT_PAIRS:
        for position, percent in enumerate(pair):
            assert priced[percent] <= granted_sms(split_sms, percent,
                                                  position), (pair, percent)
    load_catalog(str(LBP))


def test_committed_corun_and_features_are_complete_and_one_cards():
    corun, feats = load_corun(str(CORUN)), load_features(str(FEATURES))
    assert len(corun.records) == 25 * 3 * 9 == 675
    assert corun.archs == feats.archs == sorted(ARCHS)
    assert corun.batches == (1, 8, 32)
    assert feats.batches == (1, 8, 16, 32)
    _, provider = load_catalog(str(LBP))
    assert corun.card == feats.card == provider.card
    assert "H100" in corun.card
    for r in corun.records:
        assert r["sms"] == [granted_sms(provider.split_sms, p, i)
                            for i, p in enumerate(r["percent"])]
        assert all(t > 0 for t in r["solo_ms"] + r["corun_ms"])
    # measured features tell the archs apart (C.4: the 2080 Ti features
    # of the placeholder profiles were the same for every arch)
    dram = {a: feats.at(a, 40, 16)[1] for a in ARCHS}
    assert len(set(dram.values())) == len(ARCHS)
    assert all(0 < d < 1 for d in dram.values())


def test_serve_replays_the_committed_tables(monkeypatch):
    """The paper's comparison from the committed tables, on the CPU, on
    the JAX package's mix (the default): the fit, five max scales and the
    ideal's enumeration alone, both replays and the controller under
    fluctuating rates at the example's share and seed conserving their
    requests; no path reaches the analytic 2080 Ti ground truth or
    features."""
    import repro_torch.core.interference as tint
    import repro_torch.simulator.engine as teng

    def boom(*args, **kw):
        raise AssertionError("an analytic 2080 Ti function was called")

    for mod in (tint, teng):
        monkeypatch.setattr(mod, "true_interference_factors", boom,
                            raising=False)
    monkeypatch.setattr(tint, "solo_features", boom)
    rc, lines = _main(["--results", str(LBP), "--corun", str(CORUN),
                       "--features", str(FEATURES), "--gpus", "4",
                       "--max-scale", "--replay", "--horizon-s", "5",
                       "--fluctuate"])
    assert rc == 0
    assert any(line.startswith("interference predictor (Fig. 9)")
               for line in lines)
    assert any(line.startswith("  deepseek-moe-16b ") for line in lines)
    out = json.loads(lines[-1])
    for key in ("elastic_max_scale", "selftuning_max_scale",
                "ideal_max_scale", "ideal_enumerated_max_scale"):
        assert out[key] > 0
    # whole cards: four cards hold the five models only by time-sharing
    # one, which their SLOs all but forbid; five cards give each its own
    assert out["sbp_max_scale"] >= 0
    profiles, provider = load_catalog(str(LBP))
    mix = serve.parse_rates(MIX)
    assert tcore.SquishyBinPacking(
        {m: profiles[m] for m in mix}, cluster=serve.cluster_of(5),
        lat=provider).max_scale(mix, 0.0, serve.SEARCH_HI) > 0
    # the controller on the measured co-run factors, then with interference
    # off: the same offered requests, each run conserving them
    for key, label in (("fluctuate", "measured"), ("fluctuate_off", "off")):
        fl = out[key]
        assert fl["conserved"] and fl["total"] > 0
        assert fl["completed"] + fl["dropped"] == fl["total"]
        assert fl["interference"] == label and fl["reschedules"] > 0
        assert fl["planner"] == "gpulet"
        assert (fl["seed"], fl["example_share"]) == (serve.EXAMPLE_SEED,
                                                     serve.EXAMPLE_SHARE)
        assert fl["scale"] == out["elastic_max_scale"] * fl["example_share"]
        assert sum(v["total"] for v in fl["per_model"].values()) \
            == fl["total"] == out["fluctuate"]["total"]
    assert out["fluctuate"]["violation_rate"] \
        > out["fluctuate_off"]["violation_rate"]
    # with the measured factors, gpulet+int may admit less, down to none
    assert 0 <= out["gpulet_int_max_scale"] <= out["elastic_max_scale"]
    assert set(out["replays"]) == {"gpulet", "gpulet+int"}
    assert out["replays"]["gpulet"]["total"] > 0
    for name, rep in out["replays"].items():
        assert rep["conserved"]
        assert rep["completed"] + rep["dropped"] == rep["total"]
        assert rep["scale"] == pytest.approx(0.999 * out[
            "elastic_max_scale" if name == "gpulet"
            else "gpulet_int_max_scale"])
        assert 0 <= rep["violation_rate"] <= 1
