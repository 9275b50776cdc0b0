"""The port's gpu-lets on the CPU: the measured L(b, p) catalog, the
serving plan and its replay, the decode kernel's split plan on a partition,
and the records that ``profile_partitions`` writes.

The measurements themselves need the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``); here a small results file written by the
test stands in for one, and ``profile_partitions`` runs at the smoke size
with every partition stubbed to the whole CPU.
"""
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.core.h100lets import (CARVES, LBP_BATCHES,  # noqa: E402
                                       SYNTHETIC_TABLE, MeasuredLatency,
                                       carve_of, granted_sms, load_catalog,
                                       synthetic_catalog)
from repro_torch.core.latency import PARTITION_SIZES, SPLIT_PAIRS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.launch import partition as tpart  # noqa: E402
from repro_torch.launch import profile_partitions as pp  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "results" / "h100_lbp.jsonl"
MIX = ("yi-9b=1,chatglm3-6b=1,mamba2-780m=4,deepseek-moe-16b=1,"
       "recurrentgemma-2b=2")
# each percent on the side of the carve it names: 60 is the right side of
# the 40/60 carve, 80 of the 20/80 one, 50 the left (smaller) side
SMS = {20: 24, 40: 56, 50: 64, 60: 76, 80: 108, 100: 132}
SPLIT_SMS = {"20": [24, 108], "40": [56, 76], "50": [64, 68]}
CARVE = {20: (20, "left"), 40: (40, "left"), 50: (50, "left"),
         60: (40, "right"), 80: (20, "right"), 100: (100, "whole")}


def _step(arch, percent, batch):
    """A made-up table with a knee: the dense arch stops gaining past 60%."""
    base = {"a": 8.0, "b": 2.0}[arch]
    return round(base * 60 / min(percent, 60) + 0.01 * batch, 6)


def _records(archs=("a", "b"), batches=(1, 8, 32), card="NVIDIA H100 80GB "
             "HBM3", power=700.0, sms=SMS):
    return [{"card": card, "power_limit_w": power, "arch": a, "percent": p,
             "sms": sms[p], "carve": CARVE[p][0], "side": CARVE[p][1],
             "split_sms": SPLIT_SMS, "batch": b, "ctx": 1024,
             "weight_bytes": {"a": 9_000_000_000, "b": 1_000_000_000}[a],
             "bytes_per_req": {"a": 50_000_000, "b": 70_000_000}[a],
             "step_ms": _step(a, p, b), "runs": 10,
             "eager_wall_ms": 50.0} for a in archs
            for p in PARTITION_SIZES for b in batches]


def _write(tmp_path, records, name="lbp.jsonl"):
    path = tmp_path / name
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    return str(path)


def test_measured_catalog_lookups_and_slo(tmp_path):
    profiles, provider = load_catalog(_write(tmp_path, _records()))
    assert isinstance(provider, MeasuredLatency)
    assert provider.partition_sizes == PARTITION_SIZES
    assert provider.split_pairs == SPLIT_PAIRS
    assert provider.batch_sizes == (1, 8, 32) and provider.max_batch == 32
    assert provider.sms == SMS
    assert provider.split_sms == {20: (24, 108), 40: (56, 76), 50: (64, 68)}
    assert provider.card == "NVIDIA H100 80GB HBM3, 700.0 W"
    a = profiles["a"]
    # the step's bytes from the file, no placeholders
    assert (a.weight_mb, a.act_mb_per_req) == (9000.0, 50.0)
    assert (profiles["b"].weight_mb, profiles["b"].act_mb_per_req) == (
        1000.0, 70.0)
    assert provider.latency_ms(a, 8, 0.5) == _step("a", 50, 8)
    # a batch between measured sizes runs as the next one up
    assert provider.latency_ms(a, 5, 0.2) == _step("a", 20, 8)
    assert provider.latency_ms(a, 0, 1.0) == 0.0
    # the table as measured: no smoothing, the flat part stays flat
    assert provider.latency_ms(a, 32, 0.8) == provider.latency_ms(a, 32, 1.0)
    with pytest.raises(ValueError):
        provider.latency_ms(a, 33, 1.0)
    with pytest.raises(KeyError):
        provider.latency_ms(a, 8, 0.3)
    for name, prof in profiles.items():
        # paper convention: SLO = 2x solo full-card latency at batch 32
        assert prof.slo_ms == 2.0 * provider.latency_ms(prof, 32, 1.0)


def test_load_catalog_refuses_a_missing_cell(tmp_path):
    recs = _records()
    del recs[7]
    with pytest.raises(ValueError, match="missing"):
        load_catalog(_write(tmp_path, recs))


def test_load_catalog_refuses_two_cards(tmp_path):
    recs = _records()
    recs[3] = dict(recs[3], power_limit_w=500.0)
    with pytest.raises(ValueError, match="cards"):
        load_catalog(_write(tmp_path, recs))
    recs = _records()
    recs[0] = dict(recs[0], card="NVIDIA H100 PCIe")
    with pytest.raises(ValueError, match="cards"):
        load_catalog(_write(tmp_path, recs))


def test_load_catalog_refuses_a_cell_measured_twice(tmp_path):
    recs = _records()
    with pytest.raises(ValueError, match="twice"):
        load_catalog(_write(tmp_path, recs + recs[:1]))


def test_load_catalog_refuses_a_side_priced_from_more_sms(tmp_path):
    """The rule before the carves: 60% measured as the left side of a
    60/40 split (80 SMs) prices the right side of 40/60, which runs on
    76."""
    old = {**SMS, 60: 80, 80: 104}
    with pytest.raises(ValueError, match="60% side of split .40, 60. runs "
                       "on 76 SMs but is priced from 80"):
        load_catalog(_write(tmp_path, _records(sms=old)))
    # 50's larger side may not price it either
    with pytest.raises(ValueError, match="50% side .* priced from 68"):
        load_catalog(_write(tmp_path, _records(sms={**SMS, 50: 68})))


def test_load_catalog_refuses_a_file_without_the_granted_splits(tmp_path):
    recs = [dict(r, split_sms=None) for r in _records()]
    with pytest.raises(ValueError, match="split_sms"):
        load_catalog(_write(tmp_path, recs))
    recs = _records()
    recs[5] = dict(recs[5], split_sms={"20": [24, 108]})
    with pytest.raises(ValueError, match="split_sms"):
        load_catalog(_write(tmp_path, recs))


def test_load_catalog_refuses_a_percent_on_two_sm_counts(tmp_path):
    recs = _records()
    recs[1] = dict(recs[1], sms=recs[1]["sms"] - 8)
    with pytest.raises(ValueError, match="measured on"):
        load_catalog(_write(tmp_path, recs))


@pytest.mark.parametrize("percent,position,carve,side,sms", [
    (20, 0, 20, "left", 24), (80, 1, 20, "right", 108),
    (80, 0, 20, "right", 108), (20, 1, 20, "left", 24),
    (40, 0, 40, "left", 56), (60, 1, 40, "right", 76),
    (60, 0, 40, "right", 76), (40, 1, 40, "left", 56),
    (50, 0, 50, "left", 64), (50, 1, 50, "right", 68),
    (100, 0, 100, "whole", 132)])
def test_each_side_of_a_split_runs_on_its_carve(percent, position, carve,
                                                side, sms):
    split_sms = {int(c): tuple(v) for c, v in SPLIT_SMS.items()}
    assert carve_of(percent, position) == (carve, side)
    assert granted_sms(split_sms, percent, position) == sms
    assert carve in CARVES or carve == 100


def test_serve_prints_the_sms_each_side_runs_on(tmp_path, capsys):
    from repro_torch.core.gpulet import GpuLet, GpuState
    from repro_torch.core.scheduler_base import ScheduleResult
    _, provider = load_catalog(_write(tmp_path, _records()))
    gpus = [GpuState(0, [GpuLet(0, 60), GpuLet(0, 40)]),
            GpuState(1, [GpuLet(1, 50), GpuLet(1, 50)]),
            GpuState(2, [GpuLet(2, 100)])]
    serve.print_plan(ScheduleResult(gpus=gpus, schedulable=True,
                                    unplaced={}, scheduler="gpulet"),
                     provider, 3)
    out = capsys.readouterr().out
    assert "[60% = 76 SMs: free] [40% = 56 SMs: free]" in out
    assert "[50% = 64 SMs: free] [50% = 68 SMs: free]" in out
    assert "[100% = 132 SMs: free]" in out


def test_synthetic_catalog_shapes():
    profiles, provider = synthetic_catalog()
    assert set(profiles) == set(SYNTHETIC_TABLE)
    assert "synthetic" in provider.card
    for prof in profiles.values():
        solo = provider.latency_ms(prof, 32, 1.0)
        assert abs(prof.slo_ms - 2.0 * solo) < 1e-12
    assert provider.batch_sizes == LBP_BATCHES
    assert provider.partition_sizes == (20, 40, 50, 60, 80, 100)


def test_elastic_places_a_knee_model_on_a_partition(tmp_path):
    """Past its knee (60%) the dense arch gains nothing, so at a rate one
    card cannot serve, elastic partitioning splits cards."""
    profiles, provider = load_catalog(_write(tmp_path, _records()))
    lam = serve.max_scales(profiles, provider, {"a": 1.0, "b": 1.0}, 4)
    assert lam["elastic"] >= lam["sbp"] > 0
    res = serve.plan(profiles, provider, {"a": lam["elastic"] * 0.9,
                                          "b": lam["elastic"] * 0.9}, 4)
    assert res.schedulable
    assert any(len(gpu.lets) == 2 for gpu in res.gpus)


def test_serve_replay_end_to_end_on_synthetic():
    profiles, provider = synthetic_catalog()
    rates = {"synthetic-dense-9b": 300.0, "synthetic-ssm-780m": 900.0}
    met, result = serve.serve_end_to_end(profiles, provider, rates,
                                         n_gpus=2, horizon_s=3.0, seed=1)
    assert result.schedulable
    assert met.total > 0
    assert met.completed + met.dropped == met.total
    assert met.violation_rate < 0.10


def _main_lines(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = serve.main(argv)
    return rc, out.getvalue().splitlines()


def test_serve_cli_plan_max_scale_and_replay(tmp_path):
    path = _write(tmp_path, _records())
    rc, lines = _main_lines(["--results", path, "--rates", "a=1,b=2",
                             "--gpus", "2", "--max-scale", "--replay",
                             "--no-interference", "--horizon-s", "2"])
    assert rc == 0
    assert any(line.startswith("max schedulable scale: elastic")
               for line in lines)
    assert sum(line.startswith("  card ") for line in lines) == 2
    out = json.loads(lines[-1])
    rep = out["replay"]
    assert rep["total"] > 0 and rep["conserved"]
    assert rep["completed"] + rep["dropped"] == rep["total"]
    assert out["elastic_max_scale"] >= out["sbp_max_scale"] > 0


def test_serve_cli_runs_on_the_synthetic_table_without_a_file():
    rc, lines = _main_lines(["--max-scale", "--replay", "--horizon-s", "2"])
    assert rc == 0
    assert json.loads(lines[-1])["replay"]["conserved"]


def test_serve_cli_refuses_an_unknown_arch(tmp_path):
    with pytest.raises(SystemExit):
        serve.main(["--results", _write(tmp_path, _records()),
                    "--rates", "a=1,zz=1"])


def test_serve_from_the_committed_h100_catalog():
    """The measured file in the repo: every cell of the five archs of the
    JAX package's mix x six partitions x six batches from one card, each
    measured on the side of the carve its percent names, with the carves'
    granted SMs and the step's bytes; and the serving plan and its replay
    without interference
    run from it on the CPU (``tests/test_torch_interference.py`` replays
    it with the measured interference)."""
    lines = COMMITTED.read_text().splitlines()
    recs = [json.loads(line) for line in lines]
    cells = {(r["arch"], r["percent"], r["batch"]) for r in recs}
    # the mix's decode steps, and hubert-xlarge's forward (an encoder)
    archs = ("yi-9b", "chatglm3-6b", "mamba2-780m", "deepseek-moe-16b",
             "recurrentgemma-2b", "hubert-xlarge")
    assert cells == {(a, p, b) for a in archs for p in PARTITION_SIZES
                     for b in LBP_BATCHES}
    assert {r["arch"] for r in recs if r.get("step", "decode") == "decode"
            } == set(archs[:-1])
    assert len(recs) == len(cells)
    split_sms = {int(c): tuple(v) for c, v in recs[0]["split_sms"].items()}
    assert set(split_sms) == set(CARVES)
    for r in recs:
        assert r["step_source"] == "cuda-graph replay, median"
        assert r["runs"] >= 10 and r["step_ms"] > 0
        assert r["eager_wall_ms"] > 0 and r["sms"] > 0
        assert (r["carve"], r["side"]) == CARVE[r["percent"]]
        assert r["sms"] == granted_sms(split_sms, r["percent"])
        assert {int(c): tuple(v) for c, v in r["split_sms"].items()} == \
            split_sms
        assert r["weight_bytes"] > 0 and r["bytes_per_req"] > 0
    rc, out = _main_lines(["--results", str(COMMITTED), "--rates", MIX,
                           "--gpus", "4", "--max-scale", "--replay",
                           "--no-interference"])
    assert rc == 0
    rep = json.loads(out[-1])["replay"]
    assert rep["completed"] + rep["dropped"] == rep["total"] > 0


@pytest.mark.parametrize("sms", [24, 64, 132])
@pytest.mark.parametrize("b,hkv,s,g", [(1, 4, 1032, 8), (4, 4, 1032, 8),
                                       (4, 2, 1032, 16), (4, 1, 2048, 10),
                                       (32, 8, 1032, 4)])
def test_split_plan_follows_the_partition(sms, b, hkv, s, g):
    """Fewer SMs give no more blocks; the cluster never exceeds the limit
    it is given; the splits cover the cache."""
    for limit in (1, 4, 8, 16):
        n, chunk = tdecode.split_plan(b, hkv, s, g, sms=sms, max_split=limit)
        assert 1 <= n <= limit and n * chunk >= s > (n - 1) * chunk
        n132, _ = tdecode.split_plan(b, hkv, s, g, sms=132, max_split=limit)
        assert n <= n132
    assert tdecode.split_plan(b, hkv, s, g) == tdecode.split_plan(
        b, hkv, s, g, sms=132, max_split=16)
    with pytest.raises(ValueError):
        tdecode.split_plan(b, hkv, s, g, sms=sms, max_split=17)


def test_split_plan_on_24_sms_is_smaller_than_on_the_card():
    assert tdecode.split_plan(4, 4, 1032, 8, sms=24)[0] < \
        tdecode.split_plan(4, 4, 1032, 8, sms=132)[0]


def test_partition_state_tells_the_kernels_where_they_run():
    prev = _build.set_partition((1234, 24))
    try:
        assert _build.partition(0) == (1234, 24)
    finally:
        assert _build.set_partition(prev) == (1234, 24)


def test_target_sms_follows_the_driver_granule():
    assert [tpart.target_sms(p, 132) for p in (20, 40, 50, 60, 80)] == \
        [24, 56, 64, 80, 104]
    assert tpart.target_sms(1, 132) == tpart.GRANULE
    with pytest.raises(ValueError):
        tpart.target_sms(100, 132)


def test_partitions_raise_without_a_card():
    """No fallback to the whole card, or to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError):
        tpart.partition(20)
    with pytest.raises(RuntimeError):
        tpart.split(50)


KEYS = {"card", "power_limit_w", "arch", "percent", "sms", "carve", "side",
        "split_sms", "batch", "step", "ctx", "cache_slots", "frames",
        "layers", "dtype", "weight_bytes", "bytes_per_req", "step_ms",
        "step_source", "runs", "run_ms", "eager_wall_ms", "eager_runs",
        "torch", "cuda"}


def test_profile_partitions_record_schema_on_cpu(tmp_path):
    out = tmp_path / "lbp.jsonl"
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = pp.main(["--smoke", "--device", "cpu", "--archs",
                      "yi-9b,mamba2-780m", "--batches", "1,2",
                      "--percents", "20,100", "--out", str(out)])
    assert rc == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert {(r["arch"], r["percent"], r["batch"]) for r in recs} == {
        (a, p, b) for a in ("yi-9b", "mamba2-780m") for p in (20, 100)
        for b in (1, 2)}
    for r in recs:
        assert set(r) == KEYS
        assert r["card"] == "cpu" and r["ctx"] == pp.CTX == 1024
        assert r["step"] == "decode" and r["frames"] is None
        # a CPU run gives no device time
        assert r["step_ms"] is None and r["runs"] == 0
        assert r["step_source"].startswith("not measured")
        assert r["eager_wall_ms"] > 0 and r["layers"] == 2
        assert (r["carve"], r["side"]) == CARVE[r["percent"]]
        # no granted SM counts off the card
        assert r["sms"] is None and r["split_sms"] is None
        assert r["weight_bytes"] > 0 and r["bytes_per_req"] > 0
    assert "yi-9b b1" in buf.getvalue()


def test_filled_cache_is_seeded_and_at_ctx():
    model = pp.build("recurrentgemma-2b", device="cpu", smoke=True)
    c1, t1 = pp.filled_cache(model, 2, seed=3)
    c2, t2 = pp.filled_cache(model, 2, seed=3)
    assert c1["len"] == pp.CTX and bool((t1 == t2).all())
    for l1, l2 in zip(c1["layers"], c2["layers"]):
        for k in l1:
            assert bool((l1[k] == l2[k]).all())
    # the hybrid keeps its windowed ring
    sizes = {layer["k"].shape[1] for layer in c1["layers"] if "k" in layer}
    assert sizes == {min(pp.SLOTS, model.cfg.local_window)}
