"""Each cell run whole on the CPU at the smoke size; the command's refusals.

The smoke cells keep each cell's traffic shape, loop, entry and check;
only the sizes shrink (``smoke.py``).  The program's limit of the output
check is the committed one.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import cell as cell_mod
from bench import spec, traffic, weights
from bench.tests.smoke import smoke_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 2**31 + 977  # larger than 32 signed bits hold


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_whole_on_the_cpu(workload):
    cell = smoke_cell(workload)
    out = cell_mod.run_cell(cell, SEED, 1.0, False, device="cpu")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "check"]
    assert out["correct"] is True
    n = sum(len(traffic.schedule(cell.traffic["streams"][s["model"]], 1.0,
                                 SEED, i, weights.POOL).due)
            for i, s in enumerate(cell.config["sides"]))
    assert out["attempted"] == n > 20 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in out["metrics"].values():
        assert m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    json.dumps(out)  # one JSON line


@pytest.mark.parametrize("workload", CELLS)
def test_same_seed_same_work(workload):
    """A seed gives the same inputs, weights and served tokens; another
    seed the same amount of work in another order."""
    a, b, c = (cell_mod.build(smoke_cell(workload), s, 2.0, "cpu")[0][0]
               for s in (SEED, SEED, SEED + 1))
    assert (a.sched.due == b.sched.due).all()
    assert torch.equal(a.pool, b.pool)
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                  b.model.parameters()))
    assert sorted(a.sched.length) == sorted(c.sched.length)
    assert not (a.sched.due == c.sched.due).all()


@pytest.mark.parametrize("workload", CELLS)
def test_trace_one_gives_the_same_verdict(workload):
    """On the CPU no device trace is read: the per-layer readers of the
    loop give their numbers, the device's are left out."""
    cell = smoke_cell(workload)
    out = cell_mod.run_cell(cell, SEED, 1.0, True, device="cpu")
    assert out["correct"] is True
    assert set(out["metrics"]) == {m["name"] for m in cell.per_layer
                                   if m["layer"] == "serving loop"}


def _run(cwd, *args):
    return subprocess.run([sys.executable, "bench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(spec.ROOT, "--workload", CELLS[0], "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA card" in out.stderr


def test_no_port_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and bench/ has no port."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run(tmp_path, "--workload", CELLS[0], "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    assert "no port" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload):
    """A short run of the cell as committed, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(spec.ROOT, "--workload", workload, "--seed", str(SEED),
               "--seconds", "3", "--trace", "0")
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"


@pytest.mark.parametrize("workload", CELLS)
def test_arrivals_are_poisson(workload):
    """Counts in half-second bins spread as a Poisson stream's do (index
    of dispersion about 1, not 0), and every seed gets the same counts a
    segment in another order."""
    cell = spec.load_cell(workload)
    for i, side in enumerate(cell.config["sides"]):
        stream = cell.traffic["streams"][side["model"]]
        a, b = (traffic.schedule(stream, 51.0, s, i, weights.POOL)
                for s in (SEED, SEED + 1))
        counts = np.histogram(a.due, bins=102, range=(0, 51))[0]
        assert 0.7 < counts.var() / counts.mean() < 1.3
        edges = np.linspace(0, 51, round(51 / stream["segment_s"]) + 1)
        per_seg = [sorted(np.histogram(s.due, bins=edges)[0])
                   for s in (a, b)]
        assert per_seg[0] == per_seg[1]
        assert sorted(a.length) == sorted(b.length)
        assert abs(len(a.due) / 51 - stream["rate_rps"]) < \
            4 * (stream["rate_rps"] / 51) ** 0.5
