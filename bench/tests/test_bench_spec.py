"""BENCHMARK.json against its contract, and every name resolved to files."""
from __future__ import annotations

import ast
import json
import re

import pytest

from bench import spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert list(B) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert B["command"] == ["python3", "bench/run.py"]
    assert B["paths"] == ["bench"]
    assert 1 <= B["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in B["configs"]] + \
        [w["name"] for w in B["workloads"]] + \
        [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    for n in names + [w["traffic"] for w in B["workloads"]]:
        assert NAME.match(n), n
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in B[group]}) == len(B[group])
    metrics = B["end_to_end"] + B["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_every_cell_resolves_to_its_files():
    pairs = set()
    used = set()
    for w in B["workloads"]:
        cell = spec.load_cell(w["name"])
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        for side in cell.config["sides"]:
            assert side["model"] in cell.config["models"]
            assert side["model"] in cell.traffic["streams"]
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]))
    assert len(pairs) == len(B["workloads"])
    assert used == {c["name"] for c in B["configs"]}


def test_config_files():
    for c in B["configs"]:
        path = spec.ROOT / c["file"]
        assert path.relative_to(spec.BENCH)
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        for entry in cfg["models"].values():
            assert entry["check"]["max_gap"] is not None


def test_committed_files_parse_and_build():
    """Every configuration and traffic file, the co-located one without a
    cell included, builds the port's config and names its streams."""
    from repro_torch.models.config import ModelConfig
    for path in sorted((spec.BENCH / "configs").glob("*.json")):
        cfg = json.loads(path.read_text())
        for name, entry in cfg["models"].items():
            ModelConfig(name=name, **entry["fields"])
        assert all(0 < s["percent"] <= 100 for s in cfg["sides"])
    for path in sorted((spec.BENCH / "traffic").glob("*.json")):
        for stream in json.loads(path.read_text())["streams"].values():
            assert len(stream["lengths"]) == len(stream["weights"])
            assert stream["slo_ms"] > 0 and stream["rate_rps"] > 0


def test_metric_files_define_read():
    for path in sorted((spec.BENCH / "metrics").glob("*.py")):
        tree = ast.parse(path.read_text())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
                   for n in tree.body), path


@pytest.mark.parametrize("workload", [w["name"] for w in B["workloads"]])
def test_check_budget(workload):
    """A full check of 24 cells fits the driver's 43,200 s at this
    run_seconds."""
    rs = B["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200, workload
