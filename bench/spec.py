"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one ``configs[].file`` gives; the traffic
mix is ``traffic/<traffic>.json``; each metric is read by
``metrics/<name>.py``; each model entry's plain reference is the module its
``reference`` names (``reference/model.py`` where it names none).  Nothing
here knows a cell, a model or a metric by name: a later cell brings its
own files.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's content
    traffic: dict         # the traffic file's content
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def traffic_path(name: str) -> Path:
    return BENCH / "traffic" / f"{name}.json"


def metric_path(name: str) -> Path:
    return BENCH / "metrics" / f"{name}.py"


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: dict | None = None) -> Cell:
    spec = spec or benchmark()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    return Cell(
        name=name, chips=w["chips"],
        config=load_json(ROOT / configs[w["config"]]["file"]),
        traffic=load_json(traffic_path(w["traffic"])),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def cell_from_files(config: str, traffic: str, chips: int = 1,
                    spec: dict | None = None) -> Cell:
    """A cell that ``BENCHMARK.json`` does not list yet, from its
    configuration file (a path under the root) and traffic name: every
    metric of the benchmark applies."""
    spec = spec or benchmark()
    return Cell(name=f"{Path(config).stem}.{traffic}", chips=chips,
                config=load_json(ROOT / config),
                traffic=load_json(traffic_path(traffic)),
                end_to_end=list(spec["end_to_end"]),
                per_layer=list(spec["per_layer"]))


def reader(metric: str):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    path = metric_path(metric)
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def reference(entry: dict):
    """The plain reference module of a configuration's model ``entry``:
    the file its ``reference`` names (a path under ``bench/``), loaded
    once a process; ``bench.reference.model`` where it names none."""
    if "reference" not in entry:
        from bench.reference import model
        return model
    path = (ROOT / entry["reference"]).resolve()
    if BENCH not in path.parents or path.suffix != ".py":
        raise ValueError(f"reference {entry['reference']!r} is not a .py "
                         "file under bench/")
    return _load(path)


@functools.cache
def _load(path: Path):
    name = re.sub(r"\W", "_", str(path.relative_to(ROOT)))
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module
