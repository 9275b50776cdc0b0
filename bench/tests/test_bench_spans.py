"""The program's spans on the trace's clock, and the model step's readers,
on a made-up run whose answers are known."""
from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import pytest

from bench import serve, spans, spec, trace
from bench.cell import Run


class Span(NamedTuple):  # the recorder's record
    name: str
    start: float
    end: float
    parent: int | None
    thread: str
    args: tuple


T0 = 100.0  # the window's start on the host's clock
SPANS = [
    Span("step", 101.05, 101.5, None, "m", ("forward", 2, 512, 0)),
    Span("embed", 101.05, 101.1, 0, "m", ()),
    Span("block", 101.1, 101.3, 0, "m", (0, "attn_mlp")),
    Span("norm", 101.1, 101.2, 2, "m", ()),
    Span("block", 101.3, 101.45, 0, "m", (1, "attn_mlp")),
    Span("head", 101.45, 101.5, 0, "m", ()),
    Span("step", 103.25, 103.4, None, "m", ("forward", 4, 512, 1)),
    Span("block", 103.25, 103.4, 6, "m", (0, "attn_mlp")),
    Span("step", 101.0, 101.2, None, "another loop", ("forward", 1, 8, 0)),
]
ACTIVITY = [  # (name, start, end), seconds from the window's start
    ("k0", 0.5, 0.6),     # before any step
    ("k1", 1.2, 1.25),    # while the first step issues
    ("k2", 1.6, 2.9),     # after it closed
    ("k3", 3.3, 3.35),
    ("k4", 3.5, 4.9),
    ("k5", 4.95, 4.97),
    ("Memset (Device)", 4.97, 4.98),  # a set, not a kernel
    ("Memcpy DtoH (Device -> Pageable)", 4.98, 4.99),
]
IDLE = 0.5 + 0.6 + 0.35 + 0.4 + 0.15 + 0.05 + 1.01


def _run(activity=ACTIVITY):
    side = types.SimpleNamespace(name="m", batches=[
        serve.Batch(512, np.arange(2), 1.0, 1.5, 3.0),
        serve.Batch(512, np.arange(2, 6), 3.2, 3.4, 5.0)],
        entry_spec={"fields": {"n_layers": 2}})
    busy = sum(b - a for _, a, b in activity)
    tr = trace.Trace(0.0, 6.0, busy, {}, {}, list(activity))
    return Run(spec.Cell("c", 1, {}, {}, [], []), 5.0, [side], 1.0,
               "NVIDIA H100 80GB HBM3", tr)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: list(SPANS))


def test_pairs_and_origin(recorded):
    w = spans.window(_run())
    assert w.origin == pytest.approx(T0)
    assert [(b.dispatch, st.args[3]) for _, b, st in w.pairs] == [
        (1.0, 0), (3.2, 1)]


def test_idle_goes_to_the_innermost_span(recorded):
    run = _run()
    assert sum(b - a for a, b in spans.idle_intervals(run.trace)) == \
        pytest.approx(IDLE)
    idle = spans.idle_by_span(run)
    expect = {"embed": 0.05, "norm": 0.1, "block": 0.05 + 0.15 + 0.1,
              "head": 0.05, spans.OUTSIDE: IDLE - 0.5}
    assert set(idle) == set(expect)
    for k, v in expect.items():
        assert idle[k] == pytest.approx(v), k
    host = spans.self_seconds(run)
    for k, v in {"embed": 0.05, "norm": 0.1, "block": 0.1 + 0.15 + 0.15,
                 "head": 0.05}.items():
        assert host[k] == pytest.approx(v), k
    assert host.get("step", 0.0) == pytest.approx(0.0, abs=1e-9)
    assert spans.busy_after_step(run) == [pytest.approx(1.3),
                                          pytest.approx(1.44)]
    t = spans.tables(run)
    assert t["batches"] == 2 and t["spans"] == len(SPANS)
    assert t["idle_s"] == pytest.approx(IDLE)


def test_the_model_step_readers(recorded):
    run = _run()
    read = {m: spec.reader(m) for m in ("step_issue_us_per_layer",
                                        "idle_in_step_pct",
                                        "kernels_per_layer")}
    # the steps' lengths over 2 layers: 0.225 s and 0.075 s
    assert read["step_issue_us_per_layer"](run) == pytest.approx(150_000)
    # idle under the steps [1.05, 1.5] and [3.25, 3.4]: 0.4 + 0.1 s of 6
    assert read["idle_in_step_pct"](run) == pytest.approx(100 * 0.5 / 6)
    # two launches from the first step's start to its output, four in
    # the second's (the copy counted, the set not), over 2 layers
    assert read["kernels_per_layer"](run) == pytest.approx((1.0 + 2.0) / 2)
    for m in read:
        assert spec.reader(m + ".prompts")(run) == read[m](run)
    # a batch dispatched before the traced span, or not held whole by it,
    # does not count
    run.trace.start = 2.0
    assert read["step_issue_us_per_layer"](run) == pytest.approx(75_000)
    assert read["kernels_per_layer"](run) == pytest.approx(2.0)


def test_nothing_to_read(monkeypatch, recorded):
    run = _run()
    run.trace = None
    for m in ("step_issue_us_per_layer", "idle_in_step_pct",
              "kernels_per_layer"):
        assert spec.reader(m)(run) is None
    assert spans.idle_by_span(run) is None
    run = _run()
    # one step fewer than batches
    monkeypatch.setattr(spans, "recorded", lambda: SPANS[:6])
    assert spans.window(run) is None
    assert spec.reader("kernels_per_layer")(run) is None
    # a program without the recorder
    monkeypatch.setattr(spans, "recorded", lambda: None)
    assert spans.window(run) is None
    assert spec.reader("idle_in_step_pct")(run) is None
