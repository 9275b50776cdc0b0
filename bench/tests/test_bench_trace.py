"""The trace reduction and the trace readers, on a made-up activity."""
from __future__ import annotations

import types

import numpy as np
import pytest

from bench import flops, serve, spec, trace
from bench.cell import Run, breakdown


def _side():
    s = types.SimpleNamespace(name="m", waits=[(0.0, 1.0)], batches=[
        serve.Batch(512, np.arange(2), 1.0, 1.5, 3.0),
        serve.Batch(512, np.arange(2, 6), 3.2, 3.4, 5.0)])
    s.entry_spec = {"fields": {"n_layers": 1, "d_model": 64, "n_heads": 2,
                               "n_kv_heads": 1, "d_ff": 128,
                               "vocab_size": 100, "causal": True}}
    return s


ACTIVITY = [  # (name, start, end) in host seconds; t0 = 100
    ("void (anonymous namespace)::flash_bf16<32>(CUtensorMap)", 101.2,
     101.4),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNN", 101.4, 102.9),
    ("void at::native::vectorized_elementwise_kernel", 102.9, 103.0),
    ("void (anonymous namespace)::flash_bf16<32>(CUtensorMap)", 103.5,
     103.6),
    ("void (anonymous namespace)::flash_bf16<128>(CUtensorMap)", 103.6,
     103.7),  # another model's head dim: not this side's
    ("sm90_xmma_gemm_bf16bf16_bf16f32", 103.6, 104.8),
    ("outside the window", 90.0, 91.0),
]


def test_reduce_busy_gaps_and_names():
    tr = trace.reduce(ACTIVITY, [_side()], 100.0, 100.0, 106.0)
    assert tr.start == 0.0 and tr.window_s == pytest.approx(6.0)
    assert tr.busy_s == pytest.approx(1.8 + 1.3)
    assert sum(c for c, _ in tr.by_name.values()) == 6
    assert trace.kernel_seconds(tr, trace.FLASH) == (3, pytest.approx(0.4))
    assert trace.kernel_seconds(tr, trace.GEMM)[1] == pytest.approx(2.7)
    gaps = tr.gaps
    # each gap goes whole to what the host did at its middle
    assert gaps["waiting for arrivals"] == pytest.approx(1.2)
    assert gaps["issuing m L512"] == pytest.approx(0.5)
    assert gaps["between batches"] == pytest.approx(1.2)
    assert sum(gaps.values()) == pytest.approx(6.0 - 3.1)
    b = breakdown(tr)
    assert b["device_ops"][0][0].startswith("nvjet")
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_trace_readers():
    tr = trace.reduce(ACTIVITY, [_side()], 100.0, 100.0, 106.0)
    cell = spec.Cell("c", 1, {}, {}, [], [])
    run = Run(cell, 5.0, [_side()], 1.0, "NVIDIA H100 80GB HBM3", tr)
    idle = spec.reader("device_idle_pct")(run)
    assert idle == pytest.approx(100 * (1 - 3.1 / 6.0))
    share = spec.reader("matmul_busy_share_pct")(run)
    assert share == pytest.approx(100 * 2.7 / 3.1)
    roof = spec.reader("flash_roofline")(run)
    bounds = [flops.flash_bound_s(run.sides[0].entry_spec, b, 512, run.peak)
              for b in (2, 4)]
    assert roof == pytest.approx(100 * sum(bounds) / 0.3)
    assert spec.reader("batch_requests_mean")(run) == 3.0
    # a batch before the traced span, or whose calls are not all in the
    # trace, does not count
    run.trace.start = 2.0
    assert spec.reader("flash_roofline")(run) == pytest.approx(
        100 * bounds[1] / 0.1)
    run.trace.start = 0.0
    run.trace.activity = run.trace.activity[1:]
    assert spec.reader("flash_roofline")(run) == pytest.approx(
        100 * bounds[1] / 0.1)
    run.trace = None
    assert spec.reader("device_idle_pct")(run) is None
    assert spec.reader("flash_roofline")(run) is None
