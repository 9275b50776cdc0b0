"""granite.documents at the smoke size on the CPU: the cell through
``run_cell`` comes out correct, and not correct under each fault of what
granite brings to the port; the reference's costs against a hand count.

The faults run in float32, held to ``FP32_LIMIT``: there the port equals
the reference to float32 rounding (1e-8 of a logit,
``tests/test_torch_granite.py``), so a gap above 1e-5, a six-hundredth of
the logits' spread (``EMBED_R`` / 16), is a fault; the faults read 5e-5
to 3e-2 here.  In bf16 at this size the program's routing flips on near-ties
among 8 experts (PERF.md, the MoE fixture), which the committed limit,
read on the card at the cell's size, is set for."""
from __future__ import annotations

import pytest
import torch

from bench import cell as cell_mod
from bench import spec, weights
from bench.tests.smoke import smoke_cell

SEED = 2**31 + 4242
CELL = "granite.documents"


def _negate_expert(monkeypatch):
    """Expert 0's ``w_down`` negated in every MoE layer, after the load."""
    load = weights.load_into

    def load_negated(model, c, seed):
        load(model, c, seed)
        with torch.no_grad():
            for block in model.layers:
                block.moe.w_down[0].neg_()

    monkeypatch.setattr(weights, "load_into", load_negated)


def _skip_gated_norm(monkeypatch):
    from repro_torch.models import ssm
    monkeypatch.setattr(ssm, "gated_norm", lambda y, z, w, eps, dtype: (
        y.float() * torch.nn.functional.silu(z.float()) * w).to(dtype))


def _drop_conv_bias(monkeypatch):
    from repro_torch.models import ssm
    conv_silu = ssm.conv_silu
    monkeypatch.setattr(ssm, "conv_silu", lambda x, w, bias, state=None:
                        conv_silu(x, w, None, state))


def _default_scale(monkeypatch):
    from repro_torch.models import transformer
    full = transformer.attention_full
    monkeypatch.setattr(transformer, "attention_full",
                        lambda q, k, v, causal, window, scale=None:
                        full(q, k, v, causal=causal, window=window))


def _rope(monkeypatch):
    import dataclasses

    from repro_torch.models import transformer
    rope = transformer._rope
    monkeypatch.setattr(transformer, "_rope", lambda q, k, cfg, positions:
                        rope(q, k, dataclasses.replace(
                            cfg, position_embedding="rope"), positions))


FAULTS = {"expert_negated": _negate_expert,
          "gated_norm_skipped": _skip_gated_norm,
          "conv_bias_dropped": _drop_conv_bias,
          "scale_one_over_sqrt_dh": _default_scale,
          "rope_applied": _rope}


FP32_LIMIT = 1e-5


def _run(monkeypatch, fp32: bool = True, seed: int = SEED):
    cell = smoke_cell(CELL, rate=150.0)   # batches of several requests
    if fp32:
        # the program in float32, holding the benchmark's bf16 draws
        cell.config["dtype"] = "float32"
        copy = weights._copy
        monkeypatch.setattr(weights, "_copy", lambda params, made, where: copy(
            params, {n: t.to(params[n].dtype) if n in params else t
                     for n, t in made.items()}, where))
    for entry in cell.config["models"].values():
        entry["check"]["sample_requests"] = 150
        if fp32:
            entry["check"]["max_gap"] = FP32_LIMIT
    return cell_mod.run_cell(cell, seed, 1.0, False, device="cpu")


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_cell_is_correct(monkeypatch, fp32):
    out = _run(monkeypatch, fp32)
    assert out["correct"] is True
    (name,) = spec.load_cell(CELL).config["models"]
    assert out["check"][f"sampled_tokens.{name}"]["value"] > 100


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_come_out_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    assert _run(monkeypatch)["correct"] is False


def test_costs_count_by_hand():
    (entry,) = spec.load_cell(CELL).config["models"].values()
    ref = spec.reference(entry)
    # a token's matmul operations: 36 Mamba-2 projections, 4 attention
    # layers' projections, 40 routers, 10 experts and the shared MLP
    per_token = (36 * 2 * 4096 * (8192 + 8448 + 128 + 8192)
                 + 4 * 2 * 4096 * 128 * 80
                 + 40 * 2 * 4096 * (72 + 3 * 10 * 768 + 3 * 1536))
    causal = 4 * 4 * 128 * 32 * (1000 * 1001 // 2)
    assert ref.step_flops(entry, 1, 1000) == (
        1000 * per_token + causal + 2 * 4096 * 100352)
    assert round(per_token / 1e9, 1) == 16.8
    ops, nbytes = ref.expert_cost(entry, 16384)
    assert ops == 6 * 163840 * 4096 * 768
    assert nbytes == 2 * (3 * 72 * 4096 * 768 + 3 * 163840 * 4096
                          + 3 * 163840 * 768)
    ops, nbytes = ref.ssd_cost(entry, 2, 8192)
    assert nbytes == (2 * (2 * 8192 * 8192 + 2 * 2 * 8192 * 128)
                      + 4 * (2 * 8192 * 128 + 128)
                      + 4 * (2 * 8192 * 8192 + 2 * 128 * 128 * 64))
    assert ops == 2 * 2 * 8192 * (64 * 128 + 128 * (64 * 64 + 2 * 128 * 64))
    assert ref.flash_cost(entry, 2, 8192) == (
        4 * 128 * 32 * 2 * (8192 * 8193 // 2),
        2 * (2 * 2 * 32 * 8192 * 128 + 2 * 2 * 8 * 8192 * 128))
