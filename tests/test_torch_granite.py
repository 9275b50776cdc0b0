"""granite-4.0-h-small in the port, held to the benchmark's plain reference
(``bench/reference/granite.py``) in float32 at the smoke size, on the CPU.

The JAX package has no such model: its upstream Mamba-2 mixer, dropless
grouped dispatch, attention without RoPE at a stated scale, multipliers
and tied head are the port's own, so the reference written from the
published description is what they are held to.
"""
from __future__ import annotations

import copy
import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from bench import spec, weights  # noqa: E402
from bench.tests.smoke import smoke_cell  # noqa: E402
from repro_torch.configs import (PORT_IDS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

SEED = 2**31 + 33
ROOT = Path(__file__).resolve().parents[1]


def entry(n_layers: int = 2) -> dict:
    """The cell's model entry at the smoke size (float32 weights drawn as
    the benchmark draws them)."""
    (e,) = smoke_cell("granite.documents", n_layers=n_layers).config[
        "models"].values()
    return e


def port(e: dict, dtype=torch.float32) -> Model:
    model = Model(ModelConfig(name="granite", **e["fields"]), dtype=dtype,
                  device="cpu")
    made = dict(weights.top(e, "cpu", SEED))
    for i in range(e["fields"]["n_layers"]):
        made.update({f"layers.{i}.{k}": v for k, v in
                     weights.layer(e, i, "cpu", SEED).items()})
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(made.pop(n))
    assert not made
    return model


def reference(e: dict, groups: list) -> list:
    (out,) = spec.reference(e).run(
        e, lambda i: weights.layer(e, i, "cpu", SEED),
        weights.top(e, "cpu", SEED), groups)
    return out


def tokens(e: dict, b: int, s: int) -> torch.Tensor:
    return weights.input_pool(e, "cpu", SEED)[:b * s].view(b, s)


def test_config_is_the_published_one():
    cfg = get_config("granite-4.0-h-small")
    assert "granite-4.0-h-small" in PORT_IDS
    kinds = cfg.layer_types()
    assert [i for i, k in enumerate(kinds) if k == "moe"] == [5, 15, 25, 35]
    assert kinds.count("mamba2") == 36
    assert (cfg.ssm_n_heads, cfg.ssm_d_inner, cfg.softmax_scale) == (
        128, 8192, 1 / 128)
    assert round(cfg.param_count() / 1e9, 1) == 32.2
    with torch.device("meta"):
        model = Model(cfg, device="meta")
    # param_count, as the JAX package's, leaves out the final norm
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + cfg.d_model
    assert not hasattr(model.embed, "head")   # tied: no second copy
    smoke = get_smoke_config("granite-4.0-h-small")
    assert smoke.layer_types() == ["mamba2", "moe"]
    # the scan shares one B and C over the heads, the only G the port
    # builds: the benchmark's file has to state that one
    published = json.loads((ROOT / "bench/configs/granite-4.0-h-small.json")
                           .read_text())
    assert published["mamba_n_groups"] == 1
    assert [block.moe.layer for block in model.layers] == list(range(40))


@pytest.mark.parametrize("n_layers", [2, 4])
def test_prefill_logits_equal_the_reference(n_layers):
    e = entry(n_layers)
    model = port(e)
    x = tokens(e, 2, 21)
    with torch.inference_mode():
        logits, _ = model.prefill(x, model.init_cache(2, 21))
    (ref,) = reference(e, [x])
    v = e["fields"]["vocab_size"]
    torch.testing.assert_close(logits[..., :v], ref, rtol=1e-4, atol=1e-6)
    assert float(ref.std()) > 1e-3


def test_prefill_then_decode_equals_the_reference_forward():
    """A prefill and then decode steps through the cache (conv and SSM
    states, the KV ring) against the reference's whole forward at each
    position."""
    e = entry(2)
    model = port(e)
    x = tokens(e, 2, 24)
    with torch.inference_mode():
        logits, cache = model.prefill(x[:, :17], model.init_cache(2, 24))
        steps = [logits]
        for t in range(17, 24):
            logits, cache = model.decode_step(cache, x[:, t:t + 1])
            steps.append(logits)
    refs = reference(e, [x[:, :t] for t in range(17, 25)])
    v = e["fields"]["vocab_size"]
    for got, want in zip(steps, refs):
        torch.testing.assert_close(got[..., :v], want, rtol=1e-4, atol=1e-6)


def _mixer(seed: int = 0):
    cfg = dataclasses.replace(get_smoke_config("granite-4.0-h-small"),
                              ssm_headdim=16, ssm_d_state=16)
    mixer = ssm_mod.Mamba2(cfg, device="cpu", dtype=torch.float64)
    g = torch.Generator().manual_seed(seed)
    mixer.reset_parameters(g)
    with torch.no_grad():
        mixer.norm.normal_(1.0, 0.1, generator=g)
        mixer.d_skip.normal_(1.0, 0.1, generator=g)
    x = torch.randn(2, 37, cfg.d_model, generator=g, dtype=torch.float64)
    return cfg, mixer, x


def test_upstream_mixer_equals_a_token_by_token_recurrence():
    """The sequence form (conv, the SSD scan, the gated norm) against the
    recurrence written out a token at a time in float64; the mixer keeps
    dt, A, D, the scan's output and the gated norm in float32 whatever its
    weights' dtype, hence the float32 tolerance."""
    cfg, p, x = _mixer()
    y, state = ssm_mod.mamba2_apply(p, x, cfg)
    di, n, nh, hp = (cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_n_heads,
                     cfg.ssm_headdim)
    proj = x @ p.in_proj
    z, xbc, dt = proj.split([di, di + 2 * n, nh], -1)
    h = torch.zeros(2, nh, n, hp, dtype=torch.float64)
    a = -torch.exp(p.a_log.double())
    past = torch.zeros(2, 3, di + 2 * n, dtype=torch.float64)
    outs = []
    for t in range(x.shape[1]):
        window = torch.cat([past, xbc[:, t:t + 1]], 1)      # (2, 4, C)
        c = torch.nn.functional.silu((window * p.conv).sum(1) + p.conv_bias)
        past = window[:, 1:]
        xs, bt, ct = c.split([di, n, n], -1)
        dtt = torch.nn.functional.softplus(dt[:, t] + p.dt_bias)
        xh = xs.view(2, nh, hp)
        h = (torch.exp(dtt * a)[..., None, None] * h
             + dtt[..., None, None] * bt[:, None, :, None] * xh[:, :, None])
        yt = (ct[:, None, :, None] * h).sum(2) + xh * p.d_skip[:, None]
        g = yt.reshape(2, di) * torch.nn.functional.silu(z[:, t])
        g = g * torch.rsqrt(g.square().mean(-1, keepdim=True)
                            + cfg.rms_eps) * p.norm
        outs.append(g @ p.w_out)
    torch.testing.assert_close(y, torch.stack(outs, 1), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(state["ssm"], h, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state["conv"], past)
    # and the decode step carries on from the sequence's state
    before = ssm_mod.mamba2_apply(p, x[:, :-1], cfg)[1]
    y1, _ = ssm_mod.mamba2_decode_step(p, x[:, -1:], cfg, {
        "conv": before["conv"], "ssm": before["ssm"].float()})
    torch.testing.assert_close(y1[:, 0], outs[-1], rtol=1e-5, atol=1e-5)


def _moe(dtype):
    cfg = dataclasses.replace(get_smoke_config("granite-4.0-h-small"),
                              n_experts=8, top_k=3, capacity_factor=8 / 3)
    layer = moe_mod.MoE(cfg, device="cpu", dtype=dtype)
    layer.reset_parameters(torch.Generator().manual_seed(1))
    return cfg, layer


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_dispatch_equals_the_static_one_where_nothing_drops(dtype):
    """Uneven routing (expert 5 takes most tokens' first choice), expert 2
    chosen by none: the dropless grouped products give what the static
    buffer gives when its capacity drops nothing."""
    cfg, layer = _moe(dtype)
    g = torch.Generator().manual_seed(2)
    t = 61
    xf = torch.randn(t, cfg.d_model, generator=g).to(dtype)
    choices = torch.stack([torch.randperm(7, generator=g)[:3] for _ in
                           range(t)])
    choices = torch.where(choices >= 2, choices + 1, choices)  # never 2
    choices[: t * 2 // 3, 0] = 5
    choices[: t * 2 // 3, 1:] = torch.where(
        choices[: t * 2 // 3, 1:] == 5, 7, choices[: t * 2 // 3, 1:])
    top_w = torch.softmax(torch.randn(t, 3, generator=g), -1)
    assert moe_mod.capacity(t, cfg) >= t   # the static path drops nothing
    static = moe_mod._static(layer, xf, top_w, choices, cfg)
    dropless = moe_mod._dropless(layer, xf, top_w, choices, cfg)
    assert torch.equal(static, dropless)
    # and through the layer, routing itself
    x = xf.view(1, t, -1)
    ys = moe_mod.moe_apply(layer, x, cfg, False)[0]
    yd = moe_mod.moe_apply(layer, x, dataclasses.replace(
        cfg, moe_dropless=True), False)[0]
    assert torch.equal(ys, yd)


def test_grouped_dispatch_counts_tokens_while_recording():
    """The ``expert_tokens`` counter: what each expert received, summed on
    the device over the recorded steps, nothing outside them."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import host
    e = entry(2)
    model = port(e)
    x = tokens(e, 2, 9)
    with torch.inference_mode():
        model.prefill(x, model.init_cache(2, 9))   # not recorded
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                model.prefill(x, model.init_cache(2, 9))
    counts = host.counters("expert_tokens")
    assert sorted(counts) == [0, 1]
    k = e["fields"]["top_k"]
    for c in counts.values():
        assert c.dtype == torch.int64 and c.shape == (16,)
        assert int(c.sum()) == 2 * 2 * 9 * k


def _served_last(e: dict, sigma: float, x) -> int:
    """How many of the rows of ``x`` the reference answers with their own
    last token, the tied embedding drawn N(0, sigma^2)."""
    top = dict(weights.top(e, "cpu", SEED))
    g = torch.Generator().manual_seed(5)
    top["embed.tok"] = (torch.randn(top["embed.tok"].shape, generator=g)
                        * sigma).bfloat16()
    (logits,) = spec.reference(e).run(
        e, lambda i: weights.layer(e, i, "cpu", SEED), top, [x])[0]
    return int((logits[:, 0].argmax(-1) == x[:, -1]).sum())


def test_tied_draw_of_the_untied_models_serves_the_prompts_last_token():
    """At N(0, 0.02^2), the untied models' embedding draw, the prompt's own
    last token wins the tied head at the published width (d 4096): its
    12 e_t stays in the stream and scores 12 sigma^2 d against sigma
    sqrt(d) of the rest, 15 / rms(x_L) standard deviations.  The reference
    states sigma = EMBED_R / sqrt(d) instead, 12 EMBED_R / rms(x_L) = 1.2 /
    rms(x_L), under which, at granite's depth (40 layers, rms(x_L) above
    1), the prompt's last token wins no more often than chance."""
    wide = copy.deepcopy(entry(2))
    wide["fields"].update(d_model=4096, ssm_headdim=64, ssm_d_state=16,
                          n_heads=4, n_kv_heads=2, d_head=32, d_ff=32,
                          moe_d_ff=32, shared_d_ff=32)
    assert _served_last(wide, 0.02, tokens(wide, 8, 6)) == 8
    deep = entry(40)
    r = spec.reference(deep).EMBED_R
    x = tokens(deep, 32, 6)
    assert _served_last(deep, r / deep["fields"]["d_model"] ** 0.5, x) <= 2
