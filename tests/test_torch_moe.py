"""The port's MoE slice (deepseek-moe-16b, arctic-480b) on the CPU against
the JAX package.

``repro_torch.models.moe.moe_apply`` is held against the JAX ``moe_apply``
with the same weights (``moe_init`` from a JAX key, copied across) and the
same inputs (``numpy.random.default_rng``), fp32, at the smoke size: the
routing ids, the dropped choices, the outputs (rtol 1e-4, atol 1e-5, the
fp32 kernel tolerance of ``tests/test_kernels.py``) and the aux loss, with
a capacity that drops nothing and one that drops.  The behaviours of the
JAX package's ``tests/test_moe.py`` are ported.  The two smoke models are
held against the JAX ``Model`` (2e-4, ``tests/test_kernel_integration.py``)
through ``checkpoint/bridge.py``, and prefill + decode against forward
(1e-3, ``tests/test_models_smoke.py``).
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import Model, ModelConfig  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

LAYER = dict(rtol=1e-4, atol=1e-5)   # tests/test_kernels.py, fp32
PARITY = dict(rtol=2e-4, atol=2e-4)  # tests/test_kernel_integration.py:24
DECODE = dict(rtol=1e-3, atol=1e-3)  # tests/test_models_smoke.py:113
MOE_ARCHS = ("deepseek-moe-16b", "arctic-480b")


def port_config(jcfg) -> ModelConfig:
    fields = dataclasses.asdict(jcfg)
    del fields["kernel_impl"], fields["analysis_unroll"]
    return ModelConfig(**fields)


def smoke(arch="deepseek-moe-16b", cf=8.0):
    return dataclasses.replace(jax_smoke(arch), capacity_factor=cf)


def layer_pair(jcfg, key=0):
    """JAX ``moe_init`` params and the port's ``MoE`` holding them, fp32."""
    params = jmoe.moe_init(jax.random.key(key), jcfg, jnp.float32)
    layer = tmoe.moe_init(port_config(jcfg), device="cpu",
                          dtype=torch.float32)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            node = params
            for part in name.split("."):
                node = node[part]
            p.copy_(torch.from_numpy(np.array(node)))
    return params, layer


def inputs(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d), np.float32)


def kept_reference(ids: np.ndarray, n_experts: int, cap: int) -> np.ndarray:
    """Which (token, slot) choices an expert takes, by a loop over the
    choices in token-major, slot-minor order: the first ``cap`` of each."""
    taken = np.zeros(n_experts, int)
    keep = np.zeros(ids.size, bool)
    for i, e in enumerate(ids.reshape(-1)):
        keep[i] = taken[e] < cap
        taken[e] += 1
    return keep


def port_dispatch(layer, x, cfg):
    """The port's routing of x: (top-k ids, kept choices), as ``moe_apply``
    dispatches them."""
    t = x.shape[0] * x.shape[1]
    _, _, top_i = tmoe.route(layer, x.reshape(t, -1), cfg)
    _, keep = tmoe.slots(top_i, cfg.n_experts, tmoe.capacity(t, cfg))
    return top_i.numpy(), keep.numpy()


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf,drops", [(8.0, False), (0.25, True)])
def test_moe_apply_matches_jax(arch, cf, drops):
    """Routing ids, dropped choices, outputs and aux loss equal JAX's, with
    a capacity that drops nothing and one that drops."""
    jcfg = smoke(arch, cf)
    cfg = port_config(jcfg)
    params, layer = layer_pair(jcfg)
    x = inputs(1, 2, 32, jcfg.d_model)
    want, want_aux = jmoe.moe_apply(params, jnp.asarray(x), jcfg)
    got, got_aux = tmoe.moe_apply(layer, torch.from_numpy(x), cfg)

    t = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x.reshape(t, -1)) @ params["router"])
    _, jids = jax.lax.top_k(probs, jcfg.top_k)
    ids, keep = port_dispatch(layer, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    want_keep = kept_reference(np.asarray(jids), jcfg.n_experts,
                               jmoe.capacity(t, jcfg))
    np.testing.assert_array_equal(keep, want_keep)
    assert (not want_keep.all()) == drops
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **LAYER)


def test_no_drop_when_capacity_huge():
    """With cf covering all tokens, output = exact weighted expert mix
    (``tests/test_moe.py::test_no_drop_when_capacity_huge``)."""
    jcfg = smoke(cf=float(jax_smoke("deepseek-moe-16b").n_experts))
    cfg = port_config(jcfg)
    _, layer = layer_pair(jcfg)
    x = torch.from_numpy(inputs(1, 2, 8, cfg.d_model))
    y, aux = tmoe.moe_apply(layer, x, cfg)
    xf = x.reshape(16, cfg.d_model)
    probs = torch.softmax(xf @ layer.router, -1)
    topw, topi = torch.topk(probs, cfg.top_k, -1)
    topw = topw / topw.sum(-1, keepdim=True)
    outs = torch.stack([
        (torch.nn.functional.silu(xf @ layer.w_gate[e])
         * (xf @ layer.w_up[e])) @ layer.w_down[e]
        for e in range(cfg.n_experts)], 1)                    # (T, E, D)
    want = layer.shared(xf)
    for kk in range(cfg.top_k):
        want = want + topw[:, kk, None] * outs[torch.arange(16), topi[:, kk]]
    np.testing.assert_allclose(y.reshape(16, -1).numpy(), want.numpy(),
                               rtol=2e-4, atol=2e-4)
    assert np.isfinite(float(aux))


def test_capacity_dropping_reduces_output():
    """Choices over capacity contribute zero (GShard drop semantics)."""
    jcfg = smoke(cf=0.25)
    cfg = port_config(jcfg)
    _, layer = layer_pair(jcfg)
    x = torch.from_numpy(inputs(2, 2, 32, cfg.d_model))
    y_small, _ = tmoe.moe_apply(layer, x, cfg)
    big = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    y_big, _ = tmoe.moe_apply(layer, x, big)
    assert not torch.allclose(y_small, y_big)


@given(t=st.integers(min_value=1, max_value=4096),
       cf=st.sampled_from([0.25, 1.0, 1.25, 8.0]))
@settings(max_examples=50, deadline=None)
def test_capacity_equals_jax(t, cf):
    jcfg = smoke(cf=cf)
    c = tmoe.capacity(t, port_config(jcfg))
    assert c == jmoe.capacity(t, jcfg)
    assert c >= 8 and c % 8 == 0


def test_group_fallback_without_mesh():
    for t in (1, 7, 64, 4000):
        assert tmoe.n_dispatch_groups(t) == jmoe.n_dispatch_groups(t) == 1


def test_aux_loss_near_one_for_uniform_router():
    """Balanced routing gives aux ~= 1 (Switch normalization)."""
    jcfg = smoke()
    cfg = port_config(jcfg)
    _, layer = layer_pair(jcfg)
    with torch.no_grad():
        layer.router.zero_()
    x = torch.from_numpy(inputs(3, 4, 64, cfg.d_model))
    _, aux = tmoe.moe_apply(layer, x, cfg)
    assert 0.8 <= float(aux) <= 1.3


def test_init_fills_with_the_jax_scales():
    """Same distributions as the JAX ``moe_init`` (not the same numbers),
    the router in fp32 whatever the model dtype."""
    cfg = get_smoke_config("arctic-480b")
    layer = tmoe.moe_init(cfg, device="cpu", dtype=torch.bfloat16)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    d, f = cfg.d_model, cfg.moe_d_ff
    assert layer.router.dtype == torch.float32
    assert layer.w_up.dtype == torch.bfloat16
    for t, std in ((layer.router, d ** -0.5), (layer.w_gate, d ** -0.5),
                   (layer.w_up, d ** -0.5), (layer.w_down, f ** -0.5),
                   (layer.dense.w_down, cfg.d_ff ** -0.5)):
        assert abs(float(t.float().std()) / std - 1) < 0.05
    assert layer.shared is None  # arctic: no shared experts, a dense MLP


def jax_and_port(arch, key=0):
    jcfg = jax_smoke(arch)
    jm = JaxModel(jcfg, dtype=jnp.float32)
    params = jm.init(jax.random.key(key))
    tm = params_from_jax(jax.tree.map(np.asarray, params), port_config(jcfg),
                         device="cpu")
    return jcfg, jm, params, tm


def tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_model_logits_match_jax(arch):
    """forward / prefill / decode_step logits of the smoke model == JAX's,
    fp32, weights carried across by the bridge (stacked MoE layers)."""
    jcfg, jm, params, tm = jax_and_port(arch)
    assert {n.split(".", 3)[3] for n, _ in tm.named_parameters()
            if n.startswith("layers.0.moe.")} >= {"router", "w_gate", "w_up",
                                                  "w_down"}
    toks = tokens(1, 2, 17, jcfg.vocab_size)
    want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got = tm.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PARITY)

    jc = jm.init_cache(2, 32)
    jpre, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :16])}, jc)
    jdec, _ = jm.decode_step(params, jc, jnp.asarray(toks[:, 16:]))
    tc = tm.init_cache(2, 32)
    tpre, tc = tm.prefill(torch.from_numpy(toks[:, :16]), tc)
    tdec, tc = tm.decode_step(tc, torch.from_numpy(toks[:, 16:]))
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), **PARITY)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), **PARITY)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_decode_matches_forward(arch):
    """prefill(S) + decode(1) == forward(S + 1) at the last position, with a
    capacity that drops nothing (the JAX package's
    ``test_prefill_decode_matches_forward`` sets the same): prefill and
    decode route different token counts, so their capacities differ."""
    cfg = get_smoke_config(arch)
    cfg = dataclasses.replace(
        cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k + 1)
    model = Model(cfg, dtype=torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(tokens(4, 2, 18, cfg.vocab_size))
    cache = model.init_cache(2, 64)
    pre, cache = model.prefill(toks[:, :17], cache)
    np.testing.assert_allclose(pre[:, 0].numpy(),
                               model.forward(toks[:, :17])[:, -1].numpy(),
                               rtol=1e-4, atol=1e-4)
    dec, cache = model.decode_step(cache, toks[:, 17:])
    assert cache["len"] == 18
    np.testing.assert_allclose(dec[:, 0].numpy(),
                               model.forward(toks)[:, -1].numpy(), **DECODE)


def test_decode_capacity_drops_as_jax_does():
    """At decode deepseek-moe-16b's capacity is 8 slots an expert at every
    batch up to 32, as in JAX, so a popular expert can drop choices.  At
    the smoke size a decode-shaped call (32 tokens of one position) with 8
    slots an expert drops, and matches JAX."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    full = get_config("deepseek-moe-16b")
    for b in range(1, 33):
        assert tmoe.capacity(b, full) == jmoe.capacity(
            b, jax_config("deepseek-moe-16b")) == 8
    jcfg = smoke(cf=0.5)
    cfg = port_config(jcfg)
    assert tmoe.capacity(32, cfg) == 8
    params, layer = layer_pair(jcfg, key=5)
    x = inputs(6, 32, 1, jcfg.d_model)
    want, _ = jmoe.moe_apply(params, jnp.asarray(x), jcfg)
    got, _ = tmoe.moe_apply(layer, torch.from_numpy(x), cfg)
    _, keep = port_dispatch(layer, torch.from_numpy(x), cfg)
    assert not keep.all()  # 32 tokens x 2 choices into 4 experts x 8 slots
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
