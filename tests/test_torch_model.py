"""The port's dense decoder on the CPU against the JAX ``Model``.

JAX parameters come from ``Model.init(jax.random.key(k))`` and are carried
across by ``repro_torch.checkpoint.params_from_jax``; tokens come from
``np.random.default_rng``.  Model parity is held in fp32 (bf16 rounds at
other points in the two frameworks), at the tolerances of
``tests/test_kernel_integration.py`` and ``tests/test_models_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import save_checkpoint  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.checkpoint import load_jax_checkpoint, params_from_jax  # noqa: E402
from repro_torch.configs import (ARCH_IDS, NOT_YET_PORTED, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.models import Model, ModelConfig  # noqa: E402

DENSE = ("yi-9b", "chatglm3-6b", "command-r-35b", "stablelm-12b")
PARITY = dict(rtol=2e-4, atol=2e-4)


def port_config(jcfg) -> ModelConfig:
    """The port's config equal to a JAX config, less its JAX-only fields."""
    fields = dataclasses.asdict(jcfg)
    del fields["kernel_impl"], fields["analysis_unroll"]
    return ModelConfig(**fields)


def jax_and_port(jcfg, key, dtype=jnp.float32):
    """A JAX model with params from ``key`` and the port model holding them."""
    jm = JaxModel(jcfg, dtype=dtype)
    params = jm.init(jax.random.key(key))
    tm = params_from_jax(jax.tree.map(np.asarray, params), port_config(jcfg),
                         device="cpu")
    return jm, params, tm


def tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("arch,kernel_impl", [
    *[(a, "jnp") for a in DENSE], ("yi-9b", "interpret")])
def test_logits_match_jax(arch, kernel_impl):
    """forward / prefill / decode_step logits of the port == JAX, fp32."""
    jcfg = dataclasses.replace(jax_smoke(arch), kernel_impl=kernel_impl)
    jm, params, tm = jax_and_port(jcfg, key=0)
    toks = tokens(1, 2, 17, jcfg.vocab_size)
    want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got = tm.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(np32(got), np32(want), **PARITY)

    jc = jm.init_cache(2, 32)
    jpre, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :16])}, jc)
    jdec, _ = jm.decode_step(params, jc, jnp.asarray(toks[:, 16:]))
    tc = tm.init_cache(2, 32)
    tpre, tc = tm.prefill(torch.from_numpy(toks[:, :16]), tc)
    tdec, tc = tm.decode_step(tc, torch.from_numpy(toks[:, 16:]))
    assert tc["len"] == 17 and isinstance(tc["len"], int)
    np.testing.assert_allclose(np32(tpre), np32(jpre), **PARITY)
    np.testing.assert_allclose(np32(tdec), np32(jdec), **PARITY)


@pytest.mark.parametrize("arch", ["yi-9b", "stablelm-12b"])
def test_prefill_decode_matches_forward(arch):
    """The port's prefill(S) + decode(1) == its forward(S + 1), fp32."""
    cfg = get_smoke_config(arch)
    model = Model(cfg, dtype=torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(tokens(3, 2, 18, cfg.vocab_size))
    cache = model.init_cache(2, 64)
    pre, cache = model.prefill(toks[:, :17], cache)
    ref1 = model.forward(toks[:, :17])
    torch.testing.assert_close(pre[:, 0], ref1[:, -1], rtol=1e-4, atol=1e-4)
    dec, _ = model.decode_step(cache, toks[:, 17:])
    ref2 = model.forward(toks)
    torch.testing.assert_close(dec[:, 0], ref2[:, -1], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("prompt_len", [11, 16])
def test_ring_buffer_decode_after_prompt_longer_than_cache(prompt_len):
    """Prefill past an 8-slot ring cache, then decode one token: the logits
    equal JAX forward over all tokens with the same sliding window.

    The port writes position t at slot t % 8.  The JAX package writes the
    prompt's trailing window from slot 0, which the next decode write
    clobbers when prompt_len % 8 != 0 (11 here); 16 is the control, where
    the JAX prefill + decode agrees with its forward as well.
    """
    jcfg = dataclasses.replace(jax_smoke("yi-9b"), sliding_window=8)
    jm, params, tm = jax_and_port(jcfg, key=0)
    assert tm.cfg.sliding_window == 8
    toks = np.array(jax.random.randint(
        jax.random.key(1), (2, prompt_len + 1), 0, jcfg.vocab_size))
    want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    cache = tm.init_cache(2, prompt_len + 1, window=8)
    assert cache["layers"][0]["k"].shape[1] == 8
    _, cache = tm.prefill(torch.from_numpy(toks[:, :prompt_len]), cache)
    dec, _ = tm.decode_step(cache, torch.from_numpy(toks[:, prompt_len:]))
    np.testing.assert_allclose(np32(dec[:, 0]), np32(want[:, -1]),
                               rtol=1e-3, atol=1e-3)
    if prompt_len % 8 == 0:
        jc = jm.init_cache(2, prompt_len + 1, window=8)
        _, jc = jm.prefill(params, {"tokens": jnp.asarray(
            toks[:, :prompt_len])}, jc)
        jdec, _ = jm.decode_step(params, jc, jnp.asarray(toks[:, prompt_len:]))
        np.testing.assert_allclose(np32(jdec[:, 0]), np32(want[:, -1]),
                                   rtol=1e-3, atol=1e-3)


def test_ring_buffer_decode_token_by_token_matches_windowed_forward():
    """Decoding every token through an 8-slot ring equals forward with a
    window of 8 (the JAX ``test_sliding_window_decode...`` case)."""
    cfg = get_smoke_config("yi-9b")
    model = Model(cfg, dtype=torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(4))
    toks = torch.from_numpy(tokens(4, 1, 25, cfg.vocab_size))
    cache = model.init_cache(1, 25, window=8)
    for i in range(25):
        lg, cache = model.decode_step(cache, toks[:, i:i + 1])
    want = model.forward(toks, window_override=8)
    torch.testing.assert_close(lg[:, 0], want[:, -1], rtol=1e-4, atol=1e-4)


def test_bridge_carries_bf16_bits_exactly(tmp_path):
    """A bf16 JAX tree carried across directly, and one saved by the JAX
    package's ``save_checkpoint`` and read back with numpy only, give
    leaves bit-identical to each other and to JAX's."""
    jcfg = jax_smoke("yi-9b")
    params = JaxModel(jcfg, dtype=jnp.bfloat16).init(jax.random.key(5))
    tree = jax.tree.map(np.asarray, params)
    save_checkpoint(str(tmp_path), params, step=3)
    direct = params_from_jax(tree, get_smoke_config("yi-9b"), device="cpu")
    loaded = params_from_jax(load_jax_checkpoint(str(tmp_path), step=3),
                             get_smoke_config("yi-9b"), device="cpu")
    assert direct.dtype == torch.bfloat16
    a, b = direct.state_dict(), loaded.state_dict()
    assert a.keys() == b.keys() and len(a) == 3 + 9 * jcfg.n_layers
    for name, t in a.items():
        assert t.dtype == b[name].dtype
        bits = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(t.view(bits), b[name].view(bits)), name
    wq = np.asarray(params["layers"]["attn"]["wq"][1]).view(np.uint16)
    np.testing.assert_array_equal(
        a["layers.1.attn.wq"].view(torch.int16).numpy().view(np.uint16), wq)


def test_bridge_rejects_a_tree_of_another_shape():
    params = JaxModel(jax_smoke("stablelm-12b"),
                      dtype=jnp.float32).init(jax.random.key(0))
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax(jax.tree.map(np.asarray, params),
                        get_smoke_config("yi-9b"), device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_copies_of_the_jax_configs(arch):
    """Dense configs equal JAX's field by field (less the two JAX-only
    execution fields); the others name the slice that ports them."""
    if arch in NOT_YET_PORTED:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            get_config(arch)
        return
    for port, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch))):
        assert port == port_config(ref)
        assert port.padded_vocab == ref.padded_vocab
        assert port.param_count() == ref.param_count()


def test_model_init_fills_with_the_jax_scales():
    """Same distributions as the JAX init (not the same numbers)."""
    cfg = get_smoke_config("yi-9b")
    model = Model(cfg, dtype=torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    d, ff = cfg.d_model, cfg.d_ff
    for t, std in ((model.embed.tok, 0.02), (model.embed.head, d ** -0.5),
                   (model.layers[0].attn.wq, d ** -0.5),
                   (model.layers[1].mlp.w_down, ff ** -0.5)):
        assert abs(float(t.std()) / std - 1) < 0.05
    assert torch.equal(model.final_norm.scale, torch.ones(d))
    assert not any(p.requires_grad for p in model.parameters())


def test_cuda_entry_points_raise_where_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(get_smoke_config("yi-9b"))


def test_model_refuses_what_this_slice_does_not_serve():
    """Every arch type of ``ModelConfig`` is served; another is refused."""
    with pytest.raises(NotImplementedError, match="dense"):
        Model(dataclasses.replace(get_smoke_config("yi-9b"),
                                  arch_type="retrieval"), device="cpu")
    with pytest.raises(ValueError, match="empty cache"):
        model = Model(get_smoke_config("yi-9b"), device="cpu")
        cache = model.init_cache(1, 8)
        cache["len"] = 3
        model.prefill(torch.zeros(1, 2, dtype=torch.int32), cache)
