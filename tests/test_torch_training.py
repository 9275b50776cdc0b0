"""The port's training path on the CPU against the JAX package's.

The JAX package trains on its jnp path (``kernel_impl = "jnp"``, XLA's
autodiff): its Pallas kernels have no ``custom_vjp``, so ``jax.grad``
cannot go through them.  That path is the reference here.  Weights come
from the JAX ``Model.init`` through the bridge, inputs from numpy seeds;
everything is fp32 at the smoke size unless a test says otherwise.

Tolerances:
  * loss: rtol = atol = 2e-4, the logits' parity of
    ``tests/test_kernel_integration.py``;
  * gradients: |port - JAX| <= 1e-3 |JAX| + 2e-4 max |JAX leaf| per leaf
    (the two frameworks reduce over batch, sequence and width in other
    orders, so an element near zero is held to its leaf's scale);
  * AdamW: fp32 leaves and moments rtol 1e-5 / atol 1e-7 (the same
    arithmetic, fp32 rounding); a bf16 parameter within one bf16 rounding
    (rtol 2^-7), since an fp32 value one ulp apart may round either way;
  * the backward passes against autograd: the fp32 kernel tolerance of
    ``tests/test_kernels.py`` (1e-4 / 1e-5) for attention, the RG-LRU
    scan's (1e-5 / 1e-5).
"""
import dataclasses
import inspect
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as jax_load  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.training import optim as joptim  # noqa: E402
from repro.training.train import make_train_step as jax_train_step  # noqa: E402
from repro_torch.checkpoint import (load_jax_checkpoint,  # noqa: E402
                                    params_from_jax)
from repro_torch.checkpoint import store as tstore  # noqa: E402
from repro_torch.checkpoint.bridge import _jax_path, _leaf  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.data import token_batches  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import rglru_scan as trglru  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.training import optim as toptim  # noqa: E402
from repro_torch.training import train as ttrain_mod  # noqa: E402
from test_torch_model import jax_and_port, port_config, tokens  # noqa: E402

LOSS = dict(rtol=2e-4, atol=2e-4)
FP32 = dict(rtol=1e-4, atol=1e-5)       # test_kernels.py:19-21
SCAN = dict(rtol=1e-5, atol=1e-5)       # test_kernels.py:104
ADAM = dict(rtol=1e-5, atol=1e-7)
ADAM_BF16 = dict(rtol=2.0 ** -7, atol=0.0)

# one arch per family: dense, MoE (with its aux loss), SSM, hybrid, VLM
# (with its patches) and audio (with a label per frame)
FAMILIES = ("chatglm3-6b", "deepseek-moe-16b", "mamba2-780m",
            "recurrentgemma-2b", "internvl2-76b", "hubert-xlarge")


def make_batch(jcfg, seed, b=2, s=24) -> dict:
    """The JAX batch of ``jcfg``'s family, as numpy arrays."""
    rng = np.random.default_rng(seed)
    if jcfg.arch_type == "audio":
        return {"frame_embeds": rng.standard_normal(
                    (b, s, jcfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, jcfg.vocab_size, (b, s)).astype(
                    np.int32)}
    batch = {"tokens": tokens(seed, b, s, jcfg.vocab_size)}
    if jcfg.arch_type == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, jcfg.n_frontend_tokens, jcfg.d_model)).astype(np.float32)
    return batch


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_leaf_of(tree, cfg, name):
    """The JAX tree's array for the port parameter ``name``."""
    kinds = cfg.layer_types()
    path, layer = _jax_path(name, all(k == kinds[0] for k in kinds))
    leaf = np.asarray(_leaf(tree, path), np.float32)
    return leaf if layer is None else leaf[layer]


def assert_grad_close(got, want, name):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4 * scale,
                               err_msg=name)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch):
    """``Model.loss_fn`` (remat on) and every parameter's gradient against
    ``jax.value_and_grad(Model.loss_fn)`` on the same weights and batch;
    for the MoE family also the summed aux loss of ``forward``."""
    jcfg = jax_smoke(arch)
    jm, params, tm = jax_and_port(jcfg, key=0)
    batch = make_batch(jcfg, seed=3)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, as_jax(batch)))(params)
    tm.requires_grad_(True)
    loss = tm.loss_fn(as_torch(batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS)
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        assert_grad_close(p.grad.numpy(), jax_leaf_of(jgrads, jcfg, name),
                          name)
    if jcfg.arch_type == "moe":
        _, jaux = jm.forward(params, as_jax(batch))
        with torch.no_grad():
            _, aux = tm.forward(torch.from_numpy(batch["tokens"]),
                                with_aux=True)
        assert float(jaux) > 0
        np.testing.assert_allclose(float(aux), float(jaux), **LOSS)


def test_forward_without_aux_is_the_serving_forward():
    """Training's options leave the serving forward as it was: logits
    alone, equal with and without remat and aux."""
    cfg = jax_smoke("deepseek-moe-16b")
    _, _, tm = jax_and_port(cfg, key=1)
    toks = torch.from_numpy(tokens(2, 2, 16, cfg.vocab_size))
    with torch.inference_mode():
        plain = tm.forward(toks)
        logits, aux = tm.forward(toks, remat=True, with_aux=True)
    assert isinstance(plain, torch.Tensor) and aux.dtype == torch.float32
    torch.testing.assert_close(plain, logits, rtol=0, atol=0)
    assert not any(p.requires_grad for p in tm.parameters())


def test_moe_layer_is_called_through_its_module():
    """The blocks call the MoE layer as a module, serving and training
    alike, so a forward hook on it sees every call's input (the card's
    routing check reads them)."""
    cfg = jax_smoke("deepseek-moe-16b")
    _, _, tm = jax_and_port(cfg, key=5)
    seen = []
    for block in tm.layers:
        block.moe.register_forward_hook(
            lambda mod, args, out: seen.append(args[0].shape))
    toks = torch.from_numpy(tokens(3, 2, 16, cfg.vocab_size))
    with torch.inference_mode():
        tm.forward(toks)
    assert len(seen) == cfg.n_layers
    tm.requires_grad_(True)
    loss = tm.loss_fn({"tokens": toks})
    assert len(seen) == 2 * cfg.n_layers
    loss.backward()  # the recompute under remat may stop inside the layer


def test_remat_gives_the_same_gradients():
    """Each block recomputed in the backward (``torch.utils.checkpoint``)
    gives the gradients of the plain backward, bit for bit."""
    jcfg = jax_smoke("recurrentgemma-2b")
    _, _, tm = jax_and_port(jcfg, key=2)
    tm.requires_grad_(True)
    batch = as_torch(make_batch(jcfg, seed=4, s=80))  # past the window
    grads = []
    for remat in (True, False):
        tm.zero_grad(set_to_none=True)
        tm.loss_fn(batch, remat=remat).backward()
        grads.append([p.grad.clone() for p in tm.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -------------------------------------------------------------- optimizer --


def mixed_tree(seed):
    """A bf16 matrix, an fp32 vector and an fp32 scalar, as numpy fp32."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "s": np.float32(rng.standard_normal())}


DTYPES = {"w": (jnp.bfloat16, torch.bfloat16), "b": (jnp.float32,
                                                     torch.float32),
          "s": (jnp.float32, torch.float32)}


def test_adamw_update_matches_jax_over_three_steps():
    """Mixed bf16 / fp32 parameters, gradients large enough that the clip
    binds at every step: parameters, moments, step, grad norm and learning
    rate after each of 3 steps."""
    cfg = joptim.OptimConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                             clip_norm=1.0)
    init = mixed_tree(0)
    jp = {k: jnp.asarray(v, DTYPES[k][0]) for k, v in init.items()}
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(DTYPES[k][1])
          for k, v in init.items()}
    jstate, tstate = joptim.adamw_init(jp), toptim.adamw_init(tp)
    tcfg = toptim.OptimConfig(**dataclasses.asdict(cfg))
    for step in range(3):
        g = {k: v * 10.0 for k, v in mixed_tree(step + 1).items()}
        jg = {k: jnp.asarray(v, DTYPES[k][0]) for k, v in g.items()}
        tg = {k: torch.from_numpy(np.array(v, np.float32)).to(DTYPES[k][1])
              for k, v in g.items()}
        jp, jstate, jm = joptim.adamw_update(jp, jg, jstate, cfg)
        tm = toptim.adamw_update(tp, tg, tstate, tcfg)
        assert float(jm["grad_norm"]) > cfg.clip_norm  # the clip binds
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), **ADAM)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **ADAM)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        for k in init:
            tol = ADAM_BF16 if k == "w" else ADAM
            assert tp[k].dtype == DTYPES[k][1]
            np.testing.assert_allclose(tp[k].float().numpy(),
                                       np.asarray(jp[k], np.float32), **tol)
            for mom in ("m", "v"):
                assert tstate[mom][k].dtype == torch.float32
                np.testing.assert_allclose(tstate[mom][k].numpy(),
                                           np.asarray(jstate[mom][k]),
                                           **ADAM)


def test_schedule_matches_jax_at_every_step():
    cfg = joptim.OptimConfig(lr=0.3, warmup_steps=5, total_steps=20)
    tcfg = toptim.OptimConfig(**dataclasses.asdict(cfg))
    for step in range(0, 26):
        want = float(joptim.schedule(cfg, jnp.array(step)))
        got = toptim.schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)
    # the floor: 0.1 of the peak after the decay
    assert float(toptim.schedule(tcfg, 20)) == pytest.approx(0.03)


def test_global_norm_matches_jax():
    tree = mixed_tree(7)
    want = float(joptim.global_norm({k: jnp.asarray(v, DTYPES[k][0])
                                     for k, v in tree.items()}))
    got = toptim.global_norm({k: torch.from_numpy(np.array(v)).to(
        DTYPES[k][1]) for k, v in tree.items()})
    np.testing.assert_allclose(float(got), want, **ADAM)
    assert float(toptim.global_norm({"a": torch.tensor([3.0]),
                                     "b": torch.tensor([4.0])})) == 5.0


def test_train_step_matches_jax():
    """One step of the port's ``train_step`` against JAX's
    ``make_train_step`` on smoke chatglm3-6b (fp32): loss, grad norm,
    learning rate and every parameter after the update."""
    jcfg = jax_smoke("chatglm3-6b")
    jm, params, tm = jax_and_port(jcfg, key=3)
    cfg = joptim.OptimConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batch = make_batch(jcfg, seed=5, s=32)
    jparams, _, jmetrics = jax_train_step(jm, cfg)(
        params, joptim.adamw_init(params), as_jax(batch))
    step = ttrain_mod.make_train_step(
        tm, toptim.OptimConfig(**dataclasses.asdict(cfg)))
    metrics = step(batch)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(jmetrics[key]), **LOSS)
    assert int(step.state["step"]) == 1
    for name, p in tm.named_parameters():
        assert p.grad is None  # freed after the update
        np.testing.assert_allclose(p.detach().numpy(),
                                   jax_leaf_of(jparams, jcfg, name),
                                   **LOSS, err_msg=name)


def test_port_learns_synthetic_lm():
    """The port's ``tests/test_training.py::test_training_learns_synthetic_lm``:
    the same model, data, schedule and bar, bf16 on the CPU."""
    cfg = port_config(jax_smoke("chatglm3-6b"))
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batches = token_batches(cfg.vocab_size, batch=8, seq=64, n_steps=40,
                            seed=5)
    state, hist = ttrain_mod.train_loop(
        model, batches, toptim.OptimConfig(lr=1e-3, warmup_steps=10,
                                           total_steps=40),
        log_every=20, log_fn=lambda *_: None)
    assert [h["step"] for h in hist] == [20, 40]
    assert all(h["ms_per_step"] > 0 and h["tokens_per_s"] > 0 for h in hist)
    assert int(state["step"]) == 40
    assert hist[-1]["loss"] < math.log(cfg.vocab_size) - 0.3


# ------------------------------------------------------- backward passes --


def randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("s", [1, 37, 70])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("a_range", [(0.8, 1.0), (0.999, 1.0), (0.0, 0.01)])
def test_rglru_reverse_scan_matches_autograd(s, with_h0, a_range):
    """``rglru_scan_backward`` through ``rglru_scan_torch`` (the algebra
    the kernel runs on the card) against autograd of the recurrence:
    ragged lengths (chunks of 32), with and without h0, a near 1 and 0."""
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(*a_range, (2, s, 8)).astype(np.float32))
    b = randn(rng, 2, s, 8)
    h0 = randn(rng, 2, 8) if with_h0 else None
    g_seq, g_last = randn(rng, 2, s, 8), randn(rng, 2, 8)
    leaves = [t.clone().requires_grad_(True) for t in (a, b)]
    if with_h0:
        leaves.append(h0.clone().requires_grad_(True))
    outs = trglru.rglru_scan_torch(leaves[0], leaves[1],
                                   leaves[2] if with_h0 else None)
    want = torch.autograd.grad(outs, leaves, (g_seq, g_last))
    got = trglru.rglru_scan_backward(trglru.rglru_scan_torch, a, outs[0]
                                     .detach(), h0, g_seq, g_last)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **SCAN)
    # the autograd Function routes the CPU gradient through the same
    leaves2 = [t.clone().requires_grad_(True) for t in leaves]
    from repro_torch.kernels import ops
    outs2 = ops.rglru_scan(*leaves2[:2], leaves2[2] if with_h0 else None)
    again = torch.autograd.grad(outs2, leaves2, (g_seq, g_last))
    for g, w in zip(again, want):
        torch.testing.assert_close(g, w, **SCAN)


def rglru_bwd_chunk_emulation(a, h_seq, h0, g_seq, g_last, rng,
                              t=trglru.CHUNK):
    """The backward entry's arithmetic (``csrc/rglru_scan.cu``, REV) on
    the CPU: chunks walked from the last, each step's coefficient read as
    a_{t+1} (0 at t = S - 1) and its input as g_t (g_last added at
    t = S - 1), straight from the tensors; each chunk's aggregate over its
    steps in reverse; its carry folded from the end state of an earlier
    position j of the walk (-1: zero) and the aggregates between, j drawn
    from ``rng`` as a look-back may find it; then its steps re-run from
    the carry, writing db_t = G_t and da_t = G_t h_{t-1} (h0 or 0 at
    t = 0); dh0 = a_0 G_0."""
    bsz, s, w = a.shape
    zero = torch.zeros(bsz, w)

    def coef(u):
        return a[:, u + 1] if u + 1 < s else zero

    def inp(u):
        return g_seq[:, u] + g_last if u == s - 1 else g_seq[:, u]

    n_chunks = -(-s // t)
    aggs, ends = [], []
    da, db = torch.empty(bsz, s, w), torch.empty(bsz, s, w)
    for k in range(n_chunks):
        c = n_chunks - 1 - k
        steps = range(c * t, min(s, (c + 1) * t))
        prod, end = torch.ones(bsz, w), zero
        for u in reversed(steps):
            prod, end = prod * coef(u), coef(u) * end + inp(u)
        aggs.append((prod, end))
        j = int(rng.integers(-1, k)) if k else -1
        grad = ends[j] if j >= 0 else zero
        for p_, e_ in aggs[j + 1:k]:
            grad = p_ * grad + e_
        ends.append(prod * grad + end)
        for u in reversed(steps):
            grad = coef(u) * grad + inp(u)
            db[:, u] = grad
            prev = (h_seq[:, u - 1] if u > 0 else
                    zero if h0 is None else h0)
            da[:, u] = grad * prev
    return da, db, a[:, 0] * grad


@pytest.mark.parametrize("s", [1, 31, 32, 33, 150])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("a_range", [(0.8, 1.0), (0.999, 1.0), (0.0, 0.01)])
def test_rglru_fused_backward_algebra_matches_jax_vjp(s, with_h0, a_range):
    """The index algebra of the fused backward kernel (the shifted a,
    g_last folded in at t = S - 1, h_{t-1} with h0, chunks of 32 walked
    from the end with their look-back) against ``jax.vjp`` of the JAX
    reference recurrence ``ref.rglru_scan_ref``, at the scan tolerance."""
    rng = np.random.default_rng(s + 300)
    a = rng.uniform(*a_range, (2, s, 8)).astype(np.float32)
    b = (rng.standard_normal((2, s, 8)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32) if with_h0 else None
    g_seq = rng.standard_normal((2, s, 8)).astype(np.float32)
    g_last = rng.standard_normal((2, 8)).astype(np.float32)
    prim = [jnp.asarray(v) for v in (a, b) + ((h0,) if with_h0 else ())]
    (h_seq, _), vjp = jax.vjp(jref.rglru_scan_ref, *prim)
    want = vjp((jnp.asarray(g_seq), jnp.asarray(g_last)))
    got = rglru_bwd_chunk_emulation(
        torch.from_numpy(a), torch.from_numpy(np.array(h_seq)),
        None if h0 is None else torch.from_numpy(h0),
        torch.from_numpy(g_seq), torch.from_numpy(g_last), rng)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SCAN)


FLASH_BWD_CASES = [
    (2, 4, 2, 77, 64, True, None),     # causal, GQA, ragged S
    (2, 4, 2, 130, 64, True, 40),      # windowed
    (1, 4, 1, 70, 160, False, None),   # full, Dh 160 padded to 192
    (2, 2, 2, 50, 80, False, 16),      # window without a causal mask
    (1, 10, 1, 100, 256, True, 64),    # recurrentgemma's heads
    (1, 10, 1, 260, 256, True, 100),   # 64-row tiles at Dh 256, the window
                                       # binding across them
]


def bf16_rows_err(got, want) -> float:
    """Worst error at the card's bf16 gradient check: |got - want| / (row
    RMS + |want|), the RMS over Dh floored at 1e-2 of the tensor's (it
    must stay below 3e-2)."""
    w = want.float()
    floor = 1e-2 * float(w.pow(2).mean().sqrt())
    rms = w.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(floor)
    return float(((got.float() - w).abs() / (rms + w.abs())).max())


def flash_grad_case(b, h, hkv, s, dh, causal, window, dtype):
    """q, k, v (from (B, S, H, Dh) storage), dO, and autograd's gradients
    of ``flash_attention_torch`` on them."""
    rng = np.random.default_rng(dh + s)
    q, k, v = (randn(rng, b, s, n, dh).to(dtype).transpose(1, 2)
               for n in (h, hkv, hkv))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = tflash.flash_attention_torch(*leaves, causal=causal, window=window)
    do = randn(rng, b, h, s, dh).to(dtype)
    return (q, k, v, do), torch.autograd.grad(o, leaves, do)


@pytest.mark.parametrize("b,h,hkv,s,dh,causal,window", FLASH_BWD_CASES)
def test_flash_backward_tiles_match_autograd(b, h, hkv, s, dh, causal,
                                             window):
    """The plain emulation of the backward kernels' tile algorithm (per
    query tile lse and D, then dQ; per query head and key tile dK / dV,
    summed over the group's heads) in fp32 against autograd of
    ``flash_attention_torch``."""
    inputs, want = flash_grad_case(b, h, hkv, s, dh, causal, window,
                                   torch.float32)
    got = tflash.flash_attention_bwd_tiles(*inputs, causal=causal,
                                           window=window)
    for g, w, x in zip(got, want, inputs):
        assert g.shape == x.shape
        torch.testing.assert_close(g, w, **FP32)


@pytest.mark.parametrize("b,h,hkv,s,dh,causal,window", FLASH_BWD_CASES)
def test_flash_backward_tiles_in_bf16_match_autograd(b, h, hkv, s, dh,
                                                     causal, window):
    """The same in bf16, P and dS rounded to bf16 before the products as
    the tensor-core kernels round them, against autograd of the plain
    version on the same bf16 inputs at the card's bf16 check; and the
    rounding is there (the fp32 emulation of the same values differs)."""
    inputs, want = flash_grad_case(b, h, hkv, s, dh, causal, window,
                                   torch.bfloat16)
    got = tflash.flash_attention_bwd_tiles(*inputs, causal=causal,
                                           window=window)
    for g, w, x in zip(got, want, inputs):
        assert g.shape == x.shape and g.dtype == torch.bfloat16
        assert bf16_rows_err(g, w) < 3e-2
    unrounded = tflash.flash_attention_bwd_tiles(
        *(t.float() for t in inputs), causal=causal, window=window)
    assert not torch.equal(got[0].float(), unrounded[0].bfloat16().float())


def test_flash_backward_tiles_in_bf16_hold_cancelling_rows():
    """bf16 inputs, causal: the emulation (D = rowsum(P * dP), summed in
    fp32) against autograd of the plain version, at the card's bf16 check
    (3e-2 on values divided by their row's RMS, floored at 1e-2 of the
    tensor's).  D = rowsum(dO * O) with O rounded to bf16, as a forward
    kernel hands it over, misses in rows whose gradient cancels: shown
    here on the same inputs."""
    rng = np.random.default_rng(148)
    q, k, v = (randn(rng, 2, 77, n, 64).bfloat16().transpose(1, 2)
               for n in (8, 2, 2))
    do = randn(rng, 2, 77, 8, 64).bfloat16().transpose(1, 2)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = tflash.flash_attention_torch(*leaves)
    want = torch.autograd.grad(o, leaves, do)

    got = tflash.flash_attention_bwd_tiles(q, k, v, do)
    assert max(bf16_rows_err(g, w) for g, w in zip(got, want)) < 3e-2
    # the same dq with D from the bf16 output
    qf, kf, vf = (t.float().repeat_interleave(4 if t is not q else 1, 1)
                  for t in (q, k, v))
    logits = (qf @ kf.transpose(-1, -2)) / 8.0
    mask = torch.ones(77, 77, dtype=torch.bool).tril()
    p = torch.softmax(logits.masked_fill(~mask, -1e30), -1)
    dp = do.float() @ vf.transpose(-1, -2)
    d_from_o = (do.float() * o.detach().float()).sum(-1, keepdim=True)
    dq_from_o = (p * (dp - d_from_o) / 8.0) @ kf
    assert bf16_rows_err(dq_from_o, want[0]) > 3e-2


# ------------------------------------------------------------ checkpoint --


@pytest.mark.parametrize("arch", ["yi-9b", "recurrentgemma-2b"])
def test_port_checkpoint_is_read_by_jax(arch, tmp_path):
    """A checkpoint the port writes (stacked layers for yi-9b, the
    hybrid's per-layer list for recurrentgemma-2b) has the JAX writer's
    manifest entries for the same weights, is read by the JAX
    ``load_checkpoint`` into the JAX model, whose forward gives the port's
    logits, and reads back through the bridge to the same weights."""
    jcfg = jax_smoke(arch)
    jm, params, _ = jax_and_port(jcfg, key=4)
    # the port trains a step first, so the weights are its own
    cfg = port_config(jcfg)
    tm = Model(cfg, dtype=torch.float32, device="cpu").init(
        torch.Generator().manual_seed(4))
    ttrain_mod.make_train_step(tm, toptim.OptimConfig())(
        make_batch(jcfg, seed=6))
    tm.requires_grad_(False)
    tstore.save_checkpoint(str(tmp_path / "port"), tm, step=1)
    back = jax_load(str(tmp_path / "port"), jm.param_shapes(), step=1)
    toks = tokens(7, 2, 20, jcfg.vocab_size)
    want, _ = jm.forward(back, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = tm.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS)

    # the JAX writer on the same weights: the same entries and bytes
    jax_save(str(tmp_path / "jax"), back, step=1)
    manifests = [json.loads((tmp_path / d / "ckpt_1.json").read_text())
                 for d in ("port", "jax")]
    assert manifests[0]["entries"] == manifests[1]["entries"]
    assert manifests[0]["step"] == 1
    assert tstore.manifest_nbytes(str(tmp_path / "port"), 1) == \
        jstore.manifest_nbytes(str(tmp_path / "jax"), 1)
    tree = load_jax_checkpoint(str(tmp_path / "port"), step=1)
    again = params_from_jax(tree, cfg, device="cpu")
    for (n, a), b in zip(again.state_dict().items(),
                         tm.state_dict().values()):
        assert torch.equal(a, b), n


def test_bf16_checkpoint_round_trips_bits(tmp_path):
    """bf16 leaves stored as uint16 views: the JAX reader and the bridge
    both get the port's bits back."""
    jcfg = jax_smoke("chatglm3-6b")
    tm = Model(port_config(jcfg), dtype=torch.bfloat16, device="cpu").init(
        torch.Generator().manual_seed(8))
    tstore.save_checkpoint(str(tmp_path), tm, step=None)
    entries = json.loads((tmp_path / "ckpt.json").read_text())["entries"]
    assert {e["dtype"] for e in entries} == {"bfloat16", "float32"}
    back = jax_load(str(tmp_path), JaxModel(jcfg).param_shapes())
    for name, p in tm.named_parameters():
        want = jax_leaf_of(back, jcfg, name)
        assert np.array_equal(p.float().numpy(), want), name
    again = params_from_jax(load_jax_checkpoint(str(tmp_path)),
                            port_config(jcfg), device="cpu")
    for a, b in zip(again.parameters(), tm.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_copied_functions_are_the_jax_ones():
    """``entry_nbytes``, ``manifest_nbytes`` and ``mini_config`` are
    copies, and the mini configs agree for every arch."""
    for fn in ("entry_nbytes", "manifest_nbytes"):
        assert inspect.getsource(getattr(tstore, fn)) == \
            inspect.getsource(getattr(jstore, fn))
    assert inspect.getsource(ttrain.mini_config) == \
        inspect.getsource(jtrain.mini_config)
    for arch in ARCH_IDS:
        assert ttrain.mini_config(arch) == port_config(
            jtrain.mini_config(arch))


# -------------------------------------------------------- the launcher --


def get_port(arch):
    from repro_torch.configs import get_smoke_config
    return get_smoke_config(arch)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-780m"])
def test_launch_train_on_the_cpu(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu --preset smoke``:
    a line per step with loss, grad norm, ms and tokens/s, the peak memory
    line, and a checkpoint the bridge reads (mamba2-780m: through the SSD
    scan's ``SSDScan``)."""
    assert ttrain.main(["--arch", arch, "--preset", "smoke",
                        "--device", "cpu", "--steps", "3", "--batch", "2",
                        "--seq", "16", "--checkpoint-dir",
                        str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    steps = [line for line in out if line.startswith("step ")]
    assert len(steps) == 3
    for line in steps:
        assert "loss=" in line and "grad_norm=" in line
        assert "ms/step" in line and "tokens/s" in line
    assert any(line.startswith("peak device memory: not measured")
               for line in out)
    tree = load_jax_checkpoint(str(tmp_path), step=3)
    params_from_jax(tree, get_port(arch), device="cpu")


def test_launch_train_refusals():
    """The audio encoder is refused (as in JAX); an SSM trains on the card
    as on the CPU (the SSD scan has its backward kernel); without a card
    the card is refused, never replaced by the CPU."""
    with pytest.raises(SystemExit, match="encoder"):
        ttrain.main(["--arch", "hubert-xlarge", "--preset", "smoke",
                     "--device", "cpu"])
    assert ttrain.refusal(get_port("mamba2-780m"), "cuda") is None
    assert ttrain.refusal(get_port("mamba2-780m"), "cpu") is None
    assert ttrain.refusal(get_port("recurrentgemma-2b"), "cuda") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.main(["--arch", "yi-9b", "--preset", "smoke",
                         "--steps", "1"])
