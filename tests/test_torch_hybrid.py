"""The port's hybrid slice (recurrentgemma) on the CPU against the JAX
package.

``rglru_scan_torch``, the plain version of the CUDA kernel
``csrc/rglru_scan.cu``, is held against the JAX Pallas ``rglru_scan`` in
interpret mode and against the oracle ``ref.rglru_scan_ref`` at the
tolerance of ``tests/test_kernels.py::test_rglru_scan`` (1e-5); the
attention plain versions at recurrentgemma's head shape (Dh 256, ten query
heads on one KV head) at the kernel tolerances of ``tests/test_kernels.py``.
The RG-LRU block and the whole model are held against JAX in fp32 at the
tolerances of ``tests/test_kernel_integration.py`` (2e-4) and
``tests/test_models_smoke.py`` (1e-3 for prefill + decode vs forward).
Decoding past the local window is held against JAX's windowed
``forward``, not its ``prefill``, whose ring write differs (the port
writes position t at slot t % size).
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import save_checkpoint  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.checkpoint import load_jax_checkpoint, params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as trglru  # noqa: E402
from repro_torch.models import Model, ModelConfig  # noqa: E402
from repro_torch.models import rglru as tmrglru  # noqa: E402
from repro_torch.models.layers import causal_conv  # noqa: E402

SCAN = dict(rtol=1e-5, atol=1e-5)    # test_kernels.py:104
PARITY = dict(rtol=2e-4, atol=2e-4)  # test_kernel_integration.py:24
DECODE = dict(rtol=1e-3, atol=1e-3)  # test_models_smoke.py:113


def kernel_tol(dtype):                # test_kernels.py:19-21
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-5)


def port_config(jcfg) -> ModelConfig:
    fields = dataclasses.asdict(jcfg)
    del fields["kernel_impl"], fields["analysis_unroll"]
    return ModelConfig(**fields)


def np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def scan_inputs(seed, b, s, w):
    """The distributions of the JAX ``test_rglru_scan``, drawn with numpy."""
    rng = np.random.default_rng(seed)
    a = 1 / (1 + np.exp(-rng.standard_normal((b, s, w)))) * 0.2 + 0.8
    bb = rng.standard_normal((b, s, w)) * 0.1
    h0 = rng.standard_normal((b, w))
    return (a.astype(np.float32), bb.astype(np.float32),
            h0.astype(np.float32))


# ------------------------------------------------------------- kernels ----


@pytest.mark.parametrize("b,s,w,blk", [
    (2, 512, 256, 128),
    (1, 256, 2560, 256),
    (3, 128, 128, 128),
])
def test_rglru_plain_matches_pallas_and_ref(b, s, w, blk):
    a, bb, h0 = scan_inputs(0, b, s, w)
    h, h_last = trglru.rglru_scan_torch(torch.from_numpy(a),
                                        torch.from_numpy(bb))
    assert h.dtype == torch.float32 and h.shape == (b, s, w)
    pallas = pallas_rglru(jnp.asarray(a), jnp.asarray(bb), block_t=blk,
                          interpret=True)
    want, want_last = ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(bb))
    np.testing.assert_allclose(np32(h), np32(pallas), **SCAN)
    np.testing.assert_allclose(np32(h), np32(want), **SCAN)
    np.testing.assert_allclose(np32(h_last), np32(want_last), **SCAN)
    # with an initial state, and any S
    h, h_last = trglru.rglru_scan_torch(torch.from_numpy(a[:, :s - 3]),
                                        torch.from_numpy(bb[:, :s - 3]),
                                        torch.from_numpy(h0))
    want, want_last = ref.rglru_scan_ref(
        jnp.asarray(a[:, :s - 3]), jnp.asarray(bb[:, :s - 3]),
        jnp.asarray(h0))
    np.testing.assert_allclose(np32(h), np32(want), **SCAN)
    np.testing.assert_allclose(np32(h_last), np32(want_last), **SCAN)


def rglru_chunk_emulation(a, b, h0, rng, t=trglru.CHUNK):
    """The arithmetic of the kernel (``csrc/rglru_scan.cu``) on the CPU,
    chunks of ``t`` steps: each chunk's aggregate from zero, (prod a,
    h_end); its carry folded from the end state of an earlier chunk j (-1:
    h0) and the aggregates between, as its look-back finds them (j drawn
    from ``rng``: any j gives the same carry up to rounding); then its
    steps re-run from the carry, and its end state published."""
    bsz, s, w = a.shape
    n_chunks = -(-s // t)
    aggs, ends = [], []
    out = torch.empty(bsz, s, w)
    for c in range(n_chunks):
        steps = range(c * t, min(s, (c + 1) * t))
        prod, end = torch.ones(bsz, w), torch.zeros(bsz, w)
        for u in steps:
            prod, end = prod * a[:, u], a[:, u] * end + b[:, u]
        aggs.append((prod, end))
        j = int(rng.integers(-1, c)) if c else -1
        h = (ends[j] if j >= 0 else torch.zeros(bsz, w) if h0 is None
             else h0.clone())
        for p_, e_ in aggs[j + 1:c]:
            h = p_ * h + e_
        ends.append(prod * h + end)
        for u in steps:
            h = a[:, u] * h + b[:, u]
            out[:, u] = h
    return out, h


def chunk_case(s, a_range):
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(*a_range, (2, s, 64))
                         .astype(np.float32))
    bb = torch.from_numpy(rng.standard_normal((2, s, 64), np.float32)
                          * 0.1)
    h0 = torch.from_numpy(rng.standard_normal((2, 64), np.float32))
    return rng, a, bb, h0


@pytest.mark.parametrize("a_range", [(0.8, 1.0), (0.999, 1.0), (0.0, 0.01)])
@pytest.mark.parametrize("s", [130, 300, 1000])
def test_rglru_chunk_algebra_matches_plain_version(s, a_range):
    """Aggregates, carry fold and re-scan at the kernel's chunk length, S a
    multiple of no chunk, an initial state, a in the serving range, near 1
    (the carry is nearly the whole state) and near 0 (the carry vanishes):
    within the scan tolerance of the sequential recurrence."""
    rng, a, bb, h0 = chunk_case(s, a_range)
    assert s % trglru.CHUNK
    got = rglru_chunk_emulation(a, bb, h0, rng)
    want = trglru.rglru_scan_torch(a, bb, h0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np32(g), np32(w), **SCAN)


def test_rglru_chunk_algebra_over_long_memory_is_as_exact_as_plain():
    """2500 steps with a near 1: the fp32 rounding of any order of the
    recurrence drifts like a random walk.  Held against the recurrence in
    float64, the chunk algebra (79 chunks) stays within the scan tolerance
    and no further off than the plain version's own step-by-step fp32."""
    rng, a, bb, h0 = chunk_case(2500, (0.999, 1.0))
    h = h0.double()
    exact = torch.empty(a.shape, dtype=torch.float64)
    for t in range(a.shape[1]):
        h = a[:, t].double() * h + bb[:, t].double()
        exact[:, t] = h
    got, _ = rglru_chunk_emulation(a, bb, h0, rng)
    plain, _ = trglru.rglru_scan_torch(a, bb, h0)
    np.testing.assert_allclose(np32(got), np32(exact), **SCAN)
    assert float((got.double() - exact).abs().max()) <= float(
        (plain.double() - exact).abs().max())


@pytest.mark.parametrize("s,w", [(1, 2560), (1000, 2560), (4096, 2561),
                                 (33, 7)])
def test_rglru_scratch_covers_both_lane_widths(s, w):
    """The wrapper's scratch holds a status for every (row, chunk, tile)
    whether a thread takes two lanes or one, the counter, and three floats
    a lane a chunk."""
    n_status, n_values = trglru.scratch_sizes(4, s, w)
    n_chunks = -(-s // trglru.CHUNK)
    for lanes in (1, 2):
        tiles = -(-w // (trglru.THREADS * lanes))
        assert n_status >= 4 * n_chunks * tiles + 1
    assert n_values == 3 * 4 * n_chunks * w


def test_ops_routes_rglru_scan_by_device():
    a, bb, h0 = (torch.from_numpy(x) for x in scan_inputs(1, 2, 9, 16))
    before = trglru.launches
    for got, want in zip(ops.rglru_scan(a, bb, h0),
                         trglru.rglru_scan_torch(a, bb, h0)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert trglru.launches == before
    # meta is priced, not computed: the plain version's shapes and dtypes
    for got, want in zip(ops.rglru_scan(a.to("meta"), bb.to("meta")),
                         trglru.rglru_scan_torch(a, bb)):
        assert (got.device.type, got.shape, got.dtype) == (
            "meta", want.shape, want.dtype)
    assert trglru.launches == before
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no implementation"):
        ops.rglru_scan(other, bb)
    with pytest.raises(ValueError, match="not a CUDA device"):
        trglru.rglru_scan_cuda(a, bb, h0)


def attn_inputs(seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    out = []
    for shape in shapes:
        j = jnp.asarray(rng.standard_normal(shape, np.float32), jdt)
        out.append((j, torch.from_numpy(np.array(j, np.float32)).to(tdt)))
    return out


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_at_the_hybrid_head_shape(window, dtype):
    """Flash and decode plain versions at Dh 256 with ten query heads on
    one KV head, against the Pallas kernels and the oracles."""
    (jq, tq), (jk, tk), (jv, tv) = attn_inputs(
        0, dtype, (1, 10, 128, 256), (1, 1, 128, 256), (1, 1, 128, 256))
    got = tflash.flash_attention_torch(tq, tk, tv, causal=True,
                                       window=window)
    for want in (pallas_flash(jq, jk, jv, causal=True, window=window,
                              interpret=True),
                 ref.flash_attention_ref(jq, jk, jv, causal=True,
                                         window=window)):
        np.testing.assert_allclose(np32(got), np32(want), **kernel_tol(dtype))
    (jq, tq), (jk, tk), (jv, tv) = attn_inputs(
        1, dtype, (2, 10, 256), (2, 256, 1, 256), (2, 256, 1, 256))
    lengths = np.asarray([256, 77], np.int32)
    got = tdecode.decode_attention_torch(tq, tk, tv,
                                         torch.from_numpy(lengths),
                                         window=window)
    jl = jnp.asarray(lengths)
    for want in (pallas_decode(jq, jk, jv, jl, window=window,
                               interpret=True),
                 ref.decode_attention_ref(jq, jk, jv, jl, window=window)):
        np.testing.assert_allclose(np32(got), np32(want), **kernel_tol(dtype))


def test_decode_split_plan_with_one_kv_head():
    """recurrentgemma at batch 4 has four (row, KV head) pairs of ten query
    heads, served in two blocks of five: eight blocks before splitting, so
    the cache takes the most splits one cluster holds (16) at 1032 slots,
    with the 2048-slot ring full and past it, every slot in exactly one
    split."""
    for s, want in ((1032, (16, 65)), (2048, (16, 128)), (2100, (16, 132))):
        n_split, chunk = tdecode.split_plan(4, 1, s, 10)
        assert (n_split, chunk) == want
        assert n_split * chunk >= s > (n_split - 1) * chunk


# --------------------------------------------------------------- model ----


def jax_and_port(jcfg, key, dtype=jnp.float32):
    jm = JaxModel(jcfg, dtype=dtype)
    params = jm.init(jax.random.key(key))
    tm = params_from_jax(jax.tree.map(np.asarray, params), port_config(jcfg),
                         device="cpu")
    return jm, params, tm


def tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("jax_conv", ["ssm._causal_conv", "rglru._conv"])
def test_causal_conv_matches_jax(jax_conv, with_state):
    """The port's one causal conv against both JAX copies (the SSM one
    applies silu), in fp32 at 1e-6; and the S = 1 decode form, stepped
    token by token, against the sequence form."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = (rng.standard_normal((4, 16)) / 4).astype(np.float32)
    st = (rng.standard_normal((2, 3, 16)).astype(np.float32) if with_state
          else None)
    if jax_conv == "ssm._causal_conv":
        want, want_st = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                          None if st is None else
                                          jnp.asarray(st))
    else:
        want, want_st = jrglru._conv({"conv": jnp.asarray(w)},
                                     jnp.asarray(x), None if st is None
                                     else jnp.asarray(st))
    tw = torch.from_numpy(w)
    got, got_st = causal_conv(torch.from_numpy(x), tw,
                              None if st is None else torch.from_numpy(st))
    if jax_conv == "ssm._causal_conv":
        got = torch.nn.functional.silu(got)
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np32(got), np32(want), **tol)
    np.testing.assert_allclose(np32(got_st), np32(want_st), **tol)
    state = (torch.zeros(2, 3, 16) if st is None else torch.from_numpy(st))
    steps = []
    for t in range(x.shape[1]):
        out, state = causal_conv(torch.from_numpy(x[:, t:t + 1]), tw, state)
        steps.append(out)
    seq, seq_st = causal_conv(torch.from_numpy(x), tw,
                              None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(np32(torch.cat(steps, 1)), np32(seq), **tol)
    np.testing.assert_allclose(np32(state), np32(seq_st), **tol)


def test_rglru_block_and_decode_step_match_jax():
    """rglru_apply from zero and from a carried state, and
    rglru_decode_step, against the JAX functions in fp32."""
    jcfg = jax_smoke("recurrentgemma-2b")
    _, params, tm = jax_and_port(jcfg, key=0)
    jp, tp, cfg = params["layers"][0]["rglru"], tm.layers[0].rglru, tm.cfg
    x = np.random.default_rng(4).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32)
    want, jstate = jrglru.rglru_apply(jp, jnp.asarray(x[:, :13]), jcfg)
    got, state = tmrglru.rglru_apply(tp, torch.from_numpy(x[:, :13]), cfg)
    np.testing.assert_allclose(np32(got), np32(want), **PARITY)
    for k in ("conv", "h"):
        np.testing.assert_allclose(np32(state[k]), np32(jstate[k]), **PARITY)
    want, jstate = jrglru.rglru_apply(jp, jnp.asarray(x[:, 13:20]), jcfg,
                                      jstate)
    got, state = tmrglru.rglru_apply(tp, torch.from_numpy(x[:, 13:20]), cfg,
                                     state)
    np.testing.assert_allclose(np32(got), np32(want), **PARITY)
    want, jstate = jrglru.rglru_decode_step(jp, jnp.asarray(x[:, 20:]), jcfg,
                                            jstate)
    got, state = tmrglru.rglru_decode_step(tp, torch.from_numpy(x[:, 20:]),
                                           cfg, state)
    np.testing.assert_allclose(np32(got), np32(want), **PARITY)
    np.testing.assert_allclose(np32(state["h"]), np32(jstate["h"]), **PARITY)


def test_recurrentgemma_logits_match_jax():
    """forward / prefill / decode_step of the port == JAX, fp32."""
    jcfg = jax_smoke("recurrentgemma-2b")
    jm, params, tm = jax_and_port(jcfg, key=1)
    toks = tokens(5, 2, 23, jcfg.vocab_size)
    want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got = tm.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(np32(got), np32(want), **PARITY)
    jc = jm.init_cache(2, 32)
    jpre, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :22])}, jc)
    jdec, _ = jm.decode_step(params, jc, jnp.asarray(toks[:, 22:]))
    tc = tm.init_cache(2, 32)
    assert [sorted(c) for c in tc["layers"]] == [
        ["conv", "h"], ["conv", "h"], ["k", "v"]]
    tpre, tc = tm.prefill(torch.from_numpy(toks[:, :22]), tc)
    tdec, tc = tm.decode_step(tc, torch.from_numpy(toks[:, 22:]))
    np.testing.assert_allclose(np32(tpre), np32(jpre), **PARITY)
    np.testing.assert_allclose(np32(tdec), np32(jdec), **PARITY)


def test_recurrentgemma_prefill_decode_matches_forward():
    """The port's prefill(S) + decode(1) == its forward(S + 1), fp32."""
    cfg = get_smoke_config("recurrentgemma-2b")
    model = Model(cfg, dtype=torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(tokens(3, 2, 18, cfg.vocab_size))
    pre, cache = model.prefill(toks[:, :17], model.init_cache(2, 64))
    torch.testing.assert_close(pre[:, 0], model.forward(toks[:, :17])[:, -1],
                               rtol=1e-4, atol=1e-4)
    dec, _ = model.decode_step(cache, toks[:, 17:])
    torch.testing.assert_close(dec[:, 0], model.forward(toks)[:, -1],
                               **DECODE)


def test_decode_past_the_local_window_matches_jax_windowed_forward():
    """A 75-token prompt through the smoke's 64-slot local ring (75 % 64 is
    not 0), then four decode steps, each against JAX ``forward`` over all
    tokens so far (its attention layers apply the 64-token window)."""
    jcfg = jax_smoke("recurrentgemma-2b")
    assert jcfg.local_window == 64
    jm, params, tm = jax_and_port(jcfg, key=2)
    toks = tokens(6, 2, 79, jcfg.vocab_size)
    want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    cache = tm.init_cache(2, 79)
    assert cache["layers"][2]["k"].shape[1] == 64
    pre, cache = tm.prefill(torch.from_numpy(toks[:, :75]), cache)
    np.testing.assert_allclose(np32(pre[:, 0]), np32(want[:, 74]), **DECODE)
    for t in range(75, 79):
        dec, cache = tm.decode_step(cache, torch.from_numpy(toks[:, t:t + 1]))
        np.testing.assert_allclose(np32(dec[:, 0]), np32(want[:, t]),
                                   **DECODE)


def test_bridge_carries_a_hybrid_checkpoint_bit_exactly(tmp_path):
    """The hybrid's per-layer list, carried directly and through the JAX
    ``save_checkpoint`` (keys ``layers/<i>/...``) read back with numpy
    only: bf16 bits equal to each other and to JAX's, fp32 decay
    parameters kept fp32."""
    jcfg = jax_smoke("recurrentgemma-2b")
    params = JaxModel(jcfg, dtype=jnp.bfloat16).init(jax.random.key(5))
    assert isinstance(params["layers"], list)
    save_checkpoint(str(tmp_path), params, step=2)
    cfg = get_smoke_config("recurrentgemma-2b")
    direct = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                             device="cpu")
    loaded = params_from_jax(load_jax_checkpoint(str(tmp_path), step=2), cfg,
                             device="cpu")
    a, b = direct.state_dict(), loaded.state_dict()
    assert a.keys() == b.keys()
    for name, t in a.items():
        assert t.dtype == b[name].dtype
        bits = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(t.view(bits), b[name].view(bits)), name
    assert a["layers.0.rglru.lam"].dtype == torch.float32
    assert a["layers.0.rglru.w_r"].dtype == torch.bfloat16
    w_r = np.asarray(params["layers"][1]["rglru"]["w_r"]).view(np.uint16)
    np.testing.assert_array_equal(
        a["layers.1.rglru.w_r"].view(torch.int16).numpy().view(np.uint16),
        w_r)
    wq = np.asarray(params["layers"][2]["attn"]["wq"]).view(np.uint16)
    np.testing.assert_array_equal(
        b["layers.2.attn.wq"].view(torch.int16).numpy().view(np.uint16), wq)


def test_rglru_init_draws_the_jax_scales():
    cfg = get_smoke_config("recurrentgemma-2b")
    model = Model(cfg, dtype=torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    p = model.layers[1].rglru
    d, w = cfg.d_model, cfg.lru_width
    for t, std in ((p.w_x, d ** -0.5), (p.w_gate, d ** -0.5),
                   (p.conv, 0.25), (p.w_r, w ** -0.5), (p.w_out, w ** -0.5)):
        assert abs(float(t.std()) / std - 1) < 0.1
    jp = jrglru.rglru_init(jax.random.key(0), jax_smoke("recurrentgemma-2b"),
                           jnp.float32)
    assert p.lam.dtype == torch.float32
    np.testing.assert_allclose(p.lam.numpy(), np.asarray(jp["lam"]),
                               rtol=1e-6)
    assert model.layers[2].attn.wq.shape == (d, cfg.n_heads, cfg.head_dim)
