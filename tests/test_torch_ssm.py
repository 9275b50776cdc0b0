"""The port's SSM slice (mamba2) on the CPU against the JAX package.

``ssd_scan_torch``, the plain version of the CUDA kernel
``csrc/ssd_scan.cu``, is held against the JAX Pallas ``ssd_scan`` in
interpret mode and against the sequential oracle ``ref.ssd_scan_ref``, at
the scale-normalised tolerance of ``tests/test_kernels.py::test_ssd_scan``
(rtol = atol = 1e-4 on outputs divided by max |reference|).  The mixer and
the whole model are held against JAX in fp32, at the tolerances of
``tests/test_kernel_integration.py`` (2e-4) and
``tests/test_models_smoke.py`` (1e-3 for prefill + decode vs forward).
Inputs come from ``numpy.random.default_rng``; JAX weights are carried
across by ``params_from_jax``.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.models import Model, ModelConfig  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

SCAN_TOL = 1e-4                   # scale-normalised, test_kernels.py:87-90
PARITY = dict(rtol=2e-4, atol=2e-4)  # test_kernel_integration.py:24
DECODE = dict(rtol=1e-3, atol=1e-3)  # test_models_smoke.py:113


def port_config(jcfg) -> ModelConfig:
    fields = dataclasses.asdict(jcfg)
    del fields["kernel_impl"], fields["analysis_unroll"]
    return ModelConfig(**fields)


def scan_inputs(seed, b, s, h, p, n, with_h0=False):
    """The distributions of the JAX ``test_ssd_scan``, drawn with numpy."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, h, p), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h), np.float32)))
    a = -np.exp(rng.standard_normal(h).astype(np.float32))
    bm = rng.standard_normal((b, s, n), np.float32) * 0.3
    cm = rng.standard_normal((b, s, n), np.float32) * 0.3
    h0 = (rng.standard_normal((b, h, n, p), np.float32) if with_h0
          else None)
    return xh, dt, a, bm, cm, h0


def torch_args(*arrays):
    return [None if x is None else torch.from_numpy(np.asarray(x))
            for x in arrays]


def assert_scaled(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, rtol=SCAN_TOL,
                               atol=SCAN_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 128, 2, 32, 16, 32),
    (2, 256, 4, 64, 32, 64),
    (1, 64, 3, 64, 128, 64),      # mamba2's P and N
])
def test_ssd_plain_matches_pallas_and_ref(b, s, h, p, n, chunk):
    xh, dt, a, bm, cm, _ = scan_inputs(0, b, s, h, p, n)
    y, _ = tssd.ssd_scan_torch(*torch_args(xh, dt, a, bm, cm))
    assert y.dtype == torch.float32 and y.shape == (b, s, h, p)
    jargs = [jnp.asarray(x) for x in (xh, dt, a, bm, cm)]
    pallas = pallas_ssd(*jargs, chunk=chunk, interpret=True)
    want, _ = ref.ssd_scan_ref(*jargs)
    assert_scaled(y, pallas)
    assert_scaled(y, want)


@pytest.mark.parametrize("s", [1, 63, 100, 129])
def test_ssd_plain_ragged_length_with_state(s):
    """Any S, an initial state, and the final state: the Pallas kernel
    needs a chunk multiple and returns no state, so these are held against
    the sequential oracle."""
    xh, dt, a, bm, cm, h0 = scan_inputs(1, 2, s, 3, 32, 16, with_h0=True)
    y, hf = tssd.ssd_scan_torch(*torch_args(xh, dt, a, bm, cm, h0))
    want, hf_want = ref.ssd_scan_ref(*[jnp.asarray(x)
                                       for x in (xh, dt, a, bm, cm, h0)])
    assert_scaled(y, want)
    assert_scaled(hf, hf_want)


def test_ssd_plain_takes_bf16_inputs_and_strided_b_c():
    """The model hands bf16 x and B / C as slices of one projection."""
    xh, dt, a, bm, cm, _ = scan_inputs(2, 2, 40, 2, 32, 16)
    bc = torch.from_numpy(np.concatenate([bm, cm], -1)).bfloat16()
    x16 = torch.from_numpy(xh).bfloat16()
    y, hf = tssd.ssd_scan_torch(x16, torch.from_numpy(dt),
                                torch.from_numpy(a), bc[..., :16],
                                bc[..., 16:])
    want, hf_want = ref.ssd_scan_ref(
        jnp.asarray(x16.float().numpy()), jnp.asarray(dt), jnp.asarray(a),
        jnp.asarray(bc[..., :16].float().numpy()),
        jnp.asarray(bc[..., 16:].float().numpy()))
    assert_scaled(y, want)
    assert_scaled(hf, hf_want)


def test_ops_routes_ssd_scan_by_device():
    args = torch_args(*scan_inputs(3, 1, 20, 2, 32, 16, with_h0=True))
    before = tssd.launches
    got = ops.ssd_scan(*args)
    want = tssd.ssd_scan_torch(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert tssd.launches == before
    # meta is priced, not computed: the plain version's shapes and dtypes
    meta = [t.to("meta") for t in args]
    for g, w in zip(ops.ssd_scan(*meta), want):
        assert (g.device.type, g.shape, g.dtype) == ("meta", w.shape, w.dtype)
    assert tssd.launches == before
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no implementation"):
        ops.ssd_scan(other, *args[1:])
    with pytest.raises(ValueError, match="not a CUDA device"):
        tssd.ssd_scan_cuda(*args)


def split_bf16(u):
    """u -> (hi, lo), both bf16 values held in fp32: hi = bf16(u) and
    lo = bf16(u - hi), so u = hi + lo to about 2^-17 of |u|."""
    hi = u.to(torch.bfloat16).float()
    return hi, (u - hi).to(torch.bfloat16).float()


def round_once(u):
    """The negative control: u rounded once to bf16 (and no lo part)."""
    return u.to(torch.bfloat16).float(), torch.zeros_like(u)


def ssd_split_emulation(xh, dt, a, bmat, cmat, h0, split=split_bf16):
    """The arithmetic of the bf16 kernel (``csrc/ssd_scan.cu``,
    ``ssd_bf16_kernel``) on the CPU: chunks of 64; in every product one
    operand is exactly bf16 (C, B or x) and the other, fp32, enters as
    ``split(u)`` = (hi, lo), multiplied twice with fp32 sums:

        G = C B^T; M' = [j <= i] exp(cum_i - cum_j) G dt_j
        y = M' x + diag(exp cum) C H               (M', H split)
        H <- exp(cum_L) H + (B o w dt)^T x         (the scaled B^T split)
    """
    b, s, h, p = xh.shape
    n, ln = bmat.shape[-1], 64
    pad = -s % ln
    x = torch.nn.functional.pad(xh.float(), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    bf = torch.nn.functional.pad(bmat.float(), (0, 0, 0, pad))
    cf = torch.nn.functional.pad(cmat.float(), (0, 0, 0, pad))
    lower = torch.ones(ln, ln, dtype=torch.bool).tril()[None, :, :, None]
    state = torch.zeros(b, h, n, p) if h0 is None else h0.float()
    ys = []
    for c in range(x.shape[1] // ln):
        sl = slice(c * ln, (c + 1) * ln)
        xt = x[:, sl].permute(0, 2, 1, 3)                  # (B, H, L, P)
        dtc, bc, cc = dtf[:, sl], bf[:, sl], cf[:, sl]
        cum = torch.cumsum(dtc * a.float(), dim=1)         # (B, L, H)
        gram = cc @ bc.transpose(1, 2)                     # (B, L, L)
        dec = (cum[:, :, None] - cum[:, None]).masked_fill(~lower, -1e30)
        m = (dec.exp() * (gram[..., None] * dtc[:, None])).permute(0, 3, 1, 2)
        mhi, mlo = split(m)                                # (B, H, L, L)
        hhi, hlo = split(state)                            # (B, H, N, P)
        y = (cum.permute(0, 2, 1).exp()[..., None]
             * (cc[:, None] @ hhi + cc[:, None] @ hlo)) + mhi @ xt + mlo @ xt
        tot = cum[:, -1]                                   # (B, H)
        w = ((tot[:, None] - cum).exp() * dtc).permute(0, 2, 1)  # (B, H, L)
        ahi, alo = split(bc.transpose(1, 2)[:, None] * w[:, :, None])
        state = tot.exp()[..., None, None] * state + ahi @ xt + alo @ xt
        ys.append(y.permute(0, 2, 1, 3))
    return torch.cat(ys, dim=1)[:, :s], state


def mamba2_bf16_args(s):
    """mamba2's head shape (P 64, N 128), three heads, an initial state;
    x, B and C rounded to bf16 as the model hands them over."""
    xh, dt, a, bm, cm, h0 = scan_inputs(s, 2, s, 3, 64, 128, with_h0=True)
    return (torch.from_numpy(xh).bfloat16(), torch.from_numpy(dt),
            torch.from_numpy(a), torch.from_numpy(bm).bfloat16(),
            torch.from_numpy(cm).bfloat16(), torch.from_numpy(h0))


@pytest.mark.parametrize("s", [63, 130])
def test_ssd_split_products_hold_the_scan_tolerance(s):
    """The bf16 kernel's hi / lo products stay within the scan tolerance
    (1e-4 of max |reference|) of the fp32 plain version."""
    args = mamba2_bf16_args(s)
    got = ssd_split_emulation(*args)
    want = tssd.ssd_scan_torch(*args)
    for g, w in zip(got, want):
        assert_scaled(g, w)


def test_ssd_single_bf16_rounding_misses_the_scan_tolerance():
    """Negative control: the same products with the fp32 operand rounded
    once to bf16 fail the check the split products pass."""
    args = mamba2_bf16_args(130)
    got = ssd_split_emulation(*args, split=round_once)
    want = tssd.ssd_scan_torch(*args)
    with pytest.raises(AssertionError):
        for g, w in zip(got, want):
            assert_scaled(g, w)


def jax_and_port(arch, key, dtype=jnp.float32):
    jcfg = jax_smoke(arch)
    jm = JaxModel(jcfg, dtype=dtype)
    params = jm.init(jax.random.key(key))
    tm = params_from_jax(jax.tree.map(np.asarray, params), port_config(jcfg),
                         device="cpu")
    return jcfg, jm, params, tm


def np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def test_ssm_mixer_and_decode_step_match_jax():
    """ssm_apply from zero and from a carried state, and ssm_decode_step,
    against the JAX functions in fp32 on the same weights and inputs."""
    jcfg, _, params, tm = jax_and_port("mamba2-780m", key=0)
    jp = jax.tree.map(lambda x: x[0], params["layers"]["ssm"])  # layer 0
    tp = tm.layers[0].ssm
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 21, cfg.d_model), np.float32)
    want, jstate = jssm.ssm_apply(jp, jnp.asarray(x[:, :13]), jcfg)
    got, state = tssm.ssm_apply(tp, torch.from_numpy(x[:, :13]), cfg)
    np.testing.assert_allclose(np32(got), np32(want), **PARITY)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(np32(state[k]), np32(jstate[k]), **PARITY)
    want, jstate2 = jssm.ssm_apply(jp, jnp.asarray(x[:, 13:20]), jcfg, jstate)
    got, state2 = tssm.ssm_apply(tp, torch.from_numpy(x[:, 13:20]), cfg,
                                 state)
    np.testing.assert_allclose(np32(got), np32(want), **PARITY)
    want, jstate3 = jssm.ssm_decode_step(jp, jnp.asarray(x[:, 20:]), jcfg,
                                         jstate2)
    got, state3 = tssm.ssm_decode_step(tp, torch.from_numpy(x[:, 20:]), cfg,
                                       state2)
    np.testing.assert_allclose(np32(got), np32(want), **PARITY)
    np.testing.assert_allclose(np32(state3["ssm"]), np32(jstate3["ssm"]),
                               **PARITY)


def test_mamba2_logits_match_jax():
    """forward / prefill / decode_step of the port == JAX, fp32."""
    jcfg, jm, params, tm = jax_and_port("mamba2-780m", key=1)
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 23)).astype(np.int32)
    want, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    got = tm.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(np32(got), np32(want), **PARITY)
    jc = jm.init_cache(2, 32)
    jpre, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :22])}, jc)
    jdec, _ = jm.decode_step(params, jc, jnp.asarray(toks[:, 22:]))
    tc = tm.init_cache(2, 32)
    assert set(tc["layers"][0]) == {"conv", "ssm"}
    tpre, tc = tm.prefill(torch.from_numpy(toks[:, :22]), tc)
    tdec, tc = tm.decode_step(tc, torch.from_numpy(toks[:, 22:]))
    assert tc["len"] == 23
    np.testing.assert_allclose(np32(tpre), np32(jpre), **PARITY)
    np.testing.assert_allclose(np32(tdec), np32(jdec), **PARITY)


def test_mamba2_prefill_decode_matches_forward():
    """The port's prefill(S) + decode(1) == its forward(S + 1), fp32."""
    cfg = get_smoke_config("mamba2-780m")
    model = Model(cfg, dtype=torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 18)))
    pre, cache = model.prefill(toks[:, :17], model.init_cache(2, 64))
    torch.testing.assert_close(pre[:, 0], model.forward(toks[:, :17])[:, -1],
                               rtol=1e-4, atol=1e-4)
    dec, _ = model.decode_step(cache, toks[:, 17:])
    torch.testing.assert_close(dec[:, 0], model.forward(toks)[:, -1],
                               **DECODE)


def test_ssm_init_draws_the_jax_scales():
    cfg = get_smoke_config("mamba2-780m")
    model = Model(cfg, dtype=torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    p = model.layers[1].ssm
    d, di, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_n_heads
    for t, std in ((p.w_z, d ** -0.5), (p.w_bc, d ** -0.5),
                   (p.conv, 0.25), (p.w_out, di ** -0.5)):
        assert abs(float(t.std()) / std - 1) < 0.1
    jp = jssm.ssm_init(jax.random.key(0), jax_smoke("mamba2-780m"),
                       jnp.float32)
    for name in ("a_log", "dt_bias", "d_skip"):
        t = getattr(p, name)
        assert t.dtype == torch.float32 and t.shape == (nh,)
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[name]),
                                   rtol=1e-6)
    assert p.w_x.dtype == torch.float32  # the model dtype here
