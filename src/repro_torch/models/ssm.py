"""Mamba-2 SSD mixers (arXiv:2405.21060): the JAX package's and upstream's.

``SSM`` (layer kind ``ssm``, mamba2-780m) is the PyTorch counterpart of the
JAX package's ``models/ssm.py``, with its simplifications: the short
depthwise conv runs on the x branch only, B and C get no conv, and there
is no gated norm.  It is held to the JAX package, not to upstream Mamba-2.

``Mamba2`` (layer kind ``mamba2``, granite-4.0-h-small) is the upstream
mixer, which the JAX package does not have: one ``in_proj`` to z (Di),
xBC (Di + 2 N) and dt (H); a causal depthwise conv of width 4 over xBC
with its bias, then SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log);
the same scan; y + D x; the gated norm rmsnorm(y * silu(z)) * w over the
whole Di (G = 1), in fp32; ``out_proj``.  The scan takes one B and C
shared by every head, so only G = 1 is built.  Its state holds the last 3
inputs of all Di + 2 N conv channels.

Per head h with headdim P and state size N:
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t^T        (N x P state)
    y_t = C_t^T h_t + D * x_t
A is a per-head negative scalar; B_t, C_t are shared across heads.  The
sequence form runs the ``ssd_scan`` kernel (``kernels/ops.py``) where JAX
calls ``ssd_chunked``, and trains through the kernel's backward
(``SSDScan``: ``csrc/ssd_scan_bwd.cu`` on the card) where JAX
differentiates ``ssd_chunked``; the one-token decode step is plain
PyTorch, as in JAX.  States are dicts ``{"conv": (B, K-1, Di), "ssm": (B, H, N, P) fp32}``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _param, causal_conv
from repro_torch.obs import host

CONV_K = 4  # depthwise conv kernel width


class SSM(nn.Module):
    """The mixer's parameters, in the JAX layouts (``ssm_init``)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, di = cfg.d_model, cfg.ssm_d_inner
        n, nh = cfg.ssm_d_state, cfg.ssm_n_heads
        self.w_z = _param((d, di), device, dtype)
        self.w_x = _param((d, di), device, dtype)
        self.w_bc = _param((d, 2 * n), device, dtype)
        self.w_dt = _param((d, nh), device, dtype)
        self.conv = _param((CONV_K, di), device, dtype)
        self.a_log = _param((nh,), device, torch.float32)
        self.dt_bias = _param((nh,), device, torch.float32)
        self.d_skip = _param((nh,), device, torch.float32)
        self.w_out = _param((di, d), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator):
        s = 1.0 / math.sqrt(self.w_z.shape[0])
        for w in (self.w_z, self.w_x, self.w_bc, self.w_dt):
            w.normal_(0.0, s, generator=generator)
        self.conv.normal_(0.0, 1.0 / CONV_K, generator=generator)
        nh = self.a_log.shape[0]
        self.a_log.copy_(torch.linspace(1.0, 16.0, nh).log())
        self.dt_bias.zero_()
        self.d_skip.fill_(1.0)
        self.w_out.normal_(0.0, 1.0 / math.sqrt(self.w_out.shape[0]),
                           generator=generator)


def ssm_init(cfg: ModelConfig, *, device, dtype) -> SSM:
    """Allocate the mixer (fill it with ``reset_parameters``)."""
    return SSM(cfg, device=device, dtype=dtype)


class Mamba2(nn.Module):
    """The upstream mixer's parameters: ``in_proj`` (d, Di + C + H) with C
    = Di + 2 N (one B / C group), the conv (4, C) and its ``conv_bias`` (C,) in the model's
    dtype; ``a_log``, ``dt_bias``, ``d_skip`` (H,) and the gated norm's
    ``norm`` (Di,) in fp32; ``w_out`` (Di, d)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, di, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_n_heads
        c = di + 2 * cfg.ssm_d_state
        self.eps = cfg.rms_eps
        self.in_proj = _param((d, di + c + nh), device, dtype)
        self.conv = _param((CONV_K, c), device, dtype)
        self.conv_bias = _param((c,), device, dtype)
        self.a_log = _param((nh,), device, torch.float32)
        self.dt_bias = _param((nh,), device, torch.float32)
        self.d_skip = _param((nh,), device, torch.float32)
        self.norm = _param((di,), device, torch.float32)
        self.w_out = _param((di, d), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """Upstream's init: A in -[1, 16], dt in [0.001, 0.1] through the
        bias, D 1, the norm 1, the conv uniform of fan-in 4."""
        d, di = self.in_proj.shape[0], self.w_out.shape[0]
        self.in_proj.normal_(0.0, d ** -0.5, generator=generator)
        bound = CONV_K ** -0.5
        for w in (self.conv, self.conv_bias):
            w.uniform_(-bound, bound, generator=generator)
        nh = self.a_log.shape[0]
        self.a_log.uniform_(0.0, math.log(16.0), generator=generator)
        dt = torch.empty(nh, device=self.a_log.device).uniform_(
            math.log(1e-3), math.log(0.1), generator=generator).exp()
        self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        self.d_skip.fill_(1.0)
        self.norm.fill_(1.0)
        self.w_out.normal_(0.0, di ** -0.5, generator=generator)


def mamba2_init(cfg: ModelConfig, *, device, dtype) -> Mamba2:
    """Allocate the upstream mixer (fill it with ``reset_parameters``)."""
    return Mamba2(cfg, device=device, dtype=dtype)


def conv_silu(xbc, w, bias, state=None):
    """The upstream conv: causal, depthwise, width K = ``w.shape[0]``, over
    xbc (B, S, C) with ``bias``, then SiLU (in fp32, rounded once to xbc's
    dtype).  ``state``: the K-1 inputs before xbc (B, K-1, C), or None for
    zeros; S = 1 is the decode step.  Returns (out (B, S, C) contiguous,
    the last K-1 inputs)."""
    k, c = w.shape
    pad = (xbc.new_zeros(xbc.shape[0], k - 1, c) if state is None
           else state)
    xpad = torch.cat([pad, xbc], dim=1)
    out = F.conv1d(xpad.transpose(1, 2), w.t()[:, None, :], bias, groups=c)
    out = F.silu(out.float()).to(xbc.dtype).transpose(1, 2).contiguous()
    return out, xpad[:, -(k - 1):].clone()


def gated_norm(y, z, w, eps: float, dtype):
    """rmsnorm(y * silu(z)) * w over the last dim, in fp32, cast to
    ``dtype``: upstream's gated RMSNorm of one group."""
    g = y.float() * F.silu(z.float())
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + eps)
    return (g * w).to(dtype)


def _mamba2_split(p: Mamba2, x, cfg: ModelConfig):
    """in_proj's (z, xBC, dt)."""
    di, nh = cfg.ssm_d_inner, cfg.ssm_n_heads
    return (x @ p.in_proj).split([di, p.conv.shape[1], nh], dim=-1)


def mamba2_apply(p: Mamba2, x, cfg: ModelConfig, state=None):
    """The upstream mixer over a sequence.  x: (B, S, D); state: None (from
    zero) or a state dict.  Returns (y (B, S, D), new state)."""
    b, s, _ = x.shape
    di, n, nh, hp = (cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_n_heads,
                     cfg.ssm_headdim)
    z, xbc, dt = _mamba2_split(p, x, cfg)
    rec = host.on and host.open("conv")
    xbc, new_conv = conv_silu(xbc, p.conv, p.conv_bias,
                              None if state is None else state["conv"])
    if rec:
        host.close()
    xs, bmat, cmat = xbc.split([di, n, n], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)
    xh = xs.reshape(b, s, nh, hp)
    rec = host.on and host.open("ssd_scan")
    y, h_final = ops.ssd_scan(xh, dt, -torch.exp(p.a_log), bmat, cmat,
                              None if state is None else state["ssm"])
    if rec:
        host.close()
    rec = host.on and host.open("gated_norm")
    y = y + xh.float() * p.d_skip[:, None]
    y = gated_norm(y.reshape(b, s, di), z, p.norm, p.eps, x.dtype)
    if rec:
        host.close()
    return y @ p.w_out, {"conv": new_conv, "ssm": h_final}


def mamba2_decode_step(p: Mamba2, x, cfg: ModelConfig, state):
    """One-token decode of the upstream mixer.  x: (B, 1, D); state from
    ``init_mamba2_state`` or a prefill.  Returns (y (B, 1, D), new
    state)."""
    b = x.shape[0]
    di, n, nh, hp = (cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_n_heads,
                     cfg.ssm_headdim)
    z, xbc, dt = _mamba2_split(p, x, cfg)
    xbc, new_conv = conv_silu(xbc, p.conv, p.conv_bias, state["conv"])
    xs, bmat, cmat = xbc[:, 0].split([di, n, n], dim=-1)
    dt1 = F.softplus(dt[:, 0].float() + p.dt_bias)
    xh = xs.reshape(b, nh, hp).float()
    y, h_new = _recur(state["ssm"], xh, dt1, -torch.exp(p.a_log),
                      bmat.float(), cmat.float(), p.d_skip)
    y = gated_norm(y.reshape(b, 1, di), z, p.norm, p.eps, x.dtype)
    return y @ p.w_out, {"conv": new_conv, "ssm": h_new}


def init_mamba2_state(cfg: ModelConfig, batch: int, *, device,
                      dtype) -> dict:
    return {
        "conv": torch.zeros((batch, CONV_K - 1,
                             cfg.ssm_d_inner + 2 * cfg.ssm_d_state),
                            device=device, dtype=dtype),
        "ssm": torch.zeros((batch, cfg.ssm_n_heads, cfg.ssm_d_state,
                            cfg.ssm_headdim), device=device,
                           dtype=torch.float32),
    }


def _recur(h, xh, dt1, a, b1, c1, d_skip):
    """One step of the recurrence in fp32: h (B, H, N, P), xh (B, H, P),
    dt1 (B, H), b1 / c1 (B, N).  Returns (C^T h' + D x (B, H, P), h')."""
    decay = torch.exp(dt1 * a)                                 # (B, H)
    upd = torch.einsum("bn,bh,bhp->bhnp", b1, dt1, xh)
    h_new = decay[:, :, None, None] * h + upd
    y = torch.einsum("bn,bhnp->bhp", c1, h_new)
    return y + xh * d_skip[:, None], h_new


def _split_proj(p: SSM, x, cfg: ModelConfig):
    n = cfg.ssm_d_state
    bc = x @ p.w_bc
    return x @ p.w_z, x @ p.w_x, bc[..., :n], bc[..., n:], x @ p.w_dt


def ssm_apply(p: SSM, x, cfg: ModelConfig, state=None):
    """Full mixer.  x: (B, S, D); state: None (from zero) or a state dict.

    Returns (y (B, S, D), new state)."""
    b, s, _ = x.shape
    nh, hp = cfg.ssm_n_heads, cfg.ssm_headdim
    z, xin, bmat, cmat, dt = _split_proj(p, x, cfg)
    xin, new_conv = causal_conv(xin, p.conv,
                                None if state is None else state["conv"])
    xin = F.silu(xin.float()).to(x.dtype)
    dt = F.softplus(dt.float() + p.dt_bias)
    a = -torch.exp(p.a_log)
    xh = xin.reshape(b, s, nh, hp)
    y, h_final = ops.ssd_scan(xh, dt, a, bmat, cmat,
                              None if state is None else state["ssm"])
    y = y + xh.float() * p.d_skip[:, None]
    y = y.reshape(b, s, cfg.ssm_d_inner).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    return y @ p.w_out, {"conv": new_conv, "ssm": h_final}


def ssm_decode_step(p: SSM, x, cfg: ModelConfig, state):
    """One-token decode.  x: (B, 1, D); state from ``init_ssm_state`` or a
    prefill.  Returns (y (B, 1, D), new state)."""
    b = x.shape[0]
    nh, hp = cfg.ssm_n_heads, cfg.ssm_headdim
    z, xin, bmat, cmat, dt = _split_proj(p, x, cfg)
    conv_out, new_conv = causal_conv(xin, p.conv, state["conv"])
    xin1 = F.silu(conv_out[:, 0].float()).to(x.dtype)          # (B, Di)
    dt1 = F.softplus(dt[:, 0].float() + p.dt_bias)             # (B, H)
    a = -torch.exp(p.a_log)
    xh = xin1.reshape(b, nh, hp).float()
    b1, c1 = bmat[:, 0].float(), cmat[:, 0].float()            # (B, N)
    y, h_new = _recur(state["ssm"], xh, dt1, a, b1, c1, p.d_skip)
    y = y.reshape(b, 1, cfg.ssm_d_inner).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    return y @ p.w_out, {"conv": new_conv, "ssm": h_new}


def init_ssm_state(cfg: ModelConfig, batch: int, *, device, dtype) -> dict:
    return {
        "conv": torch.zeros((batch, CONV_K - 1, cfg.ssm_d_inner),
                            device=device, dtype=dtype),
        "ssm": torch.zeros((batch, cfg.ssm_n_heads, cfg.ssm_d_state,
                            cfg.ssm_headdim), device=device,
                           dtype=torch.float32),
    }
