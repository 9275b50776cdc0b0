"""Mamba-2 SSD mixer (arXiv:2405.21060).

PyTorch counterpart of the JAX package's ``models/ssm.py``, with its
simplifications: the short depthwise conv runs on the x branch only, B and
C get no conv, and there is no gated norm.  The port is held to the JAX
package, not to upstream Mamba-2.

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
    decay = torch.exp(dt1 * a)                                 # (B, H)
    upd = torch.einsum("bn,bh,bhp->bhnp", b1, dt1, xh)
    h_new = decay[:, :, None, None] * state["ssm"] + upd
    y = torch.einsum("bn,bhnp->bhp", c1, h_new)
    y = y + xh * p.d_skip[:, None]
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
