"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

PyTorch counterpart of the JAX package's ``models/rglru.py``:

    r_t = sigmoid(W_r x_t)            recurrence gate
    i_t = sigmoid(W_i x_t)            input gate
    a_t = a ^ (c * r_t)               with a = sigmoid(lambda), c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)

wrapped in the Griffin structure: linear in-projection, short depthwise
conv, RG-LRU, and a gated (GeLU) output branch.  The sequence form runs the
``rglru_scan`` kernel (``kernels/ops.py``) where JAX calls
``lax.associative_scan``, with a carried state passed as ``h0``; decode is
the plain one-step update.  The gates' matmuls run in fp32, as in JAX.
States are dicts ``{"conv": (B, K-1, W), "h": (B, W) fp32}``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _param, causal_conv

CONV_K = 4
C_EXP = 8.0


class RGLRU(nn.Module):
    """The block's parameters, in the JAX layouts (``rglru_init``)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width or cfg.d_model
        self.w_x = _param((d, w), device, dtype)
        self.w_gate = _param((d, w), device, dtype)
        self.conv = _param((CONV_K, w), device, dtype)
        self.w_r = _param((w, w), device, dtype)
        self.w_i = _param((w, w), device, dtype)
        self.lam = _param((w,), device, torch.float32)
        self.w_out = _param((w, d), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator):
        d, w = self.w_x.shape
        for t in (self.w_x, self.w_gate):
            t.normal_(0.0, 1.0 / math.sqrt(d), generator=generator)
        self.conv.normal_(0.0, 1.0 / CONV_K, generator=generator)
        for t in (self.w_r, self.w_i, self.w_out):
            t.normal_(0.0, 1.0 / math.sqrt(w), generator=generator)
        # a = sigmoid(lambda)^c in about (0.9, 0.999)
        self.lam.copy_(torch.linspace(2.2, 6.0, w))


def rglru_init(cfg: ModelConfig, *, device, dtype) -> RGLRU:
    """Allocate the block (fill it with ``reset_parameters``)."""
    return RGLRU(cfg, device=device, dtype=dtype)


def _gates(p: RGLRU, xb):
    """a_t and the scaled input.  xb: (..., W) float32."""
    r = torch.sigmoid(xb @ p.w_r.float())
    i = torch.sigmoid(xb @ p.w_i.float())
    log_a = C_EXP * r * F.logsigmoid(p.lam)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9))
    return a, beta * (i * xb)


def rglru_apply(p: RGLRU, x, cfg: ModelConfig, state=None):
    """x: (B, S, D) -> (B, S, D); state: None or a state dict.

    Returns (y, new state)."""
    xb, new_conv = causal_conv(x @ p.w_x, p.conv,
                               None if state is None else state["conv"])
    a, b = _gates(p, xb.float())
    h, new_h = ops.rglru_scan(a, b, None if state is None else state["h"])
    gate = F.gelu((x @ p.w_gate).float(), approximate="tanh")
    y = (h * gate).to(x.dtype) @ p.w_out
    return y, {"conv": new_conv, "h": new_h}


def rglru_decode_step(p: RGLRU, x, cfg: ModelConfig, state):
    """x: (B, 1, D); the O(1) recurrent update.  Returns (y, new state)."""
    conv_out, new_conv = causal_conv(x @ p.w_x, p.conv, state["conv"])
    a, b = _gates(p, conv_out[:, 0].float())
    h = a * state["h"] + b
    gate = F.gelu((x[:, 0] @ p.w_gate).float(), approximate="tanh")
    y = ((h * gate).to(x.dtype) @ p.w_out)[:, None]
    return y, {"conv": new_conv, "h": h}


def init_rglru_state(cfg: ModelConfig, batch: int, *, device,
                     dtype) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.zeros((batch, CONV_K - 1, w), device=device,
                            dtype=dtype),
        "h": torch.zeros((batch, w), device=device, dtype=torch.float32),
    }
