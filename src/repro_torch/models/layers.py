"""Shared model layers: norms, GQA attention, MLPs.

PyTorch counterpart of the JAX package's ``models/layers.py``; its rotary
embedding (``apply_rope``) is the plain version of the RoPE kernel, in
``kernels/rope.py``.  Every layer keeps the JAX parameter layout (``wq``
(d, H, Dh), ``wo`` (H, Dh, d), ``w_up`` (d, d_ff), ``tok`` (V, d), ``head``
(d, V)), so weights carry across without transposes.  The dtype points
match the JAX code: norms, RoPE and the SwiGLU gate compute in fp32 and
cast back.

Modules allocate their parameters with ``torch.empty`` on the given device
and fill nothing: ``reset_parameters(generator)`` draws the JAX init's
distributions (same scales, not the same numbers), and the checkpoint
bridge copies JAX weights in instead.  Parameters are created without
gradients (serving needs none); the trainer turns them on.

Attention takes the JAX layer layout (B, S, H, Dh) and runs through the
kernels in ``kernels/ops.py`` (the prefill flash kernel and the decode
kernel); the JAX ``attention_blockwise`` has no counterpart because the
flash kernel and its plain version take its place.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)

# ---------------------------------------------------------------- norms ----


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class RMSNorm(nn.Module):
    """Norm parameters are fp32 whatever the model dtype, as in JAX."""

    def __init__(self, d: int, *, device, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = _param((d,), device, torch.float32)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.scale.fill_(1.0)

    def forward(self, x):
        return rmsnorm(x, self.scale, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, d: int, *, device):
        super().__init__()
        self.scale = _param((d,), device, torch.float32)
        self.bias = _param((d,), device, torch.float32)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return layernorm(x, self.scale, self.bias)


def make_norm(kind: str, rms_eps: float = 1e-6):
    """The norm module class for ``ModelConfig.norm`` (an RMSNorm with
    ``rms_eps``)."""
    if kind == "layernorm":
        return LayerNorm
    return functools.partial(RMSNorm, eps=rms_eps)


# ------------------------------------------------------------ attention ----


class Attention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 *, device, dtype):
        super().__init__()
        self.d_model = d_model
        self.wq = _param((d_model, n_heads, head_dim), device, dtype)
        self.wk = _param((d_model, n_kv, head_dim), device, dtype)
        self.wv = _param((d_model, n_kv, head_dim), device, dtype)
        self.wo = _param((n_heads, head_dim, d_model), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator):
        s = 1.0 / math.sqrt(self.d_model)
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.normal_(0.0, s, generator=generator)

    def project(self, x):
        """x: (B, S, d) -> q (B, S, H, Dh), k and v (B, S, Hkv, Dh)."""
        b, s, _ = x.shape
        return tuple((x @ w.flatten(1)).view(b, s, *w.shape[1:])
                     for w in (self.wq, self.wk, self.wv))

    def out(self, o):
        """o: (B, S, H, Dh) -> (B, S, d)."""
        return o.flatten(2) @ self.wo.flatten(0, 1)


def _repeat_kv(k, n_heads: int):
    """(B, S, Hkv, Dh) -> (B, S, H, Dh) by group broadcast.

    The model never calls it: both attention kernels keep the GQA group
    factored so the KV cache is read once.  It serves callers that need
    the full head count, such as a library attention call used as a
    yardstick.
    """
    b, s, hkv, dh = k.shape
    if hkv == n_heads:
        return k
    rep = n_heads // hkv
    return k[:, :, :, None, :].expand(b, s, hkv, rep, dh).reshape(
        b, s, n_heads, dh)


def attention_full(q, k, v, *, causal: bool, window: int | None = None,
                   scale: float | None = None):
    """Prefill attention.  q: (B, S, H, Dh), k/v: (B, S, Hkv, Dh); the
    softmax ``scale`` 1/sqrt(Dh) unless given.

    Runs the flash kernel on (B, H, S, Dh) views of the same storage: the
    kernel reads through strides, so no transpose is copied.
    """
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              scale=scale)
    return out.transpose(1, 2)


def attention_decode(q, k_cache, v_cache, cache_len, *,
                     window: int | None = None, scale: float | None = None):
    """Single-token decode attention, grouped-GQA form.

    q: (B, 1, H, Dh); k_cache/v_cache: (B, S_max, Hkv, Dh); cache_len: (B,)
    int32 number of valid slots (the new token's K/V already written).
    """
    return ops.decode_attention(q[:, 0], k_cache, v_cache, cache_len,
                                window=window, scale=scale)[:, None]


# --------------------------------------------------------------- conv ----


def causal_conv(x, conv_w, conv_state=None):
    """Depthwise causal conv along the sequence (the short conv of the SSM
    and RG-LRU blocks).  x: (B, S, W); conv_w: (K, W); conv_state: the
    previous K-1 inputs (B, K-1, W), or None for zeros.  S = 1 is the decode
    step.  Returns (out in x's dtype, the last K-1 inputs)."""
    k = conv_w.shape[0]
    pad = (torch.zeros_like(x[:, :k - 1]) if conv_state is None
           else conv_state)
    xpad = torch.cat([pad, x], dim=1)
    out = sum(xpad[:, i:i + x.shape[1]] * conv_w[i] for i in range(k))
    state = xpad[:, -(k - 1):]
    # a sequence's state is copied out: as a view it would keep the whole
    # padded sequence alive in the cache, a (B, S, W) buffer per layer
    return out, (state.clone() if x.shape[1] > 1 else state)


# ---------------------------------------------------------------- mlp ----


def mlp(x, w_up, w_down, w_gate, activation: str):
    up = x @ w_up
    if activation == "swiglu":
        gate = F.silu((x @ w_gate).float())
        h = gate.to(x.dtype) * up
    else:
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    return h @ w_down


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, activation: str, *, device,
                 dtype):
        super().__init__()
        self.activation = activation
        self.w_up = _param((d_model, d_ff), device, dtype)
        self.w_down = _param((d_ff, d_model), device, dtype)
        self.w_gate = (_param((d_model, d_ff), device, dtype)
                       if activation == "swiglu" else None)

    @torch.no_grad()
    def reset_parameters(self, generator):
        s_in = 1.0 / math.sqrt(self.w_up.shape[0])
        s_out = 1.0 / math.sqrt(self.w_up.shape[1])
        self.w_up.normal_(0.0, s_in, generator=generator)
        self.w_down.normal_(0.0, s_out, generator=generator)
        if self.w_gate is not None:
            self.w_gate.normal_(0.0, s_in, generator=generator)

    def forward(self, x):
        return mlp(x, self.w_up, self.w_down, self.w_gate, self.activation)


# ------------------------------------------------------------- embeddings --


class Embed(nn.Module):
    """The token embedding ``tok`` (V, d) and the head (d, V); ``tied``
    keeps no head (the model multiplies by ``tok`` transposed, a view)."""

    def __init__(self, vocab: int, d_model: int, *, device, dtype,
                 tied: bool = False):
        super().__init__()
        self.tok = _param((vocab, d_model), device, dtype)
        if not tied:
            self.head = _param((d_model, vocab), device, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.tok.normal_(0.0, 0.02, generator=generator)
        if "head" in self._parameters:
            self.head.normal_(0.0, 1.0 / math.sqrt(self.tok.shape[1]),
                              generator=generator)
