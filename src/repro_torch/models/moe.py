"""Mixture-of-Experts layer: token-choice top-k routing with static capacity.

PyTorch counterpart of the JAX package's ``models/moe.py``, computing what
its ``moe_apply`` computes: an fp32 router softmax, each token's top-k
experts with their weights renormalised, the Switch load-balance loss
(``aux_loss``, a training term: serving asks ``moe_apply`` for none, so a
served or captured step launches none of its kernels), and a dispatch
into a static (E, C, D) buffer.  A token's position within
an expert comes from a cumulative count over the token-major, slot-minor
flattening of the (token, slot) choices, so the same choices are dropped
once an expert holds C = ``capacity(T)`` of them (GShard / Switch drop
semantics: a dropped choice contributes zero).  The experts run as three
products batched over experts (``torch.bmm``, as the JAX package's
``einsum`` outside any Pallas kernel), the results gather back with the
routing weights, and the shared and dense-residual MLPs add on.

The dispatch is static-shaped and free of host syncs (no ``nonzero``, no
boolean-mask indexing, no ``.item()``): a decode step with MoE layers is
captured as a CUDA graph.  JAX's ``.at[dest].set(..., mode="drop")`` has
no torch counterpart, so a dropped choice is written to one spare row past
the E x C buffer, which nothing reads; the gather back clamps its index
into the buffer and masks the dropped choices to zero, as JAX's clamped
``take`` does.  Every step reads every expert's weights, because the
buffer has C rows for each expert whether a token chose it or not.

With no device mesh there is one dispatch group (``n_dispatch_groups``),
and JAX's sharding constraints have nothing to do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig, round_up
from repro_torch.models.layers import MLP, _param


class MoE(nn.Module):
    """The layer's parameters, in the JAX layouts (``moe_init``): the fp32
    ``router`` (d, E), the experts' ``w_gate`` / ``w_up`` (E, d, f) and
    ``w_down`` (E, f, d), and the ``shared`` (width f x n_shared) and
    ``dense`` (width d_ff) SwiGLU MLPs where the config has them."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.router = _param((d, e), device, torch.float32)
        self.w_gate = _param((e, d, f), device, dtype)
        self.w_up = _param((e, d, f), device, dtype)
        self.w_down = _param((e, f, d), device, dtype)
        self.shared = (MLP(d, f * cfg.n_shared_experts, "swiglu",
                           device=device, dtype=dtype)
                       if cfg.n_shared_experts else None)
        self.dense = (MLP(d, cfg.d_ff, "swiglu", device=device, dtype=dtype)
                      if cfg.moe_dense_residual else None)

    @torch.no_grad()
    def reset_parameters(self, generator):
        s_in = 1.0 / math.sqrt(self.cfg.d_model)
        s_out = 1.0 / math.sqrt(self.cfg.moe_d_ff)
        for w, s in ((self.router, s_in), (self.w_gate, s_in),
                     (self.w_up, s_in), (self.w_down, s_out)):
            w.normal_(0.0, s, generator=generator)
        for mlp in (self.shared, self.dense):
            if mlp is not None:
                mlp.reset_parameters(generator)

    def forward(self, x, with_aux: bool = False):
        """x: (B, S, D) -> (y (B, S, D), the aux loss with ``with_aux``,
        else None).  The blocks call the layer through here, so forward
        hooks see its input."""
        return moe_apply(self, x, self.cfg, with_aux)


def moe_init(cfg: ModelConfig, *, device, dtype) -> MoE:
    """Allocate the layer (fill it with ``reset_parameters``)."""
    return MoE(cfg, device=device, dtype=dtype)


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ceil(T k / E x capacity_factor), at least 8, a
    multiple of 128 from 128 up (of 8 below), as in JAX."""
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return round_up(max(c, 8), 128 if c >= 128 else 8)


def n_dispatch_groups(n_tokens: int) -> int:
    """Dispatch groups: one per data shard in JAX; the port runs on one
    device, where JAX falls back to a single group."""
    return 1


def route(p: MoE, xf, cfg: ModelConfig):
    """The router.  xf: (T, D) -> (probs (T, E) fp32, top-k weights (T, k)
    renormalised to sum to 1, top-k expert ids (T, k), largest first)."""
    probs = torch.softmax(xf.float() @ p.router, dim=-1)
    top_w, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_w, top_i


def slots(top_i, n_experts: int, cap: int):
    """Where the (token, slot) choices ``top_i`` (T, k) go, taken
    token-major and slot-minor: (the row of each in the (E x cap) buffer,
    ``n_experts * cap`` for a dropped one; which are kept: the first
    ``cap`` of each expert)."""
    flat_e = top_i.reshape(-1)
    # one row an expert, one column a choice: the running count along a
    # row scans the innermost dimension (a scan along the outer one of the
    # (T k, E) one-hot took over half of deepseek-moe-16b's prefill of 4 x
    # 1000 tokens on an H100)
    onehot = (torch.arange(n_experts, device=top_i.device)[:, None]
              == flat_e[None, :]).to(torch.int32)
    pos = (onehot.cumsum(1) - 1).gather(0, flat_e[None, :])[0]
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos, n_experts * cap)
    return dest, keep


def aux_loss(probs, top_i, n_experts: int):
    """The Switch load-balance loss E * sum_e f_e * p_e: ``probs`` (T, E)
    the router's, ``top_i`` (T, k) the chosen ids, f_e the share of all
    choices that went to expert e (dropped ones included)."""
    received = F.one_hot(top_i.reshape(-1), n_experts).sum(0)
    return n_experts * torch.sum(probs.mean(0)
                                 * (received.float() / top_i.numel()))


def moe_apply(p: MoE, x, cfg: ModelConfig, with_aux: bool = True):
    """x: (B, S, D) -> (y (B, S, D), the Switch aux loss as an fp32 scalar,
    or None with ``with_aux`` false)."""
    b, s, d = x.shape
    t, k, e = b * s, cfg.top_k, cfg.n_experts
    cap = capacity(t // n_dispatch_groups(t), cfg)
    xf = x.reshape(t, d)
    probs, top_w, top_i = route(p, xf, cfg)
    dest, keep = slots(top_i, e, cap)

    # a dropped choice goes to the spare row e * cap, which nothing reads
    src = xf[:, None].expand(t, k, d).reshape(t * k, d)
    buf = x.new_zeros(e * cap + 1, d).index_copy_(0, dest, src)
    buf = buf[:e * cap].view(e, cap, d)

    gate = F.silu(torch.bmm(buf, p.w_gate).float())
    up = torch.bmm(buf, p.w_up)
    out = torch.bmm(gate.to(x.dtype) * up, p.w_down).view(e * cap, d)

    gathered = out.index_select(0, dest.clamp(max=e * cap - 1))
    gathered = gathered * keep[:, None].to(x.dtype)
    gathered = gathered * top_w.reshape(t * k, 1).to(x.dtype)
    y = gathered.view(t, k, d).sum(1)
    for mlp in (p.shared, p.dense):
        if mlp is not None:
            y = y + mlp(xf)
    aux = aux_loss(probs, top_i, e) if with_aux else None
    return y.reshape(b, s, d), aux
