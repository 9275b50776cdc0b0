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

A configuration that says ``moe_dropless`` (granite-4.0-h-small: 72
experts, 10 a token) takes the dropless grouped dispatch instead, which
the JAX package does not have: the (token, choice) pairs sorted by expert
on the device (a stable sort, so token-major within an expert), each
expert's end offset found by ``searchsorted``, gate, up and down each one
grouped product over the experts (``torch._grouped_mm`` in bf16 on the
card; a product an expert in the plain version), and the results put back
in pair order, weighted and summed over the choices as the static path
sums them.  It holds no (E, C, d) buffer, multiplies only the rows chosen,
launches as many kernels for 72 experts as for 8, and waits on nothing
(a static capacity that dropped nothing would need C = T here, 7.2 times
the expert work).  Spans under ``moe``: ``route``, ``dispatch``,
``experts``, ``combine``, ``shared``; while they record, the tokens each
expert received are summed on the device into the ``expert_tokens``
counter of ``obs/host.py``, one per layer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig, round_up
from repro_torch.models.layers import MLP, _param
from repro_torch.obs import host


class MoE(nn.Module):
    """The layer's parameters, in the JAX layouts (``moe_init``): the fp32
    ``router`` (d, E), the experts' ``w_gate`` / ``w_up`` (E, d, f) and
    ``w_down`` (E, f, d), and the ``shared`` (width ``shared_width``) and
    ``dense`` (width d_ff) SwiGLU MLPs where the config has them.
    ``layer`` is its index in the model (the counter's key)."""

    def __init__(self, cfg: ModelConfig, *, device, dtype,
                 layer: int | None = None):
        super().__init__()
        self.cfg = cfg
        self.layer = layer
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.router = _param((d, e), device, torch.float32)
        self.w_gate = _param((e, d, f), device, dtype)
        self.w_up = _param((e, d, f), device, dtype)
        self.w_down = _param((e, f, d), device, dtype)
        self.shared = (MLP(d, cfg.shared_width, "swiglu",
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


def moe_init(cfg: ModelConfig, *, device, dtype,
             layer: int | None = None) -> MoE:
    """Allocate layer ``layer``'s MoE (fill it with ``reset_parameters``)."""
    return MoE(cfg, device=device, dtype=dtype, layer=layer)


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


def grouped_mm(a, w, ends):
    """a (M, K), its rows sorted by expert; w (E, K, N); ends (E,) int32,
    the running count of rows through each expert.  Returns (M, N): each
    expert's rows times its matrix.  On the card: one grouped product, bf16
    only (``torch._grouped_mm``; any other dtype raises rather than wait on
    the host); on the CPU the plain version, a product an expert (it reads
    ``ends`` on the host)."""
    if a.is_cuda:
        if a.dtype != torch.bfloat16:
            raise TypeError(f"grouped_mm on the card takes bf16, not "
                            f"{a.dtype} (torch._grouped_mm)")
        return torch._grouped_mm(a, w, offs=ends)
    out = a.new_empty(a.shape[0], w.shape[-1])
    start = 0
    for e, end in enumerate(ends.tolist()):
        out[start:end] = a[start:end] @ w[e]
        start = end
    return out


def _static(p: MoE, xf, top_w, top_i, cfg: ModelConfig):
    """The routed experts' sum through the (E x C) buffer (drops past C)."""
    t, d = xf.shape
    k, e = cfg.top_k, cfg.n_experts
    cap = capacity(t // n_dispatch_groups(t), cfg)
    rec = host.on and host.open("dispatch")
    dest, keep = slots(top_i, e, cap)
    # a dropped choice goes to the spare row e * cap, which nothing reads
    src = xf[:, None].expand(t, k, d).reshape(t * k, d)
    buf = xf.new_zeros(e * cap + 1, d).index_copy_(0, dest, src)
    buf = buf[:e * cap].view(e, cap, d)
    if rec:
        host.close()

    rec = host.on and host.open("experts")
    gate = F.silu(torch.bmm(buf, p.w_gate).float())
    up = torch.bmm(buf, p.w_up)
    out = torch.bmm(gate.to(xf.dtype) * up, p.w_down).view(e * cap, d)
    if rec:
        host.close()

    rec = host.on and host.open("combine")
    gathered = out.index_select(0, dest.clamp(max=e * cap - 1))
    gathered = gathered * keep[:, None].to(xf.dtype)
    gathered = gathered * top_w.reshape(t * k, 1).to(xf.dtype)
    y = gathered.view(t, k, d).sum(1)
    if rec:
        host.close()
    return y


def _dropless(p: MoE, xf, top_w, top_i, cfg: ModelConfig):
    """The routed experts' sum, every choice through grouped products."""
    t, d = xf.shape
    k, e = cfg.top_k, cfg.n_experts
    rec = host.on and host.open("dispatch")
    ids, order = torch.sort(top_i.reshape(-1), stable=True)
    ends = torch.searchsorted(
        ids, torch.arange(e, device=ids.device, dtype=ids.dtype),
        right=True).to(torch.int32)
    xs = xf.index_select(0, order // k)
    if rec:
        host.close()
        host.count("expert_tokens", p.layer,
                   torch.diff(ends, prepend=ends.new_zeros(1)))

    rec = host.on and host.open("experts")
    gate = F.silu(grouped_mm(xs, p.w_gate, ends).float())
    up = grouped_mm(xs, p.w_up, ends)
    out = grouped_mm(gate.to(xf.dtype) * up, p.w_down, ends)
    if rec:
        host.close()

    rec = host.on and host.open("combine")
    back = torch.empty_like(out).index_copy_(0, order, out)
    back = back * top_w.reshape(t * k, 1).to(xf.dtype)
    y = back.view(t, k, d).sum(1)
    if rec:
        host.close()
    return y


def moe_apply(p: MoE, x, cfg: ModelConfig, with_aux: bool = True):
    """x: (B, S, D) -> (y (B, S, D), the Switch aux loss as an fp32 scalar,
    or None with ``with_aux`` false)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    rec = host.on and host.open("route")
    probs, top_w, top_i = route(p, xf, cfg)
    if rec:
        host.close()
    y = (_dropless if cfg.moe_dropless else _static)(p, xf, top_w, top_i,
                                                       cfg)
    rec = host.on and host.open("shared")
    for mlp in (p.shared, p.dense):
        if mlp is not None:
            y = y + mlp(xf)
    if rec:
        host.close()
    aux = aux_loss(probs, top_i, cfg.n_experts) if with_aux else None
    return y.reshape(b, s, d), aux
