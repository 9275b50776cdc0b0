"""Block assembly: attention, MoE, SSM and RG-LRU residual blocks, and the
layer stack.

PyTorch counterpart of the JAX package's ``models/transformer.py`` for the
kinds ``attn_mlp`` (dense), ``moe`` (attention then the MoE layer in place
of the MLP), ``ssm`` (mamba2) and ``rglru`` / ``attn`` (the hybrid's
recurrent and local-attention blocks).  The JAX package scans stacked
layer parameters with ``lax.scan`` (or loops over the hybrid's list);
here the stack is a Python loop over an ``nn.ModuleList`` of blocks.

Caches are per-layer dicts, updated in place (the JAX code returns new
arrays; in place saves a copy of the cache per layer): ``{"k", "v"}`` of
(B, size, Hkv, Dh) tensors for attention, the SSM and RG-LRU state dicts
for the recurrent kinds.  A hybrid ``attn`` layer's cache holds
``min(max_len, local_window)`` slots.  Both prefill and decode write
position t at ring slot ``t % size``.  The JAX ``_attention_seq`` writes
the trailing window of a prompt longer than the cache from slot 0 instead,
which the next decode step's write at ``len % size`` then clobbers; the
port deliberately does not copy that.

Training runs the same blocks over a full sequence: ``stack_apply_seq``
with ``with_aux`` sums the MoE layers' aux losses (serving asks for none,
so it launches none of their kernels), and with ``remat`` each block runs
under ``torch.utils.checkpoint``, as the JAX package wraps each layer in
``jax.checkpoint``: the backward recomputes a block's forward instead of
keeping its activations.
"""
from __future__ import annotations

import torch
# checkpoint imports torch._dynamo on its first call, and that import's
# garbage cycles reach the step's frames and keep its tensors alive
import torch._dynamo  # noqa: F401
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ATTN_KINDS, ModelConfig
from repro_torch.models.layers import (MLP, Attention, apply_rope,
                                       attention_decode, attention_full,
                                       make_norm)
from repro_torch.obs import host

KINDS = ATTN_KINDS + ("ssm", "rglru")


def _require_ported(kind: str):
    if kind not in KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not yet ported; the port has {KINDS}")


# ---------------------------------------------------------------- init ----


class Block(nn.Module):
    """Pre-norm residual block, with the JAX ``init_layer`` parameters of
    its kind: attention then MLP (``attn_mlp``, ``attn``); attention then
    the MoE layer (``moe``); the SSM mixer alone (``ssm``); the RG-LRU then
    MLP (``rglru``)."""

    def __init__(self, kind: str, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        _require_ported(kind)
        norm = make_norm(cfg.norm)
        d = cfg.d_model
        self.ln1 = norm(d, device=device)
        if kind in ATTN_KINDS:
            self.attn = Attention(d, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim, device=device, dtype=dtype)
        elif kind == "ssm":
            self.ssm = ssm_mod.ssm_init(cfg, device=device, dtype=dtype)
        else:
            self.rglru = rglru_mod.rglru_init(cfg, device=device,
                                              dtype=dtype)
        if kind != "ssm":
            self.ln2 = norm(d, device=device)
        if kind == "moe":
            self.moe = moe_mod.moe_init(cfg, device=device, dtype=dtype)
        elif kind != "ssm":
            self.mlp = MLP(d, cfg.d_ff, cfg.activation, device=device,
                           dtype=dtype)

    def reset_parameters(self, generator):
        for m in self.children():
            m.reset_parameters(generator)


def init_layer(kind: str, cfg: ModelConfig, *, device, dtype) -> Block:
    """Allocate one layer (parameters unfilled: see ``Model.init``)."""
    return Block(kind, cfg, device=device, dtype=dtype)


def init_layer_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     *, device, dtype) -> dict:
    _require_ported(kind)
    if kind == "ssm":
        return ssm_mod.init_ssm_state(cfg, batch, device=device, dtype=dtype)
    if kind == "rglru":
        return rglru_mod.init_rglru_state(cfg, batch, device=device,
                                          dtype=dtype)
    size = min(max_len, cfg.local_window) if kind == "attn" else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, device=device, dtype=dtype),
            "v": torch.zeros(shape, device=device, dtype=dtype)}


# ------------------------------------------------------------- attention --


def _ring_write(cache: dict, k, v, start: int):
    """Write k/v (B, n, Hkv, Dh) of positions start.. at slots t % size.

    Only the last ``size`` positions are kept; they land in at most two
    contiguous runs of slots.
    """
    size = cache["k"].shape[1]
    n = min(k.shape[1], size)
    first = (start + k.shape[1] - n) % size
    head = min(n, size - first)
    for name, t in (("k", k), ("v", v)):
        t = t[:, t.shape[1] - n:]
        cache[name][:, first:first + head] = t[:, :head]
        cache[name][:, :n - head] = t[:, head:]


def _attention_seq(attn: Attention, x, cfg: ModelConfig, positions, window,
                   cache=None):
    """Full-sequence attention (prefill).  Returns (out, cache)."""
    q, k, v = attn.project(x)
    rec = host.on and host.open("rope")
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if rec:
        host.close()
    rec = host.on and host.open("flash")
    out = attention_full(q, k, v, causal=cfg.causal, window=window)
    if rec:
        host.close()
    if cache is not None:
        rec = host.on and host.open("ring_write")
        _ring_write(cache, k, v, start=0)
        if rec:
            host.close()
    return attn.out(out), cache


def _attention_step(attn: Attention, x, cfg: ModelConfig, cache,
                    cache_len: int, positions, n_valid, window):
    """One-token decode.  x: (B, 1, D); cache_len: tokens so far (an int);
    positions: (B, 1) = cache_len; n_valid: (B,) int32 valid slots after
    this token's write."""
    q, k, v = attn.project(x)
    rec = host.on and host.open("rope")
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if rec:
        host.close()
    rec = host.on and host.open("ring_write")
    _ring_write(cache, k, v, start=cache_len)
    if rec:
        host.close()
    rec = host.on and host.open("decode_attention")
    out = attention_decode(q, cache["k"], cache["v"], n_valid, window=window)
    if rec:
        host.close()
    return attn.out(out), cache


# ---------------------------------------------------------------- blocks --


def _window(kind: str, cfg: ModelConfig, window_override):
    if window_override is not None:
        return window_override
    return cfg.local_window if kind == "attn" else cfg.sliding_window


def _feed_forward(block: Block, x, kind: str, with_aux: bool = False):
    """The block's second residual half: the MLP, or the MoE layer, or
    nothing (``ssm``).  Returns (x, aux): aux is the MoE aux loss (a
    training term) with ``with_aux`` on an MoE block, else None."""
    if kind == "ssm":
        return x, None
    rec = host.on and host.open("norm")
    h = block.ln2(x)
    if rec:
        host.close()
    if kind == "moe":
        rec = host.on and host.open("moe")
        y, aux = block.moe(h, with_aux)
        if rec:
            host.close()
        return x + y, aux
    rec = host.on and host.open("mlp")
    y = block.mlp(h)
    if rec:
        host.close()
    return x + y, None


def block_apply_seq(block: Block, x, kind: str, cfg: ModelConfig, positions,
                    cache=None, window_override=None, with_aux: bool = False):
    """Full-sequence residual block.  Returns (x, cache, aux); a recurrent
    kind's state in ``cache`` is replaced by the state after the sequence;
    aux is the MoE aux loss with ``with_aux`` on an MoE block, else
    None."""
    rec = host.on and host.open("norm")
    h = block.ln1(x)
    if rec:
        host.close()
    if kind in ATTN_KINDS:
        rec = host.on and host.open("attention")
        out, cache = _attention_seq(block.attn, h, cfg, positions,
                                    _window(kind, cfg, window_override),
                                    cache)
        if rec:
            host.close()
    else:
        apply = (ssm_mod.ssm_apply if kind == "ssm"
                 else rglru_mod.rglru_apply)
        rec = host.on and host.open(kind)
        out, state = apply(getattr(block, kind), h, cfg, cache)
        if cache is not None:
            cache.update(state)
        if rec:
            host.close()
    x, aux = _feed_forward(block, x + out, kind, with_aux)
    return x, cache, aux


def block_apply_step(block: Block, x, kind: str, cfg: ModelConfig, cache,
                     cache_len: int, positions, n_valid,
                     window_override=None):
    """One-token decode block.  Returns (x, cache)."""
    rec = host.on and host.open("norm")
    h = block.ln1(x)
    if rec:
        host.close()
    if kind in ATTN_KINDS:
        rec = host.on and host.open("attention")
        out, cache = _attention_step(block.attn, h, cfg, cache, cache_len,
                                     positions, n_valid,
                                     _window(kind, cfg, window_override))
        if rec:
            host.close()
    else:
        step = (ssm_mod.ssm_decode_step if kind == "ssm"
                else rglru_mod.rglru_decode_step)
        rec = host.on and host.open(kind)
        out, state = step(getattr(block, kind), h, cfg, cache)
        cache.update(state)
        if rec:
            host.close()
    return _feed_forward(block, x + out, kind)[0], cache


# ----------------------------------------------------------- layer stack --


def stack_apply_seq(layers: nn.ModuleList, x, cfg: ModelConfig, positions,
                    caches=None, window_override=None, remat: bool = False,
                    with_aux: bool = False):
    """Run all layers over a full sequence.  Returns (x, caches, aux): aux
    is the sum of the MoE layers' aux losses (an fp32 scalar, 0 without MoE
    layers) with ``with_aux``, else None.  ``remat`` recomputes each block
    in the backward (no caches then)."""
    if remat and caches is not None:
        raise ValueError("remat is for training: it takes no caches")
    kinds = cfg.layer_types()
    aux = torch.zeros((), device=x.device) if with_aux else None
    for i, block in enumerate(layers):
        args = (block, x, kinds[i], cfg, positions,
                None if caches is None else caches[i], window_override,
                with_aux)
        rec = host.on and host.open("block", i, kinds[i])
        if remat:
            # the model draws no random numbers: no RNG state to replay
            x, _, a = torch.utils.checkpoint.checkpoint(
                block_apply_seq, *args, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, _, a = block_apply_seq(*args)
        if rec:
            host.close()
        if a is not None:
            aux = aux + a
    return x, caches, aux


def stack_apply_step(layers: nn.ModuleList, x, cfg: ModelConfig, caches,
                     cache_len: int, window_override=None):
    """One decode step through all layers.  Returns (x, caches)."""
    kinds = cfg.layer_types()
    b = x.shape[0]
    # every attention layer's cache has the same size (an SSM stack has
    # none); the tensors below are shared by every layer: built once per
    # step, and from host ints, so the step never waits on the device to
    # find its ring slot
    size = next((c["k"].shape[1] for c in caches if "k" in c), 0)
    positions = torch.full((b, 1), cache_len, dtype=torch.int64,
                           device=x.device)
    n_valid = torch.full((b,), min(cache_len + 1, size), dtype=torch.int32,
                         device=x.device)
    for i, block in enumerate(layers):
        rec = host.on and host.open("block", i, kinds[i])
        x, _ = block_apply_step(block, x, kinds[i], cfg, caches[i],
                                cache_len, positions, n_valid,
                                window_override)
        if rec:
            host.close()
    return x, caches
