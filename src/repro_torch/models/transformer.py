"""Block assembly for the dense ``attn_mlp`` decoder, and the layer stack.

PyTorch counterpart of the JAX package's ``models/transformer.py``, for the
``attn_mlp`` kind only; the other kinds come with later slices of the port
and raise ``NotImplementedError`` here.  The JAX package scans stacked
layer parameters with ``lax.scan``; here the stack is a Python loop over an
``nn.ModuleList`` of blocks.

KV caches are dicts ``{"k", "v"}`` of (B, size, Hkv, Dh) tensors, updated
in place (the JAX code returns new arrays; in place saves a copy of the
cache per layer).  Both prefill and decode write position t at ring slot
``t % size``.  The JAX ``_attention_seq`` writes the trailing window of a
prompt longer than the cache from slot 0 instead, which the next decode
step's write at ``len % size`` then clobbers; the port deliberately does
not copy that.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, Attention, apply_rope,
                                       attention_decode, attention_full,
                                       make_norm)

# layer kind -> the slice of the port that brings it
_FUTURE_SLICE = {"moe": "MoE", "ssm": "SSM", "rglru": "hybrid",
                 "attn": "hybrid"}


def _require_attn_mlp(kind: str):
    if kind != "attn_mlp":
        raise NotImplementedError(
            f"layer kind {kind!r} is not yet ported; it comes with the "
            f"{_FUTURE_SLICE.get(kind, 'a later')} slice of the port")


# ---------------------------------------------------------------- init ----


class Block(nn.Module):
    """Pre-norm residual block: attention, then MLP."""

    def __init__(self, cfg: ModelConfig, *, device, dtype):
        super().__init__()
        norm = make_norm(cfg.norm)
        d = cfg.d_model
        self.ln1 = norm(d, device=device)
        self.attn = Attention(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                              device=device, dtype=dtype)
        self.ln2 = norm(d, device=device)
        self.mlp = MLP(d, cfg.d_ff, cfg.activation, device=device,
                       dtype=dtype)

    def reset_parameters(self, generator):
        for m in (self.ln1, self.attn, self.ln2, self.mlp):
            m.reset_parameters(generator)


def init_layer(kind: str, cfg: ModelConfig, *, device, dtype) -> Block:
    """Allocate one layer (parameters unfilled: see ``Model.init``)."""
    _require_attn_mlp(kind)
    return Block(cfg, device=device, dtype=dtype)


def init_layer_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     *, device, dtype) -> dict:
    _require_attn_mlp(kind)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
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
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = attention_full(q, k, v, causal=cfg.causal, window=window)
    if cache is not None:
        _ring_write(cache, k, v, start=0)
    return attn.out(out), cache


def _attention_step(attn: Attention, x, cfg: ModelConfig, cache,
                    cache_len: int, positions, n_valid, window):
    """One-token decode.  x: (B, 1, D); cache_len: tokens so far (an int);
    positions: (B, 1) = cache_len; n_valid: (B,) int32 valid slots after
    this token's write."""
    q, k, v = attn.project(x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    _ring_write(cache, k, v, start=cache_len)
    out = attention_decode(q, cache["k"], cache["v"], n_valid, window=window)
    return attn.out(out), cache


# ---------------------------------------------------------------- blocks --


def block_apply_seq(block: Block, x, kind: str, cfg: ModelConfig, positions,
                    cache=None, window_override=None):
    """Full-sequence residual block.  Returns (x, cache)."""
    _require_attn_mlp(kind)
    window = (window_override if window_override is not None
              else cfg.sliding_window)
    a_out, cache = _attention_seq(block.attn, block.ln1(x), cfg, positions,
                                  window, cache)
    x = x + a_out
    return x + block.mlp(block.ln2(x)), cache


def block_apply_step(block: Block, x, kind: str, cfg: ModelConfig, cache,
                     cache_len: int, positions, n_valid,
                     window_override=None):
    """One-token decode block.  Returns (x, cache)."""
    _require_attn_mlp(kind)
    window = (window_override if window_override is not None
              else cfg.sliding_window)
    a_out, cache = _attention_step(block.attn, block.ln1(x), cfg, cache,
                                   cache_len, positions, n_valid, window)
    x = x + a_out
    return x + block.mlp(block.ln2(x)), cache


# ----------------------------------------------------------- layer stack --


def stack_apply_seq(layers: nn.ModuleList, x, cfg: ModelConfig, positions,
                    caches=None, window_override=None):
    """Run all layers over a full sequence.  Returns (x, caches)."""
    kinds = cfg.layer_types()
    for i, block in enumerate(layers):
        x, _ = block_apply_seq(block, x, kinds[i], cfg, positions,
                               None if caches is None else caches[i],
                               window_override)
    return x, caches


def stack_apply_step(layers: nn.ModuleList, x, cfg: ModelConfig, caches,
                     cache_len: int, window_override=None):
    """One decode step through all layers.  Returns (x, caches)."""
    kinds = cfg.layer_types()
    b = x.shape[0]
    size = caches[0]["k"].shape[1]
    # shared by every layer: built once per step, and from host ints, so
    # the step never waits on the device to find its ring slot
    positions = torch.full((b, 1), cache_len, dtype=torch.int64,
                           device=x.device)
    n_valid = torch.full((b,), min(cache_len + 1, size), dtype=torch.int32,
                         device=x.device)
    for i, block in enumerate(layers):
        x, _ = block_apply_step(block, x, kinds[i], cfg, caches[i],
                                cache_len, positions, n_valid,
                                window_override)
    return x, caches
