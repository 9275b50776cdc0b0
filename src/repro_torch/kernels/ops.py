"""The attention entry points, with the JAX ``kernels/ops.py`` signatures.

The JAX package selects a backend with ``impl``; the port selects it from
the tensor's device.  A CPU tensor runs the plain PyTorch version; a CUDA
tensor launches the hand-written kernel, and a build or launch failure
raises (no fallback).  Any other device raises.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash


def _route(t, name: str) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"{name}: no implementation for device {t.device}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None):
    """q: (B, H, S, Dh); k/v: (B, Hkv, S, Dh).  Returns (B, H, S, Dh)."""
    if _route(q, "flash_attention") == "cpu":
        return _flash.flash_attention_torch(q, k, v, causal=causal,
                                            window=window)
    return _flash.flash_attention_cuda(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: int | None = None):
    """q: (B, H, Dh); caches: (B, S, Hkv, Dh); lengths: (B,) int32.

    Returns (B, H, Dh)."""
    if _route(q, "decode_attention") == "cpu":
        return _decode.decode_attention_torch(q, k_cache, v_cache, lengths,
                                              window=window)
    return _decode.decode_attention_cuda(q, k_cache, v_cache, lengths,
                                         window=window)
