"""The kernel entry points, with the JAX ``kernels/ops.py`` signatures.

The JAX package selects a backend with ``impl``; the port selects it from
the tensor's device.  A CPU tensor runs the plain PyTorch version; a CUDA
tensor launches the hand-written kernel, and a build or launch failure
raises (no fallback).  A ``meta`` tensor is priced, not computed: its
outputs have the kernel's shapes and dtypes, the kernel's scratch is
allocated on ``meta`` too, and the launch's operations and bytes (the
kernel module's ``cost``) go to an open ``pricing.pricing()`` ledger
(``kernels/pricing.py``; the dry run, ``launch/dryrun.py``).  Nothing on
the main path is on ``meta``: the executor, the trainer and the profilers
build on the card unless told the CPU.  Any other device raises.

Gradients: when grad mode is on and an input requires grad, a CUDA
(or ``meta``) tensor's ``flash_attention``, ``ssd_scan``, ``rglru_scan``
and ``rope`` go through a ``torch.autograd.Function`` whose backward is
a kernel as well (``FlashAttention``, ``SSDScan``, ``RGLRUScan``,
``RoPE``).  ``ssd_scan`` and ``rglru_scan`` take their Function on the
CPU too (the backward kernel's algorithm through the plain versions:
``ssd_scan_bwd_chunks``, the reverse scan), and a CPU ``flash_attention``
or ``rope`` is differentiated by autograd through its plain version.
Without grad the route is the one above.  Each kernel
module's ``FORWARD`` and ``BACKWARD`` map a device type to its entry; its
CPU entries run inside ``pricing.plain``, so the dry run's counters skip
what a plain version does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import rope as _rope
from repro_torch.kernels import ssd_scan as _ssd


def _route(t, name: str) -> str:
    if t.device.type in ("cpu", "cuda", "meta"):
        return t.device.type
    raise ValueError(f"{name}: no implementation for device {t.device}")


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None):
    """q: (B, H, S, Dh); k/v: (B, Hkv, S, Dh).  Returns (B, H, S, Dh).
    ``scale`` is the softmax scale, 1/sqrt(Dh) unless given."""
    route = _route(q, "flash_attention")
    if route != "cpu" and _wants_grad(q, k, v):
        return _flash.FlashAttention.apply(q, k, v, causal, window, scale)
    return _flash.FORWARD[route](q, k, v, causal=causal, window=window,
                                 scale=scale)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: int | None = None, scale: float | None = None):
    """q: (B, H, Dh); caches: (B, S, Hkv, Dh); lengths: (B,) int32.

    Returns (B, H, Dh)."""
    return _decode.FORWARD[_route(q, "decode_attention")](
        q, k_cache, v_cache, lengths, window=window, scale=scale)


def ssd_scan(xh, dt, a, bmat, cmat, h0=None):
    """xh: (B, S, H, P); dt: (B, S, H); a: (H,); bmat/cmat: (B, S, N);
    h0: (B, H, N, P) or None.

    Returns (y (B, S, H, P), h_final (B, H, N, P)), both fp32, except on
    the CPU, where fp64 inputs give fp64 outputs (the exact reference of
    the checks).  Unlike the JAX entry it takes and returns the state, and
    any S works."""
    route = _route(xh, "ssd_scan")
    if _wants_grad(xh, dt, a, bmat, cmat, h0):
        return _ssd.SSDScan.apply(xh, dt, a, bmat, cmat, h0)
    return _ssd.FORWARD[route](xh, dt, a, bmat, cmat, h0)


def rglru_scan(a, b, h0=None):
    """a, b: (B, S, W); h0: (B, W) or None.

    Returns (h_seq (B, S, W), h_last (B, W)), both fp32."""
    route = _route(a, "rglru_scan")
    if _wants_grad(a, b, h0):
        return _rglru.RGLRUScan.apply(a, b, h0)
    return _rglru.FORWARD[route](a, b, h0)


def rope(q, k, positions, theta: float):
    """q: (B, S, H, Dh); k: (B, S, Hkv, Dh); positions: (B, S) int64.

    Returns q and k rotated (split-half RoPE in fp32, cast back to their
    dtype), as two calls of the JAX ``apply_rope`` would; on the card in
    one launch."""
    route = _route(q, "rope")
    if route != "cpu" and _wants_grad(q, k):
        return _rope.RoPE.apply(q, k, positions, theta)
    return _rope.FORWARD[route](q, k, positions, theta)
