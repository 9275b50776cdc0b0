"""Prefill attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``,
function ``flash_attention`` (body ``_flash_kernel``): online softmax over
KV blocks with fp32 running max, denominator and accumulator; causal and/or
sliding-window mask with fully masked KV blocks skipped; GQA (query head h
reads KV head h // group); scale 1/sqrt(Dh); masked logits -1e30;
denominator floored at 1e-30.

What bounds it on the H100: at the serving shapes (B=4, H=32, S <= 1000,
Dh=128) the bytes of q/k/v/o and the causal matmul operations are of the
same order; with S growing the operations (4*Dh per live query-key pair)
take over, so the bf16 kernel is built on the tensor cores.

Design (bf16, the serving path): one thread block per (head, batch row,
query tile of 128; 64 at Dh 256), two consumer warpgroups multiplying with
``wgmma`` (Q K^T from shared memory, P V with P in registers) and a
producer warpgroup keeping K/V tiles in flight by TMA in a two-stage ring;
the online softmax in fp32 registers; fully masked key tiles never loaded and
only edge tiles masked; query tiles launched longest-first.  Dh 160
(stablelm-12b) is padded to 192 columns and Dh 80 (hubert-xlarge) to 128
in shared memory by TMA's zero fill.  hubert runs it non-causal: every
key tile is live and only the ragged last one is masked.  fp32 inputs (the card-vs-CPU parity checks) run the CUDA-core
kernel of the first port.  Any S works: the ragged last tile is masked in
the kernel (the TPU kernel required S to be a multiple of its block).
q/k/v/o are read and written through their strides, so the model's
(B, S, H, Dh) -> (B, H, S, Dh) transpose stays a view; the bf16 kernel's
TMA needs 16-byte aligned bases and strides, which the wrapper checks.
The source note in ``csrc/flash_attention.cu`` has the details.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

launches = 0  # launches of the CUDA kernel (plain-version calls not counted)

NEG_INF = -1e30
HEAD_DIMS = (64, 80, 128, 160, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 +
             [ctypes.c_int64] * 12 +
             [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_lib = None  # the loaded library, once built


def flash_attention_torch(q, k, v, *, causal: bool = True,
                          window: int | None = None):
    """Plain version.  q: (B, H, S, Dh); k/v: (B, Hkv, S, Dh).

    The math of the JAX oracle ``flash_attention_ref``: fp32 inside,
    output in q's dtype.
    """
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    qg = q.float().reshape(b, hkv, h // hkv, s, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * (
        1.0 / math.sqrt(dh))
    pos = torch.arange(s, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    probs = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, h, s, dh).to(q.dtype)


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} must be 4-d")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError("flash_attention_cuda: q/k/v must share one "
                             f"dtype of {list(_DTYPES)}")
        if t.device != q.device:
            raise ValueError("flash_attention_cuda: q/k/v on two devices")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_cuda: {name} needs unit "
                             "stride on the head dim")
    b, h, s, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, dh):
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if h % k.shape[1]:
        raise ValueError("flash_attention_cuda: H must be a multiple of Hkv")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {dh} not in "
                         f"{HEAD_DIMS}")
    if q.numel() == 0:
        raise ValueError("flash_attention_cuda: empty input")
    if window is not None and window < 1:
        raise ValueError("flash_attention_cuda: window must be >= 1")
    if q.dtype == torch.bfloat16:
        # TMA: 16-byte aligned base addresses and strides
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(
                    st % 8 for st, n in zip(t.stride()[:3], t.shape[:3])
                    if n > 1):
                raise ValueError(f"flash_attention_cuda: bf16 {name} needs "
                                 "16-byte aligned base and strides")


def _strides(t) -> list[int]:
    """(batch, head, seq) strides in elements; a dimension of size 1 gets
    the head dim's (any stride is valid there, and the tensor map wants a
    multiple of 16 bytes)."""
    return [st if n > 1 else t.shape[3]
            for st, n in zip(t.stride()[:3], t.shape[:3])]


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int | None = None):
    """Launch the kernel.  Same contract as ``flash_attention_torch``."""
    global launches, _lib
    _check(q, k, v, window)
    if _lib is None:
        _lib = _build.library("flash_attention", _ARGTYPES)
    b, h, s, dh = q.shape
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return flash_attention_cuda(q, k, v, causal=causal, window=window)
    o = torch.empty_like(q)
    err = _lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPES[q.dtype], b, h, k.shape[1], s, dh,
        *_strides(q), *_strides(k), *_strides(v), *_strides(o), int(causal),
        -1 if window is None else window, 1.0 / math.sqrt(dh),
        _build.current_stream(q.device.index))
    _build.check(_lib, err, "flash_attention")
    launches += 1
    return o
