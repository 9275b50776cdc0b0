"""Decode attention: the CUDA kernels ``csrc/decode_attention.cu`` and their
plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/decode_attention.py``,
function ``decode_attention`` (body ``_decode_kernel``): one query token
per row against a (B, S, Hkv, Dh) KV cache; slot j of row b is valid when
``j < lengths[b]`` and, with a window, ``j >= lengths[b] - window`` (slot
indices, exactly as the TPU kernel masks them).  Each program serves the
G = H / Hkv query heads of one KV head, so the cache is read once.

What bounds it on the H100: the bytes of the valid part of the KV cache
(the operations are 4*Dh per head and slot, far below the card's ratio of
operations to bytes).  Design: flash-decoding.  One block per (cache
split, KV head, batch row) reads its slice of the cache once for all G
heads, four warps each keeping an fp32 online softmax, four slots' loads
in flight per warp; a second small kernel combines the splits' partial
(max, denominator, accumulator).  Splitting the cache length fills the
132 SMs where B * Hkv blocks (16 for yi-9b at batch 4) could not.  With
recurrentgemma's one KV head at batch 4 the rule gives 68 blocks at a
1032-slot cache and 128 when the 2048-slot ring is full; splits of fewer
slots would give more blocks but lengthen the combine, whose threads walk
the splits one by one (the larger cost on the card, see ``PERF.md``).  The
partials are allocated here with ``torch.empty``; the kernels allocate
nothing.  ``lengths`` stays on the device: the blocks read it themselves,
so a decode step never waits on the host.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

launches = 0  # launches of the CUDA kernel pair (plain calls not counted)

NEG_INF = -1e30
# head dim -> query heads per KV head the kernel is built for (Dh 256 with
# group 10 is recurrentgemma's shape)
GROUPS = {64: (1, 2, 4, 8, 16), 128: (1, 2, 4, 8, 16), 256: (10,)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TARGET_BLOCKS = 2 * 132  # two blocks per SM of an H100
_MIN_SPLIT = 64           # fewest cache slots worth a block of their own

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 +
             [ctypes.c_int64] * 10 +
             [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def decode_attention_torch(q, k_cache, v_cache, lengths, *,
                           window: int | None = None):
    """Plain version.  q: (B, H, Dh); caches: (B, S, Hkv, Dh); lengths: (B,).

    The math of the JAX oracle ``decode_attention_ref``: fp32 inside,
    output in q's dtype.
    """
    b, h, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(b, hkv, h // hkv, dh)
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * (
        1.0 / math.sqrt(dh))
    pos = torch.arange(s, device=q.device)[None, :]
    lens = lengths.to(q.device)[:, None]
    valid = pos < lens
    if window is not None:
        valid &= pos >= lens - window
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v_cache.float())
    return out.reshape(b, h, dh).to(q.dtype)


def _check(q, k_cache, v_cache, lengths, window):
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"decode_attention_cuda: {name} is on "
                             f"{t.device}, not q's CUDA device")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError("decode_attention_cuda: q and caches must "
                             f"share one dtype of {list(_DTYPES)}")
        if t.stride(-1) != 1:
            raise ValueError(f"decode_attention_cuda: {name} needs unit "
                             "stride on the head dim")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention_cuda: shapes q {tuple(q.shape)}"
                         f" k {tuple(k_cache.shape)} v "
                         f"{tuple(v_cache.shape)}")
    b, h, dh = q.shape
    _, s, hkv, dk = k_cache.shape
    if k_cache.shape[0] != b or dk != dh or h % hkv:
        raise ValueError(f"decode_attention_cuda: shapes q {tuple(q.shape)}"
                         f" k {tuple(k_cache.shape)}")
    if h // hkv not in GROUPS.get(dh, ()):
        raise ValueError(f"decode_attention_cuda: head dim {dh} with group "
                         f"{h // hkv} not in {GROUPS}")
    if (lengths.device != q.device or lengths.dtype != torch.int32
            or lengths.shape != (b,) or not lengths.is_contiguous()):
        raise ValueError("decode_attention_cuda: lengths must be a "
                         "contiguous (B,) int32 tensor on q's device")
    if q.numel() == 0 or s == 0:
        raise ValueError("decode_attention_cuda: empty input")
    if window is not None and window < 1:
        raise ValueError("decode_attention_cuda: window must be >= 1")


def split_plan(b: int, hkv: int, s: int) -> tuple[int, int]:
    """(number of cache splits, slots per split) for a launch."""
    n_split = max(1, min(-(-_TARGET_BLOCKS // (b * hkv)), -(-s // _MIN_SPLIT)))
    chunk = -(-s // n_split)
    return -(-s // chunk), chunk


def decode_attention_cuda(q, k_cache, v_cache, lengths, *,
                          window: int | None = None):
    """Launch the kernels.  Same contract as ``decode_attention_torch``;
    every ``lengths[b]`` must be >= 1 (a row with no valid slot gives 0,
    as the TPU kernel does)."""
    global launches
    _check(q, k_cache, v_cache, lengths, window)
    lib = _build.library("decode_attention", _ARGTYPES)
    b, h, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    n_split, chunk = split_plan(b, hkv, s)
    with torch.cuda.device(q.device):
        o = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
        part_ml = torch.empty((2, b, hkv, n_split, g), dtype=torch.float32,
                              device=q.device)
        part_acc = torch.empty((b, hkv, n_split, g, dh),
                               dtype=torch.float32, device=q.device)
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), o.data_ptr(), part_ml[0].data_ptr(),
            part_ml[1].data_ptr(), part_acc.data_ptr(),
            _DTYPES[q.dtype], b, hkv, g, s, dh, n_split, chunk,
            q.stride(0), q.stride(1), k_cache.stride(0), k_cache.stride(1),
            k_cache.stride(2), v_cache.stride(0), v_cache.stride(1),
            v_cache.stride(2), o.stride(0), o.stride(1),
            -1 if window is None else window, 1.0 / math.sqrt(dh),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "decode_attention")
    launches += 1
    return o
