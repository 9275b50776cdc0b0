"""Prefill attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``,
function ``flash_attention`` (body ``_flash_kernel``): online softmax over
KV blocks with fp32 running max, denominator and accumulator; causal and/or
sliding-window mask with fully masked KV blocks skipped; GQA (query head h
reads KV head h // group); scale 1/sqrt(Dh) (or a stated ``scale``, the
kernel's argument, as granite's attention multiplier 1/Dh); masked logits
-1e30;
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

The backward (``flash_attention_bwd_cuda``, ``csrc/flash_attention_bwd.cu``)
has no TPU counterpart: the JAX package differentiates its jnp attention
with XLA's autodiff, and its Pallas kernel has no ``custom_vjp``.  It
computes what autograd of ``flash_attention_torch`` computes, from q, k, v
and dO, and leaves the forward kernel as it is, so it recomputes what it
needs.  What bounds it on the H100: operations.  The least work is about
10 * Dh operations per live query-key pair (S, dP, dV, dK, dQ); the
kernels do 18 * Dh (S and dP twice in the first pass, once in the
second).  bf16 runs on the tensor cores (``wgmma``, tiles by TMA through
a two-stage ring, tiles of 64 queries or keys): a first kernel per query
tile sweeps the live key tiles twice, once for each row's log-sum-exp and
D = rowsum(P * dP) (not rowsum(dO * O): the forward's O is rounded to
bf16, which would reach dQ in a row whose gradient cancels) and once for
dQ += dS K; a second kernel per (query head, key tile) takes dV += P^T dO
and dK += dS^T Q over the live query tiles, one consumer warpgroup for
each, P and dS rounded to bf16 as the products' register operand.  dK and
dV are taken per query head, as fp32 partials that a last pass sums over
the GQA group in a fixed order, so a group's heads run in parallel, no
atomics are needed and two calls give bitwise-equal gradients.  fp32 (the
card-vs-CPU parity path, held to fp64) keeps the CUDA-core kernels of the
first version: TF32 would miss its tolerance.
``flash_attention_bwd_tiles`` is a plain emulation of the bf16 kernels'
tile algorithm, and ``FlashAttention`` the ``torch.autograd.Function``
that pairs the forward and backward kernels.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build, pricing

launches = 0  # launches of the CUDA kernel (plain-version calls not counted)
bwd_launches = 0  # calls of the backward kernels' entry, one per backward

NEG_INF = -1e30
HEAD_DIMS = (64, 80, 128, 160, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 +
             [ctypes.c_int64] * 12 +
             [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
_lib = None  # the loaded library, once built
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 +
                 [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                  ctypes.c_void_p])


def _scale(dh: int, scale: float | None) -> float:
    return 1.0 / math.sqrt(dh) if scale is None else scale


def flash_attention_torch(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          scale: float | None = None):
    """Plain version.  q: (B, H, S, Dh); k/v: (B, Hkv, S, Dh).

    The math of the JAX oracle ``flash_attention_ref``: fp32 inside (fp64
    for fp64 inputs, the exact reference of the gradient checks), output
    in q's dtype.
    """
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    inner = torch.promote_types(q.dtype, torch.float32)
    qg = q.to(inner).reshape(b, hkv, h // hkv, s, dh)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(inner)) * (
        _scale(dh, scale))
    pos = torch.arange(s, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    probs = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.to(inner))
    return out.reshape(b, h, s, dh).to(q.dtype)


def live_pairs(s: int, causal: bool, window) -> int:
    """Query-key pairs the mask lets through, per (row, head): the work
    this shape needs."""
    q = np.arange(s)
    hi = q + 1 if causal else np.full(s, s)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(s, int)
    return int((hi - lo).sum())


def cost(b: int, h: int, hkv: int, s: int, dh: int, *, causal: bool = True,
         window: int | None = None, itemsize: int = 2) -> tuple[int, int]:
    """(operations, bytes) of one forward call: 4 Dh operations per live
    query-key pair and query head (Q K^T and P V, a multiply-add each), and
    q, k, v read once, o written once."""
    ops = 4 * dh * live_pairs(s, causal, window) * b * h
    return ops, itemsize * (2 * b * h * s * dh + 2 * b * hkv * s * dh)


def bwd_cost(b: int, h: int, hkv: int, s: int, dh: int, *,
             causal: bool = True, window: int | None = None,
             itemsize: int = 2) -> tuple[int, int]:
    """(operations, bytes) of one backward call: the least work, 10 Dh
    operations per live pair and query head (S, dP, dV, dK, dQ); q, dO, k,
    v read once, dq, dk, dv written once (o is not read)."""
    ops = 10 * dh * live_pairs(s, causal, window) * b * h
    return ops, itemsize * (3 * b * h * s * dh + 4 * b * hkv * s * dh)


def _cost_of(q, k, causal, window, of=cost):
    b, h, s, dh = q.shape
    return of(b, h, k.shape[1], s, dh, causal=causal, window=window,
              itemsize=q.element_size())


def flash_attention_meta(q, k, v, *, causal: bool = True,
                         window: int | None = None,
                         scale: float | None = None):
    """The meta route (``kernels/pricing.py``): the kernel's output,
    computed by nothing, and its cost charged."""
    pricing.charge("flash_attention", _cost_of(q, k, causal, window))
    return torch.empty_like(q)


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
                         window: int | None = None,
                         scale: float | None = None):
    """Launch the kernel.  Same contract as ``flash_attention_torch``."""
    global launches, _lib
    _check(q, k, v, window)
    if _lib is None:
        _lib = _build.library("flash_attention", _ARGTYPES)
    b, h, s, dh = q.shape
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                        scale=scale)
    o = torch.empty_like(q)
    err = _lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPES[q.dtype], b, h, k.shape[1], s, dh,
        *_strides(q), *_strides(k), *_strides(v), *_strides(o), int(causal),
        -1 if window is None else window, _scale(dh, scale),
        _build.current_stream(q.device.index))
    _build.check(_lib, err, "flash_attention")
    launches += 1
    return o


# -------------------------------------------------------------- backward --


# queries or keys a tile of the bf16 backward kernels
# (``csrc/flash_attention_bwd.cu``: ``BT``, wgmma's M)
BWD_TILE = 64


def _visible(qi, kj, causal: bool, window):
    """(len(qi), len(kj)) mask of the query-key pairs the forward keeps."""
    ok = torch.ones(len(qi), len(kj), dtype=torch.bool, device=qi.device)
    if causal:
        ok &= kj[None] <= qi[:, None]
    if window is not None:
        ok &= kj[None] > qi[:, None] - window
    return ok


def flash_attention_bwd_tiles(q, k, v, do, *, causal: bool = True,
                              window: int | None = None):
    """Plain emulation of the bf16 backward kernels' tile algorithm, in fp32.

    q/do: (B, H, S, Dh); k/v: (B, Hkv, S, Dh).  Returns (dq, dk, dv) in
    the dtypes of q, k and v.  The kernels' two passes over tiles of
    ``BWD_TILE`` queries or keys: per (head, query tile) a first sweep over
    the live key tiles for each row's log-sum-exp and D = rowsum(P * dP),
    online, and a second for dQ += dS K; per (query head, key tile) dV +=
    P^T dO and dK += dS^T Q over the live query tiles, summed over the GQA
    group in order.  1/sqrt(Dh) scales dQ and dK after the products.  For
    bf16 inputs P and dS are rounded to bf16 where the kernels round them,
    as the products' register operand; fp32 inputs keep them in fp32 (the
    algebra of the fp32 kernels).  The CPU tests hold it against autograd
    of ``flash_attention_torch``.
    """
    b, h, s, dh = q.shape
    group, t = h // k.shape[1], BWD_TILE
    scale = 1.0 / math.sqrt(dh)

    def rnd(x):
        return x.bfloat16().float() if q.dtype == torch.bfloat16 else x

    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    pos = torch.arange(s, device=q.device)
    lse = torch.empty(b, h, s, device=q.device)
    delta = torch.empty(b, h, s, device=q.device)

    def key_tiles(q0):
        q_last = min(q0 + t, s) - 1
        begin = max(0, q0 - window + 1) // t * t if window else 0
        return range(begin, q_last + 1 if causal else s, t)

    def query_tiles(k0):
        k_last = min(k0 + t, s) - 1
        end = min(s, k_last + window) if window else s
        return range(k0 if causal else 0, end, t)

    def logits(hq, q0, k0):
        """The scaled logits (masked: -inf) and dP of one pair of tiles."""
        qi, kj = pos[q0:q0 + t], pos[k0:k0 + t]
        sc = qf[:, hq, q0:q0 + t] @ kf[:, hq // group, k0:k0 + t].mT
        dp = dof[:, hq, q0:q0 + t] @ vf[:, hq // group, k0:k0 + t].mT
        return (sc * scale).masked_fill(~_visible(qi, kj, causal, window),
                                        -math.inf), dp

    # kernel 1, per (head, query tile): sweep 1, the log-sum-exp and D of
    # every row, online (a running max m, and l = sum exp(S - m), u = sum
    # exp(S - m) dP, rescaled as m grows; lse = m + log l, D = u / l);
    # sweep 2, dQ += dS K with dS = P (dP - D)
    dq = torch.zeros_like(qf)
    for hq in range(h):
        for q0 in range(0, s, t):
            rows = len(pos[q0:q0 + t])
            m = torch.full((b, rows), NEG_INF, device=q.device)
            l = torch.zeros(b, rows, device=q.device)
            u = torch.zeros(b, rows, device=q.device)
            for k0 in key_tiles(q0):
                sc, dp = logits(hq, q0, k0)
                m_new = torch.maximum(m, sc.amax(-1))
                p = torch.exp(sc - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                u = u * corr + (p * dp).sum(-1)
                m = m_new
            l = l.clamp_min(1e-30)
            lse[:, hq, q0:q0 + t] = m + torch.log(l)
            delta[:, hq, q0:q0 + t] = u / l
            for k0 in key_tiles(q0):
                sc, dp = logits(hq, q0, k0)
                ds = torch.exp(sc - lse[:, hq, q0:q0 + t, None]) * (
                    dp - delta[:, hq, q0:q0 + t, None])
                dq[:, hq, q0:q0 + t] += rnd(ds) @ kf[:, hq // group,
                                                     k0:k0 + t]
    # kernel 2, per (query head, key tile): that head's share of dK and dV
    # over the live query tiles; then the shares of a GQA group summed in
    # order
    part_k = torch.zeros(b, h, s, dh, device=q.device)
    part_v = torch.zeros(b, h, s, dh, device=q.device)
    for hq in range(h):
        for k0 in range(0, s, t):
            for q0 in query_tiles(k0):
                sc, dp = logits(hq, q0, k0)
                p = torch.exp(sc - lse[:, hq, q0:q0 + t, None])
                ds = p * (dp - delta[:, hq, q0:q0 + t, None])
                part_v[:, hq, k0:k0 + t] += rnd(p).mT @ dof[:, hq, q0:q0 + t]
                part_k[:, hq, k0:k0 + t] += rnd(ds).mT @ qf[:, hq, q0:q0 + t]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for hq in range(h):
        dk[:, hq // group] += part_k[:, hq] * scale
        dv[:, hq // group] += part_v[:, hq]
    return ((dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _aligned16(t) -> bool:
    """The backward's 16-byte loads (fp32) and TMA tiles (bf16): base and
    (batch, head, seq) strides 16-byte aligned, the head dim contiguous."""
    per = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % per == 0 for st, n in zip(t.stride()[:3],
                                                   t.shape[:3]) if n > 1))


def flash_attention_bwd_cuda(q, k, v, do, *, causal: bool = True,
                             window: int | None = None,
                             scale: float | None = None):
    """Launch the backward kernels: (dq, dk, dv) of ``flash_attention_cuda(q,
    k, v, ...)`` for the incoming gradient ``do`` (B, H, S, Dh), each in
    its input's dtype and layout.  Same arguments as the forward."""
    global bwd_launches
    _check(q, k, v, window)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError("flash_attention_bwd_cuda: do must match q's "
                         "shape, dtype and device")
    if not _aligned16(do):
        do = do.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _aligned16(t):
            raise ValueError(f"flash_attention_bwd_cuda: {name} needs "
                             "16-byte aligned base and strides")
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return flash_attention_bwd_cuda(q, k, v, do, causal=causal,
                                            window=window, scale=scale)
    lib = _build.library("flash_attention_bwd", _BWD_ARGTYPES)
    b, h, s, dh = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # fp32 scratch: each row's lse and D, and where a KV head serves a
    # group, dK and dV partials per query head
    n_stats = b * h * s
    n_part = 2 * n_stats * dh if h > k.shape[1] else 0
    scratch = torch.empty(2 * n_stats + n_part, dtype=torch.float32,
                          device=q.device)
    base = scratch.data_ptr()
    strides = (ctypes.c_int64 * 21)(*[
        st for t in (q, k, v, do, dq, dk, dv) for st in _strides(t)])
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        base, base + 4 * n_stats, base + 8 * n_stats if n_part else None,
        _DTYPES[q.dtype], b, h,
        k.shape[1], s, dh, strides, int(causal),
        -1 if window is None else window, _scale(dh, scale),
        _build.current_stream(q.device.index))
    _build.check(lib, err, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv


def flash_attention_bwd_meta(q, k, v, do, *, causal: bool = True,
                             window: int | None = None,
                             scale: float | None = None):
    """The backward's meta route: the gradients and the scratch the CUDA
    wrapper allocates, computed by nothing, and its cost charged."""
    pricing.charge("flash_attention_backward",
                   _cost_of(q, k, causal, window, bwd_cost))
    if not _aligned16(do):  # a meta tensor's base address is 0
        do = do.contiguous()
    b, h, s, dh = q.shape
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    n_stats = b * h * s
    n_part = 2 * n_stats * dh if h > k.shape[1] else 0
    torch.empty(2 * n_stats + n_part, dtype=torch.float32, device=q.device)
    return grads


# device type -> the forward and the backward (``kernels/ops.py``); a CPU
# tensor is differentiated by autograd through the plain version
FORWARD = {"cpu": pricing.plain(flash_attention_torch),
           "meta": flash_attention_meta, "cuda": flash_attention_cuda}
BACKWARD = {"meta": flash_attention_bwd_meta,
            "cuda": flash_attention_bwd_cuda}


class FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernels as its gradient (CUDA
    tensors; ``meta`` tensors take the meta route of both).  Saves q, k and
    v; the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale=None):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return FORWARD[q.device.type](q, k, v, causal=causal, window=window,
                                      scale=scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = BACKWARD[q.device.type](q, k, v, do, causal=ctx.causal,
                                             window=ctx.window,
                                             scale=ctx.scale)
        return dq, dk, dv, None, None, None
