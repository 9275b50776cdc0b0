"""Rotary position embedding of q and k: the CUDA kernel ``csrc/rope.cu``
and its plain PyTorch version.

Replaces no TPU kernel.  The JAX package rotates in jnp
(``src/repro/models/layers.py::apply_rope``) and XLA fuses the chain into
the step; the port's plain version, ``apply_rope``, is the same chain in
PyTorch: 17 operations a call (the frequency table's four, the angles, cos,
sin, the fp32 copy, four products, a difference, a sum, the concatenation
and the cast back), twice a layer, for q and for k.  On the card the host
spent about half of a hubert-xlarge or yi-9b step issuing them.

What bounds it on the H100: bytes.  A rotation is six fp32 operations a
pair of elements, far below the ridge, so the least time reads q and k
once and writes them once in their dtype (4 bytes an element in bf16):
at B 4 x S 1000, hubert-xlarge's 2 x 1280 rotated elements a token are
41.0 MB, 12.2 us at 3.35 TB/s.

Design: one launch rotates q and k together.  A block owns a few
consecutive tokens, computes their (cos, sin) table once in shared memory
and applies it to every query and key head of those tokens, in 16-byte
chunks of each half of a head where the addresses allow; q, k and
positions are read through their strides, so neither a projection's view
nor a prefill's broadcast positions is copied.  The arithmetic is the
plain version's, operation for operation and rounding for rounding in
fp32 (``csrc/rope.cu``), with the frequency table made once per (head
dim, theta, device) by ``rope_freqs`` on the device and kept, so the
kernel's output is the plain version's bit for bit on the card.

``launches`` counts forward calls on the card, one launch each.  The
backward of a rotation is the rotation by minus the angle: the same kernel
with the sine negated (``rope_backward_cuda``, counted in
``bwd_launches``).  ``RoPE`` is the ``torch.autograd.Function`` that
pairs the two; on the CPU autograd differentiates the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, pricing

launches = 0      # forward calls on the card (plain calls not counted)
bwd_launches = 0  # backward calls on the card, one launch each

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
_lib = None  # the loaded library, once built
_plans: dict = {}   # launch signature -> _Params (checked once)
_tables: dict = {}  # (head dim, theta, device) -> rope_freqs there


class _Params(ctypes.Structure):
    """The C entry's ``Params``: a launch's shape and strides."""
    _fields_ = [(n, ctypes.c_int64) for n in (
        "dtype", "B", "S", "H", "Hkv", "D", "sqb", "sqs", "sqh", "skb",
        "sks", "skh", "spb", "sps")]


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10_000.0):
    """Split-half RoPE in fp32.  x: (..., S, H, Dh); positions: (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., :, None, None].float() * freqs   # (..., S, 1, Dh/2)
    cos, sin = ang.cos(), ang.sin()
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_torch(q, k, positions, theta: float):
    """Plain version: ``apply_rope`` of q (B, S, H, Dh) and of k
    (B, S, Hkv, Dh) at positions (B, S).  Returns both, in their dtype."""
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta)


def cost(b: int, s: int, h: int, hkv: int, dh: int, *,
         itemsize: int = 2) -> tuple[int, int]:
    """(operations, bytes) of one call: six a rotated pair (four products,
    a difference, a sum) and one product an angle; q and k read and
    written once in their dtype, the positions (int64) and the frequency
    table (fp32) read once."""
    n = b * s * (h + hkv) * dh
    return 3 * n + b * s * dh // 2, 2 * itemsize * n + 8 * b * s + 2 * dh


def rope_meta(q, k, positions, theta: float, *, kernel: str = "rope"):
    """The meta route (``kernels/pricing.py``): the outputs the CUDA
    wrapper allocates, computed by nothing, and the cost charged to
    ``kernel`` (the backward's route charges ``rope_backward``: the same
    kernel, the same cost)."""
    b, s, h, dh = q.shape
    pricing.charge(kernel, cost(b, s, h, k.shape[2], dh,
                                itemsize=q.element_size()))
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty(k.shape, dtype=k.dtype, device=k.device))


def _check(q, k, positions):
    if q.device.type != "cuda":
        raise ValueError(f"rope_cuda: q is on {q.device}, not a CUDA device")
    for name, t in (("k", k), ("positions", positions)):
        if t.device != q.device:
            raise ValueError(f"rope_cuda: {name} is on {t.device}, not q's "
                             "CUDA device")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"rope_cuda: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} must be (B, S, heads, Dh)")
    b, s, _, dh = q.shape
    if (k.shape[:2] != (b, s) or k.shape[3] != dh
            or positions.shape != (b, s)):
        raise ValueError(f"rope_cuda: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} positions "
                         f"{tuple(positions.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        raise ValueError("rope_cuda: q and k must share one dtype of "
                         f"{list(_DTYPES)}")
    if positions.dtype != torch.int64:
        raise ValueError("rope_cuda: positions must be int64")
    if dh % 2 or q.stride(3) != 1 or k.stride(3) != 1:
        raise ValueError("rope_cuda: Dh must be even, with unit stride")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError("rope_cuda: empty input")


def _library():
    global _lib
    if _lib is None:
        _lib = _build.library("rope", _ARGTYPES)
    return _lib


def _table(dh: int, theta: float, device):
    """``rope_freqs`` on ``device``, made by its first call and kept (the
    stream that made it is waited on once, so any stream may read it)."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("rope_cuda: the frequency table is made by a "
                           "call outside CUDA graph capture (warm up first)")
    table = rope_freqs(dh, theta, device)
    torch.cuda.current_stream(device).synchronize()
    _tables[dh, theta, device] = table
    return table


def _launch(q, k, positions, theta: float, negate: int):
    """One launch; returns the rotated q and k (contiguous, q's dtype).

    A call is host-bound (the kernel takes microseconds), so the contract
    is checked once per signature and a call then allocates the two
    outputs and makes one ctypes call."""
    key = (q.shape, q.stride(), q.dtype, q.device, k.shape, k.stride(),
           k.dtype, k.device, positions.shape, positions.stride(),
           positions.dtype, positions.device)
    params = _plans.get(key)
    if params is None:
        _check(q, k, positions)
        b, s, h, dh = q.shape
        params = _plans[key] = _Params(
            _DTYPES[q.dtype], b, s, h, k.shape[2], dh, *q.stride()[:3],
            *k.stride()[:3], *positions.stride())
    table = _tables.get((q.shape[3], theta, q.device))
    if table is None:
        table = _table(q.shape[3], theta, q.device)
    lib = _lib or _library()
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return _launch(q, k, positions, theta, negate)
    qo = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ko = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    err = lib.rope_launch(
        q.data_ptr(), k.data_ptr(), positions.data_ptr(), table.data_ptr(),
        qo.data_ptr(), ko.data_ptr(), ctypes.addressof(params), negate,
        _build.current_stream(q.device.index))
    if err:
        _build.check(lib, err, "rope")
    return qo, ko


def rope_cuda(q, k, positions, theta: float):
    """Launch the kernel.  Same contract as ``rope_torch``."""
    global launches
    out = _launch(q, k, positions, theta, 0)
    launches += 1
    return out


def rope_backward_cuda(dq, dk, positions, theta: float):
    """The gradients of q and k given those of the rotations, in one
    launch: the kernel with the sine negated (the rotation back)."""
    global bwd_launches
    out = _launch(dq, dk, positions, theta, 1)
    bwd_launches += 1
    return out


# device type -> the forward and the backward (``kernels/ops.py``)
FORWARD = {"cpu": pricing.plain(rope_torch), "meta": rope_meta,
           "cuda": rope_cuda}
BACKWARD = {"meta": functools.partial(rope_meta, kernel="rope_backward"),
            "cuda": rope_backward_cuda}


class RoPE(torch.autograd.Function):
    """The rotation with its backward, the rotation back: for a CUDA tensor
    the kernel twice (``rope_cuda``, ``rope_backward_cuda``), for a
    ``meta`` tensor their meta routes.  Saves the positions."""

    @staticmethod
    def forward(ctx, q, k, positions, theta):
        ctx.save_for_backward(positions)
        ctx.theta = theta
        return FORWARD[q.device.type](q, k, positions, theta)

    @staticmethod
    def backward(ctx, dq, dk):
        positions, = ctx.saved_tensors
        dq, dk = BACKWARD[dq.device.type](dq, dk, positions, ctx.theta)
        return dq, dk, None, None
