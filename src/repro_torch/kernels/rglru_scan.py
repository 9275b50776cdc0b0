"""RG-LRU linear scan: the CUDA kernel ``csrc/rglru_scan.cu`` and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/rglru_scan.py``,
function ``rglru_scan`` (body ``_rglru_kernel``): the linear recurrence
h_t = a_t * h_{t-1} + b_t over (B, S, W), in fp32, with the state carried
along the whole sequence.  Unlike the TPU kernel, the port's kernel takes
an initial state ``h0`` and returns the last one (as the JAX
``ref.rglru_scan_ref`` does), and any S works.

What bounds it on the H100: bytes.  At the serving shape (B 4, S 1000,
W 2560, fp32) it reads a and b once and writes h once, 123 MB, 0.037 ms at
3.35 TB/s; the operations (one FMA per element) are negligible.  Design:
one thread per (batch row, lane) walks t with h in a register; neighbouring
threads take neighbouring lanes, so every load and store of a warp is one
coalesced 128-byte line.  The S steps depend on each other, so the kernel
is bound by memory latency unless many loads are in flight: each thread
issues the loads of 16 steps before it runs them, and blocks of 64 threads
(160 blocks at the serving shape) spread the warps over all 132 SMs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0  # launches of the CUDA kernel (plain-version calls not counted)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 +
             [ctypes.c_int64] * 4 + [ctypes.c_void_p])


def rglru_scan_torch(a, b, h0=None):
    """Plain version: the sequential recurrence of ``ref.rglru_scan_ref``.

    a, b: (B, S, W); h0: (B, W) or None.  Returns h_seq (B, S, W) and
    h_last (B, W), both fp32.
    """
    bsz, s, w = a.shape
    af, bf = a.float(), b.float()
    h = (torch.zeros(bsz, w, device=a.device) if h0 is None
         else h0.float())
    out = torch.empty(bsz, s, w, device=a.device)
    for t in range(s):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out, h


def _check(a, b, h0):
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_cuda: a is on {a.device}, not a CUDA "
                         "device")
    for name, t in (("b", b), ("h0", h0)):
        if t is not None and t.device != a.device:
            raise ValueError(f"rglru_scan_cuda: {name} is on {t.device}, "
                             "not a's CUDA device")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan_cuda: shapes a {tuple(a.shape)} b "
                         f"{tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError("rglru_scan_cuda: a and b must share one dtype of "
                         f"{list(_DTYPES)}")
    if a.stride(-1) != 1 or b.stride(-1) != 1:
        raise ValueError("rglru_scan_cuda: a and b need unit stride on W")
    if h0 is not None and (h0.shape != (a.shape[0], a.shape[2])
                           or h0.dtype != torch.float32
                           or not h0.is_contiguous()):
        raise ValueError("rglru_scan_cuda: h0 must be a contiguous (B, W) "
                         "float32 tensor")
    if a.numel() == 0:
        raise ValueError("rglru_scan_cuda: empty input")


def rglru_scan_cuda(a, b, h0=None):
    """Launch the kernel.  Same contract as ``rglru_scan_torch``."""
    global launches
    _check(a, b, h0)
    lib = _build.library("rglru_scan", _ARGTYPES)
    bsz, s, w = a.shape
    with torch.cuda.device(a.device):
        h_seq = torch.empty((bsz, s, w), dtype=torch.float32,
                            device=a.device)
        h_last = torch.empty((bsz, w), dtype=torch.float32, device=a.device)
        err = lib.rglru_scan_launch(
            a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), h_seq.data_ptr(),
            h_last.data_ptr(), _DTYPES[a.dtype], bsz, s, w,
            *a.stride()[:2], *b.stride()[:2],
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "rglru_scan")
    launches += 1
    return h_seq, h_last
