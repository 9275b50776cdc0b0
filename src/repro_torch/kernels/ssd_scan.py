"""Mamba-2 SSD scan: the CUDA kernel ``csrc/ssd_scan.cu`` and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py``, function
``ssd_scan`` (body ``_ssd_kernel``).  Per (batch, head) with headdim P and
state size N, over the sequence:

    h_t = exp(dt_t * a) h_{t-1} + dt_t * B_t x_t^T        (N x P state)
    y_t = C_t^T h_t

computed chunk by chunk as in ``ssd_chunked`` (``src/repro/models/ssm.py``):
inside a chunk the decay-masked gram C B^T times x * dt, plus the carried
state's contribution, then the state update.  Unlike the TPU kernel, the
port's kernel takes an initial state ``h0`` and returns the final state,
so a prefill hands its state to decode; and any S works (positions past S
count as dt = 0, which leaves the state unchanged, as the JAX padding
does).

What bounds it on the H100, at the serving shape (B 4, S 1000, H 48, P 64,
N 128, bf16 x / B / C): bytes.  The function moves about 89 MB (the fp32 y
and the fp32 states in and out are most of it), 0.027 ms at 3.35 TB/s; its
chunked products are about 8 GFLOP on the tensor cores (0.008 ms at 989
TFLOP/s).  Run in fp32 on the CUDA cores, as the first kernel did, the
same recurrence needs 6.3 GFLOP of fp32 and the operations bound it
(0.094 ms at 67 TFLOP/s).

The route is chosen by dtype (not a fallback: both are kernels):

* bf16 x / B / C (the model's serving path): ``ssd_bf16_kernel``, on the
  tensor cores (``mma.sync`` m16n8k16, bf16 in, fp32 accumulate).  The
  JAX kernel computes in fp32 and the check on the card stays at 1e-4 of
  the output's scale, which one bf16 rounding (2^-9) of an fp32 operand
  would fail.  But in every product of a chunk one operand is exactly
  bf16 (C, B or x as the model hands them): the fp32 factors (the decay
  mask, dt, the state) fold into the other operand u, which is split into
  hi = bf16(u) and lo = bf16(u - hi) and multiplied twice, hi v + lo v,
  about 2^-17 relative per element.  Per chunk of 64: the gram C B^T (one
  pass), M' x with M' = [j <= i] exp(cum_i - cum_j) (C B^T)_ij dt_j (two),
  C H for the carried state (two), and the update
  H <- exp(cum_L) H + (B o w dt)^T x (two).  One block of 4 warps owns a
  (batch row, head, 32 of the 64 columns of P): a column of y and of the
  state reads only that column of x, so the 384 blocks of the serving
  shape fill the card in one wave, three to an SM (75,264 bytes of shared
  memory each).  The fp32 state stays in the warps' accumulator registers
  from h0 to h_final and is never rounded; only its hi / lo copy for C H
  goes to shared memory.  B, C and x are staged as bf16 with ``cp.async``,
  the next chunk's loads overlapping this chunk's products.  It needs no
  scratch.
* fp32 x / B / C (the parity path): ``ssd_kernel``, the first kernel,
  unchanged: one block of 256 threads per (head, batch row), the fp32
  state in shared memory, every product on the CUDA cores in fp32.

Both loop over chunks of 64 positions inside a block (the loop replaces
the TPU's sequential chunk axis: CUDA blocks run in no order) and
recompute the gram C B^T for every head (it is shared across heads).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

launches = 0  # kernel launches, one a call (plain-version calls not counted)

NEG_INF = -1e30
CHUNK = 64            # the plain version's chunk (the kernel has its own)
SHAPES = ((128, 64),)  # (N, P) the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 +
             [ctypes.c_int64] * 7 + [ctypes.c_void_p])


def ssd_scan_torch(xh, dt, a, bmat, cmat, h0=None):
    """Plain version, the chunked form of the JAX ``ssd_chunked``.

    xh: (B, S, H, P); dt: (B, S, H) > 0; a: (H,) < 0; bmat, cmat: (B, S, N);
    h0: (B, H, N, P) or None.  Returns y (B, S, H, P) and h_final
    (B, H, N, P), both fp32.
    """
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    pad = -s % CHUNK
    # positions past S get dt = 0: decay 1 and no update, a no-op
    xf = F.pad(xh.float(), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    bf = F.pad(bmat.float(), (0, 0, 0, pad))
    cf = F.pad(cmat.float(), (0, 0, 0, pad))
    nc = (s + pad) // CHUNK
    xdt = (xf * dtf[..., None]).view(b, nc, CHUNK, h, p)
    bc = bf.view(b, nc, CHUNK, n)
    cc = cf.view(b, nc, CHUNK, n)
    cums = torch.cumsum((dtf * a.float()).view(b, nc, CHUNK, h), dim=2)
    lower = torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                       device=xh.device).tril()[None, :, :, None]
    state = (torch.zeros(b, h, n, p, device=xh.device) if h0 is None
             else h0.float())
    ys = []
    for c in range(nc):
        cum = cums[:, c]                                   # (B, L, H)
        gram = torch.einsum("bin,bjn->bij", cc[:, c], bc[:, c])
        # mask the exponent before exp: the upper triangle would overflow
        dec = (cum[:, :, None] - cum[:, None]).masked_fill(~lower, NEG_INF)
        m = dec.exp() * gram[..., None]                    # (B, L, L, H)
        y = torch.einsum("bijh,bjhp->bihp", m, xdt[:, c])
        y = y + torch.einsum("bin,bhnp->bihp", cc[:, c],
                             state) * cum.exp()[..., None]
        tot = cum[:, -1]                                   # (B, H)
        w = (tot[:, None] - cum).exp()                     # (B, L, H)
        state = tot.exp()[:, :, None, None] * state + torch.einsum(
            "bjn,bjh,bjhp->bhnp", bc[:, c], w, xdt[:, c])
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s], state


def _check(xh, dt, a, bmat, cmat, h0):
    dev = xh.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan_cuda: xh is on {dev}, not a CUDA device")
    named = (("xh", xh), ("dt", dt), ("a", a), ("bmat", bmat),
             ("cmat", cmat)) + ((("h0", h0),) if h0 is not None else ())
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"ssd_scan_cuda: {name} is on {t.device}, "
                             f"not xh's CUDA device")
    if xh.dim() != 4:
        raise ValueError("ssd_scan_cuda: xh must be (B, S, H, P)")
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    if (dt.shape != (b, s, h) or a.shape != (h,) or bmat.shape != (b, s, n)
            or cmat.shape != (b, s, n)
            or (h0 is not None and h0.shape != (b, h, n, p))):
        raise ValueError(
            f"ssd_scan_cuda: shapes xh {tuple(xh.shape)} dt "
            f"{tuple(dt.shape)} a {tuple(a.shape)} bmat {tuple(bmat.shape)} "
            f"cmat {tuple(cmat.shape)}"
            + ("" if h0 is None else f" h0 {tuple(h0.shape)}"))
    if (n, p) not in SHAPES:
        raise ValueError(f"ssd_scan_cuda: (N, P) = {(n, p)} not in {SHAPES}")
    if xh.dtype not in _DTYPES or bmat.dtype != xh.dtype or \
            cmat.dtype != xh.dtype:
        raise ValueError("ssd_scan_cuda: xh, bmat and cmat must share one "
                         f"dtype of {list(_DTYPES)}")
    for name, t in (("dt", dt), ("a", a), ("h0", h0)):
        if t is not None and (t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"ssd_scan_cuda: {name} must be a contiguous "
                             "float32 tensor")
    for name, t in (("xh", xh), ("bmat", bmat), ("cmat", cmat)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan_cuda: {name} needs unit stride on "
                             "its last dim")
    if xh.numel() == 0:
        raise ValueError("ssd_scan_cuda: empty input")


def ssd_scan_cuda(xh, dt, a, bmat, cmat, h0=None):
    """Launch the kernel.  Same contract as ``ssd_scan_torch``."""
    global launches
    _check(xh, dt, a, bmat, cmat, h0)
    lib = _build.library("ssd_scan", _ARGTYPES)
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    with torch.cuda.device(xh.device):
        y = torch.empty((b, s, h, p), dtype=torch.float32, device=xh.device)
        h_final = torch.empty((b, h, n, p), dtype=torch.float32,
                              device=xh.device)
        err = lib.ssd_scan_launch(
            xh.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_final.data_ptr(), _DTYPES[xh.dtype], b, s, h,
            p, n, *xh.stride()[:3], *bmat.stride()[:2], *cmat.stride()[:2],
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "ssd_scan")
    launches += 1
    return y, h_final
