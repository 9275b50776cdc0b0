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

The backward (``csrc/ssd_scan_bwd.cu``; the TPU kernel has none, the JAX
package differentiates its jnp ``ssd_chunked``) computes dx, ddt, da, dB,
dC and dh0 by the equations of ``ssd_scan_bwd_chunks``, its CPU
emulation.  What bounds it at mamba2's training shape (B 4, S 1024, H 48,
bf16 x / B / C, fp32 dy): bytes, about 106 MB (x, dt, B, C and dy read,
the gradients written), 0.032 ms at 3.35 TB/s; its chunked products are
2.9e10 operations, 0.029 ms on the tensor cores.  Both routes recompute
the chunk-start states in a forward sweep rather than have the forward
save them (the forward keeps its state in registers and writes only
h_final; the states are 101 MB fp32 a layer at the training shape, held
only for the call in the kernel's scratch, written and read once), then
walk the chunks in reverse with the fp32 carry dH.  dB and dC sum over the
heads and da over the batch rows: each block writes fp32 partials and a
second kernel sums them in a fixed order, so two calls give bitwise-equal
gradients (no float atomics).  The route is chosen by dtype, as the
forward's:

* bf16 x / B / C (the training path): ``ssd_bwd_bf16_kernel``, on the
  tensor cores with the forward's precision scheme (one operand exactly
  bf16, the fp32 one split into hi / lo: two passes; three, hi hi + hi lo
  + lo hi, where both are fp32: M^T dy and H dy^T).  One block of 4 warps
  per (batch row, head, 32 of the 64 columns of P), as the forward: column
  p of dx, dh0 and the carry reads only column p of x, dy, h0 and
  dh_final, and every other gradient is a sum over p, so the blocks write
  their shares of ddt, da, dB and dC and ``ssd_bwd_bf16_sum`` adds the
  column blocks and heads (403 MB of dB / dC partials at the training
  shape).  Per chunk three phases, each with its own warp layout so that
  the L x L tiles stay in registers as A operands: by rows i (G = C B^T,
  dM = dy x^T dt, dG and E; dG's hi / lo tiles go to shared memory), by
  rows j (G^T recomputed into M^T, du = M^T dy + w B dH, dx), by rows n of
  the transposes (H dy^T with H from the scratch, dC^T and dB^T written as
  the block's partials, the carry in accumulator registers).  75,536
  bytes of shared memory and 168 registers: three blocks an SM, the 384
  blocks of the training shape in one wave.
* fp32 x / B / C (the parity path): ``ssd_bwd_kernel``, the first kernel,
  unchanged: one block of 256 threads per (batch row, head), every product
  in fp32 on the CUDA cores, then ``ssd_bwd_sum`` over the heads'
  partials (201 MB).

``SSDScan`` pairs the forward and backward for autograd;
``bwd_launches`` counts backward calls on the card.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, pricing

launches = 0  # kernel launches, one a call (plain-version calls not counted)
bwd_launches = 0  # backward passes on the card (``ssd_scan_bwd_cuda``)

NEG_INF = -1e30
CHUNK = 64            # the plain version's chunk (the kernel has its own)
KERNEL_CHUNK = 64     # the kernels' chunk (``L`` in both CUDA sources)
SHAPES = ((128, 64),)  # (N, P) the kernel is built for
COL_BLOCK = 32        # columns of P a bf16 block owns (the kernels' PB)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 +
             [ctypes.c_int64] * 7 + [ctypes.c_void_p])


def _compute_dtype(xh) -> torch.dtype:
    """fp32, or fp64 for fp64 inputs (the exact reference of the checks)."""
    return torch.float64 if xh.dtype == torch.float64 else torch.float32


def cost(b: int, s: int, h: int, p: int, n: int, *, dtype=torch.bfloat16,
         with_h0: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one forward call.  Bytes: x, B and C read
    once (in ``dtype``), dt and a (fp32), y written (fp32), h0 read and
    h_final written (fp32).  Operations of the route ``dtype`` takes: bf16,
    the chunked form's products on the tensor cores (chunks of L = 64): the
    gram C B^T (2 L N a position, shared by the heads), and per head M' x
    (2 L P), C H and the state update (2 N P each); fp32, the recurrence
    on the CUDA cores: decay and update, then C^T h, per element of every
    (position, head) state."""
    item = 2 if dtype == torch.bfloat16 else 4
    nbytes = (item * (b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h)
              + 4 * (b * s * h * p + b * h * n * p * (1 + with_h0)))
    ell = KERNEL_CHUNK
    if dtype == torch.bfloat16:
        return 2 * b * s * (ell * n + h * (ell * p + 2 * n * p)), nbytes
    return 4 * b * s * h * n * p, nbytes


def bwd_cost(b: int, s: int, h: int, p: int, n: int, *,
             dtype=torch.bfloat16, with_h0: bool = False,
             with_dh_final: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one backward call.  Bytes: x, B, C read and
    dx, dB, dC written (in ``dtype``), dt, a read and ddt, da written
    (fp32), dy read (fp32), h0 read and dh0 written, dh_final read.
    Operations (chunks of L = 64): the gram, per head dM and M^T dy (2 L P
    each), dG B and dG^T C (2 L N each), and six products of 2 N P (C H,
    B dH, dy H^T, u dH^T, C^T dy, the recomputed state update)."""
    item = 2 if dtype == torch.bfloat16 else 4
    x_el, bc_el, dt_el = b * s * h * p, 2 * b * s * n, b * s * h
    nbytes = (2 * item * (x_el + bc_el) + 2 * 4 * (dt_el + h) + 4 * x_el
              + 4 * b * h * n * p * (2 * with_h0 + with_dh_final))
    ell = KERNEL_CHUNK
    ops = 2 * b * s * (ell * n + h * (2 * ell * p + 2 * ell * n + 6 * n * p))
    return ops, nbytes


def ssd_scan_meta(xh, dt, a, bmat, cmat, h0=None):
    """The meta route (``kernels/pricing.py``): the kernel's outputs,
    computed by nothing, and its cost charged."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    pricing.charge("ssd_scan", cost(b, s, h, p, n, dtype=xh.dtype,
                                    with_h0=h0 is not None))
    f32 = dict(dtype=torch.float32, device=xh.device)
    return torch.empty((b, s, h, p), **f32), torch.empty((b, h, n, p), **f32)


def ssd_scan_bwd_meta(xh, dt, a, bmat, cmat, h0, dy, dh_final):
    """The backward's meta route: the gradients and the scratch
    ``ssd_scan_bwd_cuda`` allocates, computed by nothing, and its cost
    charged."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    pricing.charge("ssd_scan_backward",
                   bwd_cost(b, s, h, p, n, dtype=xh.dtype,
                            with_h0=h0 is not None,
                            with_dh_final=dh_final is not None))
    f32 = dict(dtype=torch.float32, device=xh.device)
    grads = (torch.empty((b, s, h, p), **f32), torch.empty((b, s, h), **f32),
             torch.empty((h,), **f32), torch.empty((b, s, n), **f32),
             torch.empty((b, s, n), **f32), torch.empty((b, h, n, p), **f32))
    torch.empty(sum(bwd_scratch_sizes(b, s, h, p, n, xh.dtype).values()),
                **f32)
    return grads


def ssd_scan_torch(xh, dt, a, bmat, cmat, h0=None):
    """Plain version, the chunked form of the JAX ``ssd_chunked``.

    xh: (B, S, H, P); dt: (B, S, H) > 0; a: (H,) < 0; bmat, cmat: (B, S, N);
    h0: (B, H, N, P) or None.  Returns y (B, S, H, P) and h_final
    (B, H, N, P), both fp32 (fp64 for fp64 inputs).
    """
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    ft = _compute_dtype(xh)
    pad = -s % CHUNK
    # positions past S get dt = 0: decay 1 and no update, a no-op
    xf = F.pad(xh.to(ft), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.to(ft), (0, 0, 0, pad))
    bf = F.pad(bmat.to(ft), (0, 0, 0, pad))
    cf = F.pad(cmat.to(ft), (0, 0, 0, pad))
    nc = (s + pad) // CHUNK
    xdt = (xf * dtf[..., None]).view(b, nc, CHUNK, h, p)
    bc = bf.view(b, nc, CHUNK, n)
    cc = cf.view(b, nc, CHUNK, n)
    cums = torch.cumsum((dtf * a.to(ft)).view(b, nc, CHUNK, h), dim=2)
    lower = torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                       device=xh.device).tril()[None, :, :, None]
    state = (torch.zeros(b, h, n, p, device=xh.device, dtype=ft)
             if h0 is None else h0.to(ft))
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


# -------------------------------------------------------------- backward --


def ssd_scan_bwd_chunks(xh, dt, a, bmat, cmat, h0, dy, dh_final,
                        product=torch.einsum):
    """Gradients of ``y, h_final = ssd_scan(xh, dt, a, bmat, cmat, h0)``
    by the backward kernels' algorithm (``csrc/ssd_scan_bwd.cu``),
    vectorised over batch and head, looping over chunks only.

    ``dy`` (B, S, H, P) and ``dh_final`` (B, H, N, P) are the incoming
    gradients; either may be None (zero), as may ``h0``.  Returns dx
    (B, S, H, P), ddt (B, S, H), da (H,), dB, dC (B, S, N) and dh0
    (B, H, N, P), all fp32 (fp64 for fp64 inputs).  ``product(eq, u, v)``
    computes each matrix product of two operands (``torch.einsum`` by
    default; the CPU tests pass one that multiplies as the bf16 kernel's
    tensor cores do); the other sums are plain.

    First the chunk-start states H_c, forward from h0 (the kernels' first
    sweep); then, over the chunks in reverse with the carry dH' (the
    gradient of the chunk's end state, ``dh_final`` at the last chunk),
    per (batch row, head) and chunk, in the forward's notation (cum the
    inclusive cumulative sum of dt a in the chunk, tot its last entry,
    u = dt x, w_j = exp(tot - cum_j), G = C B^T,
    M_ij = [i >= j] exp(cum_i - cum_j) G_ij):

        dM_ij = [i >= j] (dy x^T)_ij dt_j    dG = dM o exp(cum_i - cum_j)
        du_j  = sum_i M_ij dy_i + w_j dH'^T B_j
        Z     = H dy^T                       (N x L)
        dC_i  = sum_j dG_ij B_j + exp(cum_i) Z_i
        dB_j  = sum_i dG_ij C_i + w_j dt_j dH' x_j
        dcum  = rowsum(E) - colsum(E) + exp(cum_i) C_i . Z_i
                - w_j u_j . (dH'^T B_j),   E = dM o M,
                plus <dH', H'> at the chunk's last position
        ds    = the reverse cumulative sum of dcum in the chunk
        ddt   = a ds + x . du,  dx = dt du,  da = sum dt ds
        dH   <- exp(tot) dH' + sum_i C_i exp(cum_i) dy_i^T

    with <dH', H'> = exp(tot) <dH', H> + the sum of the u . (dH'^T B)
    terms, so the end state is not needed.  dB and dC sum over the heads.
    Positions past S count as dt = 0 and zero inputs, as in the forward,
    and their gradients are dropped.
    """
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    ft = _compute_dtype(xh)
    dev = xh.device
    pad = -s % CHUNK
    nc = (s + pad) // CHUNK
    x = F.pad(xh.to(ft), (0, 0, 0, 0, 0, pad)).view(b, nc, CHUNK, h, p)
    dtf = F.pad(dt.to(ft), (0, 0, 0, pad)).view(b, nc, CHUNK, h)
    bc = F.pad(bmat.to(ft), (0, 0, 0, pad)).view(b, nc, CHUNK, n)
    cc = F.pad(cmat.to(ft), (0, 0, 0, pad)).view(b, nc, CHUNK, n)
    g = (torch.zeros_like(x) if dy is None else
         F.pad(dy.to(ft), (0, 0, 0, 0, 0, pad)).view(b, nc, CHUNK, h, p))
    af = a.to(ft)
    u = x * dtf[..., None]
    cums = torch.cumsum(dtf * af, dim=2)                 # (B, nc, L, H)
    lower = torch.ones(CHUNK, CHUNK, dtype=torch.bool,
                       device=dev).tril()[None, :, :, None]

    state = (torch.zeros(b, h, n, p, device=dev, dtype=ft) if h0 is None
             else h0.to(ft))
    starts = []
    for c in range(nc):
        starts.append(state)
        cum = cums[:, c]
        tot = cum[:, -1]
        sw = (tot[:, None] - cum).exp() * dtf[:, c]      # w dt, (B, L, H)
        state = tot.exp()[:, :, None, None] * state + product(
            "bjhn,bjhp->bhnp", bc[:, c][:, :, None] * sw[..., None],
            x[:, c])

    dh = (torch.zeros(b, h, n, p, device=dev, dtype=ft) if dh_final is None
          else dh_final.to(ft))
    da = torch.zeros(h, device=dev, dtype=ft)
    dxs, ddts, dbs, dcs = [], [], [], []
    for c in reversed(range(nc)):
        cum = cums[:, c]                                 # (B, L, H)
        tot = cum[:, -1]                                 # (B, H)
        es = cum.exp()
        w = (tot[:, None] - cum).exp()
        hs, bb, cb = starts[c], bc[:, c], cc[:, c]
        xc, uc, gc, dtc = x[:, c], u[:, c], g[:, c], dtf[:, c]
        dec = (cum[:, :, None] - cum[:, None]).masked_fill(
            ~lower, NEG_INF).exp()                       # (B, L, L, H)
        m = dec * product("bin,bjn->bij", cb, bb)[..., None]
        dm = product("bihp,bjhp->bijh", gc, xc) * dtc[:, None] * lower
        dg = dm * dec
        e = dm * m
        bd = product("bjn,bhnp->bjhp", bb, dh)           # dH'^T B_j
        du = product("bijh,bihp->bjhp", m, gc) + w[..., None] * bd
        z = product("bhnp,bihp->bhni", hs, gc)           # H dy^T
        t1 = es * torch.einsum("bin,bhni->bih", cb, z)
        t2 = w * (bd * uc).sum(-1)
        dcum = e.sum(2) - e.sum(1) + t1 - t2
        dcum[:, -1] += tot.exp() * (dh * hs).sum((-2, -1)) + t2.sum(1)
        ds = dcum.flip(1).cumsum(1).flip(1)
        ddts.append(af * ds + (xc * du).sum(-1))
        da = da + (dtc * ds).sum((0, 1))
        dxs.append(dtc[..., None] * du)
        dcs.append((product("bijh,bjn->bihn", dg, bb)
                    + es[..., None] * z.permute(0, 3, 1, 2)).sum(2))
        dbs.append((product("bijh,bin->bjhn", dg, cb)
                    + (w * dtc)[..., None]
                    * product("bjhp,bhnp->bjhn", xc, dh)).sum(2))
        dh = tot.exp()[:, :, None, None] * dh + product(
            "bihn,bihp->bhnp", cb[:, :, None] * es[..., None], gc)

    def seq(chunks):
        return torch.cat(chunks[::-1], dim=1)[:, :s]

    return seq(dxs), seq(ddts), da, seq(dbs), seq(dcs), dh


_BWD_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 +
                 [ctypes.c_int64] * 7 + [ctypes.c_void_p])


def bwd_scratch_sizes(b: int, s: int, h: int, p: int, n: int,
                      dtype=torch.float32) -> dict:
    """fp32 entries of the backward kernel's scratch: the chunk-start
    states it recomputes (B, H, chunks, N, P); the partials of dB and dC
    (K, B, S, N each), K = H for fp32 x / B / C (a block per head) and
    H P / 32 for bf16 (a block per head and 32 columns of P); and ``da``:
    the partials of da, (B, H) for fp32, and for bf16 (P / 32, B, H)
    followed by ddt's (P / 32, B, S, H)."""
    n_chunks = -(-s // CHUNK)
    cols = p // COL_BLOCK if dtype == torch.bfloat16 else 1
    return {"states": b * h * n_chunks * n * p, "db": cols * h * b * s * n,
            "dc": cols * h * b * s * n,
            "da": cols * b * h + (cols * b * s * h if cols > 1 else 0)}


def ssd_scan_bwd_cuda(xh, dt, a, bmat, cmat, h0, dy, dh_final):
    """Launch the backward route of xh's dtype (bf16: ``ssd_bwd_bf16_kernel``
    then ``ssd_bwd_bf16_sum``; fp32: ``ssd_bwd_kernel`` then
    ``ssd_bwd_sum``).  Same contract as ``ssd_scan_bwd_chunks``: every
    gradient fp32."""
    global bwd_launches
    _check(xh, dt, a, bmat, cmat, h0)
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    for name, t, shape in (("dy", dy, (b, s, h, p)),
                           ("dh_final", dh_final, (b, h, n, p))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or not t.is_contiguous()
                              or t.device != xh.device):
            raise ValueError(f"ssd_scan_bwd_cuda: {name} must be a "
                             f"contiguous float32 {shape} tensor on "
                             f"{xh.device}")
    lib = _build.library("ssd_scan_bwd", _BWD_ARGTYPES)
    sizes = bwd_scratch_sizes(b, s, h, p, n, xh.dtype)
    with torch.cuda.device(xh.device):
        f32 = dict(dtype=torch.float32, device=xh.device)
        dx = torch.empty((b, s, h, p), **f32)
        ddt = torch.empty((b, s, h), **f32)
        da = torch.empty((h,), **f32)
        db = torch.empty((b, s, n), **f32)
        dc = torch.empty((b, s, n), **f32)
        dh0 = torch.empty((b, h, n, p), **f32)
        scratch = torch.empty(sum(sizes.values()), **f32)
        ptr, at = {}, scratch.data_ptr()
        for key, count in sizes.items():
            ptr[key], at = at, at + 4 * count
        err = lib.ssd_scan_bwd_launch(
            xh.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), None if h0 is None else h0.data_ptr(),
            None if dy is None else dy.data_ptr(),
            None if dh_final is None else dh_final.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
            dc.data_ptr(), dh0.data_ptr(), ptr["states"], ptr["db"],
            ptr["dc"], ptr["da"], _DTYPES[xh.dtype], b, s, h, p, n,
            *xh.stride()[:3], *bmat.stride()[:2], *cmat.stride()[:2],
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "ssd_scan_bwd")
    bwd_launches += 1
    return dx, ddt, da, db, dc, dh0


# device type -> the forward and the backward (``kernels/ops.py``)
FORWARD = {"cpu": pricing.plain(ssd_scan_torch), "meta": ssd_scan_meta,
           "cuda": ssd_scan_cuda}
BACKWARD = {"cpu": pricing.plain(ssd_scan_bwd_chunks),
            "meta": ssd_scan_bwd_meta, "cuda": ssd_scan_bwd_cuda}


class SSDScan(torch.autograd.Function):
    """The scan with its backward kernel: on a CUDA tensor the forward
    kernel, then ``ssd_scan_bwd_cuda``; on a ``meta`` tensor their meta
    routes; on the CPU ``ssd_scan_torch``, then ``ssd_scan_bwd_chunks``.
    Saves the inputs only: the backward recomputes the chunk-start states
    (in the kernel, into a scratch freed with the call).  Each gradient
    comes back in its input's dtype."""

    @staticmethod
    def forward(ctx, xh, dt, a, bmat, cmat, h0):
        ctx.set_materialize_grads(False)
        y, h_final = FORWARD[xh.device.type](xh, dt, a, bmat, cmat, h0)
        ctx.save_for_backward(xh, dt, a, bmat, cmat, h0)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        xh, dt, a, bmat, cmat, h0 = ctx.saved_tensors
        route = xh.device.type
        if route != "cpu":  # the kernel takes fp32 contiguous gradients
            dy = None if dy is None else dy.float().contiguous()
            dh_final = (None if dh_final is None
                        else dh_final.float().contiguous())
        dx, ddt, da, db, dc, dh0 = BACKWARD[route](xh, dt, a, bmat, cmat, h0,
                                                   dy, dh_final)
        return (dx.to(xh.dtype), ddt.to(dt.dtype), da.to(a.dtype),
                db.to(bmat.dtype), dc.to(cmat.dtype),
                None if h0 is None else dh0.to(h0.dtype))
