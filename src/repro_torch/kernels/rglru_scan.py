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
3.35 TB/s; the operations (one FMA per element) are negligible.

Design: a chunk-parallel scan in one pass.  The recurrence is linear, so
a chunk of T = 32 steps acts on the state as h -> A h + E, with A the
product of its a_t and E its last state from zero.  One block of 128
threads per (batch row, chunk, 256 lanes), each thread 2 neighbouring
lanes, 2,560 blocks at the serving shape:

1. the block takes its (chunk, row, tile) from an atomic counter,
   chunk-major, loads its chunk's a and b into registers (64 loads a thread
   in flight) and publishes (A, E) to an fp32 scratch;
2. it looks back (a decoupled look-back): one warp reads the status of the
   32 chunks before it at once, takes the nearest one that has published
   its end state (or h0 before chunk 0) and folds that state and the
   aggregates between into its carry, publishes its own end state, then
   re-runs its steps from the carry and writes every h_t; the last chunk
   writes h_last.

Why it is safe: the counter hands out every item of chunk c - 1 before any
item of chunk c, and only to a block that is running, so a block waits
only on blocks that are resident or done, in whatever order the card
starts them; values are published before their status, with a fence
between, and read through the L2 after the status, with a fence between;
a wait that spins 2^22 polls traps (a launch error) instead of hanging.
The card tests cover S from 1 to 4096 (128 chunks, so look-backs past a
32-chunk window), both dtypes, h0, strided and odd-width inputs.

The first kernel walked all S dependent steps in one thread per lane (320
warps at the serving shape), so the card waited on memory latency (2.6x
the bound); here the chunks run at once and a and b are read once, so the
pass moves the function's own bytes.  A two-pass form (chunk aggregates,
then carry fold and re-scan) was tried on the way: it reads a and b twice
and was slower on the card (``PERF.md`` §6).  The scratch, allocated here
with ``torch.empty``, is 3 floats a lane a chunk (3.9 MB at the serving
shape) and one int32 status a (row, chunk, tile), which the launch zeroes
(``cudaMemsetAsync``) before the kernel.  The carry changes the order of the fp32 operations (A
carry + E instead of one step after another), which stays within the 1e-5
check.

``launches`` counts calls of the forward entry, one a call.

The backward is a second entry of the same source
(``rglru_scan_bwd_launch``, the kernel's REV direction).  With h_t = a_t
h_{t-1} + b_t, the total gradient G_t of h_t is the same linear recurrence
run backwards, G_t = g_t + a_{t+1} G_{t+1} (g the incoming gradient of
h_seq, that of h_last added at t = S - 1, a_S taken as 0), and then db_t =
G_t, da_t = G_t h_{t-1} (h_{-1} = h0 or 0) and dh0 = a_0 G_0.  The kernel
walks the chunks from the end with the same look-back (the counter hands
out work from the last chunk, so the argument above holds), reads a_{t+1},
g_t and h_{t-1} straight from the caller's tensors and writes da and db
once: no flipped, shifted or concatenated copies, so it moves the
function's own bytes (a, h_seq, g read, da, db written: 210 MB at the
training shape B 4, S 1024, W 2560, 0.063 ms at 3.35 TB/s).  One lane a
thread: the step's three loads (a_{t+1}, g_t, h_{t-1}) for all 32 steps
are in flight at once, in 128 registers.  ``rglru_scan_backward_cuda`` is
one launch, counted in ``bwd_launches`` (``launches`` counts forward scans
only); ``rglru_scan_backward`` is its plain version, the same recurrence
through a scan it is given on flipped inputs (``rglru_scan_torch`` on the
CPU).  ``RGLRUScan`` is the ``torch.autograd.Function`` that pairs the
two.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, pricing

launches = 0  # forward scans on the card (plain-version calls not counted)
bwd_launches = 0  # backward passes on the card, one launch each

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 +
             [ctypes.c_int64] * 4 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 +
                 [ctypes.c_int64] * 2 + [ctypes.c_void_p])
CHUNK = 32     # steps per chunk (csrc/rglru_scan.cu: T)
THREADS = 128  # threads per block, each 1 or 2 lanes


def scratch_sizes(bsz: int, s: int, w: int) -> tuple[int, int]:
    """(int32 status entries, fp32 values) the kernel needs: one status a
    (row, chunk, tile), tiles of one lane a thread at most, and a counter;
    A, E and the end state a lane a chunk."""
    n_chunks = -(-s // CHUNK)
    return bsz * n_chunks * -(-w // THREADS) + 1, 3 * bsz * n_chunks * w


def cost(bsz: int, s: int, w: int, *, itemsize: int = 4,
         with_h0: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one forward call: a multiply-add per element;
    a and b read once, h_seq (fp32) written once, h0 read and h_last
    written (fp32)."""
    n = bsz * s * w
    return 2 * n, 2 * itemsize * n + 4 * n + 4 * bsz * w * (1 + with_h0)


def bwd_cost(bsz: int, s: int, w: int, *, itemsize: int = 4,
             with_h0: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one backward call: two multiply-adds per
    element (the reverse recurrence, da); a, h_seq and g read once, da and
    db written once (fp32), g_last and h0 read and dh0 written."""
    n = bsz * s * w
    return 4 * n, itemsize * n + 16 * n + 4 * bsz * w * (2 + with_h0)


def rglru_scan_meta(a, b, h0=None):
    """The meta route (``kernels/pricing.py``): the outputs and the scratch
    the CUDA wrapper allocates, computed by nothing, and the cost
    charged."""
    bsz, s, w = a.shape
    pricing.charge("rglru_scan", cost(bsz, s, w, itemsize=a.element_size(),
                                      with_h0=h0 is not None))
    n_status, n_values = scratch_sizes(bsz, s, w)
    h_seq = torch.empty((bsz, s, w), dtype=torch.float32, device=a.device)
    h_last = torch.empty((bsz, w), dtype=torch.float32, device=a.device)
    torch.empty(n_values + n_status, dtype=torch.float32, device=a.device)
    return h_seq, h_last


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
    """Launch the kernel.  Same contract as ``rglru_scan_torch``.

    The kernel takes about 50 us at the serving shape, so the host's work
    a call is kept small: three allocations (the outputs and one scratch
    holding the fp32 values, then the int32 statuses) and the raw stream
    handle."""
    global launches
    _check(a, b, h0)
    if a.device.index != torch.cuda.current_device():
        with torch.cuda.device(a.device):
            return rglru_scan_cuda(a, b, h0)
    lib = _build.library("rglru_scan", _ARGTYPES)
    bsz, s, w = a.shape
    n_status, n_values = scratch_sizes(bsz, s, w)
    h_seq = torch.empty((bsz, s, w), dtype=torch.float32, device=a.device)
    h_last = torch.empty((bsz, w), dtype=torch.float32, device=a.device)
    scratch = torch.empty(n_values + n_status, dtype=torch.float32,
                          device=a.device)
    values = scratch.data_ptr()
    err = lib.rglru_scan_launch(
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        h_seq.data_ptr(), h_last.data_ptr(), values + 4 * n_values, values,
        _DTYPES[a.dtype], bsz, s, w, *a.stride()[:2], *b.stride()[:2],
        _build.current_stream(a.device.index))
    _build.check(lib, err, "rglru_scan")
    launches += 1
    return h_seq, h_last


# -------------------------------------------------------------- backward --


def rglru_scan_backward(scan, a, h_seq, h0, g_seq, g_last):
    """Plain version of the backward: gradients (da, db, dh0) of
    ``h_seq, h_last = scan(a, b, h0)`` for the incoming gradients ``g_seq``
    (B, S, W) and ``g_last`` (B, W), all fp32: the reverse recurrence
    G_t = g_t + a_{t+1} G_{t+1} through ``scan`` on flipped inputs, then
    db = G, da_t = G_t h_{t-1} and dh0 = a_0 G_0 (t from 0).  ``h_seq`` is
    the forward's output; ``h0`` may be None."""
    bsz, s, w = a.shape
    af = a.float()
    g = g_seq.float()
    g = torch.cat([g[:, :-1], (g[:, -1] + g_last.float())[:, None]], dim=1)
    a_next = torch.cat([af[:, 1:], af.new_zeros(bsz, 1, w)], dim=1)
    grad = scan(a_next.flip(1), g.flip(1))[0].flip(1)      # G_t
    first = af.new_zeros(bsz, w) if h0 is None else h0.float()
    h_prev = torch.cat([first[:, None], h_seq[:, :-1]], dim=1)
    return grad * h_prev, grad, af[:, 0] * grad[:, 0]


def _check_bwd(a, h_seq, h0, g_seq, g_last):
    _check(a, a, h0)
    bsz, s, w = a.shape
    for name, t, shape in (("h_seq", h_seq, (bsz, s, w)),
                           ("g_seq", g_seq, (bsz, s, w)),
                           ("g_last", g_last, (bsz, w))):
        if (t.shape != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != a.device):
            raise ValueError(f"rglru_scan_backward_cuda: {name} must be a "
                             f"contiguous float32 {shape} tensor on "
                             f"{a.device}")


def rglru_scan_backward_cuda(a, h_seq, h0, g_seq, g_last):
    """``rglru_scan_backward`` in one launch of the kernel's backward entry
    (``rglru_scan_bwd_launch``): the reverse recurrence read straight from
    a, g_seq, g_last and h_seq, no flipped or concatenated copies.
    ``g_seq`` and ``g_last`` are taken contiguous (a copy only where they
    are not); returns fp32 da, db (B, S, W) and dh0 (B, W)."""
    global bwd_launches
    g_seq, g_last = g_seq.float().contiguous(), g_last.float().contiguous()
    _check_bwd(a, h_seq, h0, g_seq, g_last)
    if a.device.index != torch.cuda.current_device():
        with torch.cuda.device(a.device):
            return rglru_scan_backward_cuda(a, h_seq, h0, g_seq, g_last)
    lib = _build.library("rglru_scan", _ARGTYPES)
    entry = lib.rglru_scan_bwd_launch
    if entry.argtypes is None:
        entry.argtypes, entry.restype = _BWD_ARGTYPES, ctypes.c_int
    bsz, s, w = a.shape
    n_status, n_values = scratch_sizes(bsz, s, w)
    f32 = dict(dtype=torch.float32, device=a.device)
    da = torch.empty((bsz, s, w), **f32)
    db = torch.empty((bsz, s, w), **f32)
    dh0 = torch.empty((bsz, w), **f32)
    scratch = torch.empty(n_values + n_status, **f32)
    values = scratch.data_ptr()
    err = entry(
        a.data_ptr(), g_seq.data_ptr(), g_last.data_ptr(), h_seq.data_ptr(),
        None if h0 is None else h0.data_ptr(), da.data_ptr(), db.data_ptr(),
        dh0.data_ptr(), values + 4 * n_values, values, _DTYPES[a.dtype], bsz,
        s, w, *a.stride()[:2], _build.current_stream(a.device.index))
    _build.check(lib, err, "rglru_scan_bwd")
    bwd_launches += 1
    return da, db, dh0


def rglru_scan_backward_meta(a, h_seq, h0, g_seq, g_last):
    """The backward's meta route: what ``rglru_scan_backward_cuda``
    allocates, computed by nothing, and its cost charged."""
    g_seq, g_last = g_seq.float().contiguous(), g_last.float().contiguous()
    bsz, s, w = a.shape
    pricing.charge("rglru_scan_backward",
                   bwd_cost(bsz, s, w, itemsize=a.element_size(),
                            with_h0=h0 is not None))
    n_status, n_values = scratch_sizes(bsz, s, w)
    f32 = dict(dtype=torch.float32, device=a.device)
    grads = (torch.empty((bsz, s, w), **f32), torch.empty((bsz, s, w), **f32),
             torch.empty((bsz, w), **f32))
    torch.empty(n_values + n_status, **f32)
    return grads


# device type -> the forward and the backward (``kernels/ops.py``)
FORWARD = {"cpu": pricing.plain(rglru_scan_torch), "meta": rglru_scan_meta,
           "cuda": rglru_scan_cuda}
BACKWARD = {"cpu": pricing.plain(functools.partial(rglru_scan_backward,
                                                   rglru_scan_torch)),
            "meta": rglru_scan_backward_meta,
            "cuda": rglru_scan_backward_cuda}


class RGLRUScan(torch.autograd.Function):
    """The scan with its backward: for a CUDA tensor the kernel's two
    entries (``rglru_scan_cuda``, ``rglru_scan_backward_cuda``), for a
    ``meta`` tensor their meta routes, on the CPU ``rglru_scan_torch`` and
    ``rglru_scan_backward`` through it.  Saves a, h0 and h_seq."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h_seq, h_last = FORWARD[a.device.type](a, b, h0)
        ctx.save_for_backward(a, h_seq, h0)
        ctx.b_dtype = b.dtype
        return h_seq, h_last

    @staticmethod
    def backward(ctx, g_seq, g_last):
        a, h_seq, h0 = ctx.saved_tensors
        da, db, dh0 = BACKWARD[a.device.type](a, h_seq, h0, g_seq, g_last)
        return (da.to(a.dtype), db.to(ctx.b_dtype),
                None if h0 is None else dh0)
