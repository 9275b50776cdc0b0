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
operations to bytes).  Design: flash-decoding in one launch.  The
``n_split`` blocks of one (batch row, KV head, head block) form a thread
block cluster; each streams its slice of the cache through a ring of
shared-memory tiles by ``cp.async`` (16-byte copies) and keeps an fp32
online softmax for its heads, and the blocks then merge their (max,
denominator, accumulator) through distributed shared memory, each writing
its own share of the outputs.  A block serves at most 5 query heads
(``heads_per_block``): G 8 and 16 run as blocks of 4, G 10 as two blocks
of 5, which keeps a lane's accumulator small and gives more blocks.
Nothing is allocated per call but the output.  Splitting the cache length
fills the SMs where B * Hkv (16 for yi-9b at batch 4, 4 for
recurrentgemma) could not; ``split_plan`` is the rule the card's sweep
chose (``PERF.md``), taken on the SMs of the partition the launch runs on
(the whole card's 132, or a gpu-let's, ``launch/partition.py``), with no
cluster larger than that partition can hold: a 16-block cluster needs 16
SMs of one GPC inside it.  A cluster that cannot launch raises.
``lengths`` stays on the device: the blocks read it themselves, so a
decode step never waits on the host.  The cache
rows must be 16-byte aligned (base and strides), as the model's caches
are.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, pricing

launches = 0  # launches of the CUDA kernel (plain calls not counted)

NEG_INF = -1e30
# head dim -> query heads per KV head the kernel is built for (Dh 256 with
# group 10 is recurrentgemma's shape)
GROUPS = {64: (1, 2, 4, 8, 16), 128: (1, 2, 4, 8, 16), 160: (4,),
          256: (10,)}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SPLIT = 16            # the largest thread block cluster of an H100
_BLOCKS_PER_SM = 2        # the sweep's best on the whole card
_MIN_SPLIT = 64           # fewest cache slots worth a block of their own

_ARGTYPES = [ctypes.c_void_p] * 7
_lib = None  # the loaded library, once built
_plans: dict = {}  # (partition, launch signature) -> _Params (checked once)
_max_split: dict = {}  # (partition, dtype, Dh, G) -> largest cluster


class _Params(ctypes.Structure):
    """The C entry's ``Params``: a launch's shape, strides and scalars."""
    _fields_ = ([(n, ctypes.c_int64) for n in (
        "dtype", "B", "Hkv", "G", "S", "D", "n_split", "chunk", "sqb", "sqh",
        "skb", "sks", "skh", "svb", "svs", "svh", "sob", "soh", "window")]
        + [("scale", ctypes.c_double)])


def decode_attention_torch(q, k_cache, v_cache, lengths, *,
                           window: int | None = None,
                           scale: float | None = None):
    """Plain version.  q: (B, H, Dh); caches: (B, S, Hkv, Dh); lengths: (B,).

    The math of the JAX oracle ``decode_attention_ref``: fp32 inside,
    output in q's dtype.
    """
    b, h, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(b, hkv, h // hkv, dh)
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * (
        1.0 / math.sqrt(dh) if scale is None else scale)
    pos = torch.arange(s, device=q.device)[None, :]
    lens = lengths.to(q.device)[:, None]
    valid = pos < lens
    if window is not None:
        valid &= pos >= lens - window
    logits = logits.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v_cache.float())
    return out.reshape(b, h, dh).to(q.dtype)


def cost(b: int, h: int, hkv: int, dh: int, valid_slots: int, *,
         itemsize: int = 2) -> tuple[int, int]:
    """(operations, bytes) of one call over ``valid_slots`` valid cache
    slots in all (the sum over the batch rows): 4 Dh operations per query
    head and valid slot (q k and p v), the valid keys and values read once
    (each KV head's once, for its whole group) and q read, o written."""
    return (4 * dh * h * valid_slots,
            itemsize * (2 * valid_slots * hkv * dh + 2 * b * h * dh))


def decode_attention_meta(q, k_cache, v_cache, lengths, *,
                          window: int | None = None,
                          scale: float | None = None):
    """The meta route (``kernels/pricing.py``): the kernel's output,
    computed by nothing, and its cost charged.  A meta ``lengths`` holds no
    values, so every row is priced with every slot valid (``window`` of
    them at most): a full cache, as the dry run's decode steps have it."""
    b, h, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    per_row = min(s, window) if window else s
    pricing.charge("decode_attention", cost(b, h, hkv, dh, b * per_row,
                                            itemsize=q.element_size()))
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


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
    vec = 16 // k_cache.element_size()  # elements in a 16-byte load
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"decode_attention_cuda: {name} rows must be "
                             "16-byte aligned (base and strides)")
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


def heads_per_block(g: int) -> int:
    """Query heads one block serves of a group of ``g`` (the kernel's
    ``heads_per_block``): up to 5, so a lane's accumulator stays small."""
    return g if g <= 4 else 5 if g % 5 == 0 else 4


def split_plan(b: int, hkv: int, s: int, g: int = 1, *, sms: int = 132,
               max_split: int = MAX_SPLIT) -> tuple[int, int]:
    """(number of cache splits, slots per split) for a launch over ``s``
    cache slots, ``b`` rows, ``hkv`` KV heads of ``g`` query heads each, on
    ``sms`` SMs that hold clusters of at most ``max_split`` blocks.

    The rule the card's sweep chose (``PERF.md``): split each
    (row, KV head, head block) until the launch has about two blocks per SM,
    with at least 64 slots a split and at most ``max_split`` splits (one
    cluster)."""
    if not 1 <= max_split <= MAX_SPLIT:
        raise ValueError(f"split_plan: max_split {max_split} not in "
                         f"1..{MAX_SPLIT}")
    blocks = b * hkv * (g // heads_per_block(g))
    n_split = max(1, min(-(-_BLOCKS_PER_SM * sms // blocks),
                         -(-s // _MIN_SPLIT), max_split))
    chunk = -(-s // n_split)
    return -(-s // chunk), chunk


def _library():
    global _lib
    if _lib is None:
        lib = _build.library("decode_attention", _ARGTYPES)
        lib.decode_attention_max_clusters.argtypes = [ctypes.c_void_p] * 2
        lib.decode_attention_max_clusters.restype = ctypes.c_int
        _lib = lib
    return _lib


def max_cluster(dtype, dh: int, g: int) -> int:
    """The largest cluster of decode blocks (``dtype``, head dim ``dh``,
    group ``g``) that the current partition of the card holds, from
    ``cudaOccupancyMaxActiveClusters`` in its context.  Raises if not even
    one block fits."""
    key = (_build.partition_key(), dtype, dh, g)
    limit = _max_split.get(key)
    if limit is None:
        lib = _library()
        limit = 0
        for n_split in range(MAX_SPLIT, 0, -1):
            params = _Params(_DTYPES[dtype], 1, 1, g, n_split, dh, n_split, 1,
                             *[0] * 10, -1, 1.0)
            n = ctypes.c_int(0)
            _build.check(lib, lib.decode_attention_max_clusters(
                ctypes.addressof(params), ctypes.byref(n)),
                "decode_attention (cluster occupancy)")
            if n.value >= 1:
                limit = n_split
                break
        if limit == 0:
            raise RuntimeError("decode_attention_cuda: no cluster of decode "
                               "blocks fits this partition")
        _max_split[key] = limit
    return limit


def _plan(q, k_cache, v_cache, lengths, window, n_split,
          scale) -> _Params:
    """Check a launch signature once and build its parameters."""
    _check(q, k_cache, v_cache, lengths, window)
    b, h, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    sms = _build.partition(q.device.index)[1]
    limit = max_cluster(q.dtype, dh, h // hkv)
    if n_split is None:
        n_split, chunk = split_plan(b, hkv, s, h // hkv, sms=sms,
                                    max_split=limit)
    else:
        if not 1 <= n_split <= min(s, limit):
            raise ValueError(f"decode_attention_cuda: n_split {n_split} not "
                             f"in 1..{min(s, limit)} (clusters of at most "
                             f"{limit} blocks fit where it runs)")
        chunk = -(-s // n_split)
    # the output is allocated contiguous: strides (h * dh, dh)
    return _Params(_DTYPES[q.dtype], b, hkv, h // hkv, s, dh, n_split, chunk,
                   *q.stride()[:2], *k_cache.stride()[:3],
                   *v_cache.stride()[:3], h * dh, dh,
                   -1 if window is None else window,
                   1.0 / math.sqrt(dh) if scale is None else scale)


def decode_attention_cuda(q, k_cache, v_cache, lengths, *,
                          window: int | None = None,
                          n_split: int | None = None,
                          scale: float | None = None):
    """Launch the kernel.  Same contract as ``decode_attention_torch``;
    every ``lengths[b]`` must be >= 1 (a row with no valid slot gives 0,
    as the TPU kernel does).  ``n_split`` overrides ``split_plan`` (the
    card's sweep of the rule uses it).

    The decode step is host-bound, so a call checks the full contract once
    per signature (shapes, strides, dtypes, devices, window, split) and
    then only the cache's alignment; it allocates only the output."""
    global launches
    key = (_build.partition_key(), q.shape, q.stride(),
           q.dtype, q.device, k_cache.shape,
           k_cache.stride(), k_cache.dtype, k_cache.device, v_cache.shape,
           v_cache.stride(), v_cache.dtype, v_cache.device, lengths.shape,
           lengths.stride(), lengths.dtype, lengths.device, window, n_split,
           scale)
    params = _plans.get(key)
    if params is None:
        params = _plans[key] = _plan(q, k_cache, v_cache, lengths, window,
                                     n_split, scale)
    kp, vp = k_cache.data_ptr(), v_cache.data_ptr()
    if (kp | vp) % 16:
        raise ValueError("decode_attention_cuda: cache rows must be 16-byte "
                         "aligned")
    lib = _lib or _library()
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return decode_attention_cuda(q, k_cache, v_cache, lengths,
                                         window=window, n_split=n_split,
                                         scale=scale)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = lib.decode_attention_launch(
        q.data_ptr(), kp, vp, lengths.data_ptr(), o.data_ptr(),
        ctypes.addressof(params), _build.current_stream(q.device.index))
    if err:
        _build.check(lib, err, "decode_attention")
    launches += 1
    return o


# device type -> the entry a call takes (``kernels/ops.py``)
FORWARD = {"cpu": pricing.plain(decode_attention_torch),
           "meta": decode_attention_meta, "cuda": decode_attention_cuda}
