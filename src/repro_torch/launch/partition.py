"""SM partitions of one card: the port's gpu-lets.

The counterpart of the JAX package's ``launch/mesh.py::make_submesh``, which
carves a tpu-let (a sub-mesh) out of a pod.  On the H100 a gpu-let is a set
of SMs of the card.  The paper made its partitions with MPS thread
percentages; here they are CUDA green contexts, which partition SMs inside
one process and need no daemon (MPS and MIG are the alternatives named in
``ROADMAP.md``).

  * ``split(left)`` carves the card's SMs once into a partition of about
    ``left`` percent and the remainder (``csrc/partition_probe.cu``,
    ``partition_split``), so the two are disjoint; the CUDA driver grants
    SMs in groups (8 on the H100) and every ``Partition`` carries the
    count it granted.  A left side above 50 is the mirror of
    ``split(100 - left)``: the same carve, sides swapped.  So the paper's
    five splits are three carves (``core.h100lets.CARVES``: 24 + 108,
    56 + 76 and 64 + 68 SMs on the H100), and each percent runs on one SM
    count (20 on 24, 40 on 56, 60 on 76, 80 on 108; 50 on 64 or 68);
  * ``partition(percent)`` is one gpu-let of that size: the side of the
    carve that ``percent`` names (50 the left, smaller side); 100 is the
    whole card: the primary context and a stream of its own, no green
    context;
  * ``with part:`` makes the partition's context current on the calling
    thread and its stream PyTorch's current stream, and tells the kernels
    (``kernels._build.partition``) how many SMs they run on.  Every launch
    inside goes to the partition's SMs; tensors allocated outside it are
    read inside it.  Work queued on the caller's stream before entering
    runs first; nothing orders the caller's later work after the
    partition's (two partitions' work stays concurrent), so the caller
    synchronises the partition (``part.synchronize()``) before it reads
    a result outside;
  * ``sm_ids(part)`` launches the probe kernel on the partition and returns
    the SM ids (``%smid``) its blocks ran on.

A green context lives as long as the process: PyTorch's caching allocator
and CUDA graphs may hold memory and executables made while it was current,
so the pair of each split is made once per card and kept (``split``
returns the same pair again), at most five pairs a card.

A partition that cannot be made raises; nothing falls back to the whole
card.  Percentages are the paper's (``core.latency.PARTITION_SIZES``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.h100lets import carve_of
from repro_torch.kernels import _build

GRANULE = 8  # SMs the CUDA driver grants an H100 green context at a time

_P = ctypes.c_void_p
_lib = None
_splits: dict = {}  # (device, SMs asked) -> the pair of that split, kept


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.library("partition_probe",
                             [_P, ctypes.c_int, ctypes.c_longlong, _P])
        for name, args in (
                ("partition_split", [ctypes.c_int, ctypes.c_int, _P, _P, _P,
                                     _P]),
                ("partition_push", [_P]),
                ("partition_pop", [])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
        lib.driver_error_string.argtypes = [ctypes.c_int]
        lib.driver_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _driver_check(err: int, what: str):
    if err:
        raise RuntimeError(f"{what} failed: CUDA driver error {err} "
                           f"({_library().driver_error_string(err).decode()})")


def target_sms(percent: float, total: int) -> int:
    """SMs asked of the driver for ``percent`` of a card of ``total`` SMs:
    the nearest multiple of ``GRANULE``, at least one granule."""
    if not 0 < percent < 100:
        raise ValueError(f"a split partition is 0-100% of the card, not "
                         f"{percent}")
    return max(GRANULE, GRANULE * round(percent / 100 * total / GRANULE))


class Partition:
    """One gpu-let: a set of SMs of card ``device``, a context that owns
    them and a stream in that context; ``carve`` and ``side`` name the
    carve of the SMs it is a side of (``core.h100lets.carve_of``)."""

    def __init__(self, percent: int, sms: int, device: int, stream,
                 ctx: int | None = None, carve: int = 100,
                 side: str = "whole"):
        self.percent, self.sms, self.device = percent, sms, device
        self.carve, self.side = carve, side
        self.stream = stream
        self._ctx = ctx
        self._stack: list = []

    @property
    def key(self) -> int:
        """Tells the kernels' per-partition caches apart: the green
        context's handle, 0 for the whole card."""
        return self._ctx or 0

    def __repr__(self):
        return (f"Partition({self.percent}%, {self.sms} SMs, "
                f"{'whole card' if self._ctx is None else 'green context'})")

    def __enter__(self) -> "Partition":
        # work queued before entering (a cache filled on the caller's
        # stream) runs before the partition's: its stream waits on an event
        # of the caller's, as PyTorch's own green contexts do
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        if self._ctx is not None:
            _driver_check(_library().partition_push(self._ctx),
                          "cuCtxPushCurrent")
        self.stream.wait_event(ready)
        stream_cm = torch.cuda.stream(self.stream)
        stream_cm.__enter__()
        prev = _build.set_partition((self.key, self.sms))
        self._stack.append((stream_cm, prev))
        return self

    def __exit__(self, *exc):
        stream_cm, prev = self._stack.pop()
        _build.set_partition(prev)
        stream_cm.__exit__(*exc)
        if self._ctx is not None:
            _driver_check(_library().partition_pop(), "cuCtxPopCurrent")
        return False

    def synchronize(self):
        self.stream.synchronize()


def _require_card(device: int):
    if not torch.cuda.is_available():
        raise RuntimeError("SM partitions need a CUDA card")
    torch.cuda.init()
    return torch.cuda.get_device_properties(device).multi_processor_count


def split(left: float, device: int = 0) -> tuple[Partition, Partition]:
    """Two disjoint partitions of card ``device``: about ``left`` percent
    of its SMs and the rest.  Their ``percent`` is the paper's name of the
    split (``left``, ``100 - left``); ``sms`` what the driver granted.  A
    ``left`` above 50 returns the pair of ``split(100 - left)`` swapped,
    so both share one carve and its green contexts."""
    if left > 50:
        right_side, left_side = split(100 - left, device)
        return left_side, right_side
    total = _require_card(device)
    key = (device, target_sms(left, total))
    pair = _splits.get(key)
    if pair is None:
        arrs = [(_P * 2)() for _ in range(3)]
        sms = (ctypes.c_int * 2)()
        _driver_check(_library().partition_split(device, key[1], *arrs, sms),
                      "partition_split")
        gctx, ctx, streams = arrs
        if not all((gctx[0], gctx[1], sms[0], sms[1])):
            raise RuntimeError(f"partition_split({left}%): the driver left "
                               f"{sms[1]} SMs beside {sms[0]}; no pair of "
                               "partitions")
        pair = _splits[key] = tuple(Partition(
            p, sms[i], device,
            torch.cuda.ExternalStream(streams[i], device=torch.device(
                "cuda", device)), ctx[i], carve=left, side=side)
            for i, (p, side) in enumerate(((left, "left"),
                                           (100 - left, "right"))))
    return pair


def partition(percent: int, device: int = 0) -> Partition:
    """One gpu-let of ``percent`` of card ``device``'s SMs: the side of the
    carve that ``percent`` names (``core.h100lets.carve_of``); 100 is the
    whole card (the primary context, a stream of its own)."""
    if percent == 100:
        total = _require_card(device)
        return Partition(100, total, device,
                         torch.cuda.Stream(device=device))
    carve, side = carve_of(percent)
    return split(carve, device)[side == "right"]


def split_sms(carves, device: int = 0) -> dict[int, tuple[int, int]]:
    """The (left, right) SMs the driver granted each carve in ``carves``."""
    return {c: tuple(p.sms for p in split(c, device)) for c in carves}


def sm_ids(part: Partition, blocks: int | None = None,
           spin_cycles: int = 200_000) -> set[int]:
    """The SM ids the probe kernel's blocks ran on in ``part``.  Each block
    spins ``spin_cycles`` (about 0.1 ms) so the launch's blocks are
    resident together; ``blocks`` (default 32 a granted SM) is more than
    one SM holds, so every SM of the partition takes some."""
    blocks = blocks or 32 * part.sms
    lib = _library()
    with part:
        out = torch.full((blocks,), -1, dtype=torch.int32,
                         device=f"cuda:{part.device}")
        _build.check(lib, lib.partition_probe_launch(
            out.data_ptr(), blocks, spin_cycles,
            _build.current_stream(part.device)), "partition_probe")
        part.synchronize()
        ids = set(out.cpu().tolist())
    if -1 in ids:
        raise RuntimeError("partition_probe: a block did not run")
    return ids


__all__ = ["GRANULE", "Partition", "partition", "sm_ids", "split",
           "split_sms", "target_sms"]
