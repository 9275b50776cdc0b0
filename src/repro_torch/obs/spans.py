"""Typed span records for the engine event log (ISSUE 8 satellite).

The engine's ``self.log`` (gated by ``EngineConfig.event_log``) used to
hold untyped tuples — ``("batch", epoch, let, launch, done, model, n)``
and friends — that every consumer indexed positionally.  These records
replace them with ``NamedTuple`` subclasses whose field order matches
the legacy tuples exactly, so positional access (``e[0] == "batch"``,
``e[3] < t_apply``) keeps working while new code gets named fields.

Every record's first field is its ``kind`` tag (the ``make_*`` helpers
fill it); ``SPAN_KINDS`` maps tag → type.  Records are plain tuples
underneath: they pickle cheaply across forked node workers and
sort/compare like the tuples they replace.
"""
from __future__ import annotations

from typing import NamedTuple


class BatchSpan(NamedTuple):
    """One opaque batch launch on a gpu-let: occupies ``[launch, done)``."""

    kind: str
    epoch: int
    let: int
    launch_ms: float
    done_ms: float
    model: str
    n: int


class DecodeSpan(NamedTuple):
    """One streaming decode chunk: ``n`` pool members advance ``k`` steps."""

    kind: str
    epoch: int
    let: int
    launch_ms: float
    done_ms: float
    model: str
    n: int
    steps: int


class DropSpan(NamedTuple):
    """A request dropped at batch formation (SLO already expired)."""

    kind: str
    t_ms: float
    model: str


class PreemptSpan(NamedTuple):
    """An in-flight batch of ``n`` requests cancelled and re-queued."""

    kind: str
    t_ms: float
    let: int
    model: str
    n: int


class ApplySpan(NamedTuple):
    """A staged schedule installed (gpu-let re-partition committed)."""

    kind: str
    t_ms: float


class TickSpan(NamedTuple):
    """A controller tick fired; ``resched`` marks a placement change."""

    kind: str
    t_ms: float
    resched: bool


#: tag -> record type, for validators and exporters
SPAN_KINDS = {
    "batch": BatchSpan,
    "decode": DecodeSpan,
    "drop": DropSpan,
    "preempt": PreemptSpan,
    "apply": ApplySpan,
    "tick": TickSpan,
}


def make_batch(epoch: int, let: int, launch_ms: float, done_ms: float,
               model: str, n: int) -> BatchSpan:
    return BatchSpan("batch", epoch, let, launch_ms, done_ms, model, n)


def make_decode(epoch: int, let: int, launch_ms: float, done_ms: float,
                model: str, n: int, steps: int) -> DecodeSpan:
    return DecodeSpan("decode", epoch, let, launch_ms, done_ms, model, n,
                      steps)


def make_drop(t_ms: float, model: str) -> DropSpan:
    return DropSpan("drop", t_ms, model)


def make_preempt(t_ms: float, let: int, model: str, n: int) -> PreemptSpan:
    return PreemptSpan("preempt", t_ms, let, model, n)


def make_apply(t_ms: float) -> ApplySpan:
    return ApplySpan("apply", t_ms)


def make_tick(t_ms: float, resched: bool) -> TickSpan:
    return TickSpan("tick", t_ms, resched)
