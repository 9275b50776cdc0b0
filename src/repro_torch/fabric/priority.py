"""Priority classes for fabric traffic.

Requests carry an integer priority *level* (``Request.priority``); lower
level = more important.  Three named classes cover the usual serving tiers:

  * ``GOLD``   (0) — interactive, SLO-guaranteed.  Never shed, never
    re-routed away from its chosen node, never preempted.
  * ``SILVER`` (1) — standard.  May be re-routed to a less-loaded node
    when its chosen node is backed up; preemptible by GOLD.
  * ``BRONZE`` (2) — best-effort/batch.  First to be re-routed, the only
    class the router will *shed* outright under fleet-wide overload;
    preemptible by GOLD and SILVER.

The semantics are positional, not name-bound: the router re-routes levels
>= ``FabricConfig.reroute_level`` and sheds levels >= ``shed_level``, and a
node engine preempts an in-flight batch only for a strictly more important
arrival, so any number of levels works.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Iterable, Mapping

import numpy as np

from repro_torch.simulator.events import Request

GOLD, SILVER, BRONZE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    name: str
    level: int


PRIORITY_CLASSES: tuple[PriorityClass, ...] = (
    PriorityClass("gold", GOLD),
    PriorityClass("silver", SILVER),
    PriorityClass("bronze", BRONZE),
)

CLASS_NAMES: dict[int, str] = {c.level: c.name for c in PRIORITY_CLASSES}


def draw_priorities(n: int, mix: Mapping[int, float],
                    seed: int = 0) -> np.ndarray | None:
    """i.i.d. priority levels for ``n`` requests (None if ``mix`` empty).

    One vectorized ``choice`` call — deterministic for a fixed seed and
    count, and shared by the object and SoA assignment paths so both tag
    identically.
    """
    if not n or not mix:
        return None
    levels = sorted(mix)
    w = np.asarray([float(mix[lv]) for lv in levels], dtype=float)
    if w.sum() <= 0:
        raise ValueError("priority mix needs at least one positive weight")
    rng = np.random.default_rng(seed)
    draws = rng.choice(len(levels), size=n, p=w / w.sum())
    return np.asarray(levels, dtype=np.int16)[draws]


def assign_priorities(requests: Iterable[Request],
                      mix: Mapping[int, float],
                      seed: int = 0) -> None:
    """Tag each request with a priority level drawn i.i.d. from ``mix``.

    ``mix`` maps level -> probability weight (normalized here).  In-place;
    deterministic for a fixed seed and request order.
    """
    reqs = list(requests)
    levels = draw_priorities(len(reqs), mix, seed)
    if levels is None:
        return
    for r, p in zip(reqs, levels.tolist()):
        r.priority = p
