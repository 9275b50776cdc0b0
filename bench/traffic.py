"""The one traffic generator: open-loop arrivals of one stream a model.

A stream (a traffic file's ``streams[<model>]``) gives:

  * ``rate_rps``: mean arrivals a second;
  * ``lengths`` and ``weights``: the request lengths (an audio clip's
    frames, a prompt's tokens) and their shares;
  * ``batch_cap``: ``{"requests": n}`` and / or ``{"tokens": n}``, the
    most one batch may hold;
  * ``slo_ms``: the latency limit of every request of the stream;
  * ``arrival_seed`` and ``segment_s``: the Poisson realization and the
    length of the segments that ``--seed`` reorders (below).

Arrivals are a Poisson process.  One realization of it, drawn from the
stream's ``arrival_seed`` (a constant of the traffic file), gives every
request's gap and length: exponential gaps of mean ``1 / rate_rps`` and
lengths drawn by ``weights``, each independent of the others, so bursts
of arrivals and runs of long requests come as a Poisson stream brings
them.  The window is cut into segments of about ``segment_s`` seconds,
and ``--seed`` puts the realization's segments in another order: every
seed gets the same arrivals and lengths in another order, and the same
bursts.  With a realization drawn from ``--seed`` itself, yi9b.prompts'
p95 moved by 20-45% between seeds, from which bursts the seed drew.
Each request also gets an offset into the input pool that the benchmark
makes from the seed (``weights.input_pool``): its frames or tokens are the
pool's ``length`` entries from there.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Schedule:
    due: np.ndarray        # (n,) seconds from the window's start, sorted
    length: np.ndarray     # (n,) frames or tokens
    offset: np.ndarray     # (n,) start in the input pool


def seed_sequence(seed: int, *key) -> np.random.SeedSequence:
    if seed < 0:
        raise ValueError(f"--seed must be >= 0, not {seed}")
    return np.random.SeedSequence([seed, *key])


def realization(stream: dict, seconds: float, key: int):
    """(due, length) of the stream's Poisson realization over
    ``[0, seconds)``: unit-rate gaps scaled by ``1 / rate_rps``, so two
    rates give the same realization, one compressed."""
    base = (stream["arrival_seed"], key)
    gaps = np.random.default_rng(seed_sequence(*base, 0))
    want = stream["rate_rps"] * seconds  # arrivals expected; draw 10 sd more
    unit = gaps.standard_exponential(int(want + 10 * want ** 0.5 + 20))
    due = np.cumsum(unit) / stream["rate_rps"]
    due = due[due < seconds]
    w = np.asarray(stream["weights"], float)
    length = np.random.default_rng(seed_sequence(*base, 1)).choice(
        np.asarray(stream["lengths"]), size=len(due), p=w / w.sum())
    return due, length


def schedule(stream: dict, seconds: float, seed: int, key: int,
             pool_len: int) -> Schedule:
    """The stream's requests due in ``[0, seconds)``: the realization's
    segments in the order ``seed`` draws."""
    rng = np.random.default_rng(seed_sequence(seed, key))
    due0, length0 = realization(stream, seconds, key)
    n_seg = max(1, round(seconds / stream["segment_s"]))
    edges = np.linspace(0.0, seconds, n_seg + 1)
    seg = np.searchsorted(edges, due0, side="right") - 1
    due, length = [], []
    for slot, k in enumerate(rng.permutation(n_seg)):
        here = seg == k
        due.append(due0[here] - edges[k] + edges[slot])
        length.append(length0[here])
    length = np.concatenate(length).astype(np.int64)
    offset = rng.integers(0, pool_len - length + 1)
    return Schedule(np.concatenate(due), length, offset.astype(np.int64))


def cap(stream: dict, length: int) -> int:
    """The most requests of ``length`` one batch holds."""
    caps = stream["batch_cap"]
    n = caps.get("requests", 1 << 30)
    if "tokens" in caps:
        n = min(n, caps["tokens"] // length)
    if n < 1:
        raise ValueError(f"batch cap {caps} holds no request of {length}")
    return n
