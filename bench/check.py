"""Whether what the timed path served is right: the reference's verdict.

After the window, a sample of the requests a side finished is drawn from
the seed, the longest request among them always in it.  The reference (the
entry's module, ``spec.reference``: ``reference/model.py`` unless the
entry names another; float32, weights made again from the seed layer by
layer) runs once over each sampled request's input, and each served
token (a prefill's first token, an encoder's label of each frame) is
scored by its gap: how far the reference's logit of that token lies below
the reference's best logit at the same position.  The side's number is
the widest gap over the sample, held to the configuration's ``max_gap``.
Greedy tokens only, which is all this traffic serves.

``control=True`` also runs the reference with float8 linear layers (the
module's ``fp8_mm``) and puts it in the program's place: the token
it ranks first at each served position is scored by the same gap and
judged by the same limit, so that a run of the control comes out not
correct.
"""
from __future__ import annotations

import numpy as np
import torch

from bench import spec, traffic, weights


def sample(side, seconds: float, seed: int, key: int) -> np.ndarray:
    """Up to ``sample_requests`` finished requests, the longest first."""
    n = side.entry_spec["check"]["sample_requests"]
    ok = np.flatnonzero(~np.isnan(side.done) &
                        (side.done <= seconds + side.slo_s))
    if len(ok) == 0:
        return ok
    lengths = side.sched.length[ok]
    longest = ok[np.argmax(lengths)]
    rest = ok[ok != longest]
    rng = np.random.default_rng(traffic.seed_sequence(seed, 9, key))
    pick = rng.choice(rest, size=min(n - 1, len(rest)), replace=False)
    return np.concatenate([[longest], np.sort(pick)]).astype(int)


def _gaps(ref, tokens):
    """Gap of each token (B, S) under reference logits (B, S, V)."""
    best = ref.max(-1).values
    return best - ref.gather(-1, tokens[..., None])[..., 0]


def readings(side, seconds: float, seed: int, key: int,
             control: bool = False) -> dict:
    """{"max_gap", "tokens"} of the side, and ``control_max_gap`` with
    ``control``."""
    rids = sample(side, seconds, seed, key)
    if len(rids) == 0:
        return {"max_gap": float("nan"), "tokens": 0}
    c = side.entry_spec
    dev = side.pool.device
    groups, served = [], []
    for length in sorted(set(side.sched.length[rids].tolist())):
        g = rids[side.sched.length[rids] == length]
        offs = torch.as_tensor(side.sched.offset[g], device=dev)
        groups.append(side.pool[offs[:, None] +
                                torch.arange(length, device=dev)])
        served.append(torch.as_tensor(
            np.stack([np.atleast_1d(side.outputs[int(r)]) for r in g]),
            device=dev).long())
    ref_model = spec.reference(c)
    mms = (ref_model.plain_mm, ref_model.fp8_mm) if control else \
        (ref_model.plain_mm,)
    logits = ref_model.run(c, lambda i: weights.layer(c, i, dev, seed),
                           weights.top(c, dev, seed), groups, mms)
    ref = logits[0]
    out = {"max_gap": max(float(_gaps(r, t).max()) for r, t in
                          zip(ref, served)),
           "tokens": int(sum(t.numel() for t in served))}
    if control:
        out["control_max_gap"] = max(
            float(_gaps(r, lc.argmax(-1)).max())
            for r, lc in zip(ref, logits[1]))
    return out


def verdict(sides, seconds: float, seed: int, control: bool = False):
    """(correct, {name: {"value", "limit"}}) over every side: each side's
    widest gap at most its limit, its ``sampled_tokens`` at least 1.  With
    ``control`` the gap judged is the control's (``control_max_gap``); the
    program's is still given, beside the same limit."""
    numbers, correct = {}, True
    for key, side in enumerate(sides):
        r = readings(side, seconds, seed, key, control)
        limit = side.entry_spec["check"]["max_gap"]
        judged = "control_max_gap" if control else "max_gap"
        correct &= r[judged] <= limit and r["tokens"] > 0
        for name in ("max_gap", "control_max_gap")[:1 + control]:
            numbers[f"{name}.{side.name}"] = {"value": r[name],
                                              "limit": limit}
        numbers[f"sampled_tokens.{side.name}"] = {"value": r["tokens"],
                                                  "limit": 1}
    return bool(correct), numbers
