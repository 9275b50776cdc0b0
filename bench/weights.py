"""Weights and inputs made from ``--seed`` on the device, for both sides.

Each layer's weights come from a generator of their own, seeded from
(``--seed``, the layer's index), so the reference can make any layer again
by itself after the window, layer by layer, and take nothing that the
program holds.  Which leaves a layer has, and how each is drawn, the
entry's reference module says (``layer_leaves``, ``top_leaves``: see
``reference/__init__.py``).  A layer's bf16 leaves are drawn in one
``normal_`` call into one buffer and scaled in one ``_foreach_mul_``; its
float32 norms in one more; float32 leaves of a stated draw (a router, an
SSM's decay) in one call a kind after them.  ``load_into`` copies them
into the port's ``Model`` in one ``_foreach_copy_`` a layer, after
checking that the program's leaves are exactly these, by name and
shape.

Leaves follow the port's layout (``wq`` (d, H, Dh), ``wo`` (H, Dh, d),
``w_up`` (d, F), a head padded to a multiple of 256 columns) and the JAX
init's scales (1/sqrt(fan-in); the embedding 0.02).  Norm scales are drawn
as 1 + 0.1 N(0, 1) and LayerNorm biases as 0.1 N(0, 1), not 1 and 0, so
that the output check sees them.

The input pool is the requests' raw data: frame embeddings (the stand-in
for HuBERT's conv feature encoder) or token ids, from which each request
takes ``length`` entries at its offset (``traffic.Schedule.offset``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bench import spec
from bench.traffic import seed_sequence

POOL = 1 << 16  # entries of the input pool
NORM_JITTER = 0.1
NORMS = ("scale", "bias")  # float32 norm leaves' inits


def seed_int(seed: int, *key) -> int:
    return int(seed_sequence(seed, *key).generate_state(1, np.uint64)[0])


def generator(device, seed: int, *key) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_int(seed, *key))


def _stated(init: str) -> tuple[str, float, float]:
    """``"f32:normal:<mean>:<std>"`` or ``"f32:uniform:<low>:<high>"``
    -> (kind, a, b)."""
    parts = init.split(":")
    if len(parts) != 4 or parts[0] != "f32" or \
            parts[1] not in ("normal", "uniform"):
        raise ValueError(f"init {init!r}: not normal:<std>, scale, bias, "
                         "f32:normal:<mean>:<std> or "
                         "f32:uniform:<low>:<high>")
    return parts[1], float(parts[2]), float(parts[3])


def make(leaves, device, seed: int, *key) -> dict:
    """The leaves' tensors, drawn from the generator of (seed, *key): the
    projections in bf16, then the norms in float32, then the float32
    leaves of a stated draw, the normals before the uniforms."""
    g = generator(device, seed, *key)
    out = {}
    wide = [(n, s, init) for n, s, init in leaves if init.startswith("normal")]
    norms = [(n, s, init) for n, s, init in leaves if init in NORMS]
    stated = [(n, s, _stated(init)) for n, s, init in leaves
              if init not in NORMS and not init.startswith("normal")]
    for group, dt in ((wide, torch.bfloat16), (norms, torch.float32)):
        if not group:
            continue
        views = _drawn(group, device, dt, g, "normal")
        if dt is torch.float32:
            scales = [NORM_JITTER] * len(group)
        else:
            scales = [float(init.split(":")[1]) for _, _, init in group]
        torch._foreach_mul_(views, scales)
        for v, (n, _, init) in zip(views, group):
            if init == "scale":
                v.add_(1.0)
            out[n] = v
    for kind in ("normal", "uniform"):
        group = [x for x in stated if x[2][0] == kind]
        if not group:
            continue
        views = _drawn(group, device, torch.float32, g, kind)
        # a + b x for a normal's mean and deviation; low + (high - low) x
        # for a uniform's range
        torch._foreach_mul_(views, [b if kind == "normal" else b - a
                                    for _, _, (_, a, b) in group])
        torch._foreach_add_(views, [a for _, _, (_, a, _) in group])
        out.update((n, v) for v, (n, _, _) in zip(views, group))
    return out


def _drawn(group, device, dt, g, kind: str) -> list:
    """Views of one buffer, one per leaf of ``group``, filled by one
    standard ``normal_`` or ``uniform_`` call."""
    sizes = [math.prod(s) for _, s, _ in group]
    buf = torch.empty(sum(sizes), device=device, dtype=dt)
    if kind == "normal":
        buf.normal_(0.0, 1.0, generator=g)
    else:
        buf.uniform_(0.0, 1.0, generator=g)
    return [v.view(s) for v, (_, s, _) in zip(buf.split(sizes), group)]


def layer(c: dict, i: int, device, seed: int) -> dict:
    return make(spec.reference(c).layer_leaves(c, i), device, seed, 1, i)


def top(c: dict, device, seed: int) -> dict:
    return make(spec.reference(c).top_leaves(c), device, seed, 2)


def _copy(params: dict, made: dict, where: str):
    if set(params) != set(made):
        raise ValueError(f"{where}: the program has leaves "
                         f"{sorted(set(params) - set(made))} the benchmark "
                         f"does not make, and lacks "
                         f"{sorted(set(made) - set(params))}")
    names = sorted(params)
    for n in names:
        if tuple(params[n].shape) != tuple(made[n].shape) or \
                params[n].dtype != made[n].dtype:
            raise ValueError(f"{where}.{n}: program {params[n].dtype} "
                             f"{tuple(params[n].shape)}, benchmark "
                             f"{made[n].dtype} {tuple(made[n].shape)}")
    torch._foreach_copy_([params[n] for n in names], [made[n] for n in names])


@torch.no_grad()
def load_into(model, c: dict, seed: int):
    """Copy the seed's weights into the port's ``model`` (any device)."""
    dev = next(model.parameters()).device
    _copy({n: p for n, p in model.named_parameters()
           if not n.startswith("layers.")}, top(c, dev, seed), "model")
    for i, block in enumerate(model.layers):
        _copy(dict(block.named_parameters()), layer(c, i, dev, seed),
              f"layers.{i}")


def input_pool(c: dict, device, seed: int) -> torch.Tensor:
    """(POOL, d_model) bf16 frame embeddings for an encoder, (POOL,) token
    ids in [0, vocab_size) for a decoder."""
    f = c["fields"]
    g = generator(device, seed, 3)
    if f.get("has_decoder", True):
        return torch.randint(0, f["vocab_size"], (POOL,), generator=g,
                             device=device)
    return torch.randn((POOL, f["d_model"]), generator=g, device=device,
                       dtype=torch.float32).to(torch.bfloat16)
