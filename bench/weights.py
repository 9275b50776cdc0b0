"""Weights and inputs made from ``--seed`` on the device, for both sides.

Each layer's weights come from a generator of their own, seeded from
(``--seed``, the layer's index), so the reference can make any layer again
by itself after the window, layer by layer, and take nothing that the
program holds.  A layer's bf16 leaves are drawn in one ``normal_`` call
into one buffer and scaled in one ``_foreach_mul_``; its float32 leaves
(the norms') in one more.  ``load_into`` copies them into the port's
``Model`` in one ``_foreach_copy_`` a layer, after checking that the
program's leaves are exactly these, by name and shape.

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

from bench.reference import model as ref_model
from bench.traffic import seed_sequence

POOL = 1 << 16  # entries of the input pool
NORM_JITTER = 0.1


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def seed_int(seed: int, *key) -> int:
    return int(seed_sequence(seed, *key).generate_state(1, np.uint64)[0])


def generator(device, seed: int, *key) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_int(seed, *key))


def model_leaves(c: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, init) of the leaves outside the layers: the token
    embedding and the head, or an encoder's head; the final norm."""
    f = c["fields"]
    d = f["d_model"]
    vp = round_up(f["vocab_size"], 256)
    if f.get("has_decoder", True):
        out = [("embed.tok", (vp, d), "normal:0.02"),
               ("embed.head", (d, vp), f"normal:{d ** -0.5}")]
    else:
        out = [("head", (d, vp), f"normal:{d ** -0.5}")]
    return out + ref_model.norm_leaves(c, "final_norm")


def make(leaves, device, seed: int, *key) -> dict:
    """The leaves' tensors, drawn from the generator of (seed, *key): the
    projections in bf16, the norms in float32."""
    g = generator(device, seed, *key)
    out = {}
    wide = [(n, s, init) for n, s, init in leaves if init.startswith("normal")]
    norms = [(n, s, init) for n, s, init in leaves
             if not init.startswith("normal")]
    for group, dt in ((wide, torch.bfloat16), (norms, torch.float32)):
        if not group:
            continue
        sizes = [math.prod(s) for _, s, _ in group]
        buf = torch.empty(sum(sizes), device=device, dtype=dt)
        buf.normal_(0.0, 1.0, generator=g)
        views = [v.view(s) for v, (_, s, _) in
                 zip(buf.split(sizes), group)]
        if dt is torch.float32:
            scales = [NORM_JITTER] * len(group)
        else:
            scales = [float(init.split(":")[1]) for _, _, init in group]
        torch._foreach_mul_(views, scales)
        for v, (n, _, init) in zip(views, group):
            if init == "scale":
                v.add_(1.0)
            out[n] = v
    return out


def layer(c: dict, i: int, device, seed: int) -> dict:
    return make(ref_model.leaves(c), device, seed, 1, i)


def top(c: dict, device, seed: int) -> dict:
    return make(model_leaves(c), device, seed, 2)


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
