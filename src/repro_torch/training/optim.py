"""AdamW with cosine schedule and global-norm clipping.

PyTorch counterpart of the JAX package's ``training/optim.py``, in the same
arithmetic: the moments are fp32 whatever the parameter's dtype, and the
update is computed in fp32 and cast back (no separate master copy); the
gradient is clipped by its global norm before clipping, taken in fp32; the
learning rate warms up linearly and decays on a cosine to a floor of 0.1;
the bias corrections are ``1 - b ** step`` in fp32.  ``torch.optim.AdamW``
is not this: for a bf16 parameter it keeps bf16 moments, and it has
neither this clipping nor this schedule.

Parameters, gradients and moments are dicts keyed by the model's parameter
names (``dict(model.named_parameters())``).  Where JAX returns new arrays,
``adamw_update`` updates the parameters and the state in place: a second
copy of recurrentgemma-2b's 36 GB of parameters, gradients and moments
would not fit next to them on one card.  The step count, the clip scale,
the learning rate and the metrics stay on the device, so a step never
waits on the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def schedule(cfg: OptimConfig, step):
    """The learning rate at ``step`` (an int or an integer tensor), an fp32
    tensor on the step's device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def adamw_init(params: dict) -> dict:
    """Zero fp32 moments beside every parameter, and the step count (an
    int32 scalar on the parameters' device)."""
    device = next(iter(params.values())).device
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    return {"m": zeros,
            "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict):
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree.values()))


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict,
                 cfg: OptimConfig) -> dict:
    """One AdamW step, in place on ``params`` and ``state``.  Returns the
    metrics ``grad_norm`` (before clipping) and ``lr``, device scalars."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, stepf)
    bc2 = 1.0 - torch.pow(cfg.b2, stepf)
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        pf = p.float()
        delta.add_(pf * cfg.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(pf.sub_(delta))
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
