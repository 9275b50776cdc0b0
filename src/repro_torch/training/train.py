"""The train step and loop.

PyTorch counterpart of the JAX package's ``training/train.py``.  The JAX
step is a pure function of (params, opt_state, batch); here the model holds
its parameters, ``make_train_step`` keeps the AdamW state, and a step
updates both in place.  The loss is ``Model.loss_fn`` (each block
recomputed in the backward, as JAX's default ``remat``); on the card its
attention and RG-LRU layers run forward and backward through the port's
kernels (``kernels/ops.py``).
"""
from __future__ import annotations

import time
from collections.abc import Callable, Iterable

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.training.optim import OptimConfig, adamw_init, adamw_update


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_train_step(model: Model, opt_cfg: OptimConfig) -> Callable:
    """Returns ``train_step(batch) -> metrics`` (``loss``, ``grad_norm``,
    ``lr``: device scalars).  Turns the model's gradients on; the AdamW
    state is ``train_step.state``."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    state = adamw_init(params)

    def train_step(batch: dict) -> dict:
        loss = model.loss_fn(to_device(batch, model.device))
        loss.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.items()}
        metrics = adamw_update(params, grads, state, opt_cfg)
        del grads
        for p in params.values():
            p.grad = None  # freed before the next step's forward
        return dict(metrics, loss=loss.detach())

    train_step.state = state
    return train_step


def train_loop(model: Model, batches: Iterable,
               opt_cfg: OptimConfig | None = None, log_every: int = 10,
               log_fn=print):
    """Single-device loop.  Returns (the AdamW state, history): a record
    ``step``, ``loss``, ``grad_norm``, ``lr``, ``ms_per_step`` and
    ``tokens_per_s`` (of ``tokens``, or of an encoder's ``labels``) every
    ``log_every`` steps, timed after the device has finished the steps
    (``torch.cuda.synchronize``), not when they were queued."""
    opt_cfg = opt_cfg or OptimConfig()
    step_fn = make_train_step(model, opt_cfg)
    history = []
    synchronize(model.device)
    t0, n_tokens = time.perf_counter(), 0
    for i, batch in enumerate(batches):
        metrics = step_fn(batch)
        n_tokens += int(np.prod(np.shape(batch.get("tokens",
                                                   batch.get("labels")))))
        if (i + 1) % log_every == 0:
            synchronize(model.device)
            dt = time.perf_counter() - t0
            rec = dict(step=i + 1, loss=float(metrics["loss"]),
                       grad_norm=float(metrics["grad_norm"]),
                       lr=float(metrics["lr"]),
                       ms_per_step=dt / log_every * 1e3,
                       tokens_per_s=n_tokens / dt)
            log_fn(f"step {i+1}: loss={rec['loss']:.4f} grad_norm="
                   f"{rec['grad_norm']:.4f} ({rec['ms_per_step']:.0f} "
                   f"ms/step, {rec['tokens_per_s']:.0f} tokens/s)")
            history.append(rec)
            t0, n_tokens = time.perf_counter(), 0
    return step_fn.state, history
