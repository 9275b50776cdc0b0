"""The training entry point.

PyTorch counterpart of the JAX package's ``launch/train.py``: the same
flags and presets (``smoke``, ``mini``), plus ``--preset full`` (the
arch's full config, which the JAX package's dry run compiles its train
step for) and ``--device`` (the card unless ``cpu`` is asked for).  It
prints each step's loss, grad norm, ms and tokens/s, and the peak device
memory.

On the card every attention, SSM and RG-LRU layer trains through the
port's kernels and their backward passes.  The audio encoder is refused as
in JAX.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-2b \\
      --preset full --steps 8 --batch 4 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
      --preset full --steps 8 --batch 4 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
      --preset smoke --device cpu --steps 20 --batch 4 --seq 64
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data import token_batches
from repro_torch.models.model import Model, resolve_device
from repro_torch.training import OptimConfig, train_loop


def mini_config(arch_id: str):
    """~100M-param member of the same family (for the e2e training demo)."""
    cfg = get_config(arch_id)
    upd = dict(
        name=cfg.name + "-mini",
        n_layers=min(cfg.n_layers, 8),
        d_model=512,
        vocab_size=min(cfg.vocab_size, 32_000),
        n_heads=min(cfg.n_heads, 8) if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        d_head=64 if cfg.n_heads else 0,
        d_ff=min(cfg.d_ff, 2048) if cfg.d_ff else 0,
        moe_d_ff=min(cfg.moe_d_ff, 1024) if cfg.moe_d_ff else 0,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_d_state=min(cfg.ssm_d_state, 64) if cfg.ssm_d_state else 0,
        ssm_headdim=64 if cfg.arch_type == "ssm" else cfg.ssm_headdim,
        ssm_chunk=64,
        lru_width=512 if cfg.lru_width else 0,
        local_window=min(cfg.local_window, 256),
        n_frontend_tokens=min(cfg.n_frontend_tokens, 32),
    )
    return dataclasses.replace(cfg, **upd)


PRESETS = {"smoke": get_smoke_config, "mini": mini_config,
           "full": get_config}


def refusal(cfg, device) -> str | None:
    """Why ``train`` refuses ``cfg`` on ``device``, or None."""
    if cfg.arch_type == "audio":
        return (f"{cfg.name} is an encoder: this entry point trains "
                "next-token models, as the JAX package's does "
                "(Model.loss_fn takes an encoder's per-frame labels)")
    return None


def train(arch: str, preset: str = "mini", steps: int = 200, batch: int = 8,
          seq: int = 128, lr: float = 1e-3, device="cuda",
          checkpoint_dir: str | None = None, log_fn=print) -> dict:
    """Train ``arch`` on the synthetic LM (bf16, seed 0).  Returns the
    report: the loop's ``history``, ``n_params``, ``peak_gib`` (the card's
    peak allocated memory; None on the CPU), ``checkpoint`` and the trained
    ``model``."""
    cfg = PRESETS[preset](arch)
    why = refusal(cfg, device)
    if why:
        raise SystemExit(why)
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(0)
    model = Model(cfg, device=device).init(gen)
    n_params = sum(p.numel() for p in model.parameters())
    log_fn(f"{cfg.name}: {n_params/1e6:.1f}M params, "
           f"{steps} steps @ batch {batch} x seq {seq} on {device}")
    batches = token_batches(cfg.vocab_size, batch, seq, steps)
    opt = OptimConfig(lr=lr, warmup_steps=min(50, steps // 4),
                      total_steps=steps)
    _, hist = train_loop(model, batches, opt, log_every=1, log_fn=log_fn)
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    log_fn("peak device memory: " + ("not measured (CPU)" if peak is None
                                     else f"{peak:.2f} GiB"))
    uniform = math.log(cfg.vocab_size)
    final = hist[-1]["loss"] if hist else float("nan")
    log_fn(f"uniform={uniform:.3f} final={final:.3f} "
           f"({'learned' if final < uniform - 0.3 else 'NOT LEARNING'})")
    path = None
    if checkpoint_dir:
        from repro_torch.checkpoint import save_checkpoint
        path = save_checkpoint(checkpoint_dir, model, step=steps)
        log_fn(f"checkpoint: {path}")
    return {"history": hist, "n_params": n_params, "peak_gib": peak,
            "checkpoint": path, "model": model}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-9b")
    ap.add_argument("--preset", choices=tuple(PRESETS), default="mini")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train(args.arch, args.preset, args.steps, args.batch, args.seq, args.lr,
          args.device, args.checkpoint_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
