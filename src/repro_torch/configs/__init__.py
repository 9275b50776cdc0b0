"""Architecture configs of the port (exact published hyper-parameters).

``get_config(arch_id)`` returns the full-size ModelConfig;
``get_smoke_config(arch_id)`` returns a reduced variant of the same family
(<=2 layers, d_model<=512, <=4 experts) for CPU smoke tests.  Both behave
as the JAX package's ``configs`` do.  The dense configs are ported; the
others name the slice of the port that brings them.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = (
    "deepseek-moe-16b",
    "internvl2-76b",
    "stablelm-12b",
    "arctic-480b",
    "chatglm3-6b",
    "recurrentgemma-2b",
    "mamba2-780m",
    "yi-9b",
    "command-r-35b",
    "hubert-xlarge",
)

# arch id -> the slice of the port that brings its config and model code
NOT_YET_PORTED = {
    "deepseek-moe-16b": "MoE",
    "arctic-480b": "MoE",
    "mamba2-780m": "SSM",
    "recurrentgemma-2b": "hybrid",
    "internvl2-76b": "encoder/VLM",
    "hubert-xlarge": "encoder/VLM",
}


def _module(arch_id: str):
    return importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_"))


def get_config(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    if arch_id in NOT_YET_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not yet ported; it comes with the "
            f"{NOT_YET_PORTED[arch_id]} slice of the port")
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts."""
    cfg = get_config(arch_id)
    pattern = cfg.pattern
    n_layers = min(cfg.n_layers, 2)
    if cfg.arch_type == "hybrid":
        n_layers = 3  # keep one full (rec, rec, attn) pattern unit
    updates = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=256,
        vocab_size=min(cfg.vocab_size, 1024),
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_head=64 if cfg.n_heads else 0,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        moe_d_ff=min(cfg.moe_d_ff, 256) if cfg.moe_d_ff else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        ssm_d_state=min(cfg.ssm_d_state, 32) if cfg.ssm_d_state else 0,
        ssm_headdim=32 if cfg.arch_type == "ssm" else cfg.ssm_headdim,
        ssm_chunk=16,
        lru_width=256 if cfg.lru_width else 0,
        local_window=64 if cfg.arch_type == "hybrid" else cfg.local_window,
        sliding_window=cfg.sliding_window and min(cfg.sliding_window, 64),
        pattern=pattern,
        n_frontend_tokens=min(cfg.n_frontend_tokens, 16),
    )
    return dataclasses.replace(cfg, **updates)


__all__ = ["ARCH_IDS", "NOT_YET_PORTED", "get_config", "get_smoke_config"]
