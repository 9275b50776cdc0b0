"""input_specs(): stand-ins on torch's ``meta`` device for every (arch x
shape) combination.

The port's counterpart of the JAX package's ``launch/specs.py``.  Where JAX
hands out ``ShapeDtypeStruct``s, these are tensors on ``meta``: they carry
a shape, a dtype and strides and hold no memory, so the full-size configs
(up to 480 B parameters) are described without allocating anything.
``INPUT_SHAPES``, ``LONG_DECODE_WINDOW``, ``applicable`` and
``decode_window`` are copied word for word.

The cache is the port's own layout, ``Model.init_cache``: a per-layer
list of dicts and a Python int ``len``, where JAX stacks the layers of a
homogeneous stack along a leading axis.  Given a model on another device
(the CPU, the card), ``input_specs`` makes the same tensors there, zero
filled, so one combination runs where its dry run was traced.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model

#: The four assigned input shapes.
INPUT_SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode_long", seq_len=524288, global_batch=1),
}

#: Sliding window used by full-attention archs for long_500k decode.
LONG_DECODE_WINDOW = 4096


def sds(shape, dtype, device="meta"):
    """A ``meta`` tensor, the port's ``ShapeDtypeStruct``; on another
    device, zeros."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.zeros(shape, dtype=dtype, device=device)


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """Whether this (arch x shape) combination runs, and why not if skipped.

    Skips per DESIGN.md §Arch-applicability: encoder-only archs have no
    decode step.  Full-attention archs run long_500k via the sliding-window
    variant (so they are NOT skipped).
    """
    info = INPUT_SHAPES[shape_name]
    if info["kind"].startswith("decode") and not cfg.has_decoder:
        return False, "encoder-only: no autoregressive decode"
    return True, ""


def batch_specs(cfg: ModelConfig, batch: int, seq: int, *,
                device="meta") -> dict:
    """Training/prefill batch stand-ins, in the JAX dtypes."""
    if cfg.arch_type == "audio":
        return {
            "frame_embeds": sds((batch, seq, cfg.d_model), torch.bfloat16,
                                device),
            "labels": sds((batch, seq), torch.int32, device),
        }
    if cfg.arch_type == "vlm":
        n_patch = min(cfg.n_frontend_tokens, seq // 4)
        return {
            "tokens": sds((batch, seq - n_patch), torch.int32, device),
            "patch_embeds": sds((batch, n_patch, cfg.d_model),
                                torch.bfloat16, device),
        }
    return {"tokens": sds((batch, seq), torch.int32, device)}


def decode_window(cfg: ModelConfig, shape_name: str) -> int | None:
    """Ring-buffer window for the decode cache (None = dense cache)."""
    if shape_name != "long_500k":
        return None
    if cfg.arch_type in ("ssm", "hybrid"):
        return None  # recurrent state / local windows are already O(1)
    return LONG_DECODE_WINDOW  # sliding-window variant for full-attention


def input_specs(arch_cfg: ModelConfig, shape_name: str, *,
                model: Model | None = None):
    """Returns (step_kind, specs) where specs matches the step's signature.

    step kinds: "train" -> (batch,), "encode" -> (batch,), "prefill" ->
    (batch, cache), "decode" -> (cache, tokens).  ``model`` gives the
    device and, through its ``init_cache``, the cache (a ``meta`` model is
    built if None).
    """
    info = INPUT_SHAPES[shape_name]
    return step_specs(arch_cfg, info["kind"], info["global_batch"],
                      info["seq_len"], window=decode_window(arch_cfg,
                                                            shape_name),
                      model=model)


def step_specs(cfg: ModelConfig, kind: str, batch: int, seq: int, *,
               window: int | None = None, model: Model | None = None):
    """``input_specs`` for any shape: a step ``kind`` of ``INPUT_SHAPES``
    at ``batch`` x ``seq`` (a decode cache of ``window`` slots at most)."""
    device = model.device if model is not None else torch.device("meta")
    if kind == "train":
        return "train", (batch_specs(cfg, batch, seq, device=device),)
    if kind == "prefill" and not cfg.has_decoder:
        # encoder-only: prefill is a plain full forward (no cache)
        return "encode", (batch_specs(cfg, batch, seq, device=device),)
    model = model or Model(cfg, device="meta")
    if kind == "prefill":
        cache = model.init_cache(batch, seq)
        return "prefill", (batch_specs(cfg, batch, seq, device=device),
                           cache)
    # decode shapes
    cache = model.init_cache(batch, seq, window=window)
    tokens = sds((batch, 1), torch.int32, device)
    return "decode", (cache, tokens)
