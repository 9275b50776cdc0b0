"""Modality frontends: stand-ins, as in the JAX package.

The counterpart of the JAX package's ``models/frontend.py``.  The audio
(hubert) and VLM (internvl) architectures specify the transformer backbone
only: the conv feature extractor and the ViT / projector are not
implemented in either package.  The model consumes pre-computed frame or
patch embeddings of shape (B, T, d_model) / (B, N_patch, d_model); these
helpers draw random ones of that shape from a ``torch.Generator`` on an
explicit device (the JAX stubs take a ``jax.random`` key).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def _normal(generator, shape, device, dtype):
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32).to(dtype)


def audio_frame_embeddings(generator: torch.Generator, batch: int,
                           n_frames: int, cfg: ModelConfig, *, device,
                           dtype=torch.bfloat16):
    """Stand-in for the wav2vec2 / HuBERT conv extractor's output:
    (B, T, d_model) standard normals."""
    return _normal(generator, (batch, n_frames, cfg.d_model), device, dtype)


def vision_patch_embeddings(generator: torch.Generator, batch: int,
                            n_patches: int, cfg: ModelConfig, *, device,
                            dtype=torch.bfloat16):
    """Stand-in for the InternViT + projector output: (B, N_patch, d_model)
    standard normals."""
    return _normal(generator, (batch, n_patches, cfg.d_model), device, dtype)
