"""Weights carried across from the JAX package (numpy only, no JAX)."""
from repro_torch.checkpoint.bridge import load_jax_checkpoint, params_from_jax

__all__ = ["load_jax_checkpoint", "params_from_jax"]
