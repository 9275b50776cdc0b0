"""Weights carried across from and to the JAX package's checkpoint format
(numpy only, no JAX)."""
from repro_torch.checkpoint.bridge import load_jax_checkpoint, params_from_jax
from repro_torch.checkpoint.store import (entry_nbytes, manifest_nbytes,
                                          save_checkpoint)

__all__ = ["entry_nbytes", "load_jax_checkpoint", "manifest_nbytes",
           "params_from_jax", "save_checkpoint"]
