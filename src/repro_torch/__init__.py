"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

The JAX package under ``src/repro`` is the reference: the same weights and
inputs go through both, and the outputs agree within stated tolerances.
This package imports ``torch`` and numpy, and nothing of ``repro`` or JAX.
"""
