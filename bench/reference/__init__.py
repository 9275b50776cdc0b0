"""Plain PyTorch references of the benchmark's models.

No kernel, cache or batching of the port, and nothing imported from it or
from the JAX package: the models are read from the configuration files'
dicts, the weights made again from the seed (``bench/weights.py``), layer
by layer.
"""
