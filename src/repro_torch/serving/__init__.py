"""Serving entry point of the port: ``python -m repro_torch.serving.executor``."""
