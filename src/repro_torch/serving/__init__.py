"""Serving of the port: the entry point ``python -m
repro_torch.serving.executor``, and the rate tracking and periodic
rescheduling of the JAX package's ``serving/controller.py`` (a copy)."""
from repro_torch.serving.controller import (EWMARateTracker, PeriodRecord,
                                            ServingController)

__all__ = ["EWMARateTracker", "ServingController", "PeriodRecord"]
