"""Data substrate: synthetic token pipeline + serving request workloads."""
from repro_torch.data.pipeline import SyntheticLM, token_batches

__all__ = ["SyntheticLM", "token_batches"]
