"""yi-9b [arXiv:2403.04652] — llama-arch GQA.

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    arch_type="dense",
    n_layers=48,
    d_model=4096,
    vocab_size=64_000,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11_008,
)
