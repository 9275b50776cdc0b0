"""chatglm3-6b [arXiv:2406.12793] — RoPE-2d, strong GQA (kv=2).

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    arch_type="dense",
    n_layers=28,
    d_model=4096,
    vocab_size=65_024,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13_696,
)
