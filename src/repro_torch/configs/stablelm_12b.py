"""stablelm-12b [hf:stabilityai/stablelm-2-12b family].

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    vocab_size=100_352,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13_824,
    norm="layernorm",
)
