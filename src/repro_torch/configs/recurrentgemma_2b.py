"""recurrentgemma-2b [arXiv:2402.19427] — RG-LRU + local attention, 1:2.

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000; block pattern
(rglru, rglru, attn) with 2048-token local attention windows.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    n_layers=26,
    d_model=2560,
    vocab_size=256_000,
    n_heads=10,
    n_kv_heads=1,
    d_head=256,
    d_ff=7680,
    activation="gelu",
    pattern=("rglru", "rglru", "attn"),
    lru_width=2560,
    local_window=2048,
)
