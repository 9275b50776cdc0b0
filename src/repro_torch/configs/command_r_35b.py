"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01] — GQA, no-bias.

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    arch_type="dense",
    n_layers=40,
    d_model=8192,
    vocab_size=256_000,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_528,
)
