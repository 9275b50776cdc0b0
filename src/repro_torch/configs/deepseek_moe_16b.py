"""deepseek-moe-16b [arXiv:2401.06066] — fine-grained MoE.

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400; 2 shared + 64
routed experts, top-6.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    n_layers=28,
    d_model=2048,
    vocab_size=102_400,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,          # per-expert hidden (fine-grained)
    moe_d_ff=1408,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
)
