"""arctic-480b [hf:Snowflake/snowflake-arctic-base] — dense-MoE hybrid.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000; 128 experts top-2
routed in parallel with a dense residual MLP.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    n_layers=35,
    d_model=7168,
    vocab_size=32_000,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    moe_d_ff=4864,
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    fsdp_serving=True,        # ~480B total params
)
