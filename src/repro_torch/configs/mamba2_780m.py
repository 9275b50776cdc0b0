"""mamba2-780m [arXiv:2405.21060] — SSD (state-space duality), attn-free.

48L d_model=1536 vocab=50280 ssm_state=128.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    n_layers=48,
    d_model=1536,
    vocab_size=50_280,
    ssm_d_state=128,
    ssm_headdim=64,
    ssm_expand=2,
)
