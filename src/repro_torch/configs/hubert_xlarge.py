"""hubert-xlarge [arXiv:2106.07447] — encoder-only audio backbone.

48L d_model=1280 16H d_ff=5120 vocab=504 (cluster targets).  The conv/mel
feature extractor is STUBBED (DESIGN.md carve-out): the model consumes
pre-computed frame embeddings.  Encoder-only => no decode shapes.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    n_layers=48,
    d_model=1280,
    vocab_size=504,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    activation="gelu",
    norm="layernorm",
    causal=False,
    frontend="audio",
    has_decoder=False,
)
