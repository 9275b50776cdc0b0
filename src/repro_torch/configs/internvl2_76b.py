"""internvl2-76b [arXiv:2404.16821] — InternViT + LLM decoder backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  The InternViT
vision tower + projector are STUBBED (see DESIGN.md carve-out): the model
consumes pre-computed patch embeddings via ``patch_embeds``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    n_layers=80,
    d_model=8192,
    vocab_size=128_256,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    frontend="vision",
    n_frontend_tokens=1024,   # patch embeddings per image tile budget
    fsdp_serving=True,        # 76B bf16 params do not fit model-axis-only
)
