"""granite-4.0-h-small [huggingface.co/ibm-granite/granite-4.0-h-small,
config.json; model_type granitemoehybrid] — Mamba-2 / attention hybrid MoE.

40L d_model=4096 vocab=100352 (tied head); attention at layers 5, 15, 25,
35 (GQA 32/8, head dim 128, no position embedding, softmax scale 1/128),
the upstream Mamba-2 mixer at the other 36 (128 heads of 64, state 128,
one B/C group, conv 4 with bias, chunk 256, expand 2); every layer ends in
72 experts of 768 with 10 a token, dropless, plus a shared SwiGLU MLP of
1536; embedding x 12, residual x 0.22, logits / 16, RMSNorm eps 1e-5.
32.2 B parameters, 64.4 GB in bf16.  The port's own: the JAX package has
no such model.
"""
from repro_torch.models.config import ModelConfig

_ATTENTION = (5, 15, 25, 35)

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    arch_type="hybrid",
    n_layers=40,
    d_model=4096,
    vocab_size=100_352,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    position_embedding="none",
    attn_scale=0.0078125,
    d_ff=768,
    moe_d_ff=768,
    n_experts=72,
    top_k=10,
    n_shared_experts=1,
    shared_d_ff=1536,
    moe_dropless=True,
    rms_eps=1e-5,
    ssm_d_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    layer_kinds=tuple("moe" if i in _ATTENTION else "mamba2"
                      for i in range(40)),
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    tie_embeddings=True,
)
