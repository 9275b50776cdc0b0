"""Model configuration for every architecture family this framework serves.

A copy of the JAX package's ``models/config.py``: the port imports nothing
of that package.  One ``ModelConfig`` describes any of the six families:
dense / moe / ssm / hybrid / vlm / audio.  ``repro_torch/configs/<id>.py``
instantiates the ported architectures with their exact published
hyper-parameters.

Two fields of the JAX config are left out because they select JAX
execution paths the port does not have: ``kernel_impl`` (the port picks
the attention kernel from the tensor's device, see ``kernels/ops.py``) and
``analysis_unroll`` (an XLA cost-analysis switch).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

ArchType = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
#: layer kinds (``ModelConfig.layer_types``) with attention and a KV cache
ATTN_KINDS = ("attn_mlp", "moe", "attn")


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: ArchType
    n_layers: int
    d_model: int
    vocab_size: int

    # attention (ignored for pure SSM)
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0                   # default d_model // n_heads
    rope_theta: float = 10_000.0
    sliding_window: int | None = None  # None = full attention
    causal: bool = True                # False for encoder-only (audio)

    # ffn
    d_ff: int = 0
    activation: Literal["swiglu", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"

    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel w/ MoE

    # ssm (mamba2 / SSD)
    ssm_d_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # hybrid (recurrentgemma): block pattern unit, e.g. ("rglru","rglru","attn")
    pattern: tuple[str, ...] = ()
    lru_width: int = 0
    local_window: int = 2048

    # modality frontend (stubbed; see DESIGN.md carve-out)
    frontend: Literal["none", "audio", "vision"] = "none"
    n_frontend_tokens: int = 0        # patches / frames provided pre-embedded

    # serving
    has_decoder: bool = True          # False => encoder-only, no decode shapes
    decode_window: int = 4096         # sliding-window used for long_500k decode

    # sharding hints
    fsdp_serving: bool = False        # shard weights over data axis in serving

    # ---- derived -----------------------------------------------------------

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        return round_up(self.vocab_size, 256)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    def layer_types(self) -> list[str]:
        """Per-layer block type list."""
        if self.arch_type == "ssm":
            return ["ssm"] * self.n_layers
        if self.arch_type == "hybrid":
            pat = self.pattern or ("rglru", "rglru", "attn")
            return [pat[i % len(pat)] for i in range(self.n_layers)]
        if self.arch_type == "moe":
            return ["moe"] * self.n_layers
        return ["attn_mlp"] * self.n_layers

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included)."""
        d, v = self.d_model, self.padded_vocab
        n = 2 * v * d  # embed + lm head
        for t in self.layer_types():
            if t == "ssm":
                di, ds, hh = self.ssm_d_inner, self.ssm_d_state, self.ssm_n_heads
                n += d * (2 * di + 2 * ds + hh) + di * d + di  # in/out proj etc
            elif t == "rglru":
                w = self.lru_width or d
                n += 2 * d * w + w * d + 2 * w * w // 1  # gates approx
            else:
                hq, hk, dh = self.n_heads, self.n_kv_heads, self.head_dim
                n += d * dh * (hq + 2 * hk) + hq * dh * d
                if t == "moe":
                    f = self.moe_d_ff
                    n += self.n_experts * 3 * d * f
                    n += self.n_shared_experts * 3 * d * f
                    n += d * self.n_experts
                    if self.moe_dense_residual:
                        n += 3 * d * self.d_ff
                else:
                    mult = 3 if self.activation == "swiglu" else 2
                    n += mult * d * self.d_ff
            n += 2 * d  # norms
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed-active experts)."""
        if self.arch_type != "moe":
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        f = self.moe_d_ff
        all_expert = self.n_layers * self.n_experts * 3 * d * f
        active_expert = self.n_layers * self.top_k * 3 * d * f
        return total - all_expert + active_expert
