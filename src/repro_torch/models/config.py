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

Fields past the JAX config's are the port's own, for models the JAX package
does not have (granite-4.0-h-small): an explicit list of layer kinds, the
upstream Mamba-2 mixer (kind ``mamba2``), attention without a position
embedding at a stated softmax scale, the three multipliers of the residual
stream, a tied head, the shared MLP's own width, a dropless MoE and the
RMSNorm's epsilon.  Each default keeps every JAX configuration's
arithmetic as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

ArchType = Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
#: layer kinds (``ModelConfig.layer_types``) with attention and a KV cache
ATTN_KINDS = ("attn_mlp", "moe", "attn")
#: layer kinds whose second half is the MoE layer: attention (``moe``) or
#: the upstream Mamba-2 mixer (``mamba2``) before it
MOE_KINDS = ("moe", "mamba2")


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
    position_embedding: Literal["rope", "none"] = "rope"
    attn_scale: float = 0.0            # softmax scale; 0 = 1/sqrt(head_dim)

    # ffn
    d_ff: int = 0
    activation: Literal["swiglu", "gelu"] = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    rms_eps: float = 1e-6

    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel w/ MoE
    shared_d_ff: int = 0              # shared MLP width; 0: moe_d_ff x shared
    moe_dropless: bool = False        # every choice computed: grouped products

    # ssm (mamba2 / SSD)
    ssm_d_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # hybrid (recurrentgemma): block pattern unit, e.g. ("rglru","rglru","attn")
    pattern: tuple[str, ...] = ()
    lru_width: int = 0
    local_window: int = 2048

    # explicit layer kinds, in place of the arch type's (granite): layer i
    # is layer_kinds[i % len(layer_kinds)]
    layer_kinds: tuple[str, ...] = ()

    # residual stream: x0 = embedding x embedding_multiplier; each block
    # half adds its output x residual_multiplier; logits / logits_scaling
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    tie_embeddings: bool = False      # the head is the embedding, transposed

    # modality frontend (stubbed; see DESIGN.md carve-out)
    frontend: Literal["none", "audio", "vision"] = "none"
    n_frontend_tokens: int = 0        # patches / frames provided pre-embedded

    # serving
    has_decoder: bool = True          # False => encoder-only, no decode shapes
    decode_window: int = 4096         # sliding-window used for long_500k decode

    # sharding hints
    fsdp_serving: bool = False        # shard weights over data axis in serving

    def __post_init__(self):
        # a list from a JSON file becomes the tuple the field holds
        object.__setattr__(self, "layer_kinds", tuple(self.layer_kinds))

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
    def softmax_scale(self) -> float:
        return self.attn_scale or self.head_dim ** -0.5

    @property
    def shared_width(self) -> int:
        return self.shared_d_ff or self.moe_d_ff * self.n_shared_experts

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    def layer_types(self) -> list[str]:
        """Per-layer block type list."""
        if self.layer_kinds:
            kinds = self.layer_kinds
            return [kinds[i % len(kinds)] for i in range(self.n_layers)]
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
        n = (1 if self.tie_embeddings else 2) * v * d  # embed + lm head
        for t in self.layer_types():
            if t == "mamba2":
                di, hh = self.ssm_d_inner, self.ssm_n_heads
                conv = di + 2 * self.ssm_d_state  # one B / C group
                n += d * (di + conv + hh) + 5 * conv + di * d + 3 * hh + di
                n += self._moe_params()
            elif t == "ssm":
                di, ds, hh = self.ssm_d_inner, self.ssm_d_state, self.ssm_n_heads
                n += d * (2 * di + 2 * ds + hh) + di * d + di  # in/out proj etc
            elif t == "rglru":
                w = self.lru_width or d
                n += 2 * d * w + w * d + 2 * w * w // 1  # gates approx
            else:
                hq, hk, dh = self.n_heads, self.n_kv_heads, self.head_dim
                n += d * dh * (hq + 2 * hk) + hq * dh * d
                if t == "moe":
                    n += self._moe_params()
                else:
                    mult = 3 if self.activation == "swiglu" else 2
                    n += mult * d * self.d_ff
            n += 2 * d  # norms
        return n

    def _moe_params(self) -> int:
        d, f = self.d_model, self.moe_d_ff
        n = self.n_experts * 3 * d * f + 3 * d * self.shared_width
        n += d * self.n_experts
        if self.moe_dense_residual:
            n += 3 * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed-active experts)."""
        moe_layers = sum(t in MOE_KINDS for t in self.layer_types())
        if not moe_layers:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        f = self.moe_d_ff
        all_expert = moe_layers * self.n_experts * 3 * d * f
        active_expert = moe_layers * self.top_k * 3 * d * f
        return total - all_expert + active_expert
