"""The reference forward of a model, layer by layer: the module an entry
that names no ``reference`` takes (the interface: ``__init__.py``).

``c`` is a configuration file's model entry: ``fields``, the port's
``ModelConfig`` fields, read here as plain numbers.  Every layer is one
pre-norm block (``layer_leaves(c, i)``, ``apply(x, w, c, mm)``):
attention (GQA, split-half RoPE, causal or not, optionally windowed) then
an MLP (SwiGLU, or GELU with the tanh approximation), each added to the
residual stream.
It is the block of the dense decoders (yi-9b) and of the audio encoder
(hubert-xlarge) as the serving system defines them: no biases on the
projections, RoPE in place of HuBERT's convolutional position embedding,
the norm before each half.  Attention is computed row by row of the batch
so that a (H, S, S) score tensor is the largest temporary.  Another
family's reference takes the halves it shares from here (``attention``,
``mlp``, ``norm``) and its own block to ``run(..., apply_layer=)``.

``run`` takes groups of equal-length requests and gives their logits over
the first ``vocab_size`` columns: a decoder's at the last position (what a
prefill answers), an encoder's at every frame.  Each layer's weights are
made once (``layer_weights(i)``), widened to float32 and used for every
group and every matmul rule in ``mms`` before the next layer's are made:
``plain_mm`` is the reference; ``fp8_mm`` rounds both operands of every
linear layer to float8 e4m3 (per-row and per-column scales, products in
float32), the precision below the served bf16, for the control.
Activations stay float32; the matmuls run in TF32 (float32 accumulation,
ten mantissa bits against the served bf16's seven), which lets one run
score hundreds of prompts in less time than the window.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest float8 e4m3fn


def field(c: dict, name: str, default=None):
    return c["fields"].get(name, default)


def head_dim(c: dict) -> int:
    return field(c, "d_head") or c["fields"]["d_model"] // c["fields"]["n_heads"]


def norm_leaves(c: dict, prefix: str) -> list:
    d = c["fields"]["d_model"]
    out = [(f"{prefix}.scale", (d,), "scale")]
    if field(c, "norm", "rmsnorm") == "layernorm":
        out.append((f"{prefix}.bias", (d,), "bias"))
    return out


def norm(x, w: dict, prefix: str, c: dict):
    if field(c, "norm", "rmsnorm") == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return ((x - mu) * torch.rsqrt(var + 1e-5) * w[f"{prefix}.scale"]
                + w[f"{prefix}.bias"])
    var = x.square().mean(-1, keepdim=True)
    return x * torch.rsqrt(var + 1e-6) * w[f"{prefix}.scale"]


def plain_mm(x, w):
    return x @ w


def _fp8(t, dim: int):
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_mm(x, w):
    return _fp8(x, -1) @ _fp8(w, 0)


def attention_leaves(c: dict) -> list:
    """The first norm's leaves and attention's projections."""
    f = c["fields"]
    d, h, hkv, dh = f["d_model"], f["n_heads"], f["n_kv_heads"], head_dim(c)
    s_in = f"normal:{d ** -0.5}"
    return norm_leaves(c, "ln1") + [
        ("attn.wq", (d, h, dh), s_in), ("attn.wk", (d, hkv, dh), s_in),
        ("attn.wv", (d, hkv, dh), s_in), ("attn.wo", (h, dh, d), s_in)]


def mlp_leaves(prefix: str, d: int, ff: int, swiglu: bool) -> list:
    """An MLP's leaves, the port's order: up, down, then gate."""
    out = [(f"{prefix}.w_up", (d, ff), f"normal:{d ** -0.5}"),
           (f"{prefix}.w_down", (ff, d), f"normal:{ff ** -0.5}")]
    if swiglu:
        out.append((f"{prefix}.w_gate", (d, ff), f"normal:{d ** -0.5}"))
    return out


def layer_leaves(c: dict, i: int) -> list:
    """Every layer is the same block."""
    f = c["fields"]
    return attention_leaves(c) + norm_leaves(c, "ln2") + mlp_leaves(
        "mlp", f["d_model"], f["d_ff"],
        field(c, "activation", "swiglu") == "swiglu")


def padded_vocab(c: dict) -> int:
    return -(-c["fields"]["vocab_size"] // 256) * 256


def top_leaves(c: dict) -> list:
    """(name, shape, init) of the leaves outside the layers: the token
    embedding and the head, or an encoder's head; the final norm."""
    f = c["fields"]
    d, vp = f["d_model"], padded_vocab(c)
    if f.get("has_decoder", True):
        out = [("embed.tok", (vp, d), "normal:0.02"),
               ("embed.head", (d, vp), f"normal:{d ** -0.5}")]
    else:
        out = [("head", (d, vp), f"normal:{d ** -0.5}")]
    return out + norm_leaves(c, "final_norm")


def rope(x, theta: float):
    """x: (B, S, H, Dh), positions 0..S-1."""
    dh = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=x.device) / dh)
    pos = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)
    ang = pos[:, None, None] * freqs
    cos, sin = ang.cos(), ang.sin()
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attend(q, k, v, causal: bool, window):
    """q: (B, S, H, Dh); k, v: (B, S, Hkv, Dh) -> (B, S, H, Dh)."""
    b, s, h, dh = q.shape
    hkv = k.shape[2]
    pos = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    out = torch.empty_like(q)
    for r in range(b):
        qr = q[r].permute(1, 0, 2).reshape(hkv, h // hkv, s, dh)
        kr, vr = k[r].permute(1, 0, 2), v[r].permute(1, 0, 2)
        scores = torch.einsum("hgqd,hkd->hgqk", qr, kr) / math.sqrt(dh)
        p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        o = torch.einsum("hgqk,hkd->hgqd", p, vr)
        out[r] = o.reshape(h, s, dh).permute(1, 0, 2)
    return out


def attention(x, w: dict, c: dict, mm):
    """``x`` plus the attention half of the block."""
    b, s, _ = x.shape
    f = c["fields"]
    hn = norm(x, w, "ln1", c)
    q, k, v = (mm(hn, w[f"attn.{n}"].flatten(1)).view(
        b, s, *w[f"attn.{n}"].shape[1:]) for n in ("wq", "wk", "wv"))
    theta = f.get("rope_theta", 10_000.0)
    o = attend(rope(q, theta), rope(k, theta), v, f.get("causal", True),
               f.get("sliding_window"))
    return x + mm(o.flatten(2), w["attn.wo"].flatten(0, 1))


def mlp(h, w: dict, prefix: str, activation: str, mm):
    if activation == "swiglu":
        y = F.silu(mm(h, w[f"{prefix}.w_gate"])) * mm(h, w[f"{prefix}.w_up"])
    else:
        y = F.gelu(mm(h, w[f"{prefix}.w_up"]), approximate="tanh")
    return mm(y, w[f"{prefix}.w_down"])


def apply(x, w: dict, c: dict, mm):
    x = attention(x, w, c, mm)
    return x + mlp(norm(x, w, "ln2", c), w, "mlp",
                   field(c, "activation", "swiglu"), mm)


@torch.inference_mode()
def run(c: dict, layer_weights, top: dict, groups: list, mms=(plain_mm,),
        *, apply_layer=None):
    """Logits (float32, ``vocab_size`` columns) of each group, for each
    rule of ``mms``: ``out[j][g]``.  A group is a decoder's token ids
    (B, S) or an encoder's frame embeddings (B, S, d_model).
    ``apply_layer(i)`` is layer ``i``'s ``apply`` (another family's block
    in this stack), this module's by default."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        return _run(c, layer_weights, top, groups, mms,
                    apply_layer or (lambda i: apply))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _run(c, layer_weights, top, groups, mms, apply_layer):
    decoder = field(c, "has_decoder", True)
    top = {k: v.float() for k, v in top.items()}
    if decoder:
        x0 = [F.embedding(g, top["embed.tok"]) for g in groups]
    else:
        x0 = [g.float() for g in groups]
    hs = [list(x0) for _ in mms]
    del x0
    for i in range(c["fields"]["n_layers"]):
        w = {k: v.float() for k, v in layer_weights(i).items()}
        block = apply_layer(i)
        for j, mm in enumerate(mms):
            hs[j] = [block(h, w, c, mm) for h in hs[j]]
        del w
    head = top["embed.head" if decoder else "head"]
    v = c["fields"]["vocab_size"]
    out = []
    for j, mm in enumerate(mms):
        out.append([mm(norm(h[:, -1:] if decoder else h, top, "final_norm",
                            c), head)[..., :v] for h in hs[j]])
    return out
