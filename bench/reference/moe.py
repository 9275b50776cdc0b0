"""The reference of the MoE decoder's block (the port's ``moe`` layer kind,
deepseek-moe-16b's block): attention, then routed and shared experts.

Each layer is ``model.py``'s attention half, then, on h = ln2(x),
x + sum_j w_j E_{e_j}(h) + S(h): the router's softmax over ``n_experts``
(float32, its product in float64 so that TF32 flips none of the program's
float32 choices), the ``top_k`` largest, their weights renormalised to sum
to 1; each expert E_e and the shared experts S (one MLP of width
``moe_d_ff * n_shared_experts``) a SwiGLU MLP.  Every choice is computed:
dropless, so a configuration whose ``capacity_factor`` lets the program
drop one is refused (``layer_leaves``).  The float8 control rounds the
experts' products; the router stays as the configuration states it.

Leaves are named as the port's ``MoE`` names them: the float32 ``router``
(d, E), drawn N(0, 1/d) by a stated float32 draw, the experts' ``w_gate``
and ``w_up`` (E, d, f) and ``w_down`` (E, f, d), and the shared MLP's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench import flops
from bench.reference import model
from bench.reference.model import fp8_mm, plain_mm, top_leaves  # noqa: F401


def moe_leaves(c: dict) -> list:
    f = c["fields"]
    d, e, ff = f["d_model"], f["n_experts"], f["moe_d_ff"]
    s_in = f"normal:{d ** -0.5}"
    out = [("moe.router", (d, e), f"f32:normal:0:{d ** -0.5}"),
           ("moe.w_gate", (e, d, ff), s_in), ("moe.w_up", (e, d, ff), s_in),
           ("moe.w_down", (e, ff, d), f"normal:{ff ** -0.5}")]
    if f.get("n_shared_experts", 0):
        out += model.mlp_leaves("moe.shared", d,
                                ff * f["n_shared_experts"], True)
    return out


def layer_leaves(c: dict, i: int) -> list:
    f = c["fields"]
    if f.get("capacity_factor", 1.25) * f["top_k"] < f["n_experts"]:
        raise ValueError(
            f"capacity_factor {f.get('capacity_factor', 1.25)} under "
            f"n_experts / top_k = {f['n_experts'] / f['top_k']:.3f}: the "
            "program may drop choices this reference computes")
    return (model.attention_leaves(c) + model.norm_leaves(c, "ln2")
            + moe_leaves(c))


def experts(h, w: dict, c: dict, mm):
    """The routed and shared experts' sum of h (B, S, d)."""
    f = c["fields"]
    t = h.reshape(-1, h.shape[-1])
    probs = torch.softmax((t.double() @ w["moe.router"].double()).float(),
                          dim=-1)
    top_w, top_i = probs.topk(f["top_k"], dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    y = torch.zeros_like(t)
    for e in range(f["n_experts"]):
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        if len(rows) == 0:
            continue
        x = t[rows]
        o = mm(F.silu(mm(x, w["moe.w_gate"][e])) * mm(x, w["moe.w_up"][e]),
               w["moe.w_down"][e])
        y.index_add_(0, rows, o * top_w[rows, slot, None])
    if f.get("n_shared_experts", 0):
        y = y + model.mlp(t, w, "moe.shared", "swiglu", mm)
    return y.view_as(h)


def apply(x, w: dict, c: dict, mm):
    x = model.attention(x, w, c, mm)
    return x + experts(model.norm(x, w, "ln2", c), w, c, mm)


def run(c: dict, layer_weights, top: dict, groups: list, mms=(plain_mm,)):
    return model.run(c, layer_weights, top, groups, mms,
                     apply_layer=lambda i: apply)


def step_flops(c: dict, b: int, s: int, *, causal=None) -> int:
    """Matmul operations of a batch as the model needs them: attention's
    projections and core, the router, ``top_k`` routed and the shared
    experts' SwiGLU products a token, the head (``flops.step_flops``'s
    conventions)."""
    f = c["fields"]
    d, h, hkv, dh = (f["d_model"], f["n_heads"], f["n_kv_heads"],
                     model.head_dim(c))
    tokens = b * s
    experts_per_token = f["top_k"] + f.get("n_shared_experts", 0)
    layer = (2 * tokens * d * dh * (2 * h + 2 * hkv)
             + flops.attention_flops(c, b, s, causal=causal)
             + 2 * tokens * d * f["n_experts"]
             + 2 * tokens * d * f["moe_d_ff"] * 3 * experts_per_token)
    head_rows = b if f.get("has_decoder", True) else tokens
    return f["n_layers"] * layer + 2 * head_rows * d * model.padded_vocab(c)


def smoke(fields: dict):
    """The CPU tests' size: 8 experts, 2 a token, the shared ones kept."""
    group = fields["n_heads"] // fields["n_kv_heads"]
    fields.update(d_model=128, d_ff=64, moe_d_ff=64, n_heads=4,
                  n_kv_heads=4 // min(group, 2), n_experts=8, top_k=2,
                  vocab_size=min(fields["vocab_size"], 500))
