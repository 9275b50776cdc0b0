"""The reference of granite-4.0-h-small: the port's ``mamba2`` and ``moe``
layer kinds, in the order of the entry's ``layer_kinds``.

Every layer is two pre-norm halves, each added to the residual stream
times ``residual_multiplier`` (0.22), as upstream's GraniteMoeHybrid
decoder layer adds them:

  * the mixer: upstream Mamba-2 (``mamba2``) or attention (``moe``);
  * the MoE: ``moe.py``'s ``experts`` (a softmax over all 72 router logits,
    the top 10, their weights renormalised: equal to granite's softmax over
    its top-10 logits) plus the shared SwiGLU MLP of ``shared_d_ff``.

Mamba-2, on h = ln1(x): ``in_proj`` to z (Di), xBC (Di + 2N) and dt (H); a
causal depthwise conv of width 4 over xBC with its bias, then SiLU; x, B,
C; dt = softplus(dt + dt_bias), A = -exp(A_log); the scan in the minimal
chunked SSD form of arXiv:2405.21060 (its ``ssd_minimal_discrete``
listing), at the published chunk, B and C one group shared by the heads;
y + D x; the gated norm rmsnorm(y * silu(z)) * w over the whole Di;
``out_proj``.  Attention: GQA with no position embedding, causal, at the
softmax scale ``attn_scale`` (1/128, not 1/sqrt(128)), in blocks of
queries.  RMSNorm at ``rms_eps`` (1e-5).  The token embedding times
``embedding_multiplier`` (12) enters the stream; the head is the embedding
transposed (tied), and the logits are divided by ``logits_scaling`` (16).

Plain torch in float32 with TF32 off (``run`` turns it off and restores
it), nothing of the port or of JAX.  ``run`` cuts each group into blocks
of at most ``BLOCK_TOKENS`` tokens, the scan takes ``SSD_TOKENS`` and
attention ``QUERY_BLOCK`` queries at a time, so that it fits on the card
once the program is freed.  The float8
control (``fp8_mm``) rounds every linear layer's operands, the router's
excepted, as ``moe.py`` states.

The draws (``weights.make``), each stated here:

  * projections N(0, 1/fan_in) in bf16 (``in_proj``, ``out_proj``, v, o,
    the experts and the shared MLP);
  * q and k N(0, sqrt(Dh) / d) in bf16: at granite's scale 1/Dh the
    scores then spread as N(0, 1/d) draws spread them at 1/sqrt(Dh) (a
    standard deviation of 1).  At N(0, 1/d) and 1/Dh they would spread by
    Dh^-1/2, 0.09: every query would average its keys nearly evenly, and
    the check could not tell RoPE applied, or the scale taken as
    1/sqrt(Dh), from the model;
  * the conv and its bias N(0, 0.29^2) in bf16: the standard deviation of
    upstream's uniform(-1/2, 1/2) init at fan-in 4;
  * ``a_log`` uniform(0, 2.77) in float32: A in -[1, 16], upstream's range;
  * ``dt_bias`` uniform(-6.91, -2.25) in float32: softplus^-1 of upstream's
    dt range, 0.001 to 0.1;
  * D (``d_skip``) N(1, 0.1^2) in float32, upstream's 1 with a jitter that
    the check sees;
  * the norms' scales, the gated norm's included, 1 + 0.1 N(0, 1) in
    float32;
  * the router N(0, ``ROUTER_R``^2 / d) in float32, its logits spread by
    ``ROUTER_R`` = 3: the 10th of 72 choices then carries about 1.4% of the
    routed weight.  At N(0, 1/d) it carries about 6%, and a bf16 near-tie
    that swaps it (the program routes from a bf16 stream that drifts from
    the reference's float32 one with depth) moved the served tokens' gap
    as far as float8 did: over 20 seeds on the card the program's widest
    gap came within 1.6x of the float8 control's narrowest;
  * the tied embedding N(0, sigma^2) in bf16, sigma = ``EMBED_R`` /
    sqrt(d).  At sigma = 0.02, the draw of the untied models, the prompt's
    own last token scores 12 sigma sqrt(d) / rms(x_L) standard deviations
    above the rest of the vocabulary at the last position (its 12 e_t
    stays in the residual stream, and the head is e_t itself): about 11 at
    rms(x_L) 1.4, so the program, the reference and the control all serve
    that token, every gap reads 0 and the check sees no layer.  With
    sigma sqrt(d) = ``EMBED_R`` that ratio is 12 ``EMBED_R`` / rms(x_L),
    at most 1 at the final residual norm the program shows on the card
    (the configuration file's ``assumed`` gives the numbers), and the
    logits' spread, ``EMBED_R`` / 16, is the same at every width, the CPU
    tests' included.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench import flops
from bench.reference import model, moe
from bench.reference.model import fp8_mm, plain_mm  # noqa: F401

CONV_K = 4
CONV_STD = 0.29
EMBED_R = 0.1         # the tied embedding's sigma times sqrt(d)
ROUTER_R = 3.0        # the router's sigma times sqrt(d): its logits' spread
BLOCK_TOKENS = 16384   # tokens of a group the reference takes at a time
QUERY_BLOCK = 2048     # queries of one attention score block
SSD_TOKENS = 8192      # tokens of one scan of the reference


def dims(c: dict):
    """(d, Di, N, H, P) of the Mamba-2 mixer."""
    f = c["fields"]
    d = f["d_model"]
    di = f.get("ssm_expand", 2) * d
    p = f.get("ssm_headdim", 64)
    return d, di, f["ssm_d_state"], di // p, p


def kinds(c: dict) -> list:
    """Each layer's kind: ``layer_kinds`` repeated to ``n_layers``, as the
    port reads it."""
    ks = c["fields"]["layer_kinds"]
    return [ks[i % len(ks)] for i in range(c["fields"]["n_layers"])]


def mamba_leaves(c: dict) -> list:
    d, di, n, h, _ = dims(c)
    conv = di + 2 * n
    return [("ssm.in_proj", (d, di + conv + h), f"normal:{d ** -0.5}"),
            ("ssm.conv", (CONV_K, conv), f"normal:{CONV_STD}"),
            ("ssm.conv_bias", (conv,), f"normal:{CONV_STD}"),
            ("ssm.a_log", (h,), "f32:uniform:0:2.77"),
            ("ssm.dt_bias", (h,), "f32:uniform:-6.91:-2.25"),
            ("ssm.d_skip", (h,), "f32:normal:1:0.1"),
            ("ssm.norm", (di,), "scale"),
            ("ssm.w_out", (di, d), f"normal:{di ** -0.5}")]


def moe_leaves(c: dict) -> list:
    f = c["fields"]
    d, e, ff = f["d_model"], f["n_experts"], f["moe_d_ff"]
    s_in = f"normal:{d ** -0.5}"
    return ([("moe.router", (d, e), f"f32:normal:0:{ROUTER_R / math.sqrt(d)}"),
             ("moe.w_gate", (e, d, ff), s_in), ("moe.w_up", (e, d, ff), s_in),
             ("moe.w_down", (e, ff, d), f"normal:{ff ** -0.5}")]
            + model.mlp_leaves("moe.shared", d, f["shared_d_ff"], True))


def layer_leaves(c: dict, i: int) -> list:
    """Layer ``i``'s leaves, named as the port's block of its kind."""
    kind = kinds(c)[i]
    d = c["fields"]["d_model"]
    if kind == "mamba2":
        mixer = model.norm_leaves(c, "ln1") + mamba_leaves(c)
    elif kind == "moe":
        qk = f"normal:{model.head_dim(c) ** 0.25 / math.sqrt(d)}"
        mixer = [(n, shape, qk if n in ("attn.wq", "attn.wk") else init)
                 for n, shape, init in model.attention_leaves(c)]
    else:
        raise ValueError(f"layer {i}: kind {kind!r} is not granite's")
    return mixer + model.norm_leaves(c, "ln2") + moe_leaves(c)


def top_leaves(c: dict) -> list:
    """The tied embedding (no head of its own) and the final norm."""
    d = c["fields"]["d_model"]
    return ([("embed.tok", (model.padded_vocab(c), d),
              f"normal:{EMBED_R / math.sqrt(d)}")]
            + model.norm_leaves(c, "final_norm"))


def norm(x, w: dict, prefix: str, c: dict):
    eps = c["fields"]["rms_eps"]
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        w[f"{prefix}.scale"]


# ---------------------------------------------------------------- mamba ----


def segsum(x):
    """exp of it is the decay between positions: (..., T) -> (..., T, T),
    sum of x over (j, i] at [i, j], -inf above the diagonal."""
    t = x.size(-1)
    cum = torch.cumsum(x, dim=-1)
    seg = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, -math.inf)


def ssd_minimal(x, a, b, cm, chunk: int):
    """arXiv:2405.21060's ``ssd_minimal_discrete`` from the zero state, B
    and C one group: x (R, S, H, P) already times dt, a (R, S, H) = A dt,
    b / cm (R, S, N).  Returns y (R, S, H, P).  S is padded to whole chunks
    with a = 0 and x = 0, which change nothing before them."""
    r, s = x.shape[:2]
    pad = -s % chunk
    if pad:
        x, a = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(a, (0, 0, 0, pad))
        b, cm = F.pad(b, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    x = x.view(r, nc, chunk, *x.shape[2:])                 # r c l h p
    a = a.view(r, nc, chunk, -1).permute(0, 3, 1, 2)       # r h c l
    b, cm = b.view(r, nc, chunk, -1), cm.view(r, nc, chunk, -1)  # r c l n
    a_cum = torch.cumsum(a, dim=-1)
    # 1. inside each chunk (diagonal blocks)
    decay = torch.exp(segsum(a))                           # r h c l s
    gram = torch.einsum("rcln,rcsn->rcls", cm, b)
    y_diag = torch.einsum("rcls,rhcls,rcshp->rclhp", gram, decay, x)
    # 2. each chunk's state
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)      # r h c l
    states = torch.einsum("rcln,rhcl,rclhp->rchpn", b, decay_states, x)
    # 3. the recurrence between chunks, from the zero state
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))  # r h z c
    states = torch.einsum("rhzc,rchpn->rzhpn", decay_chunk, states)[:, :-1]
    # 4. states to outputs
    y_off = torch.einsum("rcln,rchpn,rhcl->rclhp", cm, states,
                         torch.exp(a_cum))
    return (y_diag + y_off).reshape(r, nc * chunk, *x.shape[3:])[:, :s]


def mamba(h, w: dict, c: dict, mm):
    """The upstream Mamba-2 mixer of h = ln1(x) (B, S, d)."""
    bsz, s, _ = h.shape
    d, di, n, nh, p = dims(c)
    chunk = c["fields"].get("ssm_chunk", 256)
    z, xbc, dt = mm(h, w["ssm.in_proj"]).split([di, di + 2 * n, nh], -1)
    xpad = F.pad(xbc, (0, 0, CONV_K - 1, 0))
    conv = sum(xpad[:, k:k + s] * w["ssm.conv"][k] for k in range(CONV_K))
    xbc = F.silu(conv + w["ssm.conv_bias"])
    xs, b, cm = xbc.split([di, n, n], -1)
    dt = F.softplus(dt + w["ssm.dt_bias"])
    a = -torch.exp(w["ssm.a_log"])
    xs = xs.reshape(bsz, s, nh, p)
    rows = max(1, SSD_TOKENS // s)
    y = torch.cat([ssd_minimal(xs[r:r + rows] * dt[r:r + rows, ..., None],
                               a * dt[r:r + rows], b[r:r + rows],
                               cm[r:r + rows], chunk)
                   for r in range(0, bsz, rows)])
    y = (y + xs * w["ssm.d_skip"][:, None]).reshape(bsz, s, di)
    g = y * F.silu(z)
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True)
                        + c["fields"]["rms_eps"]) * w["ssm.norm"]
    return mm(g, w["ssm.w_out"])


# ------------------------------------------------------------ attention ----


def attend(q, k, v, scale: float):
    """Causal GQA at ``scale``, in blocks of queries.  q: (B, S, H, Dh); k,
    v: (B, S, Hkv, Dh)."""
    bsz, s, h, dh = q.shape
    hkv = k.shape[2]
    out = torch.empty_like(q)
    pos = torch.arange(s, device=q.device)
    for r in range(bsz):
        kr, vr = k[r].permute(1, 0, 2), v[r].permute(1, 0, 2)
        for q0 in range(0, s, QUERY_BLOCK):
            q1 = min(q0 + QUERY_BLOCK, s)
            qr = q[r, q0:q1].permute(1, 0, 2).reshape(hkv, h // hkv,
                                                      q1 - q0, dh)
            scores = torch.einsum("hgqd,hkd->hgqk", qr, kr[:, :q1]) * scale
            mask = pos[None, :q1] <= pos[q0:q1, None]
            p = torch.softmax(scores.masked_fill(~mask, -math.inf), dim=-1)
            o = torch.einsum("hgqk,hkd->hgqd", p, vr[:, :q1])
            out[r, q0:q1] = o.reshape(h, q1 - q0, dh).permute(1, 0, 2)
    return out


def attention(h, w: dict, c: dict, mm):
    """Attention of h = ln1(x) with no position embedding."""
    bsz, s, _ = h.shape
    q, k, v = (mm(h, w[f"attn.{n}"].flatten(1)).view(
        bsz, s, *w[f"attn.{n}"].shape[1:]) for n in ("wq", "wk", "wv"))
    o = attend(q, k, v, c["fields"]["attn_scale"])
    return mm(o.flatten(2), w["attn.wo"].flatten(0, 1))


def apply(x, w: dict, c: dict, mm, kind: str):
    m = c["fields"]["residual_multiplier"]
    mixer = mamba if kind == "mamba2" else attention
    x = x + m * mixer(norm(x, w, "ln1", c), w, c, mm)
    return x + m * moe.experts(norm(x, w, "ln2", c), w, c, mm)


@torch.inference_mode()
def run(c: dict, layer_weights, top: dict, groups: list, mms=(plain_mm,)):
    """Logits (float32, ``vocab_size`` columns) at the last position of each
    group of token ids (B, S), for each rule of ``mms``: ``out[j][g]``."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(c, layer_weights, top, groups, mms)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _run(c, layer_weights, top, groups, mms):
    f = c["fields"]
    emb = top["embed.tok"].float()
    # each group cut into blocks of whole requests, at most BLOCK_TOKENS
    blocks = [g[r:r + max(1, BLOCK_TOKENS // g.shape[1])]
              for g in groups
              for r in range(0, g.shape[0],
                             max(1, BLOCK_TOKENS // g.shape[1]))]
    hs = [[F.embedding(g, emb) * f["embedding_multiplier"] for g in blocks]
          for _ in mms]
    for i, kind in enumerate(kinds(c)):
        w = {k: v.float() for k, v in layer_weights(i).items()}
        for j, mm in enumerate(mms):
            hs[j] = [apply(h, w, c, mm, kind) for h in hs[j]]
        del w
    final = {"final_norm.scale": top["final_norm.scale"].float()}
    out = []
    for j, mm in enumerate(mms):
        logits = [mm(norm(h[:, -1:], final, "final_norm", c), emb.t())
                  [..., :f["vocab_size"]] / f["logits_scaling"]
                  for h in hs[j]]
        per_group, k = [], 0
        for g in groups:
            n = -(-g.shape[0] // max(1, BLOCK_TOKENS // g.shape[1]))
            per_group.append(torch.cat(logits[k:k + n]))
            k += n
        out.append(per_group)
    return out


# ---------------------------------------------------------------- costs ----


def step_flops(c: dict, b: int, s: int, *, causal=None) -> int:
    """Matmul operations of a batch as the model needs them
    (``flops.step_flops``'s conventions): each Mamba-2 mixer's ``in_proj``
    and ``out_proj``, each attention layer's projections and core, each
    layer's router, ``top_k`` routed experts and the shared MLP's SwiGLU
    products a token, and the head at the last position.  The scan's own
    products are left out: the kernel's roofline reads them."""
    f = c["fields"]
    d, di, n, nh, _ = dims(c)
    t = b * s
    h, hkv, dh = f["n_heads"], f["n_kv_heads"], model.head_dim(c)
    ks = kinds(c)
    n_mamba = ks.count("mamba2")
    n_attn = len(ks) - n_mamba
    mamba = 2 * t * d * (di + di + 2 * n + nh) + 2 * t * di * d
    attn = (2 * t * d * dh * (2 * h + 2 * hkv)
            + flops.attention_flops(c, b, s, causal=causal))
    ffn = (2 * t * d * f["n_experts"]
           + 2 * t * d * f["moe_d_ff"] * 3 * f["top_k"]
           + 2 * t * d * f["shared_d_ff"] * 3)
    return (n_mamba * mamba + n_attn * attn + len(ks) * ffn
            + 2 * b * d * model.padded_vocab(c))


def flash_cost(c: dict, b: int, s: int) -> tuple[int, int]:
    """(operations, bytes) of one attention call: causal, Dh 128, no RoPE
    (4 Dh a live pair and query head; q, k, v read once, o written once,
    bf16)."""
    f = c["fields"]
    h, hkv, dh = f["n_heads"], f["n_kv_heads"], model.head_dim(c)
    return (flops.attention_flops(c, b, s),
            2 * (2 * b * h * s * dh + 2 * b * hkv * s * dh))


SSD_CHUNK = 64  # the scan kernel's chunk: the smaller count of operations


def ssd_cost(c: dict, b: int, s: int) -> tuple[int, int]:
    """(operations, bytes) of one SSD scan call of a prefill from the zero
    state: the chunked form's products at chunks of ``SSD_CHUNK`` (the gram
    C B^T, 2 L N a position, shared by the heads; per head the masked
    product with x, 2 L P, C H and the state update, 2 N P each); x, B and
    C read once in bf16, dt in float32, y written in float32, the final
    state written in float32."""
    _, _, n, h, p = dims(c)
    ell = SSD_CHUNK
    ops = 2 * b * s * (ell * n + h * (ell * p + 2 * n * p))
    nbytes = (2 * (b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h)
              + 4 * (b * s * h * p + b * h * n * p))
    return ops, nbytes


def expert_cost(c: dict, tokens: int) -> tuple[int, int]:
    """(operations, bytes) of one layer's three grouped expert products over
    ``tokens`` tokens: 2 d f each for every one of the ``top_k`` choices a
    token; the weights of the experts that can be chosen (at most
    tokens x top_k of them) read once, the sorted rows read by the gate and
    up products, their two outputs written, the gated rows read and the
    down product's output written, bf16."""
    f = c["fields"]
    d, ff, e, k = f["d_model"], f["moe_d_ff"], f["n_experts"], f["top_k"]
    rows = tokens * k
    ops = 3 * 2 * rows * d * ff
    nbytes = 2 * (3 * min(e, rows) * d * ff + 2 * rows * d + 3 * rows * ff
                  + rows * d)
    return ops, nbytes


def smoke(fields: dict):
    """The CPU tests' size: both kinds in the period's order (a Mamba-2
    layer, then attention), repeated to the tests' ``n_layers``; G = 1;
    every multiplier kept; 16 experts with 6 a token, so that the last
    choice's share of the routed weight stays near the published 10 of 72
    (at 2 of 8 a bf16 near-tie swaps an expert of 40% of the weight, and
    the program's gap at 8 layers exceeds the float8 control's)."""
    fields.update(d_model=128, d_ff=64, moe_d_ff=64, shared_d_ff=96,
                  n_heads=4, n_kv_heads=2, d_head=32, n_experts=16, top_k=6,
                  ssm_d_state=16, ssm_headdim=16, ssm_chunk=16,
                  vocab_size=min(fields["vocab_size"], 500),
                  layer_kinds=["mamba2", "moe"])
