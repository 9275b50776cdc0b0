"""Frozen formulas: the operations and bytes of a batch, and the peaks.

``step_flops`` counts the matmul operations of one served batch of the
attention-and-MLP block models (2 m n k for every projection, MLP and head
product, 4 Dh a live query-key pair and query head for attention), as the
model needs them and whatever runs them: a decoder's prefill takes its
head at the last position only, an encoder's at every frame; the head is
counted at the padded width it is multiplied at.  Norms, RoPE and the
elementwise passes are not counted.  ``flash_cost`` is one attention
call's least work: its operations as above and its bytes, q, k and v read
once and the output written once, in bf16.  An entry whose reference
module (``spec.reference``) counts its own block (``step_flops``,
``flash_cost``) gets that module's counts instead.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from bench import spec

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str) -> dict | None:
    """The data sheet's peaks of the card named ``kind``, or None."""
    return json.loads(PEAKS.read_text()).get(kind)


def live_pairs(s: int, causal: bool, window=None) -> int:
    """Query-key pairs the mask lets through, for one (row, head)."""
    q = np.arange(s)
    hi = q + 1 if causal else np.full(s, s)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(s, int)
    return int((hi - lo).sum())


def _dims(c: dict):
    f = c["fields"]
    dh = f.get("d_head") or f["d_model"] // f["n_heads"]
    return f, f["d_model"], f["n_heads"], f["n_kv_heads"], dh


def attention_flops(c: dict, b: int, s: int, *, causal=None) -> int:
    """Operations of one layer's attention core for ``b`` rows of ``s``
    (``causal`` overrides the model's mask: False counts every pair)."""
    f, _, h, _, dh = _dims(c)
    causal = f.get("causal", True) if causal is None else causal
    return 4 * dh * h * b * live_pairs(s, causal, f.get("sliding_window"))


def step_flops(c: dict, b: int, s: int, *, causal=None) -> int:
    """Matmul operations of one batch of ``b`` requests of length ``s``."""
    own = getattr(spec.reference(c), "step_flops", None)
    if own is not None:
        return own(c, b, s, causal=causal)
    f, d, h, hkv, dh = _dims(c)
    tokens = b * s
    proj = 2 * tokens * d * dh * (2 * h + 2 * hkv)
    mult = 3 if f.get("activation", "swiglu") == "swiglu" else 2
    mlp = 2 * tokens * d * f["d_ff"] * mult
    layer = proj + mlp + attention_flops(c, b, s, causal=causal)
    vp = -(-f["vocab_size"] // 256) * 256
    head_rows = b if f.get("has_decoder", True) else tokens
    return f["n_layers"] * layer + 2 * head_rows * d * vp


def flash_cost(c: dict, b: int, s: int) -> tuple[int, int]:
    """(operations, bytes) of one layer's attention call."""
    own = getattr(spec.reference(c), "flash_cost", None)
    if own is not None:
        return own(c, b, s)
    _, _, h, hkv, dh = _dims(c)
    return (attention_flops(c, b, s),
            2 * (2 * b * h * s * dh + 2 * b * hkv * s * dh))


def flash_bound_s(c: dict, b: int, s: int, peak: dict) -> float:
    """The least time one attention call can take on the card."""
    ops, nbytes = flash_cost(c, b, s)
    return max(ops / peak["bf16_flops"], nbytes / peak["hbm_bytes_per_s"])
