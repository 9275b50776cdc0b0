"""The Model: config -> init / forward / prefill / decode.

PyTorch counterpart of the JAX package's ``models/model.py`` for the dense
decoders, the MoE decoders (deepseek-moe, arctic), the SSM (mamba2) and the
hybrid (recurrentgemma).  The JAX ``Model`` is pure: parameters are a
pytree passed to every method.  Here the parameters live in the
``nn.Module`` and the methods take token tensors:

  * ``forward(tokens)``: (B, S) -> logits (B, S, padded_vocab);
  * ``prefill(tokens, cache)``: logits of the last position only;
  * ``decode_step(cache, tokens)``: tokens (B, 1) -> logits (B, 1, V).

``cache["len"]`` is one Python int shared by the whole batch, so the decode
loop never waits on the device to find its ring slot.  The per-layer
caches (KV tensors, recurrent states) are updated in place.  Training (``loss_fn``) comes with the
training slice of the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Embed, make_norm

SERVED = ("dense", "moe", "ssm", "hybrid")  # arch types the port serves


def resolve_device(device) -> torch.device:
    """The device to build on; a CUDA device must be present, never
    silently replaced by the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        if cfg.arch_type not in SERVED:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.arch_type}) is not yet ported; the port "
                f"serves {SERVED}")
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.embed = Embed(cfg.padded_vocab, cfg.d_model, device=self.device,
                           dtype=dtype)
        self.layers = nn.ModuleList(
            tfm.init_layer(kind, cfg, device=self.device, dtype=dtype)
            for kind in cfg.layer_types())
        self.final_norm = make_norm(cfg.norm)(cfg.d_model, device=self.device)

    # ------------------------------------------------------------- init ----

    def init(self, generator: torch.Generator) -> "Model":
        """Fill every parameter in place from ``generator`` (on the model's
        device), with the JAX init's distributions."""
        self.embed.reset_parameters(generator)
        for block in self.layers:
            block.reset_parameters(generator)
        self.final_norm.reset_parameters(generator)
        return self

    # ---------------------------------------------------------- forward ----

    def _head(self, x):
        return x @ self.embed.head

    def _embed(self, tokens):
        return F.embedding(tokens.long(), self.embed.tok)

    def forward(self, tokens, *, window_override=None):
        """Full-sequence forward.  tokens: (B, S) -> logits (B, S, V)."""
        x = self._embed(tokens)
        b, s = tokens.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        x, _ = tfm.stack_apply_seq(self.layers, x, self.cfg, positions,
                                   window_override=window_override)
        return self._head(self.final_norm(x))

    # ------------------------------------------------------------ cache ----

    def init_cache(self, batch: int, max_len: int, *,
                   window: int | None = None) -> dict:
        """Decode cache: per layer a KV ring (``window`` caps its size; a
        hybrid's attention layers cap it at ``local_window``) or the SSM /
        RG-LRU state, all zero."""
        size = min(max_len, window) if window else max_len
        return {"layers": [
            tfm.init_layer_cache(kind, self.cfg, batch, size,
                                 device=self.device, dtype=self.dtype)
            for kind in self.cfg.layer_types()], "len": 0}

    # ---------------------------------------------------------- serving ----

    def prefill(self, tokens, cache):
        """Process a prompt into an empty ``cache``.  Returns
        (last_logits (B, 1, V), cache)."""
        if cache["len"] != 0:
            raise ValueError("prefill needs an empty cache; continue a "
                             "sequence with decode_step")
        x = self._embed(tokens)
        b, s = tokens.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        x, layers = tfm.stack_apply_seq(self.layers, x, self.cfg, positions,
                                        caches=cache["layers"])
        logits = self._head(self.final_norm(x[:, -1:]))
        return logits, {"layers": layers, "len": s}

    def decode_step(self, cache, tokens):
        """One decode step.  tokens: (B, 1) -> (logits (B, 1, V), cache)."""
        x = self._embed(tokens)
        x, layers = tfm.stack_apply_step(self.layers, x, self.cfg,
                                         cache["layers"], cache["len"])
        logits = self._head(self.final_norm(x))
        return logits, {"layers": layers, "len": cache["len"] + 1}
