"""The Model: config -> init / forward / prefill / decode.

PyTorch counterpart of the JAX package's ``models/model.py`` for every
family: the dense decoders, the MoE decoders (deepseek-moe, arctic), the
SSM (mamba2), the hybrid (recurrentgemma), the VLM (internvl) and the
audio encoder (hubert).  The JAX ``Model`` is pure: parameters are a
pytree passed to every method, and a batch is a dict.  Here the
parameters live in the ``nn.Module`` and the methods take the batch's
tensors as keyword arguments named by the JAX batch keys:

  * ``forward(tokens, patch_embeds=, frame_embeds=)``: logits (B, S,
    padded_vocab) over the whole sequence;
  * ``prefill(tokens, cache, patch_embeds=)``: logits of the last position
    only;
  * ``decode_step(cache, tokens)``: tokens (B, 1) -> logits (B, 1, V).

The inputs follow the JAX ``_embed_inputs``: a decoder embeds ``tokens``
(B, S); a VLM puts its ``patch_embeds`` (B, N_patch, d_model) before them,
so RoPE positions and the cache run over patches and text together (after
a prefill the cache holds N_patch + S positions); the audio encoder has no
token embedding and takes ``frame_embeds`` (B, T, d_model), attends
without a causal mask (``cfg.causal``) and ends in its own classification
``head`` (d_model, padded_vocab).  It has no decode step.

granite-4.0-h-small (the port's own configuration) multiplies the
embedding by ``embedding_multiplier``, ties its head to the embedding
(``tie_embeddings``: the head is ``embed.tok`` transposed, a view, so the
411 M of its vocabulary are held once) and divides the logits by
``logits_scaling``; every multiplier 1 is no operation.

``cache["len"]`` is one Python int shared by the whole batch, so the decode
loop never waits on the device to find its ring slot.  The per-layer
caches (KV tensors, recurrent states) are updated in place.

Training: ``loss_fn(batch)`` is the JAX ``loss_fn``, the mean next-token
cross-entropy in fp32 (a VLM's patch prefix cut off first; the audio
encoder's against ``labels``, a label per frame) plus 0.01 times the MoE
aux loss, with each block recomputed in the backward (``remat``).
Parameters are created without gradients; ``training/train.py`` turns
them on (``requires_grad_(True)``), and serving runs under
``torch.inference_mode``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Embed, _param, make_norm
from repro_torch.obs import host

# arch types the port serves
SERVED = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


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
        if cfg.arch_type == "audio":
            # encoder-only: a classification head, no token embedding
            self.head = _param((cfg.d_model, cfg.padded_vocab), self.device,
                               dtype)
        else:
            self.embed = Embed(cfg.padded_vocab, cfg.d_model,
                               device=self.device, dtype=dtype,
                               tied=cfg.tie_embeddings)
        self.layers = nn.ModuleList(
            tfm.init_layer(kind, cfg, device=self.device, dtype=dtype,
                           index=i)
            for i, kind in enumerate(cfg.layer_types()))
        self.final_norm = make_norm(cfg.norm, cfg.rms_eps)(
            cfg.d_model, device=self.device)

    # ------------------------------------------------------------- init ----

    def init(self, generator: torch.Generator) -> "Model":
        """Fill every parameter in place from ``generator`` (on the model's
        device), with the JAX init's distributions."""
        if self.cfg.arch_type == "audio":
            with torch.no_grad():
                self.head.normal_(0.0, self.cfg.d_model ** -0.5,
                                  generator=generator)
        else:
            self.embed.reset_parameters(generator)
        for block in self.layers:
            block.reset_parameters(generator)
        self.final_norm.reset_parameters(generator)
        return self

    # ---------------------------------------------------------- forward ----

    def _head(self, x):
        if self.cfg.arch_type == "audio":
            return x @ self.head
        logits = x @ (self.embed.tok.t() if self.cfg.tie_embeddings
                      else self.embed.head)
        s = self.cfg.logits_scaling
        return logits if s == 1.0 else logits / s

    def _logits(self, x):
        """The final norm and the head."""
        rec = host.on and host.open("head")
        logits = self._head(self.final_norm(x))
        if rec:
            host.close()
        return logits

    def _embed(self, tokens):
        x = F.embedding(tokens.long(), self.embed.tok)
        m = self.cfg.embedding_multiplier
        return x if m == 1.0 else x * m

    def _embed_inputs(self, tokens, patch_embeds, frame_embeds):
        """The residual stream's input (B, S, D) and its positions (B, S)."""
        rec = host.on and host.open("embed")
        if self.cfg.arch_type == "audio":
            if frame_embeds is None:
                raise ValueError(f"{self.cfg.name} takes frame_embeds")
            x = frame_embeds.to(self.dtype)
        else:
            x = self._embed(tokens)
            if self.cfg.arch_type == "vlm" and patch_embeds is not None:
                x = torch.cat([patch_embeds.to(self.dtype), x], dim=1)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        if rec:
            host.close()
        return x, positions

    def _rows(self, tokens, patch_embeds, frame_embeds) -> tuple[int, int]:
        """(batch, positions) of a step's inputs, a VLM's patches
        counted."""
        x = frame_embeds if self.cfg.arch_type == "audio" else tokens
        if x is None:  # refused by _embed_inputs
            return 0, 0
        n = (patch_embeds.shape[1] if self.cfg.arch_type == "vlm"
             and patch_embeds is not None else 0)
        return x.shape[0], x.shape[1] + n

    def forward(self, tokens=None, *, patch_embeds=None, frame_embeds=None,
                window_override=None, remat: bool = False,
                with_aux: bool = False):
        """Full-sequence forward.  Returns logits (B, S, V), S counting a
        VLM's patches; with ``with_aux``, (logits, the summed MoE aux loss,
        an fp32 scalar).  ``remat`` recomputes each block in the
        backward."""
        with host.step("forward", *self._rows(tokens, patch_embeds,
                                              frame_embeds)):
            x, positions = self._embed_inputs(tokens, patch_embeds,
                                              frame_embeds)
            x, _, aux = tfm.stack_apply_seq(
                self.layers, x, self.cfg, positions,
                window_override=window_override, remat=remat,
                with_aux=with_aux)
            logits = self._logits(x)
        return (logits, aux) if with_aux else logits

    def loss_fn(self, batch: dict, *, remat: bool = True):
        """Mean next-token (audio: per-frame) cross-entropy + 0.01 MoE aux.

        ``batch``: the JAX batch keys as tensors on the model's device:
        ``tokens`` (B, S), and ``patch_embeds`` for a VLM; the audio
        encoder's ``frame_embeds`` (B, T, d_model) and ``labels`` (B, T).
        """
        logits, aux = self.forward(batch.get("tokens"),
                                   patch_embeds=batch.get("patch_embeds"),
                                   frame_embeds=batch.get("frame_embeds"),
                                   remat=remat, with_aux=True)
        if self.cfg.arch_type == "audio":
            labels, lg = batch["labels"], logits
        else:
            tokens = batch["tokens"]
            n_prefix = logits.shape[1] - tokens.shape[1]  # vlm patch prefix
            # next-token: text logits at position i predict token i+1
            lg = logits[:, n_prefix:-1] if tokens.shape[1] > 1 else logits
            labels = tokens[:, 1:] if tokens.shape[1] > 1 else tokens
        # the mean of logsumexp - gold over every position, in fp32
        ce = F.cross_entropy(lg.float().flatten(0, 1),
                             labels.long().flatten())
        return ce + 0.01 * aux

    # ------------------------------------------------------------ cache ----

    def init_cache(self, batch: int, max_len: int, *,
                   window: int | None = None) -> dict:
        """Decode cache: per layer a KV ring (``window`` caps its size; a
        hybrid's attention layers cap it at ``local_window``) or the SSM /
        RG-LRU state, all zero."""
        size = min(max_len, window) if window else max_len
        with host.init_cache():
            return {"layers": [
                tfm.init_layer_cache(kind, self.cfg, batch, size,
                                     device=self.device, dtype=self.dtype)
                for kind in self.cfg.layer_types()], "len": 0}

    # ---------------------------------------------------------- serving ----

    def prefill(self, tokens, cache, *, patch_embeds=None):
        """Process a prompt (a VLM's patches first) into an empty
        ``cache``.  Returns (last_logits (B, 1, V), cache)."""
        if cache["len"] != 0:
            raise ValueError("prefill needs an empty cache; continue a "
                             "sequence with decode_step")
        with host.step("prefill", *self._rows(tokens, patch_embeds, None)):
            x, positions = self._embed_inputs(tokens, patch_embeds, None)
            s = x.shape[1]
            x, layers, _ = tfm.stack_apply_seq(self.layers, x, self.cfg,
                                               positions,
                                               caches=cache["layers"])
            logits = self._logits(x[:, -1:])
        return logits, {"layers": layers, "len": s}

    def decode_step(self, cache, tokens):
        """One decode step.  tokens: (B, 1) -> (logits (B, 1, V), cache)."""
        if not self.cfg.has_decoder:
            raise ValueError(f"{self.cfg.name} is encoder-only: it has no "
                             "decode step")
        with host.step("decode", tokens.shape[0], cache["len"] + 1):
            rec = host.on and host.open("embed")
            x = self._embed(tokens)
            if rec:
                host.close()
            x, layers = tfm.stack_apply_step(self.layers, x, self.cfg,
                                             cache["layers"], cache["len"])
            logits = self._logits(x)
        return logits, {"layers": layers, "len": cache["len"] + 1}
