"""Batch executor: the port's serving entry point.

    python -m repro_torch.serving.executor --arch yi-9b --requests 8 \\
        --batch 4 --prompt-lens 512,1000 --output-len 32
    python -m repro_torch.serving.executor --arch internvl2-76b \\
        --layers 24 --prompt-lens 512,1000 --output-len 32
    python -m repro_torch.serving.executor --arch hubert-xlarge \\
        --prompt-lens 512,1000

The PyTorch counterpart of the batch executor in the JAX package's
``examples/serve_multimodel.py``, on the streaming request model: a request
is a prompt of ``prompt_len`` tokens and ``output_len`` tokens to produce
(the first by prefill, the rest by decode steps).  Requests are grouped
into batches of equal prompt length, up to ``--batch``, because a cache's
length is one scalar per batch.  Each batch runs ``prefill`` then
``output_len - 1`` greedy ``decode_step``s; argmax is over the first
``vocab_size`` logits (the head is padded to ``padded_vocab``).

A VLM's request also carries ``cfg.n_frontend_tokens`` image patch
embeddings (1024 for internvl2-76b), which its prefill puts before the
prompt, so the time to first token includes the prefix.  An audio
encoder's request (hubert-xlarge) is a clip of ``prompt_len`` frame
embeddings; one ``forward`` of the batch answers it with a label per
frame, the argmax over the first ``vocab_size`` classes, and there are no
decode steps.  Patch and frame embeddings are the stand-ins of
``models/frontend.py``.

All requests arrive at time 0 and batches run one after another, so a
request's time to first token (a clip's: to its labels) includes the
batches served before its own.  Decode time per token is the batch's
decode wall time over its decode steps.  Prompts come from
``numpy.random.default_rng(seed)``, weights from a ``torch.Generator`` on
the device seeded with ``seed``, patches and frames from another one
seeded with ``seed``.  The executor runs on the card unless ``--device
cpu`` is given.

``--layers`` cuts the model's depth (width unchanged) for a model whose
weights do not fit the card (internvl2-76b: 141 GB in bf16): the summary
lists it under ``reduced``, and on the card it is refused for a model
that fits.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.h100intf import param_count
from repro_torch.models import frontend
from repro_torch.models.model import Model


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    prompt: np.ndarray          # (prompt_len,) int token ids; empty: a clip
    output_len: int             # tokens to produce; 0 for a clip
    n_patches: int = 0          # a VLM's image patches before the prompt
    n_frames: int = 0           # an audio clip's frames


@dataclasses.dataclass
class Result:
    rid: int
    tokens: list[int]           # output_len generated token ids (a clip:
    #                             one label per frame)
    ttft_ms: float              # from time 0 to the first token on the host
    decode_ms_per_token: float  # the batch's decode time per step


@dataclasses.dataclass
class ServeReport:
    results: list[Result]
    prefill_batches: int        # an encoder's: forward batches
    decode_steps: int
    wall_s: float               # serving time, model build excluded
    all_finite: bool            # every logit of every step was finite
    encoder: bool = False       # answered by forward alone (audio)
    batch_ms: list[float] = dataclasses.field(default_factory=list)
    reduced: list[str] = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        ttft = [r.ttft_ms for r in self.results]
        tokens = sum(len(r.tokens) for r in self.results)
        out = {"requests": len(self.results),
               "prefill_batches": self.prefill_batches,
               "decode_steps": self.decode_steps,
               "ttft_ms_p50": float(np.median(ttft)),
               "ttft_ms_max": float(max(ttft))}
        if self.encoder:
            out.update(ms_per_batch=float(np.mean(self.batch_ms)),
                       frames_per_s=tokens / self.wall_s)
        else:
            out.update(decode_ms_per_step=float(np.mean(
                [r.decode_ms_per_token for r in self.results])),
                tokens_per_s=tokens / self.wall_s)
        return {**out, "all_finite": self.all_finite,
                "reduced": self.reduced}


def weight_bytes(cfg) -> int:
    """Bytes of the model's weights in bf16 (norms and routers fp32)."""
    wide, fp32 = param_count(cfg)
    return 2 * wide + 4 * fp32


def build_model(arch: str, *, seed: int, device, smoke: bool,
                n_layers: int | None = None) -> Model:
    """``arch`` in bf16 (its smoke config if ``smoke``; ``n_layers`` of its
    layers if given), weights drawn on the device from ``seed``."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = Model(cfg, dtype=torch.bfloat16, device=device)
    return model.init(torch.Generator(device=model.device).manual_seed(seed))


def depth_reduction(arch: str, n_layers: int | None, device, *,
                    smoke: bool) -> list[str]:
    """The cuts of a run at ``n_layers`` (none without one).  On the card
    the cut is refused for a model whose full weights fit it."""
    if n_layers is None:
        return []
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if not 1 <= n_layers <= cfg.n_layers:
        raise ValueError(f"{arch}: --layers {n_layers} outside 1.."
                         f"{cfg.n_layers}")
    full = weight_bytes(cfg)
    device = torch.device(device)
    if device.type == "cuda":
        card = torch.cuda.get_device_properties(device).total_memory
        if full <= card:
            raise ValueError(f"{arch}: its {full / 1e9:.1f} GB of weights "
                             f"fit the card's {card / 1e9:.1f} GB; serve it "
                             "at full depth")
    cut = weight_bytes(dataclasses.replace(cfg, n_layers=n_layers))
    return [f"n_layers {cfg.n_layers} -> {n_layers} (bf16 weights "
            f"{full / 1e9:.1f} GB at full depth, {cut / 1e9:.1f} GB cut)"]


def make_requests(n: int, prompt_lens, output_len: int, vocab_size: int,
                  seed: int, cfg=None) -> list[Request]:
    """Request i gets prompt length ``prompt_lens[i % len(prompt_lens)]``;
    for an audio ``cfg`` that is the clip's frame count, and a VLM's
    request carries ``cfg.n_frontend_tokens`` patches."""
    rng = np.random.default_rng(seed)
    audio = cfg is not None and cfg.arch_type == "audio"
    patches = (cfg.n_frontend_tokens
               if cfg is not None and cfg.arch_type == "vlm" else 0)
    reqs = []
    for i in range(n):
        length = prompt_lens[i % len(prompt_lens)]
        if audio:
            reqs.append(Request(i, np.zeros(0, np.int64), 0, n_frames=length))
        else:
            reqs.append(Request(i, rng.integers(0, vocab_size, length),
                                output_len, n_patches=patches))
    return reqs


def make_batches(requests, max_batch: int) -> list[list[Request]]:
    """Batches of equal prompt length (and output length, patches and
    frames), at most ``max_batch`` each, in order of first arrival."""
    groups: dict[tuple, list[Request]] = {}
    for r in requests:
        key = (len(r.prompt), r.output_len, r.n_patches, r.n_frames)
        groups.setdefault(key, []).append(r)
    return [g[i:i + max_batch] for g in groups.values()
            for i in range(0, len(g), max_batch)]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def run_clips(model: Model, batch: list[Request], t0: float, gen):
    """One forward of a batch of audio clips: a label per frame.  Returns
    (results, finite)."""
    frames = frontend.audio_frame_embeddings(
        gen, len(batch), batch[0].n_frames, model.cfg, device=model.device,
        dtype=model.dtype)
    logits = model.forward(frame_embeds=frames)
    labels = logits[..., :model.cfg.vocab_size].argmax(-1).cpu()
    done = (time.perf_counter() - t0) * 1e3
    return ([Result(r.rid, labels[i].tolist(), done, 0.0)
             for i, r in enumerate(batch)],
            bool(torch.isfinite(logits).all()))


@torch.inference_mode()
def run_batch(model: Model, batch: list[Request], t0: float, gen=None):
    """Prefill (a VLM's patches first) + greedy decode of one batch.
    Returns (results, finite)."""
    dev = model.device
    vocab = model.cfg.vocab_size
    out_len = batch[0].output_len
    prompt = torch.from_numpy(np.stack([r.prompt for r in batch])).to(dev)
    b, s = prompt.shape
    n_patches = batch[0].n_patches
    patches = (frontend.vision_patch_embeddings(
        gen, b, n_patches, model.cfg, device=dev, dtype=model.dtype)
        if n_patches else None)
    cache = model.init_cache(b, n_patches + s + out_len)
    logits, cache = model.prefill(prompt, cache, patch_embeds=patches)
    tok = logits[:, -1, :vocab].argmax(-1, keepdim=True)
    finite = torch.isfinite(logits).all()
    tok.cpu()   # waits for the device: the first token is out
    t_first = time.perf_counter()
    steps = [tok]
    for _ in range(out_len - 1):
        logits, cache = model.decode_step(cache, tok)
        tok = logits[:, -1, :vocab].argmax(-1, keepdim=True)
        finite &= torch.isfinite(logits).all()
        steps.append(tok)
    tokens = torch.cat(steps, dim=1).cpu()
    t_end = time.perf_counter()
    per_tok = (t_end - t_first) * 1e3 / max(out_len - 1, 1)
    ttft = (t_first - t0) * 1e3
    return [Result(r.rid, tokens[i].tolist(), ttft, per_tok)
            for i, r in enumerate(batch)], bool(finite)


def serve(arch: str = "yi-9b", *, requests: int = 8, batch: int = 4,
          prompt_lens=(512, 1000), output_len: int = 32, seed: int = 0,
          device="cuda", smoke: bool = False,
          n_layers: int | None = None) -> ServeReport:
    """Build ``arch`` in bf16 from ``seed`` (``n_layers`` deep if given)
    and serve the seeded requests (``serve_model``)."""
    _check_load(requests, batch, prompt_lens, output_len)
    reduced = depth_reduction(arch, n_layers, device, smoke=smoke)
    model = build_model(arch, seed=seed, device=device, smoke=smoke,
                        n_layers=n_layers)
    return serve_model(model, requests=requests, batch=batch,
                       prompt_lens=prompt_lens, output_len=output_len,
                       seed=seed, reduced=reduced)


def _check_load(requests, batch, prompt_lens, output_len):
    if output_len < 1 or batch < 1 or min(prompt_lens) < 1:
        raise ValueError("output_len, batch and prompt lengths must be >= 1")


def serve_model(model: Model, *, requests: int = 8, batch: int = 4,
                prompt_lens=(512, 1000), output_len: int = 32, seed: int = 0,
                reduced: list[str] = ()) -> ServeReport:
    """Serve the requests drawn from ``seed`` on ``model``, on its device;
    ``reduced``: the cuts it was built with (``depth_reduction``), for the
    report."""
    _check_load(requests, batch, prompt_lens, output_len)
    cfg = model.cfg
    encoder = not cfg.has_decoder
    reqs = make_requests(requests, prompt_lens, output_len, cfg.vocab_size,
                         seed, cfg)
    batches = make_batches(reqs, batch)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    _sync(model.device)
    t0 = time.perf_counter()
    results, finite, batch_ms = [], True, []
    for bt in batches:
        start = time.perf_counter()
        res, ok = (run_clips if encoder else run_batch)(model, bt, t0, gen)
        batch_ms.append((time.perf_counter() - start) * 1e3)
        results += res
        finite &= ok
    wall = time.perf_counter() - t0
    results.sort(key=lambda r: r.rid)
    return ServeReport(results, len(batches),
                       sum(max(bt[0].output_len - 1, 0) for bt in batches),
                       wall, finite, encoder, batch_ms, list(reduced))


def main(argv=None) -> ServeReport:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-lens", default="512,1000",
                    help="comma-separated prompt lengths (an audio clip's "
                         "frames), cycled over requests")
    ap.add_argument("--output-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke config (for the CPU)")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve this many of the model's layers (a model "
                         "that does not fit the card)")
    args = ap.parse_args(argv)
    report = serve(args.arch, requests=args.requests, batch=args.batch,
                   prompt_lens=[int(x) for x in args.prompt_lens.split(",")],
                   output_len=args.output_len, seed=args.seed,
                   device=args.device, smoke=args.smoke,
                   n_layers=args.layers)
    dev = torch.device(args.device)
    summary = {"arch": args.arch, "smoke": args.smoke, "layers": args.layers,
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               **report.summary()}
    print(json.dumps(summary))
    return report


if __name__ == "__main__":
    main()
