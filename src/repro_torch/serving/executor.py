"""Batch executor: the port's serving entry point.

    python -m repro_torch.serving.executor --arch yi-9b --requests 8 \\
        --batch 4 --prompt-lens 512,1000 --output-len 32

The PyTorch counterpart of the batch executor in the JAX package's
``examples/serve_multimodel.py``, on the streaming request model: a request
is a prompt of ``prompt_len`` tokens and ``output_len`` tokens to produce
(the first by prefill, the rest by decode steps).  Requests are grouped
into batches of equal prompt length, up to ``--batch``, because a cache's
length is one scalar per batch.  Each batch runs ``prefill`` then
``output_len - 1`` greedy ``decode_step``s; argmax is over the first
``vocab_size`` logits (the head is padded to ``padded_vocab``).

All requests arrive at time 0 and batches run one after another, so a
request's time to first token includes the batches served before its own.
Decode time per token is the batch's decode wall time over its decode
steps.  Prompts come from ``numpy.random.default_rng(seed)``, weights from
a ``torch.Generator`` on the device seeded with ``seed``.  The executor
runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.model import Model


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    prompt: np.ndarray          # (prompt_len,) int token ids
    output_len: int


@dataclasses.dataclass
class Result:
    rid: int
    tokens: list[int]           # output_len generated token ids
    ttft_ms: float              # from time 0 to the first token on the host
    decode_ms_per_token: float  # the batch's decode time per step


@dataclasses.dataclass
class ServeReport:
    results: list[Result]
    prefill_batches: int
    decode_steps: int
    wall_s: float               # serving time, model build excluded
    all_finite: bool            # every logit of every step was finite

    def summary(self) -> dict:
        ttft = [r.ttft_ms for r in self.results]
        tokens = sum(len(r.tokens) for r in self.results)
        return {
            "requests": len(self.results),
            "prefill_batches": self.prefill_batches,
            "decode_steps": self.decode_steps,
            "ttft_ms_p50": float(np.median(ttft)),
            "ttft_ms_max": float(max(ttft)),
            "decode_ms_per_step": float(np.mean(
                [r.decode_ms_per_token for r in self.results])),
            "tokens_per_s": tokens / self.wall_s,
            "all_finite": self.all_finite,
        }


def build_model(arch: str, *, seed: int, device, smoke: bool) -> Model:
    """``arch`` in bf16 (its smoke config if ``smoke``), weights drawn on
    the device from ``seed``."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = Model(cfg, dtype=torch.bfloat16, device=device)
    return model.init(torch.Generator(device=model.device).manual_seed(seed))


def make_requests(n: int, prompt_lens, output_len: int, vocab_size: int,
                  seed: int) -> list[Request]:
    """Request i gets prompt length ``prompt_lens[i % len(prompt_lens)]``."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab_size,
                                    prompt_lens[i % len(prompt_lens)]),
                    output_len) for i in range(n)]


def make_batches(requests, max_batch: int) -> list[list[Request]]:
    """Batches of equal prompt length (and output length), at most
    ``max_batch`` each, in order of first arrival."""
    groups: dict[tuple[int, int], list[Request]] = {}
    for r in requests:
        groups.setdefault((len(r.prompt), r.output_len), []).append(r)
    return [g[i:i + max_batch] for g in groups.values()
            for i in range(0, len(g), max_batch)]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def run_batch(model: Model, batch: list[Request], t0: float):
    """Prefill + greedy decode of one batch.  Returns (results, finite)."""
    dev = model.device
    vocab = model.cfg.vocab_size
    out_len = batch[0].output_len
    prompt = torch.from_numpy(np.stack([r.prompt for r in batch])).to(dev)
    b, s = prompt.shape
    cache = model.init_cache(b, s + out_len)
    logits, cache = model.prefill(prompt, cache)
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
          device="cuda", smoke: bool = False) -> ServeReport:
    """Build ``arch`` in bf16 from ``seed`` and serve the seeded requests."""
    if output_len < 1 or batch < 1 or min(prompt_lens) < 1:
        raise ValueError("output_len, batch and prompt lengths must be >= 1")
    model = build_model(arch, seed=seed, device=device, smoke=smoke)
    reqs = make_requests(requests, prompt_lens, output_len,
                         model.cfg.vocab_size, seed)
    batches = make_batches(reqs, batch)
    _sync(model.device)
    t0 = time.perf_counter()
    results, finite = [], True
    for bt in batches:
        res, ok = run_batch(model, bt, t0)
        results += res
        finite &= ok
    wall = time.perf_counter() - t0
    results.sort(key=lambda r: r.rid)
    return ServeReport(results, len(batches),
                       sum(bt[0].output_len - 1 for bt in batches), wall,
                       finite)


def main(argv=None) -> ServeReport:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-lens", default="512,1000",
                    help="comma-separated prompt lengths, cycled over "
                         "requests")
    ap.add_argument("--output-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke config (for the CPU)")
    args = ap.parse_args(argv)
    report = serve(args.arch, requests=args.requests, batch=args.batch,
                   prompt_lens=[int(x) for x in args.prompt_lens.split(",")],
                   output_len=args.output_len, seed=args.seed,
                   device=args.device, smoke=args.smoke)
    dev = torch.device(args.device)
    summary = {"arch": args.arch, "smoke": args.smoke,
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               **report.summary()}
    print(json.dumps(summary))
    return report


if __name__ == "__main__":
    main()
