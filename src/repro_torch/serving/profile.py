"""Where a served batch's time goes on the card: a traced prefill and decode.

    python -m repro_torch.serving.profile --arch yi-9b --batch 4 \\
        --prompt-len 1000 --steps 8 [--trace-dir DIR]

Builds the executor's model (bf16, weights from ``--seed``), warms up one
prefill and a few decode steps, then traces with ``torch.profiler`` (CPU
and CUDA activities) two windows: one prefill of the batch, and
``--steps`` decode steps.  For each window it prints one JSON line: host
wall time (synchronised), device busy time (the union of the kernels'
intervals on the card), the device's idle share of the wall time, the
number of kernels, and the kernels with the most device time.  The
traces go to ``--trace-dir`` as Chrome traces when it is given.

Device numbers need the card; on ``--device cpu`` the script reports the
host wall time only and names the device numbers "not measured".
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.serving.executor import _sync, build_model


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, reach = 0.0, -np.inf
    for start, end in sorted(intervals):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return busy


def window_report(name: str, prof, wall_s: float, steps: int,
                  top: int = 8) -> dict:
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"window": name, "steps": steps,
           "wall_ms_per_step": wall_s * 1e3 / steps}
    if not kernels:
        out["device_busy_ms_per_step"] = "not measured"
        return out
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in kernels]) / 1e3
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    out.update({
        "device_busy_ms_per_step": busy / steps,
        "device_idle_share": 1.0 - busy / (wall_s * 1e3),
        "kernels_per_step": len(kernels) / steps,
        "top_kernels": [{"name": n[:90], "count": c, "ms": ms,
                         "share_of_busy": ms / busy}
                        for n, (c, ms) in ranked],
    })
    return out


@torch.inference_mode()
def run(arch: str, *, batch: int, prompt_len: int, steps: int, seed: int,
        device, smoke: bool, trace_dir: str | None) -> list[dict]:
    model = build_model(arch, seed=seed, device=device, smoke=smoke)
    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, prompt_len))).to(dev)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    warm = 3
    max_len = prompt_len + 2 * warm + steps + 2

    def prefill():
        cache = model.init_cache(batch, max_len)
        logits, cache = model.prefill(prompt, cache)
        return logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True), cache

    def decode(tok, cache, n):
        for _ in range(n):
            logits, cache = model.decode_step(cache, tok)
            tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        return tok, cache

    tok, cache = prefill()          # warm-up: allocator, cuBLAS, kernels
    tok, cache = decode(tok, cache, warm)
    _sync(dev)
    reports = []
    for name, n, fn in (("prefill", 1, prefill),
                        ("decode", steps, lambda: decode(tok, cache, steps))):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            wall = time.perf_counter() - t0
        if trace_dir:
            Path(trace_dir).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(Path(trace_dir) / f"{name}.json"))
        rep = window_report(name, prof, wall, n)
        rep.update(arch=cfg.name, batch=batch, prompt_len=prompt_len,
                   device=(torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"))
        reports.append(rep)
    return reports


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced smoke config (for the CPU)")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)
    reports = run(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                  steps=args.steps, seed=args.seed, device=args.device,
                  smoke=args.smoke, trace_dir=args.trace_dir)
    for rep in reports:
        print(json.dumps(rep))
    return reports


if __name__ == "__main__":
    main()
