"""Where a served batch's time goes on the card: a traced prefill and decode.

    python -m repro_torch.serving.profile --arch yi-9b --batch 4 \\
        --prompt-len 1000 --steps 8 [--trace-dir DIR]
    python -m repro_torch.serving.profile --arch internvl2-76b --layers 24
    python -m repro_torch.serving.profile --arch hubert-xlarge --batch 32 \\
        --prompt-len 1024

Builds the executor's model (bf16, weights from ``--seed``; ``--layers``
as the executor cuts a model that does not fit the card), warms up one
prefill and a few decode steps, then traces with ``torch.profiler`` (CPU
and CUDA activities) two windows: one prefill of the batch (a VLM's
``n_frontend_tokens`` patches before the prompt), and ``--steps`` decode
steps; on the card a third, ``--steps`` replays of one decode step
captured as a CUDA graph (the step the L(b, p) grid times).  An
encoder-only arch (hubert-xlarge) has no decode step: its windows are one
forward of the batch (``--prompt-len`` frames a clip) and, on the card,
``--steps`` replays of that forward captured as a CUDA graph.  For each window it prints one JSON line: host
wall time (synchronised), device busy time (the union of the kernels'
intervals on the card), the device's idle share of the wall time, the
number of kernels, the kernels with the most device time, and each of
the port's own kernels that ran (count, ms, and us a call).  The traces go
to ``--trace-dir`` as Chrome traces when it is given.

Device numbers need the card; on ``--device cpu`` the script reports the
host wall time only and names the device numbers "not measured".
"""
from __future__ import annotations

import argparse
import json
import re
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import _build
from repro_torch.models import frontend
from repro_torch.serving.executor import _sync, build_model, depth_reduction

# The hand-written kernels live in anonymous namespaces (ssd_bf16_kernel in
# a namespace inside one) and are named after their sources: flash_bf16 /
# flash_fp32, decode_kernel, ssd_bf16_kernel / ssd_kernel,
# rglru_lookback_kernel.
_PORT_KERNEL = re.compile(
    r"\(anonymous namespace\)::(?:\w+::)*(?:%s)_"
    % "|".join(src.split("_")[0] for src in _build.SOURCES))


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
    ours = sorted((n, c, ms) for n, (c, ms) in by_name.items()
                  if _PORT_KERNEL.search(n))
    out.update({
        "device_busy_ms_per_step": busy / steps,
        "device_idle_share": 1.0 - busy / (wall_s * 1e3),
        "kernels_per_step": len(kernels) / steps,
        "top_kernels": [{"name": n[:90], "count": c, "ms": ms,
                         "share_of_busy": ms / busy}
                        for n, (c, ms) in ranked],
        "port_kernels": [{"name": n[:90], "count": c, "ms": ms,
                          "us_per_call": ms * 1e3 / c} for n, c, ms in ours],
    })
    return out


def traced(name: str, n: int, fn, activities, dev, trace_dir) -> dict:
    """One profiler window around ``fn()``: its report."""
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    if trace_dir:
        Path(trace_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace_dir) / f"{name}.json"))
    return window_report(name, prof, wall, n)


@torch.inference_mode()
def run(arch: str, *, batch: int, prompt_len: int, steps: int, seed: int,
        device, smoke: bool, trace_dir: str | None,
        n_layers: int | None = None) -> list[dict]:
    reduced = depth_reduction(arch, n_layers, device, smoke=smoke)
    model = build_model(arch, seed=seed, device=device, smoke=smoke,
                        n_layers=n_layers)
    cfg, dev = model.cfg, model.device
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    gen = torch.Generator(device=dev).manual_seed(seed)
    label = dict(batch=batch, prompt_len=prompt_len, layers=cfg.n_layers,
                 reduced=reduced)
    if not cfg.has_decoder:
        frames = frontend.audio_frame_embeddings(
            gen, batch, prompt_len, cfg, device=dev, dtype=model.dtype)
        model.forward(frame_embeds=frames)  # warm-up
        _sync(dev)
        reports = [traced("forward", 1,
                          lambda: model.forward(frame_embeds=frames),
                          activities, dev, trace_dir)]
        if dev.type == "cuda":
            reports.append(graph_window("forward_graph", model, (frames,),
                                        steps, activities, trace_dir))
        return [_labelled(r, cfg, dev, **label) for r in reports]
    n_patches = cfg.n_frontend_tokens if cfg.arch_type == "vlm" else 0
    patches = (frontend.vision_patch_embeddings(
        gen, batch, n_patches, cfg, device=dev, dtype=model.dtype)
        if n_patches else None)
    label["n_patches"] = n_patches
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, prompt_len))).to(dev)
    warm = 3
    max_len = n_patches + prompt_len + 2 * warm + steps + 2

    def prefill():
        cache = model.init_cache(batch, max_len)
        logits, cache = model.prefill(prompt, cache, patch_embeds=patches)
        return logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True), cache

    def decode(tok, cache, n):
        for _ in range(n):
            logits, cache = model.decode_step(cache, tok)
            tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        return tok, cache

    tok, cache = prefill()          # warm-up: allocator, cuBLAS, kernels
    tok, cache = decode(tok, cache, warm)
    _sync(dev)
    reports = [traced("prefill", 1, prefill, activities, dev, trace_dir),
               traced("decode", steps, lambda: decode(tok, cache, steps),
                      activities, dev, trace_dir)]
    if dev.type == "cuda":
        reports.append(graph_window("decode_graph", model, (cache, tok),
                                    steps, activities, trace_dir))
    return [_labelled(r, cfg, dev, **label) for r in reports]


def _labelled(rep: dict, cfg, dev, **label) -> dict:
    rep.update(arch=cfg.name, **label,
               device=(torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"))
    return rep


def graph_window(name: str, model, inputs, steps: int, activities,
                 trace_dir) -> dict:
    """The step as ``launch/profile_partitions.py`` times it: a decode
    step (``inputs`` = (cache, tokens)), or an encoder's forward
    (``inputs`` = (frames,)), captured as a CUDA graph on the whole card
    and replayed ``steps`` times under the profiler, so the idle share is
    the gaps between the graph's kernels, not the host's."""
    from repro_torch.launch import profile_partitions as pp
    from repro_torch.launch.partition import partition
    capture = pp.capture if model.cfg.has_decoder else pp.capture_forward
    whole = partition(100, model.device.index or 0)
    with whole:
        graph, _ = capture(model, *inputs, whole)
        graph.replay()
        whole.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                graph.replay()
            whole.synchronize()
            wall = time.perf_counter() - t0
    graph.reset()
    if trace_dir:
        prof.export_chrome_trace(str(Path(trace_dir) / f"{name}.json"))
    return window_report(name, prof, wall, steps)


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
    ap.add_argument("--layers", type=int, default=None,
                    help="this many of the model's layers (a model that "
                         "does not fit the card)")
    args = ap.parse_args(argv)
    reports = run(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                  steps=args.steps, seed=args.seed, device=args.device,
                  smoke=args.smoke, trace_dir=args.trace_dir,
                  n_layers=args.layers)
    for rep in reports:
        print(json.dumps(rep))
    return reports


if __name__ == "__main__":
    main()
