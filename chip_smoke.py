#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, in order; the first failure ends the run with a nonzero exit:

1. device: the card's name, count and ``nvidia-smi`` name / power limit;
   TF32 off for matmuls and cuDNN, so fp32 means fp32;
2. build: both CUDA kernels from ``src/repro_torch/csrc`` with ``nvcc``
   (sm_90a), in parallel, and ``ptxas``'s register / spill report;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs at the serving shapes, bf16 and fp32, at the tolerances of the
   JAX package's ``tests/test_kernels.py``; then times on the card (CUDA
   events, inputs rotated past the 50 MB L2) of the kernel, the plain
   version and one PyTorch call as a yardstick (SDPA, never used by the
   port), beside the least time the card could take (bound);
4. model parity: yi-9b at full width, 2 layers, fp32, one seed; the card
   (CUDA kernels) against the same weights on the CPU (plain versions),
   prefill logits and three decode steps;
5. serve: ``repro_torch.serving.executor`` on yi-9b at full width (48
   layers, bf16): 8 requests, batch 4, prompts of 512 and 1000 tokens, 32
   output tokens each; every request answered with in-vocab tokens, all
   logits finite, and the kernel launch counts exactly 48 per prefill
   batch and 48 per decode step.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script exits nonzero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (3e-2, 3e-2)}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_BYTES = 50 * 2**20
PARITY_REL = 1e-3  # model parity: max |card - cpu| <= 1e-3 * max |cpu|


def log(*args):
    print(*args, flush=True)


# ------------------------------------------------------------- helpers ----


def check_close(name, got, want, dtype) -> float:
    """Raise unless |got - want| <= atol + rtol |want|; return max abs err."""
    rtol, atol = TOL[dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max())
    log(f"  {name}: max_abs_err {max_err:.3e} (rtol {rtol}, atol {atol})")
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {max_err:.3e})")
    return max_err


def copies(make, nbytes: int) -> list:
    """Enough input sets that cycling them spans 2.5x the L2 cache."""
    return [make() for _ in range(max(2, math.ceil(2.5 * L2_BYTES / nbytes)))]


def time_ms(fn, sets, iters: int) -> float:
    """Mean ms per call on the card, cycling ``sets`` after a warm-up."""
    for s in sets[:2]:
        fn(*s)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def live_pairs(s: int, causal: bool, window) -> int:
    """Query-key pairs the mask lets through (the work this data needs)."""
    q = np.arange(s)
    hi = q + 1 if causal else np.full(s, s)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(s, int)
    return int((hi - lo).sum())


# -------------------------------------------------------------- phases ----


def phase_device() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log(f"[1] device: {kind} x{count}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi[0])
    return {"platform": "gpu", "kind": kind, "count": count}


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build()
    log(f"[2] build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels() -> dict:
    """Kernels vs plain versions, then times.  Returns name -> record."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.models.layers import _repeat_kv

    log("[3] kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    def flash_inputs(b, h, hkv, s, dh, dtype):
        # the model's layout: (B, S, H, Dh) storage seen as (B, H, S, Dh)
        return tuple(randn(b, s, n, dh, dtype=dtype).transpose(1, 2)
                     for n in (h, hkv, hkv))

    def decode_inputs(b, h, hkv, s, dh, lengths, dtype):
        return (randn(b, h, dh, dtype=dtype), randn(b, s, hkv, dh, dtype=dtype),
                randn(b, s, hkv, dh, dtype=dtype),
                torch.tensor(lengths, dtype=torch.int32, device="cuda"))

    errs = {"flash_attention": 0.0, "decode_attention": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).removeprefix("torch.")
        for b, h, hkv, s, dh, window in [(4, 32, 4, 512, 128, None),
                                         (4, 32, 4, 1000, 128, None),
                                         (4, 32, 4, 512, 128, 128),
                                         (4, 16, 4, 1000, 64, None)]:
            q, k, v = flash_inputs(b, h, hkv, s, dh, dtype)
            got = fl.flash_attention_cuda(q, k, v, causal=True, window=window)
            want = fl.flash_attention_torch(q, k, v, causal=True,
                                            window=window)
            torch.cuda.synchronize()
            errs["flash_attention"] = max(errs["flash_attention"], check_close(
                f"flash {tag} B{b} H{h}/{hkv} S{s} Dh{dh} causal "
                f"window={window}", got, want, dtype))
        for b, h, hkv, s, dh, window, lens in [
                (4, 32, 4, 1032, 128, None, [1, 516, 1032, 1001]),
                (4, 32, 4, 1032, 128, 256, [1032, 700, 255, 1]),
                (2, 8, 2, 1032, 64, None, [1032, 77])]:
            q, kc, vc, lengths = decode_inputs(b, h, hkv, s, dh, lens, dtype)
            got = dec.decode_attention_cuda(q, kc, vc, lengths, window=window)
            want = dec.decode_attention_torch(q, kc, vc, lengths,
                                              window=window)
            torch.cuda.synchronize()
            errs["decode_attention"] = max(errs["decode_attention"],
                                           check_close(
                f"decode {tag} B{b} H{h}/{hkv} S{s} Dh{dh} lengths={lens} "
                f"window={window}", got, want, dtype))

    log("  times at the serving shapes (bf16), card clock:")
    dtype, item = torch.bfloat16, 2
    b, h, hkv, dh = 4, 32, 4, 128
    records = {}

    s = 1000  # the longer prompt of the serve phase
    nbytes = item * (2 * b * h * s * dh + 2 * b * hkv * s * dh)
    sets = copies(lambda: flash_inputs(b, h, hkv, s, dh, dtype), nbytes)
    lib_sets = [(q, _repeat_kv(k.transpose(1, 2), h).transpose(1, 2),
                 _repeat_kv(v.transpose(1, 2), h).transpose(1, 2))
                for q, k, v in sets]
    flash_ms = time_ms(lambda q, k, v: fl.flash_attention_cuda(q, k, v),
                       sets, 30)
    plain_ms = time_ms(lambda q, k, v: fl.flash_attention_torch(q, k, v),
                       sets[:2], 5)
    sdpa_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), lib_sets, 30)
    bms, by = bound_ms(nbytes, 4 * dh * live_pairs(s, True, None) * b * h,
                       dtype)
    records["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:82",
        shape=f"bf16 B{b} H{h} Hkv{hkv} S{s} Dh{dh} causal",
        max_abs_err=errs["flash_attention"], ms=flash_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=sdpa_ms)
    del sets, lib_sets

    s = 1032  # cache of the serve phase's 1000-token batches, all valid
    lens = [s] * b
    nbytes = item * (2 * sum(lens) * hkv * dh + 2 * b * h * dh)
    sets = copies(lambda: decode_inputs(b, h, hkv, s, dh, lens, dtype),
                  nbytes)
    lib_sets = [(q[:, :, None], _repeat_kv(kc, h).transpose(1, 2),
                 _repeat_kv(vc, h).transpose(1, 2))
                for q, kc, vc, _ in sets]
    dec_ms = time_ms(lambda *a: dec.decode_attention_cuda(*a), sets, 200)
    plain_ms = time_ms(lambda *a: dec.decode_attention_torch(*a), sets, 50)
    sdpa_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(q, k, v),
                      lib_sets, 200)
    bms, by = bound_ms(nbytes, 4 * dh * h * sum(lens), dtype)
    records["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:67",
        shape=f"bf16 B{b} H{h} Hkv{hkv} S{s} Dh{dh} lengths full",
        max_abs_err=errs["decode_attention"], ms=dec_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=sdpa_ms)
    del sets, lib_sets
    for r in records.values():
        log(f"  {r['name']} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return records


def phase_parity():
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.models.model import Model

    log("[4] model parity: yi-9b full width, 2 layers, fp32, card vs CPU")
    cfg = dataclasses.replace(get_config("yi-9b"), n_layers=2)
    card = Model(cfg, dtype=torch.float32, device="cuda")
    card.init(torch.Generator(device="cuda").manual_seed(0))
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 80)))
    launches = (fl.launches, dec.launches)
    with torch.inference_mode():
        c_card, c_cpu = card.init_cache(2, 80), cpu.init_cache(2, 80)
        outs = [(card.prefill(toks[:, :77].cuda(), c_card),
                 cpu.prefill(toks[:, :77], c_cpu))]
        for i in range(77, 80):
            (_, c_card), (_, c_cpu) = outs[-1]
            outs.append((card.decode_step(c_card, toks[:, i:i + 1].cuda()),
                         cpu.decode_step(c_cpu, toks[:, i:i + 1])))
    # fp32 on both sides (TF32 off); sums over d_model = 4096 and d_ff =
    # 11008 run in another order on the card, so the bound is relative to
    # the logits' scale.
    for step, ((got, _), (want, _)) in enumerate(outs):
        err = float((got.cpu() - want).abs().max())
        scale = float(want.abs().max())
        log(f"  {'prefill' if step == 0 else f'decode {step}'}: max abs err "
            f"{err:.3e} = {err / scale:.2e} of max |logit| {scale:.3f}")
        if not err <= PARITY_REL * scale:
            raise AssertionError("card and CPU logits disagree")
    rose = (fl.launches - launches[0], dec.launches - launches[1])
    log(f"  kernel launches: flash +{rose[0]}, decode +{rose[1]}")
    if rose != (2, 6):
        raise AssertionError(f"parity run did not go through the kernels: "
                             f"{rose}")
    del card, cpu, outs, c_card, c_cpu
    torch.cuda.empty_cache()


def phase_serve(records: dict):
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.serving import executor

    log("[5] serve: yi-9b full width (48 layers, bf16), 8 requests, batch 4,"
        " prompts 512/1000, 32 output tokens")
    cfg = get_config("yi-9b")
    torch.cuda.reset_peak_memory_stats()
    fl.launches = dec.launches = 0
    rep = executor.serve("yi-9b", requests=8, batch=4,
                         prompt_lens=(512, 1000), output_len=32, seed=0,
                         device="cuda")
    counts = {"flash_attention": fl.launches,
              "decode_attention": dec.launches}
    if len(rep.results) != 8 or not all(
            len(r.tokens) == 32 and all(0 <= t < cfg.vocab_size
                                        for t in r.tokens)
            for r in rep.results):
        raise AssertionError("a request was not answered with 32 tokens")
    if not rep.all_finite:
        raise AssertionError("non-finite logits")
    want = {"flash_attention": cfg.n_layers * rep.prefill_batches,
            "decode_attention": cfg.n_layers * rep.decode_steps}
    log(f"  launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError("kernel launch counts do not match the path")
    for name, n in counts.items():
        records[name]["launches"] = n
    s = rep.summary()
    log(f"  TTFT p50 {s['ttft_ms_p50']:.1f} ms (max {s['ttft_ms_max']:.1f}),"
        f" decode {s['decode_ms_per_step']:.2f} ms/step, "
        f"{s['tokens_per_s']:.1f} tokens/s, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"  request 0 tokens: {rep.results[0].tokens[:8]} ...")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    device = phase_device()
    phase_build()
    records = phase_kernels()
    phase_parity()
    phase_serve(records)
    log(f"total {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records.values()]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
