#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --granite    # granite's rows of phase 3 alone

Phases, in order; the first failure ends the run with a nonzero exit:

1. device: the card's name, count and ``nvidia-smi`` name / power limit;
   TF32 off for matmuls and cuDNN, so fp32 means fp32;
2. build: the CUDA kernels from ``src/repro_torch/csrc`` (the four TPU
   kernels' counterparts, the flash and SSD backward passes, RoPE and the
   partition probe) with
   ``nvcc`` (sm_90a), in parallel, and ``ptxas``'s register / spill
   report of every kernel instantiation; then, from ``cuobjdump -sass``,
   the tensor-core (``HGMMA``) and TMA (``UTMALDG``) instructions of each
   bf16 flash instantiation, forward and backward, which must have both,
   and the tensor-core (``HMMA``) instructions of the bf16 SSD kernels,
   forward and backward, which must have some;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs at the serving shapes, at the tolerances of the JAX package's
   ``tests/test_kernels.py`` (bf16 attention: relative to each output
   row's RMS, see ``TOL``): flash and decode attention at yi-9b's,
   recurrentgemma-2b's and stablelm-12b's (Dh 160) head shapes (bf16 and
   fp32, S 1000 and a ragged S), flash at hubert-xlarge's (Dh 80, not
   causal, S 1000, 512, 77) and internvl2-76b's (H64 / Hkv 8 at S 2024,
   its 1024 patches before a 1000-token prompt) and decode attention at
   internvl2-76b's (a cache of 2056 slots), and both at command-r-35b's
   (H64 / Hkv 8, S 1000, 1032 slots), the SSD scan (bf16 and fp32 inputs, S
   1000, 512 and the chunk edges 1, 63, 64, 65, with and without an
   initial state, B / C as slices of one projection) and the RG-LRU scan
   (the same, and S 4096); granite-4.0-h-small's prefill at its cell's
   cap: flash at H32 / Hkv 8, Dh 128, scale 1/128 at B2 S8192 and B8
   S2048 (against the plain version a KV head at a time), the SSD scan at
   B2 S8192 H128 P64 N128 and the dropless MoE's grouped expert products
   (16,384 tokens x 10 choices over 72 experts, bit for bit a product an
   expert), and decode attention at its heads and scale over 1032 slots,
   timed beside their bounds;
   and deepseek-moe-16b's (16 query and 16 KV heads); RoPE of q and k at
   every served head shape (bf16 and fp32; a 1000-token prefill, a decode
   step at position 3071, a VLM's text behind 1024 patches), within 1 ulp
   of two plain calls (``check_bits``: the same fp32 operations);
   then times on the card (CUDA events, inputs rotated past the 50 MB L2)
   of each kernel, its plain version and, for attention, one PyTorch call
   as a yardstick (SDPA, never used by the port), beside the least time
   the card could take (bound: each kernel module's ``cost``, the formula
   the dry run prices it with), and the time of each kernel (and for
   attention SDPA's) with the host out of the way (``device_ms``); and the
   decode kernel's time by cache splits (the sweep behind ``split_plan``);
4. model parity, fp32, one seed, the card (CUDA kernels) against the same
   weights on the CPU (plain versions), prefill logits and three decode
   steps, at full width: yi-9b, stablelm-12b, chatglm3-6b, mamba2-780m
   deepseek-moe-16b and command-r-35b (2 layers) and recurrentgemma-2b (3
   layers, one
   (rglru, rglru, attn) unit; also one 2100-token prompt, so that the
   2048-slot local ring wraps); hubert-xlarge (2 layers, one forward over
   1000 and 77 frames, no decode step) and internvl2-76b (2 layers, 1024
   patches before the prompt); for deepseek-moe-16b first the routing:
   each token's top-k experts in every MoE layer on the card against the
   CPU's, every differing decision printed with the CPU's probability gap
   there, and a difference at a gap above ``ROUTING_GAP`` fails;
5. serve: ``repro_torch.serving.executor`` on yi-9b, mamba2-780m,
   recurrentgemma-2b, stablelm-12b, chatglm3-6b, deepseek-moe-16b,
   hubert-xlarge, command-r-35b (64.8 GB of bf16 weights) and
   granite-4.0-h-small (64.4 GB) at full width
   and depth, and internvl2-76b at full width
   and 24 of its 80 layers (``LAYERS``: 141 GB of bf16 weights do not fit
   the card), bf16: 8 requests, batch 4, prompts of 512 and 1000 tokens
   (internvl2-76b's behind 1024 patch embeddings; hubert-xlarge's clips
   of 512 and 1000 frame embeddings, answered with a label per frame), 32
   output tokens each; every request answered with in-vocab tokens, all
   logits finite, and each kernel's launch count (set to 0 before each
   model's serve, read after it) exactly one per layer of its kind per
   prefill (or encoder forward) batch (flash, SSD scan, RG-LRU scan) or
   per decode step (decode attention), RoPE once per attention layer in
   both where the model has RoPE, and a dropless MoE layer's three
   grouped expert products in both (granite: flash in 4 of its 40
   layers, the SSD scan in the other 36); first the dry run
   (``launch/dryrun.py --all``: every (arch x shape) step traced on the
   ``meta`` device, started as a host process of its own after phase 1)
   is read, checked (``done: 38 ok, 2 skipped, 0 failed``) and printed as
   a table, and after each served model, on that model, each of its
   combinations whose record fits the card (every decode step, the
   cheapest prefill, the others within ``DRYRUN_BUDGET_S``) runs once at
   the record's shapes, timed by CUDA events, and once under the profiler:
   the bytes the arguments ask of the card's allocator must be the
   record's (what it gives them is printed beside), the step's peak
   (``max_memory_allocated``) within
   ``DRYRUN_PEAK_TOL`` of the record's, the device busy time at least the
   roofline's compute time, every logit finite, and each kernel launched
   once per layer of its kind, as the record's calls;
6. partitions (``repro_torch.launch``): each of the three carves of the
   card's SMs (green contexts) that realise the paper's five splits, with
   its granted SMs, proven disjoint by the ``%smid`` probe; the four
   kernels at their serving shapes on the smallest partition (24 SMs),
   each launched on the whole card first, against their plain versions,
   with their time there; the L(b, p) grid
   (``launch/profile_partitions.py``: the five models of the JAX
   package's serving mix, ``core.h100lets.MIX``: yi-9b, chatglm3-6b,
   mamba2-780m, deepseek-moe-16b, recurrentgemma-2b; full width, bf16, a
   decode step at 1024 cached
   positions captured as a CUDA graph and replayed on each of the six
   partition sizes at batches 1-32, each on the side of the carve it
   names), written to
   ``results/out/h100_lbp.jsonl`` and printed as a table, with the decode
   kernel's launch count (set to 0 before the grid, read after it) exactly
   one per attention (or MoE) layer per eager or captured step;
   hubert-xlarge's forward (1024 frames a clip, batch 8) captured and
   replayed on 24 SMs beside its committed L(b, p) cell (fails outside
   ``FORWARD_BAND`` of it); the check
   that no side of a split is priced from more SMs than it gets; and, from
   the grid just measured, the five schedulers' largest schedulable
   multiple of the mix on 4 cards, a replay of the elastic placement
   through the event engine that must conserve every request, and the
   fleet layer (``launch/serve.py --fleet 1,2,4``: the copied ``fabric``
   on nodes of 4 cards priced from this grid, interference off: the
   weak-scaling sweep at 1, 2 and 4 nodes, a node of 4 dying at half the
   horizon and a seeded fault storm on 4, each run's line printed, each
   of which must conserve its requests, and a 1-node fleet that must be
   the bare replay on the same requests; interference off, since this
   run measures no full co-run table) (host work alone:
   ``launch/serve.py`` in a process of its own, ``start_serve``, run
   beside phases 7-8 and printed after phase 8);
7. interference (``launch/profile_interference.py``, ``core/h100intf.py``):
   the co-run factors of the ten pairs of distinct models of the mix on
   the 40/60 carve (56 + 76 SMs) at batch 8 on both sides, at most two
   models on the card at a time, each beside the committed table's
   (``results/h100_corun.jsonl``), with the decode kernel's launch count
   (set to 0 before, read after) exactly one per attention layer per
   warm-up or captured step; a factor under 0.95 or a time that is not
   finite fails; mamba2-780m and yi-9b there beside synthetic partners
   that each load one resource (kernel launches, HBM, tensor cores:
   ``profile_interference.partner``); the host's time to launch each of 20
   replays of yi-9b's and deepseek-moe-16b's steps queued back to back
   (``launch_queue``); the solo features (DRAM share) of
   this run's grid on the 40 and 60 sides beside the committed ones; then,
   from the committed tables, the fitted predictor (Fig. 9), the max scale
   of SBP, self-tuning, ``gpulet``, ``gpulet+int``, ideal and the ideal's
   enumeration alone (which must place some of the mix), the replays of
   both ``gpulet`` variants at 0.999 of their maxima under the measured
   interference, and the serving controller under the fluctuating rates of
   the JAX package's example, at the example's share of the elastic
   maximum (``launch/serve.py --fluctuate``), and the fleet layer as in
   phase 6; the controller and every fleet run twice, on the committed
   co-run factors (the fleet's nodes ``fabric/h100node.py``'s measured
   nodes) and with interference off, each labelled, with goodput a node
   and violations per class (the fleet) or per model (the controller)
   logged side by side, each of which must conserve its requests, and
   the 1-node fleet the bare replay with either interference (these last
   from the committed tables alone, in a process of their own started
   before phase 6 and printed after phase 8);
8. train (recurrentgemma-2b, ``TRAIN_ARCH``, and mamba2-780m,
   ``SSM_ARCH``): the flash backward against
   autograd of the plain version (dq, dk, dv; bf16 and fp32; at
   recurrentgemma-2b's heads at S 1000 and at S 2100 with its 2048 window
   binding, yi-9b's and chatglm3-6b's groups, every other head dim at a
   small shape, causal and not; the tolerances of attention, on values
   divided by each row's RMS, ``check_grad``; the fp32 cases at S 1000
   also against the plain version in fp64) and the RG-LRU backward (its
   own entry: the reverse recurrence in one launch) against autograd of
   the plain recurrence (S 1000 and 4096, with and without h0) and RoPE's
   backward (``ops.rope`` under grad, one launch each way, at
   recurrentgemma-2b's heads, bf16 and fp32, S 1024, 2100 and behind an
   offset, within 1 ulp of autograd of the plain version), all while
   the CPU computes
   its side of one fp32 train step of a 3-layer recurrentgemma-2b at full
   width over 2100 tokens, card against CPU (loss, every gradient, the
   parameters after the AdamW step, within ``PARITY_REL``), and the card
   model's checkpoint read back through the bridge bit for bit; each
   kernel at the training shape held against its plain version (the
   flash backward also against a second call, bitwise), then
   timed beside the plain versions' and SDPA's forward + backward; the
   SSD backward against autograd of the plain version (bf16 and fp32 x /
   B / C at mamba2's heads, S 1000, 1024 and the chunk edges 1, 63, 64,
   65, with and without h0 and a gradient of h_final, B / C slices of one
   projection; every gradient divided by its max, at ``SSD_TOL``; the
   fp32 cases at S 1000 also against the plain version in fp64) while the
   CPU computes its side of the same fp32 train step of a 3-layer
   mamba2-780m over 1100 tokens (no chunk multiple); the SSD forward and
   backward at mamba2's training shape held against their plain versions
   (the backward also against a second call, bitwise), then timed; then
   ``repro_torch.launch.train`` at full width and depth, bf16, 8 steps of
   B4 x S1024, for each of the two: every loss and grad norm finite, the
   last loss below the first, and each kernel's launch count (set to 0
   before, read after) exactly the path's: recurrentgemma-2b per step 16
   flash forwards and 16 RoPE launches (8 layers, each recomputed under
   remat), 8 flash and 8 RoPE backwards, 36 RG-LRU scans (18 layers, each recomputed) and 18 RG-LRU
   backwards, no decode or SSD scan; mamba2-780m per step 96 SSD scans
   (48 layers, each recomputed) and 48 SSD backwards, nothing else; and
   one more step of each traced by the profiler (device busy, kernel time
   by family); after each of the 8 steps, outside the timed window, the
   allocated bytes before and after a collection (``gc.collect``), which
   must free nothing; and for each of the two, the first 2 steps of a
   fresh process (``chip_smoke.py --first-step ARCH``) with Python's
   collector off: each step's peak, its allocated bytes after it and after
   a collection, which must free nothing, and the modules it imported.

The line before the last is the kernels' JSON record (one entry per kernel
and served model, one for the grid's decode launches and one for the
co-run's; ``partition_ms`` is a kernel's time on the smallest partition);
the last line is ``{"ok": true, "device": {...}}``.  Phase 8 adds the
training paths' records (``path`` ``train:recurrentgemma-2b`` and
``train:mamba2-780m``): the forward kernels and the three backward passes
at the training shapes, with ``fwd_bwd_ms`` beside each backward's time.
Without a CUDA device, or without the rest of the repository beside it,
the script exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import types
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
# attention: fp32 absolute, as the JAX package's tests/test_kernels.py;
# bf16 rtol = atol = 3e-2 on each output row divided by that row's RMS over
# Dh (an absolute 3e-2 is the size of a typical output at long contexts)
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (3e-2, 3e-2)}
SSD_TOL = 1e-4     # rtol = atol on outputs divided by max |reference|
RGLRU_TOL = 1e-5   # rtol = atol
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_BYTES = 50 * 2**20
PARITY_REL = 1e-3  # model parity: max |card - cpu| <= 1e-3 * max |cpu|
# routing parity: card and CPU may choose other experts for a token only
# where the CPU's probabilities of the two are within this of each other
ROUTING_GAP = 1e-5
SERVED = ("yi-9b", "mamba2-780m", "recurrentgemma-2b", "stablelm-12b",
          "chatglm3-6b", "deepseek-moe-16b", "hubert-xlarge", "internvl2-76b",
          "command-r-35b", "granite-4.0-h-small")
# depth served where the full model does not fit the card (80 GB):
# internvl2-76b's 80 layers are 141 GB of bf16 weights, 24 are 45.3 GB
LAYERS = {"internvl2-76b": 24}


class Heads(NamedTuple):
    """An arch's attention as the serve runs it: heads, head dim, window,
    mask, the prefill length of a 1000-token prompt (a VLM's patches
    before it) and the decode cache's slots (None: no decode step)."""
    h: int
    hkv: int
    dh: int
    window: int | None = None
    causal: bool = True
    s: int = 1000
    slots: int | None = 1032


HEADS = {"yi-9b": Heads(32, 4, 128),
         "recurrentgemma-2b": Heads(10, 1, 256, 2048),
         "stablelm-12b": Heads(32, 8, 160),
         "chatglm3-6b": Heads(32, 2, 128),
         "deepseek-moe-16b": Heads(16, 16, 128),
         "hubert-xlarge": Heads(16, 16, 80, causal=False, slots=None),
         "internvl2-76b": Heads(64, 8, 128, s=1024 + 1000,
                                slots=1024 + 1000 + 32),
         "command-r-35b": Heads(64, 8, 128)}
# the dry run (``launch/dryrun.py --all``, host work in a process of its
# own from phase 1 on): its records, and on the card (phase 5) each
# combination that fits, within this wall time: every decode step, the
# cheapest prefill, and the other prefills while their expected time
# (``DRYRUN_SLOWDOWN`` x their roofline bound, two runs each) fits
DRYRUN_OUT = Path(__file__).resolve().parent / "results/out/dryrun.jsonl"
DRYRUN_BUDGET_S, DRYRUN_SLOWDOWN = 90.0, 3.0
DRYRUN_PEAK_TOL = 0.10  # the card's peak within this share of the record's
# the encoder's forward on the smallest partition (phase 6): its batch, and
# the band around its committed L(b, 20%) outside which the run fails
FORWARD_BATCH, FORWARD_BAND = 8, (0.5, 2.0)
ROOT = Path(__file__).resolve().parent
LBP_OUT = ROOT / "results/out/h100_lbp.jsonl"
# the committed tables the interference phase compares with and replays
COMMITTED = {n: ROOT / f"results/h100_{n}.jsonl"
             for n in ("lbp", "corun", "features")}
# the fleet's node counts (``launch/serve.py --fleet``) on either table
FLEET = "1,2,4"
# phase 7's schedulers on them (``launch/serve.py``, host work alone)
COMMITTED_REPLAY = (
    "--results", str(COMMITTED["lbp"]), "--corun", str(COMMITTED["corun"]),
    "--features", str(COMMITTED["features"]), "--gpus", "4", "--max-scale",
    "--replay", "--fluctuate", "--fleet", FLEET)
CORUN_CARVE, CORUN_BATCH = 40, 8  # the co-run subset: 56 + 76 SMs, batch 8
MIN_FACTOR = 0.95  # a co-run faster than solo by more than this is a fault
KERNELS = ("flash_attention", "decode_attention", "ssd_scan", "rglru_scan",
           "rope")
# phase 8: the models trained at full width and depth, and their shape
TRAIN_ARCH = "recurrentgemma-2b"
SSM_ARCH = "mamba2-780m"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 1024
# phase 8: the steps of a fresh process checked for what only a collection
# frees (``first_step``), and the time one such process may take
FIRST_STEPS, FIRST_STEP_TIMEOUT_S = 2, 300
TRAIN_PATH = f"train:{TRAIN_ARCH}"
SSM_PATH = f"train:{SSM_ARCH}"
# the fp32 card-vs-CPU step: (layers, tokens) of each trained model; 2100
# binds recurrentgemma's 2048 window, 1100 is no multiple of the SSD chunk
PARITY_SHAPE = {TRAIN_ARCH: (3, 2100), SSM_ARCH: (3, 1100)}
SSD_GRADS = ("dx", "ddt", "da", "dB", "dC", "dh0")
# a bf16 gradient row's RMS is floored at this share of the tensor's RMS
GRAD_ROW_FLOOR = 1e-2
# the flash backward's first version (CUDA cores, fp32 tiles) at the
# training shape on an H100 80GB HBM3 at 700 W (PERF.md), printed beside
# this run's time
CUDA_CORE_BWD_MS = 5.7713
# the SSD backward's first version (fp32 on the CUDA cores) and the RG-LRU
# backward's (the forward kernel on flipped copies), at the training
# shapes on the same card (PERF.md), printed beside this run's times
SSD_CUDA_CORE_BWD_MS = 2.5411
RGLRU_FLIPPED_BWD_MS = 0.3993
CKPT_DIR = ROOT / "results/out"  # ignored by git; the checkpoint is removed
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:82",
    "decode_attention": "src/repro/kernels/decode_attention.py:67",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:67",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:38",
    # no TPU kernel: the JAX package rotates in jnp and XLA fuses the chain
    "rope": "none (src/repro/models/layers.py:62, jnp)",
}
# the backward passes: no TPU kernel has one; each backs the forward it
# differentiates, from its own source (RG-LRU's is a second entry of the
# forward's)
REPLACES.update(flash_attention_backward=REPLACES["flash_attention"],
                ssd_scan_backward=REPLACES["ssd_scan"],
                rglru_scan_backward=REPLACES["rglru_scan"],
                rope_backward=REPLACES["rope"])
SOURCE = {"flash_attention_backward": "flash_attention_bwd",
          "ssd_scan_backward": "ssd_scan_bwd",
          "rglru_scan_backward": "rglru_scan", "rope_backward": "rope"}


def log(*args):
    print(*args, flush=True)


# ------------------------------------------------------------- helpers ----


def check_close(name, got, want, dtype) -> float:
    """Attention outputs (..., Dh): raise unless |got - want| <= atol +
    rtol |want|, on outputs divided by their row's RMS in bf16 (by 1 in
    fp32).  Returns the max abs error (unscaled)."""
    rtol, atol = TOL[dtype]
    scale = (want.float().pow(2).mean(-1, keepdim=True).sqrt() + 1e-9
             if dtype == torch.bfloat16 else 1.0)
    return _check(name, got, want, rtol, atol, scale)


def check_scaled(name, got, want, tol) -> float:
    """The JAX ``test_ssd_scan`` check: both sides divided by max |want|,
    then rtol = atol = ``tol``.  Returns the max abs error (unscaled)."""
    scale = float(want.float().abs().max()) + 1e-9
    return _check(name, got, want, tol, tol, scale)


def _check(name, got, want, rtol, atol, scale, quiet=False) -> float:
    """|got - want| / scale <= atol + rtol |want| / scale elementwise;
    ``scale`` is a number or a tensor that broadcasts against ``want``.
    ``quiet``: log nothing unless it fails."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol * scale + rtol * want.abs()
    max_err = float(err.max())
    if isinstance(scale, torch.Tensor):
        how = (f", row RMS {float(scale.min()):.3g}.."
               f"{float(scale.max()):.3g}, max err / RMS "
               f"{float((err / scale).max()):.3e}")
    else:
        how = "" if scale == 1.0 else f", scale {scale:.3g}"
    failed = bool(bad.any()) or not bool(torch.isfinite(got).all())
    if failed or not quiet:
        log(f"  {name}: max_abs_err {max_err:.3e} (rtol {rtol}, atol "
            f"{atol}{how})")
    if failed:
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


def device_ms(fn, sets, iters: int) -> float:
    """Mean ms per call on the card with the host out of the way: the calls
    are queued behind a spin of the card (``torch.cuda._sleep``) that lasts
    longer than the host takes to queue them, then timed by CUDA events,
    so the events see the kernels back to back.  The spin grows until the
    card is still in it when the last call is queued."""
    fn(*sets[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin = 20_000_000  # cycles, about 10 ms
    for _ in range(4):
        torch.cuda._sleep(spin)
        start.record()
        for i in range(iters):
            fn(*sets[i % len(sets)])
        end.record()
        queued_in_time = not start.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
        spin *= 4
    raise AssertionError("the host could not queue the calls within the "
                         "card's spin")


def timed(fn, *args):
    """``fn(*args)``, logging its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"  ({fn.__name__}: {time.perf_counter() - t0:.1f} s)")
    return out


def bound_ms(cost: tuple[int, int], dtype) -> tuple[float, str]:
    """The least time of a call on the card: the larger of its bytes over
    the HBM rate and its operations over their type's peak.  ``cost`` is
    (operations, bytes), from the kernel module's ``cost`` or ``bwd_cost``
    (one definition of each kernel's work, which the dry run prices
    too)."""
    ops, nbytes = cost
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def record(name, path, shape, err, ms, plain_ms, bound, library_ms,
           **extra) -> dict:
    return dict(name=name, path=path, route="cuda",
                source=f"src/repro_torch/csrc/{SOURCE.get(name, name)}.cu",
                replaces=REPLACES[name], shape=shape, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], library_ms=library_ms, **extra)


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
        entry = "?"
        for line in _build.ptxas_report(name).splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            if m:
                # the mangled name, cut before its parameter list
                entry = re.sub(r"(EEvP|EP).*$", "E", m.group(1))
                entry = entry.replace("_ZN12_GLOBAL__N_1", "")
            elif "registers" in line or "spill" in line:
                log(f"  {name} {entry}: {line.split(':', 1)[-1].strip()}")
    sass_counts(_build)


def sass_counts(build):
    """HGMMA / UTMALDG per bf16 flash instantiation and HMMA in the bf16 SSD
    kernels, forward and backward (cuobjdump -sass of the built libraries);
    raises if one has no tensor-core instruction."""
    exe = Path(build.nvcc()).parent / "cuobjdump"

    def sass_of(name):
        return subprocess.run([str(exe), "-sass",
                               str(build.library_path(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout

    for lib, kernel in (("ssd_scan", "ssd_bf16_kernel"),
                        ("ssd_scan_bwd", "ssd_bwd_bf16_kernel")):
        ssd = [b for b in sass_of(lib).split("Function : ")[1:]
               if re.match(rf"\S*{kernel}", b)]
        if len(ssd) != 1:
            raise AssertionError(f"found {len(ssd)} {kernel} in the SASS, "
                                 "expected 1")
        n_mma = ssd[0].count("HMMA") + ssd[0].count("HGMMA")
        log(f"  {lib} bf16: {n_mma} HMMA / HGMMA in its SASS")
        if not n_mma:
            raise AssertionError(f"{kernel} has no tensor-core instruction")
    sass = sass_of("flash_attention")
    found = 0
    for block in sass.split("Function : ")[1:]:
        m = re.match(r"\S*flash_bf16ILi(\d+)E", block)
        if not m:
            continue
        found += 1
        n_mma = block.count("HGMMA")
        n_tma = block.count("UTMALDG")
        log(f"  flash_attention bf16 Dh {m.group(1)}: {n_mma} HGMMA, "
            f"{n_tma} UTMALDG in its SASS")
        if not n_mma or not n_tma:
            raise AssertionError(f"flash bf16 Dh {m.group(1)} has no "
                                 "tensor-core or TMA instruction")
    if found != 5:
        raise AssertionError(f"found {found} bf16 flash instantiations in "
                             "the SASS, expected 5 (Dh 64/80/128/160/256)")
    # the backward: per head dim the rows kernel (lse, D, dQ) and the kv
    # kernel (dK, dV) with bf16 gradients (group 1) or fp32 partials
    found = 0
    for block in sass_of("flash_attention_bwd").split("Function : ")[1:]:
        m = re.match(r"\S*(flash_bwd_\w+_bf16)ILi(\d+)E(\w*)", block)
        if not m:
            continue
        found += 1
        out = "" if m.group(1).endswith("rows_bf16") else (
            ", fp32 partials" if m.group(3).startswith("f") else ", bf16")
        n_mma = block.count("HGMMA")
        n_tma = block.count("UTMALDG")
        log(f"  flash backward {m.group(1)} Dh {m.group(2)}{out}: {n_mma} "
            f"HGMMA, {n_tma} UTMALDG in its SASS")
        if not n_mma or not n_tma:
            raise AssertionError(f"{m.group(1)} Dh {m.group(2)} has no "
                                 "tensor-core or TMA instruction")
    if found != 15:
        raise AssertionError(f"found {found} bf16 flash backward "
                             "instantiations in the SASS, expected 15")


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)


def kernels_attention(gen, errs):
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fl

    def flash_inputs(b, h, hkv, s, dh, dtype):
        # the model's layout: (B, S, H, Dh) storage seen as (B, H, S, Dh)
        return tuple(_randn(gen, b, s, n, dh, dtype=dtype).transpose(1, 2)
                     for n in (h, hkv, hkv))

    def decode_inputs(b, h, hkv, s, dh, lengths, dtype):
        return (_randn(gen, b, h, dh, dtype=dtype),
                _randn(gen, b, s, hkv, dh, dtype=dtype),
                _randn(gen, b, s, hkv, dh, dtype=dtype),
                torch.tensor(lengths, dtype=torch.int32, device="cuda"))

    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).removeprefix("torch.")
        for b, h, hkv, s, dh, window, causal in [
                (4, 32, 4, 512, 128, None, True),
                (4, 32, 4, 1000, 128, None, True),
                (4, 32, 2, 1000, 128, None, True),
                (4, 32, 4, 512, 128, 128, True),
                (4, 16, 4, 1000, 64, None, True),
                (4, 10, 1, 1000, 256, 2048, True),
                (1, 10, 1, 2100, 256, 2048, True),
                (2, 10, 1, 1000, 256, 128, True),
                (4, 32, 8, 1000, 160, None, True),
                (2, 32, 8, 77, 160, None, True),
                (4, 16, 16, 1000, 128, None, True),
                (4, 16, 16, 1000, 80, None, False),   # hubert-xlarge
                (4, 16, 16, 512, 80, None, False),
                (2, 16, 16, 77, 80, None, False),
                (4, 64, 8, 2024, 128, None, True)]:   # internvl2-76b
            q, k, v = flash_inputs(b, h, hkv, s, dh, dtype)
            got = fl.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window)
            want = fl.flash_attention_torch(q, k, v, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            errs["flash_attention"] = max(errs["flash_attention"], check_close(
                f"flash {tag} B{b} H{h}/{hkv} S{s} Dh{dh} "
                f"{'causal' if causal else 'non-causal'} window={window}",
                got, want, dtype))
        for b, h, hkv, s, dh, window, lens in [
                (4, 32, 4, 1032, 128, None, [1, 516, 1032, 1001]),
                (4, 32, 4, 1032, 128, 256, [1032, 700, 255, 1]),
                (2, 8, 2, 1032, 64, None, [1032, 77]),
                (4, 10, 1, 2048, 256, 2048, [2048] * 4),
                (4, 10, 1, 1032, 256, 2048, [1032, 544, 1, 1000]),
                (4, 32, 8, 1032, 160, None, [1, 516, 1032, 1001]),
                (2, 32, 8, 77, 160, None, [77, 40]),
                (4, 32, 2, 1032, 128, None, [1032, 1, 700, 1025]),
                (4, 16, 16, 1032, 128, None, [1032, 77, 1, 1026]),
                (4, 64, 8, 2056, 128, None, [2056, 1549, 1, 2025])]:
            q, kc, vc, lengths = decode_inputs(b, h, hkv, s, dh, lens, dtype)
            got = dec.decode_attention_cuda(q, kc, vc, lengths, window=window)
            want = dec.decode_attention_torch(q, kc, vc, lengths,
                                              window=window)
            torch.cuda.synchronize()
            errs["decode_attention"] = max(errs["decode_attention"],
                                           check_close(
                f"decode {tag} B{b} H{h}/{hkv} S{s} Dh{dh} lengths={lens} "
                f"window={window}", got, want, dtype))
    return flash_inputs, decode_inputs


def ssd_inputs(gen, b, s, h, p, n, dtype, with_h0):
    """Inputs shaped as mamba2's prefill hands them to the kernel."""
    xh = _randn(gen, b, s, h, p, dtype=dtype)
    dt = torch.nn.functional.softplus(_randn(gen, b, s, h,
                                             dtype=torch.float32))
    a = -torch.exp(_randn(gen, h, dtype=torch.float32))
    bc = _randn(gen, b, s, 2 * n, dtype=dtype) * 0.3
    h0 = (_randn(gen, b, h, n, p, dtype=torch.float32) if with_h0
          else None)
    return xh, dt, a, bc[..., :n], bc[..., n:], h0


def rglru_inputs(gen, b, s, w, dtype, with_h0):
    a = (torch.sigmoid(_randn(gen, b, s, w, dtype=torch.float32)) * 0.2
         + 0.8).to(dtype)
    bb = (_randn(gen, b, s, w, dtype=torch.float32) * 0.1).to(dtype)
    h0 = _randn(gen, b, w, dtype=torch.float32) if with_h0 else None
    return a, bb, h0


def kernels_scans(gen, errs):
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ssd

    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).removeprefix("torch.")
        for s, with_h0 in [(1000, True), (1000, False), (512, False),
                           (512, True)] + [(s, h0) for s in (1, 63, 64, 65)
                                           for h0 in (True, False)]:
            args = ssd_inputs(gen, 4, s, 48, 64, 128, dtype, with_h0)
            y, hf = ssd.ssd_scan_cuda(*args)
            y_ref, hf_ref = ssd.ssd_scan_torch(*args)
            torch.cuda.synchronize()
            name = f"ssd_scan {tag} B4 S{s} H48 P64 N128 h0={with_h0}"
            errs["ssd_scan"] = max(
                errs["ssd_scan"], check_scaled(name + " y", y, y_ref,
                                               SSD_TOL),
                check_scaled(name + " h_final", hf, hf_ref, SSD_TOL))
        for s, with_h0 in [(s, h0) for s in (1000, 1, 63, 64, 65, 4096)
                           for h0 in (True, False)]:
            args = rglru_inputs(gen, 4, s, 2560, dtype, with_h0)
            h, hl = rg.rglru_scan_cuda(*args)
            h_ref, hl_ref = rg.rglru_scan_torch(*args)
            torch.cuda.synchronize()
            name = f"rglru_scan {tag} B4 S{s} W2560 h0={with_h0}"
            errs["rglru_scan"] = max(
                errs["rglru_scan"],
                _check(name + " h", h, h_ref, RGLRU_TOL, RGLRU_TOL, 1.0),
                _check(name + " h_last", hl, hl_ref, RGLRU_TOL, RGLRU_TOL,
                       1.0))


def check_bits(name, got, want) -> float:
    """The RoPE kernel repeats its plain version's fp32 arithmetic rounding
    for rounding: raise unless every element is within 1 unit in the last
    place of the output's dtype (logged: how many differ at all).  Returns
    the max abs error."""
    as_int = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    ulps = (got.view(as_int[got.dtype]).long()
            - want.view(as_int[want.dtype]).long()).abs()
    max_err = float((got.float() - want.float()).abs().max())
    differ = int((ulps > 0).sum())
    log(f"  {name}: max_abs_err {max_err:.3e}, {differ} of {ulps.numel()} "
        f"elements differ, by at most {int(ulps.max())} ulp")
    if int(ulps.max()) > 1 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version by more than 1 ulp")
    return max_err


def rope_positions(where: str, b: int, s: int):
    """A prefill's arange shared by the rows, a decode step at a cache of
    3071, or a VLM's text behind its 1024 patches."""
    if where == "prefill":
        return torch.arange(s, device="cuda").expand(b, s)
    if where == "decode":
        return torch.full((b, s), 3071, dtype=torch.int64, device="cuda")
    return torch.arange(1024, 1024 + s, device="cuda").expand(b, s)


def kernels_rope(gen, errs):
    """RoPE against two plain calls at every served head shape, both
    dtypes, a prefill, a decode step and a VLM's offset."""
    from repro_torch.kernels import rope as rp

    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).removeprefix("torch.")
        for path, hd in HEADS.items():
            for where, b, s in (("prefill", 2, 1000), ("decode", 4, 1),
                                ("offset", 2, 77)):
                q = _randn(gen, b, s, hd.h, hd.dh, dtype=dtype)
                k = _randn(gen, b, s, hd.hkv, hd.dh, dtype=dtype)
                pos = rope_positions(where, b, s)
                got = rp.rope_cuda(q, k, pos, 10_000.0)
                want = rp.rope_torch(q, k, pos, 10_000.0)
                torch.cuda.synchronize()
                for part, g, w in zip("qk", got, want):
                    errs["rope"] = max(errs["rope"], check_bits(
                        f"rope {tag} {path} {where} B{b} S{s} H{hd.h}/"
                        f"{hd.hkv} Dh{hd.dh} {part}", g, w))


def phase_kernels() -> dict:
    """Kernels vs plain versions, then times.  Returns (name, path) ->
    record."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.configs import get_config
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rope as rp
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models.layers import _repeat_kv

    log("[3] kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = dict.fromkeys(KERNELS, 0.0)
    flash_inputs, decode_inputs = kernels_attention(gen, errs)
    kernels_scans(gen, errs)
    kernels_rope(gen, errs)

    log("  times at the serving shapes (bf16 weights), card clock:")
    dtype = torch.bfloat16
    records = {}

    # prefill attention: the serve's 1000-token batches of 4 (a VLM's
    # behind its patches)
    for path, (h, hkv, dh, window, causal, s, _) in HEADS.items():
        b = 4
        cost = fl.cost(b, h, hkv, s, dh, causal=causal, window=window)
        sets = copies(lambda: flash_inputs(b, h, hkv, s, dh, dtype), cost[1])
        lib_sets = [(q, _repeat_kv(k.transpose(1, 2), h).transpose(1, 2),
                     _repeat_kv(v.transpose(1, 2), h).transpose(1, 2))
                    for q, k, v in sets]

        def kernel(q, k, v):
            return fl.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window)

        def sdpa(q, k, v):
            # within the window (S < 2048) causal and windowed are one mask
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

        ms = time_ms(kernel, sets, 30)
        dev_ms = device_ms(kernel, sets, 30)
        plain_ms = time_ms(lambda q, k, v: fl.flash_attention_torch(
            q, k, v, causal=causal, window=window), sets[:2], 5)
        sdpa_ms = time_ms(sdpa, lib_sets, 30)
        sdpa_dev = device_ms(sdpa, lib_sets, 30)
        bound = bound_ms(cost, dtype)
        records["flash_attention", path] = record(
            "flash_attention", path,
            f"bf16 B{b} H{h} Hkv{hkv} S{s} Dh{dh} "
            f"{'causal' if causal else 'non-causal'} window={window}",
            errs["flash_attention"], ms, plain_ms, bound, sdpa_ms)
        records["flash_attention", path].update(device_ms=dev_ms,
                                                library_device_ms=sdpa_dev)
        del sets, lib_sets

    # decode attention: the cache of the serve's 1000-token batches
    for path, (h, hkv, dh, window, _, _, s) in HEADS.items():
        if s is None:
            continue  # an encoder: no decode step
        b = 4
        lens = [s] * b
        cost = dec.cost(b, h, hkv, dh, sum(lens))
        sets = copies(lambda: decode_inputs(b, h, hkv, s, dh, lens, dtype),
                      cost[1])
        lib_sets = [(q[:, :, None], _repeat_kv(kc, h).transpose(1, 2),
                     _repeat_kv(vc, h).transpose(1, 2))
                    for q, kc, vc, _ in sets]
        ms = time_ms(lambda *a: dec.decode_attention_cuda(
            *a, window=window), sets, 200)
        dev_ms = device_ms(lambda *a: dec.decode_attention_cuda(
            *a, window=window), sets, 200)
        plain_ms = time_ms(lambda *a: dec.decode_attention_torch(
            *a, window=window), sets, 50)
        sdpa_ms = time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v), lib_sets, 200)
        sdpa_dev = device_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v), lib_sets, 200)
        bound = bound_ms(cost, dtype)
        records["decode_attention", path] = record(
            "decode_attention", path,
            f"bf16 B{b} H{h} Hkv{hkv} S{s} Dh{dh} lengths full "
            f"window={window}", errs["decode_attention"], ms, plain_ms,
            bound, sdpa_ms)
        records["decode_attention", path].update(device_ms=dev_ms,
                                                 library_device_ms=sdpa_dev)
        del sets, lib_sets

    split_sweep(decode_inputs)

    # RoPE: q and k of the serve's 1000-token batches of 4 (a VLM's behind
    # its patches), positions shared by the rows as a prefill has them
    for path, (h, hkv, dh, _, _, s, _) in HEADS.items():
        b, theta = 4, get_config(path).rope_theta
        cost = rp.cost(b, s, h, hkv, dh)
        pos = rope_positions("prefill", b, s)
        sets = copies(lambda: (_randn(gen, b, s, h, dh, dtype=dtype),
                               _randn(gen, b, s, hkv, dh, dtype=dtype), pos),
                      cost[1])

        def kernel(q, k, p):
            return rp.rope_cuda(q, k, p, theta)

        ms = time_ms(kernel, sets, 100)
        dev_ms = device_ms(kernel, sets, 100)
        plain_ms = time_ms(lambda q, k, p: rp.rope_torch(q, k, p, theta),
                           sets, 20)
        plain_dev = device_ms(lambda q, k, p: rp.rope_torch(q, k, p, theta),
                              sets, 20)
        records["rope", path] = record(
            "rope", path, f"bf16 B{b} S{s} H{h} Hkv{hkv} Dh{dh} q and k",
            errs["rope"], ms, plain_ms, bound_ms(cost, dtype), None)
        records["rope", path].update(device_ms=dev_ms,
                                     plain_device_ms=plain_dev)
        del sets

    # SSD scan: mamba2's prefill, bf16 x / B / C, fp32 dt and state
    b, s, h, p, n = 4, 1000, 48, 64, 128
    cost = ssd.cost(b, s, h, p, n, with_h0=True)
    sets = copies(lambda: ssd_inputs(gen, b, s, h, p, n, dtype, True),
                  cost[1])
    ms = time_ms(ssd.ssd_scan_cuda, sets, 20)
    dev_ms = device_ms(ssd.ssd_scan_cuda, sets, 20)
    plain_ms = time_ms(ssd.ssd_scan_torch, sets[:2], 3)
    # the chunked form's products on the tensor cores (bf16 operands)
    bound = bound_ms(cost, torch.bfloat16)
    records["ssd_scan", "mamba2-780m"] = record(
        "ssd_scan", "mamba2-780m",
        f"bf16 x/B/C, fp32 dt/h0 B{b} S{s} H{h} P{p} N{n}", errs["ssd_scan"],
        ms, plain_ms, bound, None)
    records["ssd_scan", "mamba2-780m"]["device_ms"] = dev_ms
    del sets
    # the fp32 path (the parity kernel, CUDA cores) at the same shape: the
    # recurrence's operations in fp32
    cost32 = ssd.cost(b, s, h, p, n, dtype=torch.float32, with_h0=True)
    sets = copies(lambda: ssd_inputs(gen, b, s, h, p, n, torch.float32,
                                     True), cost32[1])
    fp32_ms = time_ms(ssd.ssd_scan_cuda, sets, 10)
    fp32_bound = bound_ms(cost32, torch.float32)
    log(f"  ssd_scan fp32 path (parity kernel) [fp32 x/B/C B{b} S{s} H{h} "
        f"P{p} N{n}]: kernel {fp32_ms:.4f} ms, bound {fp32_bound[0]:.4f} "
        f"ms ({fp32_bound[1]}, fp32 on the CUDA cores)")
    del sets

    # RG-LRU scan: recurrentgemma's prefill, fp32 a and b
    b, s, w = 4, 1000, 2560
    cost = rg.cost(b, s, w, with_h0=True)
    sets = copies(lambda: rglru_inputs(gen, b, s, w, torch.float32, True),
                  cost[1])
    ms = time_ms(rg.rglru_scan_cuda, sets, 50)
    dev_ms = device_ms(rg.rglru_scan_cuda, sets, 50)
    plain_ms = time_ms(rg.rglru_scan_torch, sets[:2], 3)
    bound = bound_ms(cost, torch.float32)
    records["rglru_scan", "recurrentgemma-2b"] = record(
        "rglru_scan", "recurrentgemma-2b", f"fp32 B{b} S{s} W{w}",
        errs["rglru_scan"], ms, plain_ms, bound, None)
    records["rglru_scan", "recurrentgemma-2b"]["device_ms"] = dev_ms
    del sets

    granite_rows(gen, records, errs)

    for r in records.values():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        if "device_ms" in r:
            lib += f"; queued on the card: kernel {r['device_ms']:.4f} ms"
        if "library_device_ms" in r:
            lib += f", library {r['library_device_ms']:.4f} ms"
        if "plain_device_ms" in r:
            lib += f", plain {r['plain_device_ms']:.4f} ms"
        log(f"  {r['name']} ({r['path']}) [{r['shape']}]: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {lib},"
            f" bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return records


def granite_rows(gen, records: dict, errs: dict):
    """granite-4.0-h-small's prefill at its cell's cap (16,384 tokens):
    flash attention at its head shape (H32 / Hkv 8, Dh 128, causal, no
    RoPE) and stated scale 1/128 in the cell's two extreme batches (B2
    S8192 and B8 S2048), the SSD scan at its shape (B2 S8192 H128 P64 N128,
    from the zero state) and the dropless MoE's three grouped expert
    products (16,384 tokens x 10 choices over 72 experts, d 4096, f 768;
    ``models/moe.py::grouped_mm``, ``torch._grouped_mm``); and decode
    attention at the same heads and scale over phase 5's caches (B4, 1032
    slots).  Each against its plain version, timed, beside its bound in
    ms; a time under the bound fails."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import moe
    from repro_torch.models.layers import _repeat_kv

    dtype = torch.bfloat16
    h, hkv, dh, scale = 32, 8, 128, 1 / 128
    group = h // hkv

    def flash_inputs(b, s):
        # the model's layout: (B, S, H, Dh) storage seen as (B, H, S, Dh)
        return tuple(_randn(gen, b, s, n, dh, dtype=dtype).transpose(1, 2)
                     for n in (h, hkv, hkv))

    def kernel(q, k, v):
        return fl.flash_attention_cuda(q, k, v, causal=True, scale=scale)

    def plain(q, k, v):
        # one KV head's queries at a time: B2 S8192's whole fp32 score
        # tensor would take 17 GB
        return torch.cat([fl.flash_attention_torch(
            q[:, j * group:(j + 1) * group], k[:, j:j + 1], v[:, j:j + 1],
            causal=True, scale=scale) for j in range(hkv)], dim=1)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              scale=scale)

    for b, s in ((2, 8192), (8, 2048)):
        shape = f"bf16 B{b} H{h} Hkv{hkv} S{s} Dh{dh} causal scale 1/128"
        cost = fl.cost(b, h, hkv, s, dh)
        sets = copies(lambda: flash_inputs(b, s), cost[1])
        err = check_close(f"flash {shape} (granite)", kernel(*sets[0]),
                          plain(*sets[0]), dtype)
        errs["flash_attention"] = max(errs["flash_attention"], err)
        lib_sets = [(q, _repeat_kv(k.transpose(1, 2), h).transpose(1, 2),
                     _repeat_kv(v.transpose(1, 2), h).transpose(1, 2))
                    for q, k, v in sets[:2]]
        ms = time_ms(kernel, sets, 20)
        dev_ms = device_ms(kernel, sets, 20)
        plain_ms = time_ms(plain, sets[:1], 1)
        sdpa_ms = time_ms(sdpa, lib_sets, 20)
        bound = bound_ms(cost, dtype)
        assert dev_ms >= bound[0], (shape, dev_ms, bound)
        # the longest batch is the row phase 5's launches are counted on
        path = "granite-4.0-h-small" + ("" if s == 8192 else f"@S{s}")
        records["flash_attention", path] = record(
            "flash_attention", path, shape, err, ms, plain_ms, bound,
            sdpa_ms, device_ms=dev_ms,
            library_device_ms=device_ms(sdpa, lib_sets, 20))
        del sets, lib_sets

    b, slots, lens = 4, 1032, [1032, 516, 1, 1001]

    def decode_inputs(lengths):
        return (_randn(gen, b, h, dh, dtype=dtype),
                _randn(gen, b, slots, hkv, dh, dtype=dtype),
                _randn(gen, b, slots, hkv, dh, dtype=dtype),
                torch.tensor(lengths, dtype=torch.int32, device="cuda"))

    def decode(q, kc, vc, lengths):
        return dec.decode_attention_cuda(q, kc, vc, lengths, scale=scale)

    def decode_plain(q, kc, vc, lengths):
        return dec.decode_attention_torch(q, kc, vc, lengths, scale=scale)

    shape = f"bf16 B{b} H{h} Hkv{hkv} S{slots} Dh{dh} scale 1/128"
    q, kc, vc, lengths = decode_inputs(lens)
    err = check_close(f"decode {shape} lengths={lens} (granite)",
                      decode(q, kc, vc, lengths),
                      decode_plain(q, kc, vc, lengths), dtype)
    errs["decode_attention"] = max(errs["decode_attention"], err)
    cost = dec.cost(b, h, hkv, dh, b * slots)
    sets = copies(lambda: decode_inputs([slots] * b), cost[1])
    bound = bound_ms(cost, dtype)
    dev_ms = device_ms(decode, sets, 200)
    assert dev_ms >= bound[0], (shape, dev_ms, bound)
    records["decode_attention", "granite-4.0-h-small"] = record(
        "decode_attention", "granite-4.0-h-small", shape + ", lengths full",
        err, time_ms(decode, sets, 200), time_ms(decode_plain, sets, 50),
        bound, None, device_ms=dev_ms)
    del sets
    b, s, h, p, n = 2, 8192, 128, 64, 128
    cost = ssd.cost(b, s, h, p, n)
    sets = copies(lambda: ssd_inputs(gen, b, s, h, p, n, dtype, False),
                  cost[1])
    y, hf = ssd.ssd_scan_cuda(*sets[0])
    y_ref, hf_ref = ssd.ssd_scan_torch(*sets[0])
    name = f"ssd_scan bf16 B{b} S{s} H{h} P{p} N{n} (granite)"
    errs["ssd_scan"] = max(errs["ssd_scan"],
                           check_scaled(name + " y", y, y_ref, SSD_TOL),
                           check_scaled(name + " h_final", hf, hf_ref,
                                        SSD_TOL))
    del y, hf, y_ref, hf_ref
    ms = time_ms(ssd.ssd_scan_cuda, sets, 10)
    dev_ms = device_ms(ssd.ssd_scan_cuda, sets, 10)
    plain_ms = time_ms(ssd.ssd_scan_torch, sets[:1], 1)
    bound = bound_ms(cost, dtype)
    assert dev_ms >= bound[0], (name, dev_ms, bound)
    records["ssd_scan", "granite-4.0-h-small"] = record(
        "ssd_scan", "granite-4.0-h-small",
        f"bf16 x/B/C, fp32 dt B{b} S{s} H{h} P{p} N{n}, no h0",
        errs["ssd_scan"], ms, plain_ms, bound, None, device_ms=dev_ms)
    del sets

    e, k, d, f, tokens = 72, 10, 4096, 768, 16384
    rows = tokens * k
    ops = 3 * 2 * rows * d * f
    nbytes = 2 * (3 * e * d * f + 3 * rows * d + 3 * rows * f)

    def inputs():
        ids, _ = torch.sort(torch.randint(0, e, (rows,), device="cuda",
                                          generator=gen))
        ends = torch.searchsorted(ids, torch.arange(e, device="cuda"),
                                  right=True).to(torch.int32)
        x = _randn(gen, rows, d, dtype=dtype)
        w = [(_randn(gen, e, a, c, dtype=torch.float32) * a ** -0.5).to(dtype)
             for a, c in ((d, f), (d, f), (f, d))]
        return x, ends, *w

    def grouped(x, ends, wg, wu, wd):
        g = torch.nn.functional.silu(moe.grouped_mm(x, wg, ends).float())
        return moe.grouped_mm(g.to(dtype) * moe.grouped_mm(x, wu, ends), wd,
                              ends)

    def per_expert(x, ends, wg, wu, wd):
        out, start = torch.empty_like(x), 0
        for i, end in enumerate(ends.tolist()):
            xe = x[start:end]
            g = torch.nn.functional.silu((xe @ wg[i]).float())
            out[start:end] = (g.to(dtype) * (xe @ wu[i])) @ wd[i]
            start = end
        return out

    sets = [inputs() for _ in range(2)]
    got, want = grouped(*sets[0]), per_expert(*sets[0])
    err = float((got.float() - want.float()).abs().max())
    log(f"  grouped experts bf16 {tokens} x {k} over {e} experts, d {d} f "
        f"{f}: max |grouped - a product an expert| {err:.3g}")
    assert err == 0.0, "grouped products differ from the per-expert ones"
    del got, want
    ms = time_ms(grouped, sets, 10)
    dev_ms = device_ms(grouped, sets, 10)
    plain_ms = time_ms(per_expert, sets[:1], 2)
    bound = bound_ms((ops, nbytes), dtype)
    assert dev_ms >= bound[0], ("grouped experts", dev_ms, bound)
    records["grouped_experts", "granite-4.0-h-small"] = dict(
        name="grouped_experts", path="granite-4.0-h-small",
        route="torch._grouped_mm", source="src/repro_torch/models/moe.py",
        replaces="none (the JAX package's static-capacity einsum)",
        shape=f"bf16 {tokens} tokens x {k} over {e} experts, d {d} f {f}, "
              "gate, up and down", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
        library_ms=None, device_ms=dev_ms)
    del sets


def split_sweep(decode_inputs):
    """Decode time by cache splits per (row, KV head), bf16, batch 4, every
    slot valid: the serving caches (1032 slots) and the full 2048-slot
    ring; ``split_plan``'s choice is marked with *."""
    from repro_torch.kernels import decode_attention as dec

    log("  decode_attention us per call by splits, queued on the card / "
        "called back to back (CUDA events); bf16, B4, all slots valid; "
        "* = split_plan:")
    for path, (h, hkv, dh, window, _, _, slots) in HEADS.items():
        if slots is None:
            continue  # an encoder: no decode step
        for s in sorted({slots, 2048}):
            b = 4
            nbytes = dec.cost(b, h, hkv, dh, b * s)[1]
            sets = copies(lambda: decode_inputs(b, h, hkv, s, dh, [s] * b,
                                                torch.bfloat16), nbytes)
            plan = dec.split_plan(b, hkv, s, h // hkv)[0]
            row = []
            for n in sorted({1, 2, 4, 6, 8, 12, 16, plan}):
                def call(*a, n=n):
                    return dec.decode_attention_cuda(*a, window=window,
                                                     n_split=n)
                row.append(f"{n}{'*' if n == plan else ''} "
                           f"{device_ms(call, sets, 200) * 1e3:.2f}"
                           f"/{time_ms(call, sets, 300) * 1e3:.2f}")
            log(f"    {path} Hkv{hkv} G{h // hkv} Dh{dh} S{s} (bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e6:.2f}): {', '.join(row)}")
            del sets


# the calls of ``models/moe.py::grouped_mm`` (one ``torch._grouped_mm``
# launch each on the card), counted once ``count_grouped`` wraps it
GROUPED = types.SimpleNamespace(launches=0)


def count_grouped():
    """Count every ``moe.grouped_mm`` call in ``GROUPED.launches`` (the
    dropless dispatch calls it by the module's name)."""
    from repro_torch.models import moe
    inner = moe.grouped_mm
    if getattr(inner, "counted", False):
        return

    def grouped_mm(*args):
        GROUPED.launches += 1
        return inner(*args)

    grouped_mm.counted = True
    moe.grouped_mm = grouped_mm


def counters() -> dict:
    """name -> the module (or namespace) whose ``launches`` counts that
    kernel."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rope as rp
    from repro_torch.kernels import ssd_scan as ssd
    count_grouped()
    return {"flash_attention": fl, "decode_attention": dec, "ssd_scan": ssd,
            "rglru_scan": rg, "rope": rp, "grouped_experts": GROUPED}


def n_attn(cfg) -> int:
    """Layers with attention (an MoE layer has it before its experts)."""
    from repro_torch.models.config import ATTN_KINDS
    return sum(k in ATTN_KINDS for k in cfg.layer_types())


def expected_launches(cfg, prefill_batches: int, decode_steps: int) -> dict:
    """One launch per layer of the kernel's kind per prefill batch (flash,
    the scans: ``ssd_scan`` in both Mamba-2 kinds) or per decode step
    (decode attention); RoPE once per attention layer in both where the
    model has it; a dropless MoE layer's three grouped products in both."""
    from repro_torch.models.config import MOE_KINDS
    kinds = cfg.layer_types()
    steps = prefill_batches + decode_steps
    rope = cfg.position_embedding == "rope"
    dropless = sum(k in MOE_KINDS for k in kinds) if cfg.moe_dropless else 0
    return {"flash_attention": n_attn(cfg) * prefill_batches,
            "decode_attention": n_attn(cfg) * decode_steps,
            "ssd_scan": (kinds.count("ssm") + kinds.count("mamba2"))
            * prefill_batches,
            "rglru_scan": kinds.count("rglru") * prefill_batches,
            "rope": n_attn(cfg) * steps * rope,
            "grouped_experts": 3 * dropless * steps}


def moe_inputs(model) -> list:
    """(layer, input) of every MoE layer call of ``model`` from now on."""
    seen = []
    for i, block in enumerate(model.layers):
        if hasattr(block, "moe"):
            block.moe.register_forward_hook(
                lambda mod, args, out, i=i: seen.append((i, args[0])))
    return seen


def check_routing(arch, card, cpu, seen_card, seen_cpu):
    """Each token's top-k experts, in order, in every MoE layer call: the
    card's from its own layer inputs against the CPU's from its own.  Every
    differing decision is printed with the CPU's probability gap between
    the expert it ranked at the first differing slot and the next one; a
    difference at a gap above ``ROUTING_GAP`` fails."""
    from repro_torch.models.moe import route
    k = cpu.cfg.top_k
    decisions, gaps = 0, []
    for (i, x_card), (j, x_cpu) in zip(seen_card, seen_cpu, strict=True):
        assert i == j
        d = x_cpu.shape[-1]
        _, _, ids_card = route(card.layers[i].moe, x_card.reshape(-1, d),
                               card.cfg)
        probs, _, ids_cpu = route(cpu.layers[i].moe, x_cpu.reshape(-1, d),
                                  cpu.cfg)
        ranked = torch.topk(probs, k + 1, dim=-1).values
        differ = ids_card.cpu() != ids_cpu
        decisions += ids_cpu.shape[0]
        for t in differ.any(-1).nonzero()[:, 0].tolist():
            slot = int(differ[t].nonzero()[0, 0])
            gap = float(ranked[t, slot] - ranked[t, slot + 1])
            gaps.append(gap)
            log(f"    routing differs: layer {i}, token {t}, slot {slot}: "
                f"card {ids_card[t].tolist()} cpu {ids_cpu[t].tolist()}, "
                f"CPU probability gap {gap:.3e}")
    log(f"    routing: {decisions} top-{k} decisions (token x layer call), "
        f"{len(gaps)} differ" + (f", largest gap {max(gaps):.3e}"
                                 if gaps else ""))
    if any(g > ROUTING_GAP for g in gaps):
        raise AssertionError(f"{arch}: card and CPU route tokens to other "
                             "experts where they are not near a tie")
    seen_card.clear()
    seen_cpu.clear()


def parity(arch: str, n_layers: int, runs):
    """Card vs CPU, fp32, full width, ``n_layers`` layers.  ``runs``:
    (batch, prompt length) pairs; each prefills (a VLM's patches before
    the prompt) and decodes 3 tokens, or, for an encoder, runs one forward
    over that many frames.  An MoE model's routing is compared first.
    Patches and frames are numpy normals from the same seed as the
    prompt."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    card = Model(cfg, dtype=torch.float32, device="cuda")
    card.init(torch.Generator(device="cuda").manual_seed(0))
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    cpu.load_state_dict(card.state_dict())  # copied across devices
    seen_card, seen_cpu = moe_inputs(card), moe_inputs(cpu)
    mods = counters()
    n_patches = cfg.n_frontend_tokens if cfg.arch_type == "vlm" else 0
    decode_steps = 3 if cfg.has_decoder else 0
    for b, s in runs:
        log(f"  {arch}, {n_layers} layers, B{b} "
            + (f"{n_patches} patches + " if n_patches else "")
            + (f"prompt {s}:" if cfg.has_decoder else f"{s} frames:"))
        rng = np.random.default_rng(s)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 3)))
        before = {k: m.launches for k, m in mods.items()}
        with torch.inference_mode():
            if not cfg.has_decoder:
                frames = torch.from_numpy(rng.standard_normal(
                    (b, s, cfg.d_model), np.float32))
                outs = [((card.forward(frame_embeds=frames.cuda()), None),
                         (cpu.forward(frame_embeds=frames), None))]
            else:
                patches = (torch.from_numpy(rng.standard_normal(
                    (b, n_patches, cfg.d_model), np.float32))
                    if n_patches else None)
                size = n_patches + s + 3
                c_card, c_cpu = card.init_cache(b, size), cpu.init_cache(
                    b, size)
                outs = [(card.prefill(toks[:, :s].cuda(), c_card,
                                      patch_embeds=None if patches is None
                                      else patches.cuda()),
                         cpu.prefill(toks[:, :s], c_cpu,
                                     patch_embeds=patches))]
            for i in range(s, s + decode_steps):
                (_, c_card), (_, c_cpu) = outs[-1]
                outs.append((card.decode_step(c_card,
                                              toks[:, i:i + 1].cuda()),
                             cpu.decode_step(c_cpu, toks[:, i:i + 1])))
        if "moe" in cfg.layer_types():
            if not seen_cpu:
                raise AssertionError(f"{arch}: no MoE layer input was seen, "
                                     "so the routing was not compared")
            check_routing(arch, card, cpu, seen_card, seen_cpu)
        # fp32 on both sides (TF32 off); the sums over d_model and d_ff run
        # in another order on the card, so the bound is relative to the
        # logits' scale.
        for step, ((got, _), (want, _)) in enumerate(outs):
            err = float((got.cpu() - want).abs().max())
            scale = float(want.abs().max())
            what = ("forward" if not cfg.has_decoder else "prefill"
                    if step == 0 else f"decode {step}")
            log(f"    {what}: max abs err {err:.3e} = {err / scale:.2e} of "
                f"max |logit| {scale:.3f}")
            if not err <= PARITY_REL * scale:
                raise AssertionError(f"{arch}: card and CPU logits disagree")
        rose = {k: m.launches - before[k] for k, m in mods.items()}
        want = expected_launches(cfg, 1, decode_steps)
        log(f"    kernel launches {rose}")
        if rose != want:
            raise AssertionError(f"{arch}: parity run did not go through "
                                 f"the kernels: {rose}, expected {want}")
        del outs
    del card, cpu
    torch.cuda.empty_cache()


def phase_parity():
    log("[4] model parity: full width, fp32, card vs CPU")
    parity("yi-9b", 2, [(2, 77)])
    parity("stablelm-12b", 2, [(2, 77)])
    parity("chatglm3-6b", 2, [(2, 77)])
    parity("mamba2-780m", 2, [(2, 77)])
    parity("deepseek-moe-16b", 2, [(2, 77)])
    parity("recurrentgemma-2b", 3, [(2, 77), (1, 2100)])
    parity("hubert-xlarge", 2, [(2, 1000), (1, 77)])
    parity("internvl2-76b", 2, [(2, 77)])
    parity("command-r-35b", 2, [(2, 77)])


def serve_one(arch: str, records: dict, combos: list, rows: list):
    """Serve ``arch``, then run its dry-run ``combos`` on the same model
    (``dryrun_on_card``), each a row of ``rows``."""
    from repro_torch.configs import get_config
    from repro_torch.serving import executor

    layers = LAYERS.get(arch)
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers or cfg.n_layers)
    log(f"  {arch} ({cfg.n_layers} layers"
        + (f" of {get_config(arch).n_layers}" if layers else "") + "):")
    mods = counters()
    torch.cuda.reset_peak_memory_stats()
    before = cuda_bytes()
    model = executor.build_model(arch, seed=0, device="cuda", smoke=False,
                                 n_layers=layers)
    param_bytes = tuple(a - b for a, b in zip(cuda_bytes(), before))
    for m in mods.values():
        m.launches = 0
    rep = executor.serve_model(
        model, requests=8, batch=4, prompt_lens=(512, 1000), output_len=32,
        seed=0, reduced=executor.depth_reduction(arch, layers, "cuda",
                                                 smoke=False))
    counts = {k: m.launches for k, m in mods.items()}
    # a clip is answered with a label per frame, a prompt with 32 tokens
    lengths = ([512, 1000] * 4 if rep.encoder else [32] * 8)
    if [len(r.tokens) for r in rep.results] != lengths or not all(
            0 <= t < cfg.vocab_size for r in rep.results for t in r.tokens):
        what = "a label per frame" if rep.encoder else "32 tokens"
        raise AssertionError(f"{arch}: a request was not answered with "
                             f"{what}")
    if not rep.all_finite:
        raise AssertionError(f"{arch}: non-finite logits")
    want = expected_launches(cfg, rep.prefill_batches, rep.decode_steps)
    log(f"    launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError(f"{arch}: kernel launch counts do not match "
                             "the path")
    for name, n in counts.items():
        # an arch's rows of one kernel: its path, and ``path@shape``
        rows = [r for (kernel, path), r in records.items()
                if kernel == name and path.split("@")[0] == arch]
        for r in rows:
            r["launches"] = n
        if n and not rows:
            raise AssertionError(f"{arch}: {name} launched but not timed")
    s = rep.summary()
    peak = f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB"
    if rep.encoder:
        log(f"    {s['ms_per_batch']:.1f} ms a batch of 4 clips "
            f"({', '.join(f'{t:.1f}' for t in rep.batch_ms)}), "
            f"{s['frames_per_s']:.0f} frames/s, labels out p50 "
            f"{s['ttft_ms_p50']:.1f} ms (max {s['ttft_ms_max']:.1f}), {peak}")
    else:
        log(f"    TTFT p50 {s['ttft_ms_p50']:.1f} ms (max "
            f"{s['ttft_ms_max']:.1f}), decode {s['decode_ms_per_step']:.2f}"
            f" ms/step, {s['tokens_per_s']:.1f} tokens/s, {peak}")
    for cut in s["reduced"]:
        log(f"    reduced: {cut}")
    log(f"    request 0 tokens: {rep.results[0].tokens[:8]} ...")
    del rep
    torch.cuda.empty_cache()
    for rec in combos:
        rows.append(dryrun_on_card(model, rec, param_bytes))
    del model
    torch.cuda.empty_cache()


def phase_serve(records: dict, dry: subprocess.Popen):
    log("[5] serve at full width (bf16), 8 requests, batch 4, prompts "
        "512/1000 (internvl2-76b's behind 1024 patches; hubert-xlarge's "
        "clips of 512/1000 frames), 32 output tokens; after each model, "
        "the dry run's combinations of it that fit the card")
    plan = plan_dryrun(finish_dryrun(dry))
    rows = []
    t0 = time.perf_counter()
    for arch in SERVED:
        serve_one(arch, records, plan.pop(arch, []), rows)
    if plan:
        raise AssertionError(f"combinations of models not served: {plan}")
    missing = [k for k, r in records.items() if "launches" not in r]
    if missing:
        raise AssertionError(f"no served path launched {missing}")
    spent = sum(r["wall_s"] for r in rows)
    log(f"  the dry run on the card: {len(rows)} combinations in "
        f"{spent:.1f} s of this phase's {time.perf_counter() - t0:.1f} s:")
    log("    arch x shape: arguments predicted / asked / allocated on the "
        "card (GB), peak predicted / allocated on the card (GB), step ms "
        "(CUDA events), device busy ms vs the roofline's compute and memory "
        "ms, kernel launches")
    for r in rows:
        log(f"    {r['arch']} x {r['shape']}: {r['args_pred'] / 1e9:.3f} / "
            f"{r['args_asked'] / 1e9:.3f} / {r['args_card'] / 1e9:.3f}, "
            f"{r['peak_pred'] / 1e9:.3f} / "
            f"{r['peak_card'] / 1e9:.3f}, {r['ms']:.2f} ms, busy "
            f"{r['busy_ms']:.2f} ms vs {r['compute_ms']:.3f} / "
            f"{r['memory_ms']:.3f} ms, {r['launches']}")


# ------------------------------------------------------------- dry run ----


def start_dryrun() -> subprocess.Popen:
    """``python -m repro_torch.launch.dryrun --all`` into ``DRYRUN_OUT``, in
    a process of its own that never touches the card (host work: about a
    minute of one core), started before the card's first phase."""
    DRYRUN_OUT.parent.mkdir(parents=True, exist_ok=True)
    DRYRUN_OUT.unlink(missing_ok=True)
    return start_host("repro_torch.launch.dryrun", "--all", "--out",
                      str(DRYRUN_OUT))


def finish_dryrun(proc: subprocess.Popen) -> list:
    """Waits for the sweep, checks it (exit 0, ``done: 38 ok, 2 skipped,
    0 failed``, 40 records) and prints its records as a table."""
    rc = proc.wait()
    proc.out.seek(0)
    lines = proc.out.read().splitlines()
    proc.out.close()
    recs = [json.loads(line) for line in DRYRUN_OUT.read_text().splitlines()]
    if rc or not lines or lines[-1] != "done: 38 ok, 2 skipped, 0 failed" \
            or len(recs) != 40:
        raise AssertionError(f"the dry run exited {rc}: {lines[-5:]}")
    log(f"  the dry run (launch/dryrun.py --all, meta device, host): "
        f"{lines[-1]}; by arch x shape: step, arguments (params + cache + "
        "batch (+ AdamW)), temps, outputs, peak (decimal GB), fits one card "
        "(80 GB), FLOPs, eager bytes, roofline compute / memory s, trace s")
    for r in recs:
        if r["status"] != "ok":
            log(f"    {r['arch']} x {r['shape']}: {r['status']} "
                f"({r['reason']})")
            continue
        m, roof = r["memory"], r["roofline"]
        log(f"    {r['arch']} x {r['shape']}: {r['step_kind']}, "
            f"{m['argument_size_in_bytes'] / 1e9:.1f} ("
            + " + ".join(f"{v / 1e9:.1f}" for v in
                         r["argument_bytes"].values())
            + f"), {m['temp_size_in_bytes'] / 1e9:.1f}, "
            f"{m['output_size_in_bytes'] / 1e9:.2f}, "
            f"{m['peak_bytes'] / 1e9:.1f}, {r['fits_one_card']}, "
            f"{r['flops']:.3g}, {r['bytes']:.3g}, {roof['compute_s']:.4g} / "
            f"{roof['memory_s']:.4g}, {r['trace_s']}")
    return recs


def plan_dryrun(recs: list) -> dict:
    """arch -> the records to run on the card: every combination that fits
    one card, a prefill only within ``DRYRUN_BUDGET_S`` (the cheapest
    always); those left out are logged."""
    fit = [r for r in recs if r["status"] == "ok" and r["fits_one_card"]]

    def expected_s(r):
        roof = r["roofline"]
        return 2 * DRYRUN_SLOWDOWN * max(roof["compute_s"], roof["memory_s"])

    chosen = [r for r in fit if r["step_kind"] == "decode"]
    left = DRYRUN_BUDGET_S - sum(expected_s(r) for r in chosen)
    for i, r in enumerate(sorted((r for r in fit
                                  if r["step_kind"] != "decode"),
                                 key=expected_s)):
        if i == 0 or expected_s(r) <= left:
            chosen.append(r)
            left -= expected_s(r)
        else:
            log(f"  not run on the card: {r['arch']} x {r['shape']} (fits; "
                f"expected {expected_s(r):.0f} s, {max(left, 0):.0f} s of "
                f"the {DRYRUN_BUDGET_S:.0f} s left)")
    log("  to run on the card: " + ", ".join(
        f"{r['arch']} x {r['shape']}" for r in chosen))
    plan: dict = {}
    for r in chosen:
        plan.setdefault(r["arch"], []).append(r)
    return plan


def cuda_bytes() -> tuple[int, int]:
    """(bytes the tensors on the card asked for, bytes the caching
    allocator gave them): ``requested_bytes`` and ``allocated_bytes``.
    The allocator rounds a request up to 512 B, and gives a large one the
    whole block (up to 1 MiB more) where the rest is too small to split."""
    st = torch.cuda.memory_stats()
    return (st["requested_bytes.all.current"],
            st["allocated_bytes.all.current"])


def dryrun_on_card(model, rec: dict, param_bytes: tuple) -> dict:
    """One dry-run combination on the card, on the served model (its
    parameters took ``param_bytes``, ``cuda_bytes``'s pair): its arguments
    at the record's shapes (zeros: ``launch/specs.py``), the step once
    timed by CUDA events, then once traced by the profiler.  Fails unless
    the bytes the arguments asked the allocator for are the record's, the
    allocated peak (``max_memory_allocated``) within ``DRYRUN_PEAK_TOL`` of
    the record's, the device busy time at least the roofline's compute
    time, every logit finite and each kernel launched once per layer of
    its kind, as the record's calls."""
    from torch.profiler import ProfilerActivity
    from torch.utils._pytree import tree_leaves

    from repro_torch.launch import dryrun, specs
    from repro_torch.serving.profile import traced

    cfg, shape = model.cfg, rec["shape"]

    def fresh():
        """(kind, step, arguments) on new arguments at the record's
        shapes."""
        kind, args = specs.input_specs(cfg, shape, model=model)
        return (kind, *dryrun.build_step(
            model, kind, args, specs.INPUT_SHAPES[shape]["seq_len"]))

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    base = cuda_bytes()
    kind, step, arguments = fresh()
    asked, args_card = (p + a - b for p, a, b in zip(param_bytes,
                                                     cuda_bytes(), base))
    n_tensors = len({t.untyped_storage().data_ptr() for t in
                     tree_leaves(arguments) if isinstance(t, torch.Tensor)})
    del arguments
    mem = rec["memory"]
    args_pred, peak_pred = mem["argument_size_in_bytes"], mem["peak_bytes"]
    mods = counters()
    for m in mods.values():
        m.launches = 0
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = step()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    peak_card = (torch.cuda.max_memory_allocated() - base[1]
                 + param_bytes[1])
    counts = {k: m.launches for k, m in mods.items()}
    logits = out[0] if isinstance(out, tuple) else out
    finite = bool(torch.isfinite(logits).all())
    # the second run gets new arguments, allocated as the first's were:
    # the states the first step wrote sit in the blocks it freed, where
    # they split the large ones its second step would ask for again
    del out, logits, step
    torch.cuda.empty_cache()
    _, step, arguments = fresh()
    del arguments
    prof = traced(f"{rec['arch']} x {shape}", 1, step,
                  [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  torch.device("cuda"), None)
    torch.cuda.synchronize()
    del step
    torch.cuda.empty_cache()
    busy = prof["device_busy_ms_per_step"]
    if isinstance(busy, str):
        raise AssertionError(f"{rec['arch']} x {shape}: the profiler saw "
                             f"no device time in the step ({busy})")
    roof = rec["roofline"]
    row = dict(arch=rec["arch"], shape=shape, args_pred=args_pred,
               args_asked=asked, args_card=args_card, peak_pred=peak_pred,
               peak_card=peak_card,
               ms=ms, busy_ms=busy,
               compute_ms=roof["compute_s"] * 1e3,
               memory_ms=roof["memory_s"] * 1e3,
               launches={k: v for k, v in counts.items() if v},
               wall_s=time.perf_counter() - t0)
    steps = (0, 1) if kind == "decode" else (1, 0)
    want = expected_launches(cfg, *steps)
    calls = {k: v["calls"] for k, v in rec["kernels"].items()}
    log(f"    dry run {rec['arch']} x {shape} ({kind}): arguments "
        f"{asked} bytes asked of the card's allocator, {args_card} given "
        f"({n_tensors} tensors), record {args_pred}; peak {peak_card} "
        f"bytes allocated, record {peak_pred} "
        f"({peak_card / peak_pred - 1:+.2%}); {ms:.2f} ms, device busy "
        f"{row['busy_ms']:.2f} ms, roofline compute {row['compute_ms']:.3f} "
        f"ms / memory {row['memory_ms']:.3f} ms; launches {counts}, the "
        f"record's calls {calls}; {row['wall_s']:.1f} s")
    if asked != args_pred or args_card < asked:
        raise AssertionError(f"{rec['arch']} x {shape}: the arguments asked "
                             f"for {asked} bytes on the card ({args_card} "
                             f"given), the record says {args_pred}")
    if not abs(peak_card - peak_pred) <= DRYRUN_PEAK_TOL * peak_pred:
        raise AssertionError(f"{rec['arch']} x {shape}: peak {peak_card} "
                             f"bytes on the card, {peak_pred} predicted")
    if not row["busy_ms"] >= row["compute_ms"]:
        raise AssertionError(f"{rec['arch']} x {shape}: busy "
                             f"{row['busy_ms']} ms under the roofline's "
                             "compute time: the FLOPs are overcounted")
    if not finite:
        raise AssertionError(f"{rec['arch']} x {shape}: non-finite logits")
    if counts != want or row["launches"] != calls:
        raise AssertionError(f"{rec['arch']} x {shape}: launches {counts}, "
                             f"expected {want}, the record's {calls}")
    return row


# ------------------------------------------------------- partitions ----


def splits_disjoint(part_mod, total: int):
    """Each carve of the card: two partitions whose probe SM sets are
    disjoint, each of the count the CUDA driver granted, together the
    card; the mirrored split is the same carve, sides swapped."""
    from repro_torch.core.h100lets import CARVES
    for left in CARVES:
        a, b = part_mod.split(left)
        ia, ib = part_mod.sm_ids(a), part_mod.sm_ids(b)
        log(f"  carve {left}/{100 - left}: {a.sms} + {b.sms} SMs granted, "
            f"probe saw {len(ia)} + {len(ib)}, shared {len(ia & ib)}")
        if ia & ib or (len(ia), len(ib)) != (a.sms, b.sms) or \
                a.sms + b.sms != total:
            raise AssertionError(f"carve {left}: SM sets not disjoint or "
                                 "not the granted counts")
        if left != 50 and part_mod.split(100 - left) != (b, a):
            raise AssertionError(f"split {100 - left} is not the mirror of "
                                 f"carve {left}")


def kernels_on_partition(part, records: dict, errs: dict):
    """Each kernel at its serving shapes, launched first on the whole card
    and then on ``part``, against its plain version; its time on ``part``
    goes into its records as ``partition_ms``."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rope as rp
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device="cuda").manual_seed(1)
    dtype = torch.bfloat16
    tag = f"on {part.sms} SMs"

    def both(kernel, *args, **kw):
        kernel(*args, **kw)  # the whole card first
        torch.cuda.synchronize()
        with part:
            out = kernel(*args, **kw)
            part.synchronize()
        return out

    def time_on_part(fn, sets, iters):
        with part:
            return time_ms(fn, sets, iters)

    for path, (h, hkv, dh, window, causal, s, slots) in HEADS.items():
        b = 4
        mask = dict(causal=causal, window=window)
        q, k, v = (_randn(gen, b, s, n, dh, dtype=dtype).transpose(1, 2)
                   for n in (h, hkv, hkv))
        got = both(fl.flash_attention_cuda, q, k, v, **mask)
        errs["flash_attention"] = max(errs["flash_attention"], check_close(
            f"flash {tag} bf16 B{b} H{h}/{hkv} S{s} Dh{dh} {mask}", got,
            fl.flash_attention_torch(q, k, v, **mask), dtype))
        sets = copies(lambda: tuple(
            _randn(gen, b, s, n, dh, dtype=dtype).transpose(1, 2)
            for n in (h, hkv, hkv)), fl.cost(b, h, hkv, s, dh, **mask)[1])
        records["flash_attention", path]["partition_ms"] = time_on_part(
            lambda q, k, v: fl.flash_attention_cuda(q, k, v, **mask),
            sets, 30)
        # RoPE on the same q and k, in the model's (B, S, H, Dh) layout
        pos = rope_positions("prefill", b, s)
        got = both(rp.rope_cuda, q.transpose(1, 2), k.transpose(1, 2), pos,
                   10_000.0)
        for part_name, g, w in zip("qk", got, rp.rope_torch(
                q.transpose(1, 2), k.transpose(1, 2), pos, 10_000.0)):
            errs["rope"] = max(errs["rope"], check_bits(
                f"rope {tag} B{b} S{s} H{h}/{hkv} Dh{dh} {part_name}", g, w))
        records["rope", path]["partition_ms"] = time_on_part(
            lambda q, k, v: rp.rope_cuda(q.transpose(1, 2), k.transpose(1, 2),
                                         pos, 10_000.0), sets, 100)
        del sets
        if slots is None:
            continue  # an encoder: no decode step
        s = slots
        lens = [s, 1, 517, 1000]
        q = _randn(gen, b, h, dh, dtype=dtype)
        kc, vc = (_randn(gen, b, s, hkv, dh, dtype=dtype) for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = both(dec.decode_attention_cuda, q, kc, vc, lengths,
                   window=window)
        errs["decode_attention"] = max(errs["decode_attention"], check_close(
            f"decode {tag} bf16 B{b} H{h}/{hkv} S{s} Dh{dh}", got,
            dec.decode_attention_torch(q, kc, vc, lengths, window=window),
            dtype))
        full = torch.full((b,), s, dtype=torch.int32, device="cuda")
        sets = copies(lambda: (
            _randn(gen, b, h, dh, dtype=dtype),
            _randn(gen, b, s, hkv, dh, dtype=dtype),
            _randn(gen, b, s, hkv, dh, dtype=dtype), full),
            dec.cost(b, h, hkv, dh, b * s)[1])
        records["decode_attention", path]["partition_ms"] = time_on_part(
            lambda *a: dec.decode_attention_cuda(*a, window=window),
            sets, 200)
        del sets
    # every (head dim, group) the decode kernel is built for, with the
    # largest cluster the partition holds
    for dh, groups in sorted(dec.GROUPS.items()):
        for g in groups:
            b, hkv, s = 4, 2, 1032
            q = _randn(gen, b, hkv * g, dh, dtype=dtype)
            kc, vc = (_randn(gen, b, s, hkv, dh, dtype=dtype)
                      for _ in range(2))
            lengths = torch.tensor([s, 1, 517, 1000], dtype=torch.int32,
                                   device="cuda")
            got = both(dec.decode_attention_cuda, q, kc, vc, lengths)
            with part:
                limit = dec.max_cluster(dtype, dh, g)
            plan = dec.split_plan(b, hkv, s, g, sms=part.sms,
                                  max_split=limit)
            errs["decode_attention"] = max(
                errs["decode_attention"], check_close(
                    f"decode {tag} G{g} Dh{dh} (clusters up to {limit}, "
                    f"plan {plan[0]} splits)", got,
                    dec.decode_attention_torch(q, kc, vc, lengths), dtype))

    args = ssd_inputs(gen, 4, 1000, 48, 64, 128, dtype, True)
    y, hf = both(ssd.ssd_scan_cuda, *args)
    y_ref, hf_ref = ssd.ssd_scan_torch(*args)
    errs["ssd_scan"] = max(
        errs["ssd_scan"],
        check_scaled(f"ssd_scan {tag} B4 S1000 y", y, y_ref, SSD_TOL),
        check_scaled(f"ssd_scan {tag} B4 S1000 h_final", hf, hf_ref,
                     SSD_TOL))
    b, s, h, p, n = 4, 1000, 48, 64, 128
    sets = copies(lambda: ssd_inputs(gen, b, s, h, p, n, dtype, True),
                  ssd.cost(b, s, h, p, n, with_h0=True)[1])
    records["ssd_scan", "mamba2-780m"]["partition_ms"] = time_on_part(
        ssd.ssd_scan_cuda, sets, 20)
    del sets
    for s in (1000, 4096):
        args = rglru_inputs(gen, 4, s, 2560, torch.float32, True)
        h, hl = both(rg.rglru_scan_cuda, *args)
        h_ref, hl_ref = rg.rglru_scan_torch(*args)
        errs["rglru_scan"] = max(
            errs["rglru_scan"],
            _check(f"rglru_scan {tag} B4 S{s} h", h, h_ref, RGLRU_TOL,
                   RGLRU_TOL, 1.0),
            _check(f"rglru_scan {tag} B4 S{s} h_last", hl, hl_ref,
                   RGLRU_TOL, RGLRU_TOL, 1.0))
    sets = copies(lambda: rglru_inputs(gen, 4, 1000, 2560, torch.float32,
                                       True), rg.cost(4, 1000, 2560)[1])
    records["rglru_scan", "recurrentgemma-2b"]["partition_ms"] = \
        time_on_part(rg.rglru_scan_cuda, sets, 50)
    del sets
    for r in records.values():
        r["partition_sms"] = part.sms


def scans_in_corun(part_mod, errs: dict):
    """Both scans in flight at once on the two sides of the 20/80 split,
    each on either side, ten calls each, every result against its plain
    version: the RG-LRU look-back (a bounded spin) and the SSD scan's
    waves on fewer SMs beside another partition's work."""
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator(device="cuda").manual_seed(2)
    rg_args = rglru_inputs(gen, 4, 4096, 2560, torch.float32, True)
    ssd_args = ssd_inputs(gen, 4, 1000, 48, 64, 128, torch.bfloat16, True)
    rg_want, ssd_want = rg.rglru_scan_torch(*rg_args), ssd.ssd_scan_torch(
        *ssd_args)
    small, large = part_mod.split(20)
    for rg_part, ssd_part in ((small, large), (large, small)):
        outs = []
        for _ in range(10):
            with rg_part:
                rg_out = rg.rglru_scan_cuda(*rg_args)
            with ssd_part:
                outs.append((rg_out, ssd.ssd_scan_cuda(*ssd_args)))
        rg_part.synchronize()
        ssd_part.synchronize()
        tag = (f"co-run: RG-LRU on {rg_part.sms} SMs beside SSD on "
               f"{ssd_part.sms}")
        for i, ((h, hl), (y, hf)) in enumerate(outs):
            quiet = i < len(outs) - 1
            errs["rglru_scan"] = max(
                errs["rglru_scan"],
                _check(f"{tag}: rglru_scan S4096 h", h, rg_want[0],
                       RGLRU_TOL, RGLRU_TOL, 1.0, quiet),
                _check(f"{tag}: rglru_scan S4096 h_last", hl, rg_want[1],
                       RGLRU_TOL, RGLRU_TOL, 1.0, quiet))
            errs["ssd_scan"] = max(
                errs["ssd_scan"],
                _check(f"{tag}: ssd_scan S1000 y", y, ssd_want[0], SSD_TOL,
                       SSD_TOL, float(ssd_want[0].abs().max()) + 1e-9,
                       quiet),
                _check(f"{tag}: ssd_scan S1000 h_final", hf, ssd_want[1],
                       SSD_TOL, SSD_TOL, float(ssd_want[1].abs().max())
                       + 1e-9, quiet))


def grid_launches(records) -> int:
    """Decode-attention launches the grid makes: each cell runs
    ``EAGER_RUNS`` + 1 eager steps and one captured step (graph replays do
    not pass through the wrapper), one launch per attention layer."""
    from repro_torch.configs import get_config
    from repro_torch.launch import profile_partitions as pp
    steps = pp.EAGER_RUNS + 2
    return sum(steps * n_attn(get_config(r["arch"])) for r in records)


def phase_partitions(records: dict, procs: dict):
    """SM partitions (green contexts): disjoint carves, the kernels on the
    smallest partition, the L(b, p) grid from CUDA-graph replays (the path
    whose decode-attention launches are counted) and the priced SMs of
    every split's sides.  The schedulers' max scales and the elastic
    plan's replay from the grid just measured are started in the
    background (``start_serve``, ``procs["grid"]``).  Returns the grid."""
    from repro_torch.core.h100lets import granted_sms
    from repro_torch.core.latency import PARTITION_SIZES, SPLIT_PAIRS
    from repro_torch.launch import partition as part_mod
    from repro_torch.launch import profile_partitions as pp

    log("[6] partitions: SM partitions of the card (green contexts)")
    total = torch.cuda.get_device_properties(0).multi_processor_count
    splits_disjoint(part_mod, total)
    errs = dict.fromkeys(KERNELS, 0.0)
    kernels_on_partition(part_mod.partition(min(PARTITION_SIZES)), records,
                         errs)
    scans_in_corun(part_mod, errs)
    for r in records.values():
        if r["name"] in errs:   # the grouped products: not run there
            r["partition_max_abs_err"] = errs[r["name"]]

    log(f"  L(b, p) grid: decode step at {pp.CTX} cached positions, bf16, "
        "full width; CUDA-graph replays on each partition (median of "
        f"{pp.RUNS}), eager host wall beside")
    mods = counters()
    for m in mods.values():
        m.launches = 0
    t0 = time.perf_counter()
    grid = pp.profile(log=lambda line: log("  " + line))
    counts = {k: m.launches for k, m in mods.items()}
    want = dict.fromkeys(mods, 0)
    want["decode_attention"] = want["rope"] = grid_launches(grid)
    log(f"  grid: {len(grid)} cells in {time.perf_counter() - t0:.1f} s; "
        f"launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError("the grid did not go through the decode "
                             "kernel as its path says")
    if any(not (r["step_ms"] > 0 and math.isfinite(r["step_ms"]))
           for r in grid):
        raise AssertionError("a grid cell has no step time")
    pp.write(grid, LBP_OUT)
    procs["grid"] = start_serve("--results", str(LBP_OUT), "--gpus", "4",
                                "--max-scale", "--replay",
                                "--no-interference", "--fleet", FLEET)
    log(pp.table(grid))
    dec = records["decode_attention", "yi-9b"]
    # the grid's own record: yi-9b's shape, measured in phases 3 and 6
    records["decode_attention", "lbp-grid"] = dict(
        dec, path="lbp-grid", launches=counts["decode_attention"])
    forward_on_partition(part_mod.partition(min(PARTITION_SIZES)))

    # C.3: every side of every split priced from no more SMs than it gets
    priced = {r["percent"]: r["sms"] for r in grid}
    split_sms = {int(c): tuple(v) for c, v in grid[0]["split_sms"].items()}
    for pair in SPLIT_PAIRS:
        got = [granted_sms(split_sms, p, i) for i, p in enumerate(pair)]
        log(f"  split {pair[0]}/{pair[1]}: runs on {got[0]} + {got[1]} SMs, "
            f"priced from {priced[pair[0]]} + {priced[pair[1]]}")
        if any(priced[p] > g for p, g in zip(pair, got)):
            raise AssertionError(f"split {pair}: a side is priced from more "
                                 "SMs than it gets")

    log("  the five schedulers' max scales on this grid, the elastic "
        "plan's replay and the fleet run beside phases 7-8; their lines "
        "follow phase 8")
    return grid


def check_grid_schedule(result: dict):
    """Phase 6's schedulers on this run's grid: elastic partitioning
    admits load, and its replay serves every request it is offered."""
    if not result["elastic_max_scale"] > 0:
        raise AssertionError("elastic partitioning admits no load")
    rep = result["replay"]
    log("  replay " + json.dumps(rep))
    if not rep["conserved"] or rep["total"] == 0:
        raise AssertionError("the replay lost requests")


def forward_on_partition(part, arch: str = "hubert-xlarge"):
    """The encoder's L(b, p) cell on ``part``: its forward (full depth and
    width, bf16, ``FRAMES`` frames a clip) at ``FORWARD_BATCH``, captured
    and replayed there as ``launch/profile_partitions.py`` measures it,
    beside the committed file's cell; a time outside ``FORWARD_BAND`` of
    it, or on another SM count, fails."""
    from repro_torch.launch import profile_partitions as pp
    committed = [json.loads(line)
                 for line in COMMITTED["lbp"].read_text().splitlines()]
    was = [r for r in committed if (r["arch"], r["percent"], r["batch"])
           == (arch, part.percent, FORWARD_BATCH)]
    if len(was) != 1 or was[0].get("step") != "forward":
        raise AssertionError(f"{COMMITTED['lbp']}: no forward cell of {arch}"
                             f" at {part.percent}%, batch {FORWARD_BATCH}")
    was = was[0]
    model = pp.build(arch, device="cuda")
    rec, = pp.measure(model, arch, [FORWARD_BATCH], [part], seed=0,
                      device=torch.device("cuda"), ident=pp.card_identity(),
                      log=lambda line: log("  " + line))
    ratio = rec["step_ms"] / was["step_ms"]
    log(f"  {arch} forward b{FORWARD_BATCH} x {rec['frames']} frames on "
        f"{rec['sms']} SMs: {rec['step_ms']:.3f} ms, committed "
        f"{was['step_ms']:.3f} ms on {was['sms']} SMs (x{ratio:.3f})")
    if rec["sms"] != was["sms"] or not (
            FORWARD_BAND[0] <= ratio <= FORWARD_BAND[1]):
        raise AssertionError(f"{arch}: its forward on {part.percent}% is "
                             "not the committed cell's")
    del model
    torch.cuda.empty_cache()


def launch_queue(arch: str, graph, part, n: int = 20):
    """Host ms each of ``n`` replays of ``graph`` queued back to back on
    ``part`` takes to launch: a launch returns at once until the card's
    queue of pending work is full, then waits for the card to finish a
    step.  (A co-run's host launch time is that wait where it nears the
    timed span.)"""
    part.synchronize()
    stamps = [time.perf_counter()]
    with part:
        for _ in range(n):
            graph.replay()
            stamps.append(time.perf_counter())
        part.synchronize()
    done = time.perf_counter()
    gaps = ", ".join(f"{(b - a) * 1e3:.2f}"
                     for a, b in zip(stamps, stamps[1:]))
    log(f"  launch queue: {n} replays of {arch}'s step queued back to back "
        f"on {part.sms} SMs, host ms a launch: {gaps}; all done in "
        f"{(done - stamps[0]) * 1e3:.1f} ms")


def phase_interference(records: dict, grid: list):
    """Co-run factors of the ten pairs of distinct models of the mix on the
    40/60 carve at batch 8, beside the committed table, at most two models
    on the card at a time (the mix weighs about 71 GB); this run's solo
    features on the 40 and 60 sides beside the committed ones; and, from
    the committed tables, the fitted predictor, the five schedulers' max
    scale, the two replays under measured interference and the controller
    under fluctuating rates (these last from ``start_replay``, beside
    phase 8)."""
    from repro_torch.configs import get_config
    from repro_torch.core.h100intf import (features_from_grid, load_corun,
                                           load_features)
    from repro_torch.core.h100lets import MIX
    from repro_torch.core.interference import FEATURE_BATCH
    from repro_torch.launch import profile_interference as pi
    from repro_torch.launch import profile_partitions as pp
    from repro_torch.launch.partition import split

    log(f"[7] interference: co-runs on the {CORUN_CARVE}/{100 - CORUN_CARVE}"
        f" carve at batch {CORUN_BATCH}, against {COMMITTED['corun'].name}")
    table = load_corun(str(COMMITTED["corun"]))
    left, right = split(CORUN_CARVE)
    archs = list(MIX)
    mods = counters()
    for m in mods.values():
        m.launches = 0
    captured = []  # the arch of each capture: a warm-up and a captured step

    def capture(arch, part, seed):
        model = pp.build(arch, device="cuda")
        captured.append(arch)
        return model, pp.captured(model, CORUN_BATCH, part, seed=seed)

    # every arch but the last is a left side once; mamba2-780m and yi-9b also
    # beside synthetic partners that each load one resource only
    for i, a in enumerate(archs[:-1]):
        model_a, graph_a = capture(a, left, 0)
        if a in ("yi-9b", "deepseek-moe-16b"):
            launch_queue(a, graph_a[0], left)
        for b in archs[i + 1:]:
            model_b, graph_b = capture(b, right, 1)
            f = pp.corun(graph_a[0], left, graph_b[0], right)
            was = table.cells[CORUN_CARVE, a, CORUN_BATCH, b,
                              CORUN_BATCH]["factor"]
            log(f"  {a} on {left.sms} SMs x{f['factor'][0]:.3f} (committed "
                f"x{was[0]:.3f}) | {b} on {right.sms} SMs "
                f"x{f['factor'][1]:.3f} (committed x{was[1]:.3f}); solo "
                f"{f['solo_ms'][0]:.3f} / {f['solo_ms'][1]:.3f} ms, host "
                f"launch {f['launch_ms']:.1f} of {max(f['span_ms']):.1f} ms")
            times = f["solo_ms"] + f["corun_ms"]
            if not all(t > 0 and math.isfinite(t) for t in times) or \
                    min(f["factor"]) < MIN_FACTOR:
                raise AssertionError(f"co-run {a} | {b}: {f}")
            graph_b[0].reset()
            del model_b, graph_b
            torch.cuda.empty_cache()
        if a in ("mamba2-780m", "yi-9b"):
            for kind in pi.PARTNERS:
                other, _keep = pi.partner(kind, right)
                f = pp.corun(graph_a[0], left, other, right)
                log(f"  {a} b{CORUN_BATCH} on {left.sms} SMs beside "
                    f"'{kind}' on {right.sms}: x{f['factor'][0]:.3f} (solo "
                    f"{f['solo_ms'][0]:.3f} ms; the partner x"
                    f"{f['factor'][1]:.3f}, solo {f['solo_ms'][1]:.3f} ms)")
                if not all(t > 0 and math.isfinite(t)
                           for t in f["solo_ms"] + f["corun_ms"]):
                    raise AssertionError(f"co-run beside {kind}: {f}")
                other.reset()
                del other, _keep
        graph_a[0].reset()
        del model_a, graph_a
        torch.cuda.empty_cache()
    counts = {k: m.launches for k, m in mods.items()}
    want = dict.fromkeys(mods, 0)
    want["decode_attention"] = want["rope"] = 2 * sum(
        n_attn(get_config(arch)) for arch in captured)
    log(f"  co-run launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError("the co-runs did not go through the decode "
                             "kernel as their path says")
    records["decode_attention", "corun-40/60"] = dict(
        records["decode_attention", "yi-9b"], path="corun-40/60",
        launches=counts["decode_attention"])

    committed = load_features(str(COMMITTED["features"]))
    for r in features_from_grid(grid, (FEATURE_BATCH,), l2_reason=""):
        if r["percent"] in (40, 60):
            _, was = committed.at(r["arch"], r["percent"], FEATURE_BATCH)
            log(f"  features {r['arch']} {r['percent']}% ({r['sms']} SMs) "
                f"b{FEATURE_BATCH}: DRAM share {r['dram_share']:.4f} "
                f"(committed {was:.4f})")
            if not 0 < r["dram_share"] < 1.5:
                raise AssertionError(f"DRAM share {r}")
    log(f"  L2 share: {pi.L2_REASON}")
    log("  the committed tables' fit, max scales, replays and controller run"
        " beside phases 6-8; their lines follow phase 8")


def check_committed_replay(result: dict):
    """Phase 7's replays of the committed tables: every replay conserves
    its requests, some enumerated partitioning places the mix, and the
    controller ran on the measured co-run factors and with interference
    off, each run labelled and conserving its requests."""
    if not all(r["conserved"] for r in result["replays"].values()):
        raise AssertionError(f"a replay lost requests: {result}")
    if not result["ideal_enumerated_max_scale"] > 0:
        raise AssertionError("no enumerated partitioning places the mix")
    runs = [result["fluctuate"], result["fluctuate_off"]]
    for fl in runs:
        by_model = ", ".join(f"{m} {v['violation_rate'] * 100:.3f}%"
                             for m, v in fl["per_model"].items())
        log(f"  controller, interference {fl['interference']}: "
            f"{fl['violation_rate'] * 100:.3f}% violations of {fl['total']}"
            f" requests, {fl['reschedules']} reschedules, by model "
            f"{by_model}")
    if [fl["interference"] for fl in runs] != ["measured", "off"]:
        raise AssertionError(f"the controller ran {runs}")
    if not all(fl["conserved"] and fl["total"] > 0 for fl in runs):
        raise AssertionError(f"a controller run lost requests: {runs}")


def start_serve(*args: str) -> subprocess.Popen:
    """``python -m repro_torch.launch.serve *args`` in a process of its
    own (``start_host``).  The schedulers' work in phases 6 and 7 reads
    only a table and takes about a minute of one host core each, so it
    runs beside the card's later phases instead of before them."""
    return start_host("repro_torch.launch.serve", *args)


def start_host(module: str, *args: str) -> subprocess.Popen:
    """``python -m module *args`` in a process of its own that never
    touches the card, its standard output to an unnamed file."""
    out = tempfile.TemporaryFile(mode="w+")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   filter(None, [str(SRC), os.environ.get("PYTHONPATH")])))
    proc = subprocess.Popen([sys.executable, "-m", module, *args],
                            stdout=out, env=env, cwd=ROOT, text=True)
    proc.out = out
    return proc


def finish_serve(proc: subprocess.Popen, header: str) -> dict:
    """Waits for ``start_serve``'s process, logs its lines under
    ``header`` and returns its last line's JSON; fails if it exited
    nonzero (a replay that lost requests, or no output)."""
    rc = proc.wait()
    proc.out.seek(0)
    lines = proc.out.read().splitlines()
    proc.out.close()
    log(header)
    for line in lines[:-1]:
        log("  " + line)
    if rc or not lines:
        raise AssertionError(f"launch/serve.py {' '.join(proc.args[3:])} "
                             f"exited {rc}")
    return json.loads(lines[-1])


def check_fleet(result: dict, table: str, labels: list[str]):
    """A ``--fleet`` run's record: the sweep at every node count, the
    failure drain and the storm, each served with the interference of
    every label of ``labels`` (``measured``, ``off``) and labelled so,
    each conserving its requests; and the 1-node fleet the bare replay
    on the same requests, for each label."""
    fleet = result["fleet"]
    runs = fleet["runs"]
    names = [f"sweep-{n}n" for n in FLEET.split(",")]
    n = FLEET.split(",")[-1]
    names += [f"faildrain-{n}n", f"chaos-{n}n"]
    want = [(name, label) for name in names for label in labels]
    log(f"  fleet on {table}:")
    for r in runs:
        log(f"    {r['run']} interference {r['interference']}: "
            f"{r['goodput_per_node_req_s']:.4f} req/s a node, violations "
            f"{r['violation_rate'] * 100:.3f}% (" + ", ".join(
                f"{c} {v['violation_rate'] * 100:.3f}%"
                for c, v in r["per_class"].items())
            + f"), conserved {r['conserved']}")
    got = [(r["run"], r["interference"]) for r in runs]
    if got != want:
        raise AssertionError(f"the fleet ran {got}, not {want}")
    if not all(r["conserved"] and r["total"] > 0 for r in runs):
        raise AssertionError(f"a fleet run lost requests: {runs}")
    bare = fleet["bare_equal"]
    log(f"    the 1-node fleet is the bare replay: {bare}")
    if sorted(bare) != sorted(labels) or not all(bare.values()):
        raise AssertionError("the 1-node fleet is not the bare replay")


def finish_schedules(procs: dict):
    """Phases 6 and 7's scheduler processes, read and checked."""
    grid = finish_serve(
        procs["grid"], "[6] (continued) the schedulers and the fleet on "
        "this run's grid, run beside phases 7-8:")
    check_grid_schedule(grid)
    # no full co-run table of this run: its fleet runs with interference off
    check_fleet(grid, "this run's grid", ["off"])
    committed = finish_serve(
        procs["committed"], "[7] (continued) the committed tables, run "
        "beside phases 6-8:")
    check_committed_replay(committed)
    check_fleet(committed, "the committed tables", ["measured", "off"])


# ------------------------------------------------------------- training ----


def check_grad(name, got, want, dtype) -> float:
    """Gradients (..., Dh) at the attention tolerances: fp32 as the fp32
    kernels, |got - want| <= 1e-5 + 1e-4 |want|, against the plain version
    in fp64 (``plain_flash_grads(exact=True)``: the fp32 plain version
    itself misses fp64 by more than that at S 1000, where a gradient sums
    thousands of terms); bf16 3e-2 / 3e-2 on values divided by their
    row's RMS, floored at ``GRAD_ROW_FLOOR`` of the whole tensor's (a
    row's exact gradient may vanish: query 0's dq under a causal mask).
    Returns the max abs error (unscaled)."""
    rtol, atol = TOL[dtype]
    scale = 1.0
    if dtype == torch.bfloat16:
        w = want.float()
        floor = GRAD_ROW_FLOOR * float(w.pow(2).mean().sqrt())
        scale = w.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(floor) + 1e-9
    return _check(name, got, want, rtol, atol, scale)


def tol_share(got, want) -> float:
    """max |got - want| / (atol + rtol |want|) at the fp32 tolerance."""
    rtol, atol = TOL[torch.float32]
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def flash_grad_inputs(gen, b, h, hkv, s, dh, dtype):
    """q, k, v as the model hands them over ((B, S, H, Dh) storage seen as
    (B, H, S, Dh)), and dO as autograd hands it back (the same layout)."""
    return tuple(_randn(gen, b, s, n, dh, dtype=dtype).transpose(1, 2)
                 for n in (h, hkv, hkv, h))


def plain_flash_grads(q, k, v, do, causal, window, exact=False):
    """dq, dk, dv by autograd of the plain version; in fp64 with
    ``exact``."""
    from repro_torch.kernels import flash_attention as fl
    dtype = torch.float64 if exact else q.dtype
    leaves = [t.detach().to(dtype).requires_grad_(True) for t in (q, k, v)]
    out = fl.flash_attention_torch(*leaves, causal=causal, window=window)
    return torch.autograd.grad(out, leaves, do.to(dtype))


def grads_flash(gen):
    """The flash backward against autograd of the plain version."""
    from repro_torch.kernels import flash_attention as fl
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).removeprefix("torch.")
        for b, h, hkv, s, dh, causal, window in [
                (4, 10, 1, 1000, 256, True, 2048),    # recurrentgemma-2b
                (1, 10, 1, 2100, 256, True, 2048),    # its window binding
                (4, 32, 4, 1000, 128, True, None),    # yi-9b, G 8
                (4, 32, 2, 1000, 128, True, None),    # chatglm3-6b, G 16
                (2, 8, 2, 300, 64, True, None), (2, 8, 2, 300, 64, False,
                                                 None),
                (2, 16, 16, 300, 80, True, None), (2, 16, 16, 300, 80,
                                                   False, None),
                (2, 8, 2, 300, 128, False, None),
                (2, 8, 2, 300, 160, True, None), (2, 8, 2, 300, 160, False,
                                                  None),
                (2, 10, 1, 300, 256, False, None)]:
            q, k, v, do = flash_grad_inputs(gen, b, h, hkv, s, dh, dtype)
            got = fl.flash_attention_bwd_cuda(q, k, v, do, causal=causal,
                                              window=window)
            fp32 = dtype == torch.float32
            want = plain_flash_grads(q, k, v, do, causal, window, exact=fp32)
            torch.cuda.synchronize()
            name = (f"flash backward {tag} B{b} H{h}/{hkv} S{s} Dh{dh} "
                    f"{'causal' if causal else 'non-causal'} window={window}")
            for what, g, w in zip(("dq", "dk", "dv"), got, want):
                check_grad(f"{name} {what}", g, w, dtype)
            if fp32 and s >= 1000:
                # the fp32 plain version against fp64, beside the kernel
                plain = plain_flash_grads(q, k, v, do, causal, window)
                log("    share of the fp32 tolerance used against fp64: " +
                    ", ".join(f"{what} kernel {tol_share(g, e):.2f} plain "
                              f"{tol_share(p, e):.2f}" for what, g, p, e in
                              zip(("dq", "dk", "dv"), got, plain, want)))
                del plain
            del q, k, v, do, got, want


def grads_rglru(gen):
    """The RG-LRU backward (one launch of its own entry, no forward scan)
    against autograd of the plain recurrence, fp32."""
    from repro_torch.kernels import rglru_scan as rg
    for s, with_h0 in [(s, h0) for s in (1000, 4096) for h0 in (True, False)]:
        a, b, h0 = rglru_inputs(gen, 4, s, 2560, torch.float32, with_h0)
        g_seq = _randn(gen, 4, s, 2560, dtype=torch.float32)
        g_last = _randn(gen, 4, 2560, dtype=torch.float32)
        h_seq, _ = rg.rglru_scan_cuda(a, b, h0)
        fwd = rg.launches
        got = rg.rglru_scan_backward_cuda(a, h_seq, h0, g_seq, g_last)
        if rg.launches != fwd:
            raise AssertionError("the RG-LRU backward launched a forward "
                                 "scan")
        leaves = [t.clone().requires_grad_(True) for t in (a, b)]
        if with_h0:
            leaves.append(h0.clone().requires_grad_(True))
        outs = rg.rglru_scan_torch(leaves[0], leaves[1],
                                   leaves[2] if with_h0 else None)
        want = torch.autograd.grad(outs, leaves, (g_seq, g_last))
        torch.cuda.synchronize()
        for what, g, w in zip(("da", "db", "dh0"), got, want):
            _check(f"rglru backward fp32 B4 S{s} W2560 h0={with_h0} {what}",
                   g, w, RGLRU_TOL, RGLRU_TOL, 1.0)
        del a, b, h0, g_seq, h_seq, got, leaves, outs, want


def plain_ssd_grads(args, dy, dh_final, dtype=torch.float32):
    """Autograd of ``ssd_scan_torch`` on ``args`` widened to ``dtype``
    (exact for bf16 inputs): dx, ddt, da, dB, dC (and dh0 with h0)."""
    from repro_torch.kernels import ssd_scan as ssd
    leaves = [t.detach().to(dtype).requires_grad_(True)
              for t in args if t is not None]
    y, h_final = ssd.ssd_scan_torch(*leaves[:5],
                                    leaves[5] if len(leaves) == 6 else None)
    outs, grads = [y], [dy.to(dtype)]
    if dh_final is not None:
        outs.append(h_final)
        grads.append(dh_final.to(dtype))
    return torch.autograd.grad(outs, leaves, grads)


def check_ssd_grads(name, got, want) -> float:
    """The SSD backward's fp32 gradients against ``want`` at ``SSD_TOL``,
    each divided by its max |want|, in one line.  Returns the max abs
    error (unscaled)."""
    errs, shares = [], []
    for what, g, w in zip(SSD_GRADS, got, want):
        scale = float(w.float().abs().max()) + 1e-9
        errs.append(_check(f"{name} {what}", g, w, SSD_TOL, SSD_TOL, scale,
                           quiet=True))
        shares.append(f"{what} {errs[-1] / scale:.1e}")
    log(f"  {name}: max err / max |ref| " + ", ".join(shares)
        + f" (rtol = atol {SSD_TOL})")
    return max(errs)


def grads_ssd(gen):
    """The SSD backward against autograd of the plain version at mamba2's
    heads (B4 H48 P64 N128), bf16 and fp32 x / B / C, B / C slices of one
    projection: S 1000 and 1024 (the training length) and the chunk edges
    1, 63, 64, 65, with and without h0 and a gradient of h_final; the fp32
    cases at S 1000 also against the plain version in fp64."""
    from repro_torch.kernels import ssd_scan as ssd
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).removeprefix("torch.")
        for s, with_h0, with_dh in [
                (1000, True, True), (1000, False, False), (1024, True, False),
                (1024, False, True)] + [(s, h0, h0) for s in (1, 63, 64, 65)
                                        for h0 in (True, False)]:
            args = ssd_inputs(gen, 4, s, 48, 64, 128, dtype, with_h0)
            dy = _randn(gen, 4, s, 48, 64, dtype=torch.float32)
            dh = (_randn(gen, 4, 48, 128, 64, dtype=torch.float32)
                  if with_dh else None)
            got = ssd.ssd_scan_bwd_cuda(*args, dy, dh)
            want = plain_ssd_grads(args, dy, dh)
            torch.cuda.synchronize()
            name = (f"ssd backward {tag} B4 S{s} H48 P64 N128 h0={with_h0} "
                    f"dh_final={with_dh}")
            check_ssd_grads(name, got, want)
            if dtype == torch.float32 and s == 1000:
                exact = plain_ssd_grads(args, dy, dh, torch.float64)
                check_ssd_grads(name + " vs fp64", got, exact)
                log("    the fp32 plain version against fp64: max err / max "
                    "|fp64| " + ", ".join(
                        f"{what} {float((p_ - e).abs().max() / e.abs().max()):.1e}"
                        for what, p_, e in zip(SSD_GRADS, want, exact)))
                del exact
            del args, dy, dh, got, want


def plain_rope_grads(q, k, positions, gq, gk, theta):
    """dq, dk by autograd of two ``apply_rope`` calls."""
    from repro_torch.kernels import rope as rp
    leaves = [t.detach().requires_grad_(True) for t in (q, k)]
    outs = [rp.apply_rope(x, positions, theta) for x in leaves]
    return torch.autograd.grad(outs, leaves, (gq, gk))


def grads_rope(gen):
    """RoPE's backward (``ops.rope`` under grad: the ``RoPE`` Function, one
    forward and one backward launch) against autograd of the plain version
    at recurrentgemma-2b's heads (H10 Hkv1 Dh256), bf16 and fp32: the
    training batch, the parity step's 2100 tokens, and positions behind an
    offset; within 1 ulp (``check_bits``: the same fp32 operations, the
    sine negated)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import rope as rp
    h, hkv, dh = HEADS[TRAIN_ARCH][:3]
    theta = get_config(TRAIN_ARCH).rope_theta
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).removeprefix("torch.")
        for where, b, s in (("prefill", TRAIN_BATCH, TRAIN_SEQ),
                            ("prefill", 1, 2100), ("offset", 2, 300)):
            q, gq = (_randn(gen, b, s, h, dh, dtype=dtype) for _ in "qg")
            k, gk = (_randn(gen, b, s, hkv, dh, dtype=dtype) for _ in "kg")
            pos = rope_positions(where, b, s)
            leaves = [t.clone().requires_grad_(True) for t in (q, k)]
            fwd, bwd = rp.launches, rp.bwd_launches
            got = torch.autograd.grad(ops.rope(*leaves, pos, theta), leaves,
                                      (gq, gk))
            if (rp.launches, rp.bwd_launches) != (fwd + 1, bwd + 1):
                raise AssertionError("ops.rope under grad did not launch "
                                     "the kernel once each way")
            want = plain_rope_grads(q, k, pos, gq, gk, theta)
            torch.cuda.synchronize()
            for what, g, w in zip(("dq", "dk"), got, want):
                check_bits(f"rope backward {tag} {where} B{b} S{s} H{h}/"
                           f"{hkv} Dh{dh} {what}", g, w)
            del q, k, gq, gk, leaves, got, want


def times_rope_train(gen, records):
    """RoPE's forward and backward kernels at recurrentgemma-2b's training
    shape (bf16, B4 S1024 H10 Hkv1 Dh256), each first held against its
    plain version on one input set, then timed beside the plain version:
    each alone and forward + backward."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import rope as rp
    b, s, (h, hkv, dh) = TRAIN_BATCH, TRAIN_SEQ, HEADS[TRAIN_ARCH][:3]
    theta, dtype = get_config(TRAIN_ARCH).rope_theta, torch.bfloat16
    cost = rp.cost(b, s, h, hkv, dh)  # the backward's is the forward's
    pos = rope_positions("prefill", b, s)
    sets = copies(lambda: (
        _randn(gen, b, s, h, dh, dtype=dtype),
        _randn(gen, b, s, hkv, dh, dtype=dtype),
        _randn(gen, b, s, h, dh, dtype=dtype),
        _randn(gen, b, s, hkv, dh, dtype=dtype)), 2 * cost[1])
    shape = f"bf16 B{b} S{s} H{h} Hkv{hkv} Dh{dh} q and k"

    def kernel_fwd(q, k, gq, gk):
        return rp.rope_cuda(q, k, pos, theta)

    def kernel_bwd(q, k, gq, gk):
        return rp.rope_backward_cuda(gq, gk, pos, theta)

    def kernel_both(q, k, gq, gk):
        rp.rope_cuda(q, k, pos, theta)
        return rp.rope_backward_cuda(gq, gk, pos, theta)

    def plain_fwd(q, k, gq, gk):
        return rp.rope_torch(q, k, pos, theta)

    def plain_both(q, k, gq, gk):
        return plain_rope_grads(q, k, pos, gq, gk, theta)

    def backward_only(outs, leaves, gq, gk):
        return torch.autograd.grad(outs, leaves, (gq, gk), retain_graph=True)

    fwd_err = max(check_bits(f"rope forward at the training shape [{shape}]"
                             f" {what}", g, w) for what, g, w in zip(
        ("q", "k"), kernel_fwd(*sets[0]), plain_fwd(*sets[0])))
    bwd_err = max(check_bits(f"rope backward at the training shape "
                             f"[{shape}] {what}", g, w) for what, g, w in zip(
        ("dq", "dk"), kernel_bwd(*sets[0]), plain_both(*sets[0])))
    ms_fwd = time_ms(kernel_fwd, sets, 100)
    ms_bwd = time_ms(kernel_bwd, sets, 100)
    ms_both = time_ms(kernel_both, sets, 100)
    plain_fwd_ms = time_ms(plain_fwd, sets, 20)
    plain_both_ms = time_ms(plain_both, sets, 20)
    graphs = []
    for q, k, gq, gk in sets:
        leaves = [t.detach().requires_grad_(True) for t in (q, k)]
        graphs.append(([rp.apply_rope(x, pos, theta) for x in leaves],
                       leaves, gq, gk))
    plain_bwd_ms = time_ms(backward_only, graphs, 20)
    del graphs
    bound = bound_ms(cost, dtype)
    records["rope", TRAIN_PATH] = record(
        "rope", TRAIN_PATH, shape, fwd_err, ms_fwd, plain_fwd_ms, bound,
        None)
    records["rope_backward", TRAIN_PATH] = record(
        "rope_backward", TRAIN_PATH, shape, bwd_err, ms_bwd, plain_bwd_ms,
        bound, None, fwd_bwd_ms=ms_both, plain_fwd_bwd_ms=plain_both_ms)
    log(f"  rope at the training shape [{shape}]: forward {ms_fwd:.4f} ms, "
        f"backward {ms_bwd:.4f} ms (bound {bound[0]:.4f} each, {bound[1]}; "
        f"plain {plain_fwd_ms:.4f} / {plain_bwd_ms:.4f} ms); forward + "
        f"backward: kernels {ms_both:.4f} ms, plain {plain_both_ms:.4f} ms")
    del sets


def times_flash_train(gen, records):
    """The forward and backward kernels at recurrentgemma-2b's training
    shape (bf16, B4 S1024), each first held against its plain version on
    one input set, then timed beside the plain version's and SDPA's (a
    yardstick the port never calls; below S 2048 its causal mask is the
    window's): each alone and forward + backward."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fl
    from repro_torch.models.layers import _repeat_kv
    b, h, hkv, s, dh, window = 4, 10, 1, TRAIN_SEQ, 256, 2048
    dtype = torch.bfloat16
    fwd_cost = fl.cost(b, h, hkv, s, dh, window=window)
    # q, dO, k, v read; dq, dk, dv written (O is not read)
    bwd_cost = fl.bwd_cost(b, h, hkv, s, dh, window=window)

    sets = copies(lambda: flash_grad_inputs(gen, b, h, hkv, s, dh, dtype),
                  bwd_cost[1])
    shape = f"bf16 B{b} H{h} Hkv{hkv} S{s} Dh{dh} causal window={window}"

    def kernel_fwd(q, k, v, do):
        return fl.flash_attention_cuda(q, k, v, window=window)

    def kernel_bwd(q, k, v, do):
        return fl.flash_attention_bwd_cuda(q, k, v, do, window=window)

    def kernel_both(q, k, v, do):
        fl.flash_attention_cuda(q, k, v, window=window)
        return fl.flash_attention_bwd_cuda(q, k, v, do, window=window)

    def plain_fwd(q, k, v, do):
        return fl.flash_attention_torch(q, k, v, window=window)

    def plain_both(q, k, v, do):
        return plain_flash_grads(q, k, v, do, True, window)

    fwd_err = check_close(f"flash forward at the training shape [{shape}]",
                          kernel_fwd(*sets[0]), plain_fwd(*sets[0]), dtype)
    got = kernel_bwd(*sets[0])
    bwd_err = max(check_grad(f"flash backward at the training shape "
                             f"[{shape}] {what}", g, w, dtype)
                  for what, g, w in zip(("dq", "dk", "dv"), got,
                                        plain_both(*sets[0])))
    if not all(torch.equal(g, a) for g, a in zip(got, kernel_bwd(*sets[0]))):
        raise AssertionError("two calls of the flash backward on the same "
                             "inputs gave different gradients")
    log("  flash backward at the training shape: a second call on the same "
        "inputs bitwise equal (dq, dk, dv)")
    del got

    lib_sets = [[t.detach().requires_grad_(True) for t in (
        q, _repeat_kv(k.transpose(1, 2), h).transpose(1, 2),
        _repeat_kv(v.transpose(1, 2), h).transpose(1, 2))] + [do]
        for q, k, v, do in sets]

    def sdpa_fwd(q, k, v, do):
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def sdpa_both(q, k, v, do):
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return torch.autograd.grad(out, (q, k, v), do)

    def graphs(fn_out, leaves_of, set_list):
        """(out, leaves, do) per set, for timing a backward alone."""
        return [(fn_out(*st), leaves_of(st), st[-1]) for st in set_list]

    def backward_only(out, leaves, do):
        return torch.autograd.grad(out, leaves, do, retain_graph=True)

    ms_fwd = time_ms(kernel_fwd, sets, 20)
    ms_bwd = time_ms(kernel_bwd, sets, 10)
    ms_both = time_ms(kernel_both, sets, 10)
    plain_fwd_ms = time_ms(plain_fwd, sets, 3)
    plain_both_ms = time_ms(plain_both, sets, 3)
    sdpa_fwd_ms = time_ms(sdpa_fwd, lib_sets, 20)
    sdpa_both_ms = time_ms(sdpa_both, lib_sets, 10)
    plain_graphs = graphs(
        lambda q, k, v, do: fl.flash_attention_torch(q, k, v, window=window),
        lambda st: st[:3], [[t.detach().requires_grad_(True)
                             for t in st[:3]] + [st[3]] for st in sets])
    plain_bwd_ms = time_ms(backward_only, plain_graphs, 3)
    del plain_graphs
    sdpa_graphs = graphs(
        lambda q, k, v, do: F.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True),
        lambda st: st[:3], lib_sets)
    sdpa_bwd_ms = time_ms(backward_only, sdpa_graphs, 10)
    del sdpa_graphs, lib_sets
    fwd_bound = bound_ms(fwd_cost, dtype)
    bwd_bound = bound_ms(bwd_cost, dtype)
    records["flash_attention", TRAIN_PATH] = record(
        "flash_attention", TRAIN_PATH, shape, fwd_err, ms_fwd, plain_fwd_ms,
        fwd_bound, sdpa_fwd_ms)
    records["flash_attention_backward", TRAIN_PATH] = record(
        "flash_attention_backward", TRAIN_PATH, shape, bwd_err, ms_bwd,
        plain_bwd_ms, bwd_bound, sdpa_bwd_ms, fwd_bwd_ms=ms_both,
        plain_fwd_bwd_ms=plain_both_ms, library_fwd_bwd_ms=sdpa_both_ms)
    log(f"  flash at the training shape [{shape}]: forward {ms_fwd:.4f} ms "
        f"(bound {fwd_bound[0]:.4f}, {fwd_bound[1]}; plain "
        f"{plain_fwd_ms:.4f} ms, SDPA {sdpa_fwd_ms:.4f} ms); backward "
        f"{ms_bwd:.4f} ms (bound {bwd_bound[0]:.4f}, {bwd_bound[1]}: 10 Dh "
        f"operations a live pair, {bwd_cost[0]:.3g}; {bwd_cost[1]:.3g} "
        f"bytes); forward + backward: kernels {ms_both:.4f} ms, plain "
        f"{plain_both_ms:.4f} ms, SDPA {sdpa_both_ms:.4f} ms; backward "
        f"alone: plain {plain_bwd_ms:.4f} ms, SDPA {sdpa_bwd_ms:.4f} ms, "
        f"the CUDA-core version {CUDA_CORE_BWD_MS} ms")
    del sets


def times_rglru_train(gen, records):
    """The RG-LRU scan forward and its backward at the training shape
    (fp32 a, b: B4 S1024 W2560, no h0), each first held against its plain
    version on one input set, then timed beside the plain versions (the
    plain recurrence, a loop of S steps, on one set and few calls)."""
    from repro_torch.kernels import rglru_scan as rg
    b, s, w = 4, TRAIN_SEQ, 2560

    def make():
        a, bb, _ = rglru_inputs(gen, b, s, w, torch.float32, False)
        h_seq, _ = rg.rglru_scan_cuda(a, bb)
        return (a, bb, h_seq, _randn(gen, b, s, w, dtype=torch.float32),
                _randn(gen, b, w, dtype=torch.float32))

    # backward: a, h_seq and g read, da and db written (+ the (B, W) rows)
    fwd_cost, bwd_cost = rg.cost(b, s, w), rg.bwd_cost(b, s, w)
    sets = copies(make, bwd_cost[1])
    shape = f"fp32 B{b} S{s} W{w}"

    def kernel_fwd(a, bb, *_):
        return rg.rglru_scan_cuda(a, bb)

    def plain_fwd(a, bb, *_):
        return rg.rglru_scan_torch(a, bb)

    def kernel_bwd(a, bb, h_seq, g, gl):
        return rg.rglru_scan_backward_cuda(a, h_seq, None, g, gl)

    def kernel_both(a, bb, h_seq, g, gl):
        h_seq, _ = rg.rglru_scan_cuda(a, bb)
        return rg.rglru_scan_backward_cuda(a, h_seq, None, g, gl)

    def plain_bwd(a, bb, h_seq, g, gl):
        return rg.rglru_scan_backward(rg.rglru_scan_torch, a, h_seq, None,
                                      g, gl)

    def plain_both(a, bb, h_seq, g, gl):
        leaves = [t.detach().requires_grad_(True) for t in (a, bb)]
        return torch.autograd.grad(rg.rglru_scan_torch(*leaves), leaves,
                                   (g, gl))

    fwd_err = _check(f"rglru forward at the training shape [{shape}]",
                     kernel_fwd(*sets[0])[0], plain_fwd(*sets[0])[0],
                     RGLRU_TOL, RGLRU_TOL, 1.0)
    bwd_err = max(_check(f"rglru backward at the training shape [{shape}] "
                         f"{what}", g, w_, RGLRU_TOL, RGLRU_TOL, 1.0)
                  for what, g, w_ in zip(("da", "db"), kernel_bwd(*sets[0]),
                                         plain_both(*sets[0])))
    ms_fwd = time_ms(kernel_fwd, sets, 20)
    ms_bwd = time_ms(kernel_bwd, sets, 20)
    ms_both = time_ms(kernel_both, sets, 20)
    plain_fwd_ms = time_ms(plain_fwd, sets[:1], 1)
    plain_bwd_ms = time_ms(plain_bwd, sets[:1], 1)
    plain_both_ms = time_ms(plain_both, sets[:1], 1)
    fwd_bound = bound_ms(fwd_cost, torch.float32)
    bwd_bound = bound_ms(bwd_cost, torch.float32)
    records["rglru_scan", TRAIN_PATH] = record(
        "rglru_scan", TRAIN_PATH, shape, fwd_err, ms_fwd, plain_fwd_ms,
        fwd_bound, None)
    records["rglru_scan_backward", TRAIN_PATH] = record(
        "rglru_scan_backward", TRAIN_PATH, shape, bwd_err, ms_bwd,
        plain_bwd_ms, bwd_bound, None, fwd_bwd_ms=ms_both,
        plain_fwd_bwd_ms=plain_both_ms)
    log(f"  rglru at the training shape [{shape}]: forward {ms_fwd:.4f} ms "
        f"(bound {fwd_bound[0]:.4f}, {fwd_bound[1]}), backward {ms_bwd:.4f}"
        f" ms (bound {bwd_bound[0]:.4f}, {bwd_bound[1]}; the version on "
        f"flipped copies {RGLRU_FLIPPED_BWD_MS} ms); forward + "
        f"backward: kernel {ms_both:.4f} ms, plain {plain_both_ms:.4f} ms; "
        f"plain forward {plain_fwd_ms:.4f} ms, backward alone "
        f"{plain_bwd_ms:.4f} ms")
    del sets


def times_ssd_train(gen, records):
    """The SSD scan forward and its backward at mamba2-780m's training
    shape (bf16 x / B / C, fp32 dt: B4 S1024 H48 P64 N128, no h0), each
    first held against its plain version on one input set (the backward
    also against a second call, bitwise), then timed beside the plain
    versions' (autograd of ``ssd_scan_torch``).  No PyTorch call computes
    the scan, so there is no library time."""
    from repro_torch.kernels import ssd_scan as ssd
    b, s, h, p, n = TRAIN_BATCH, TRAIN_SEQ, 48, 64, 128
    dtype = torch.bfloat16

    def make():
        return (*ssd_inputs(gen, b, s, h, p, n, dtype, False)[:5],
                _randn(gen, b, s, h, p, dtype=torch.float32))

    # forward: x, B, C, dt and a read, y and h_final written; backward: the
    # same inputs and the fp32 dy read, dx, dB, dC (bf16), ddt, da written;
    # the chunked products as ``ssd_scan.cost`` / ``bwd_cost`` count them
    fwd_cost, bwd_cost = ssd.cost(b, s, h, p, n), ssd.bwd_cost(b, s, h, p, n)
    sets = copies(make, bwd_cost[1])
    shape = f"bf16 x/B/C, fp32 dt B{b} S{s} H{h} P{p} N{n}, no h0"

    def kernel_fwd(x, dt, a, bm, cm, dy):
        return ssd.ssd_scan_cuda(x, dt, a, bm, cm)

    def kernel_bwd(x, dt, a, bm, cm, dy):
        return ssd.ssd_scan_bwd_cuda(x, dt, a, bm, cm, None, dy, None)

    def kernel_both(x, dt, a, bm, cm, dy):
        ssd.ssd_scan_cuda(x, dt, a, bm, cm)
        return ssd.ssd_scan_bwd_cuda(x, dt, a, bm, cm, None, dy, None)

    def plain_fwd(x, dt, a, bm, cm, dy):
        return ssd.ssd_scan_torch(x, dt, a, bm, cm)

    def plain_both(x, dt, a, bm, cm, dy):
        leaves = [t.detach().requires_grad_(True) for t in (x, dt, a, bm, cm)]
        y, _ = ssd.ssd_scan_torch(*leaves)
        return torch.autograd.grad(y, leaves, dy)

    def backward_only(y, leaves, dy):
        return torch.autograd.grad(y, leaves, dy, retain_graph=True)

    first = sets[0]
    fwd_err = check_scaled(f"ssd_scan forward at the training shape "
                           f"[{shape}] y", kernel_fwd(*first)[0],
                           plain_fwd(*first)[0], SSD_TOL)
    got = kernel_bwd(*first)
    bwd_err = check_ssd_grads(f"ssd backward at the training shape [{shape}]",
                              got, plain_ssd_grads((*first[:5], None),
                                                   first[5], None))
    if not all(torch.equal(g, a) for g, a in zip(got, kernel_bwd(*first))):
        raise AssertionError("two calls of the SSD backward on the same "
                             "inputs gave different gradients")
    log("  ssd backward at the training shape: a second call on the same "
        "inputs bitwise equal (dx, ddt, da, dB, dC, dh0)")
    del got

    ms_fwd = time_ms(kernel_fwd, sets, 20)
    ms_bwd = time_ms(kernel_bwd, sets, 10)
    ms_both = time_ms(kernel_both, sets, 10)
    plain_fwd_ms = time_ms(plain_fwd, sets, 3)
    plain_both_ms = time_ms(plain_both, sets, 3)
    graphs = []
    for st in sets:
        leaves = [t.detach().requires_grad_(True) for t in st[:5]]
        graphs.append((ssd.ssd_scan_torch(*leaves)[0], leaves, st[5]))
    plain_bwd_ms = time_ms(backward_only, graphs, 3)
    del graphs
    fwd_bound = bound_ms(fwd_cost, dtype)
    bwd_bound = bound_ms(bwd_cost, dtype)
    records["ssd_scan", SSM_PATH] = record(
        "ssd_scan", SSM_PATH, shape, fwd_err, ms_fwd, plain_fwd_ms,
        fwd_bound, None)
    records["ssd_scan_backward", SSM_PATH] = record(
        "ssd_scan_backward", SSM_PATH, shape, bwd_err, ms_bwd, plain_bwd_ms,
        bwd_bound, None, fwd_bwd_ms=ms_both, plain_fwd_bwd_ms=plain_both_ms)
    log(f"  ssd at the training shape [{shape}]: forward {ms_fwd:.4f} ms "
        f"(bound {fwd_bound[0]:.4f}, {fwd_bound[1]}; plain "
        f"{plain_fwd_ms:.4f} ms), backward {ms_bwd:.4f} ms (bound "
        f"{bwd_bound[0]:.4f}, {bwd_bound[1]}: {bwd_cost[1]:.3g} bytes, "
        f"{bwd_cost[0]:.3g} operations; the CUDA-core version "
        f"{SSD_CUDA_CORE_BWD_MS} ms); forward + backward: kernels "
        f"{ms_both:.4f} ms, plain {plain_both_ms:.4f} ms; backward alone: "
        f"plain {plain_bwd_ms:.4f} ms")
    del sets


def train_counters() -> dict:
    """name -> (module, counter attribute) of every kernel a training step
    may launch, and of those it must not."""
    mods = counters()
    return {"flash_attention": (mods["flash_attention"], "launches"),
            "flash_attention_backward": (mods["flash_attention"],
                                         "bwd_launches"),
            "rglru_scan": (mods["rglru_scan"], "launches"),
            "rglru_scan_backward": (mods["rglru_scan"], "bwd_launches"),
            "decode_attention": (mods["decode_attention"], "launches"),
            "ssd_scan": (mods["ssd_scan"], "launches"),
            "ssd_scan_backward": (mods["ssd_scan"], "bwd_launches"),
            "rope": (mods["rope"], "launches"),
            "rope_backward": (mods["rope"], "bwd_launches")}


def read_counts(names) -> dict:
    return {k: getattr(m, attr) for k, (m, attr) in names.items()}


def expected_train_launches(cfg, steps: int) -> dict:
    """Per step: each attention layer's flash forward and RoPE twice (the
    forward and its recompute under remat) and their backwards once; each
    SSM layer's SSD scan twice and its backward kernel once; each RG-LRU
    layer's scan twice and its backward entry once."""
    kinds = cfg.layer_types()
    n_attn_layers, n_rglru = n_attn(cfg), kinds.count("rglru")
    n_ssm = kinds.count("ssm")
    return {"flash_attention": 2 * n_attn_layers * steps,
            "flash_attention_backward": n_attn_layers * steps,
            "rglru_scan": 2 * n_rglru * steps,
            "rglru_scan_backward": n_rglru * steps,
            "decode_attention": 0, "ssd_scan": 2 * n_ssm * steps,
            "ssd_scan_backward": n_ssm * steps,
            "rope": 2 * n_attn_layers * steps,
            "rope_backward": n_attn_layers * steps}


def train_parity(arch, beside):
    """fp32, ``arch`` at full width and ``PARITY_SHAPE``'s depth over one
    sequence of its length (recurrentgemma-2b: 3 layers, one (rglru, rglru,
    attn) unit, 2100 tokens so that the 2048-token window binds;
    mamba2-780m: 3 layers, 1100 tokens, no multiple of the SSD chunk): the
    card (kernels) against the same weights on the CPU (plain versions):
    the loss, every parameter's gradient, the parameters after one AdamW
    step; then a checkpoint of the card's model, read back through the
    bridge.  The CPU's step runs in a thread of its own; the card's step,
    ``beside()`` (untimed card work) and the checkpoint's round trip run
    meanwhile."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.training.optim import (OptimConfig, adamw_init,
                                            adamw_update)

    n_layers, seq = PARITY_SHAPE[arch]
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    card = Model(cfg, dtype=torch.float32, device="cuda")
    card.init(torch.Generator(device="cuda").manual_seed(0))
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    cpu.load_state_dict(card.state_dict())  # copied across devices
    toks = torch.from_numpy(np.random.default_rng(seq).integers(
        0, cfg.vocab_size, (1, seq)))
    out = {}

    def step(model):
        t0 = time.perf_counter()
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        state = adamw_init(params)
        loss = model.loss_fn({"tokens": toks.to(model.device)})
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        metrics = adamw_update(params, grads, state, OptimConfig())
        out[model.device.type] = (float(loss.detach()), metrics, grads,
                                  time.perf_counter() - t0)

    worker = threading.Thread(target=step, args=(cpu,), daemon=True)
    worker.start()
    names = train_counters()
    before = read_counts(names)
    step(card)
    rose = {k: v - before[k] for k, v in read_counts(names).items()}
    beside()
    checkpoint_round_trip(card)
    worker.join()
    if "cpu" not in out:
        raise AssertionError("the CPU's train step failed")
    for dev, (loss, metrics, _, secs) in out.items():
        log(f"    {dev}: loss {loss:.6f}, grad norm "
            f"{float(metrics['grad_norm']):.6f}, lr {float(metrics['lr']):.3e}"
            f" ({secs:.1f} s)")
    want = expected_train_launches(cfg, 1)
    log(f"    kernel launches {rose}, expected {want}")
    if rose != want:
        raise AssertionError("the card's train step did not go through the "
                             "kernels as its path says")
    (l_card, m_card, g_card, _), (l_cpu, m_cpu, g_cpu, _) = (out["cuda"],
                                                             out["cpu"])
    if not abs(l_card - l_cpu) <= PARITY_REL * abs(l_cpu):
        raise AssertionError(f"loss: card {l_card} cpu {l_cpu}")
    for key in ("grad_norm", "lr"):
        a, b = float(m_card[key]), float(m_cpu[key])
        if not abs(a - b) <= PARITY_REL * abs(b):
            raise AssertionError(f"{key}: card {a} cpu {b}")
    worst = {"grad": (0.0, ""), "param": (0.0, "")}
    params_cpu = dict(cpu.named_parameters())
    with torch.no_grad():
        for name, p in card.named_parameters():
            for what, got, want_t in (("grad", g_card[name], g_cpu[name]),
                                      ("param", p, params_cpu[name])):
                want_t = want_t.to("cuda")  # compared on the card
                scale = float(want_t.abs().max())
                rel = float((got - want_t).abs().max()) / max(scale, 1e-30)
                if not rel <= PARITY_REL:
                    raise AssertionError(f"{what} of {name}: card and CPU "
                                         f"differ by {rel:.2e} of max |cpu|")
                worst[what] = max(worst[what], (rel, name))
    log(f"    every gradient within {worst['grad'][0]:.2e} of its max |cpu| "
        f"(worst {worst['grad'][1]}), every parameter after the AdamW step "
        f"within {worst['param'][0]:.2e} (worst {worst['param'][1]}); "
        f"bound {PARITY_REL}")
    del out, g_card, g_cpu, cpu, params_cpu, card
    torch.cuda.empty_cache()


def checkpoint_round_trip(model):
    """``model``'s checkpoint in the JAX format, read back through the
    bridge onto the card: every tensor bit-equal, and the manifest's bytes
    the parameters' own."""
    from repro_torch.checkpoint import (load_jax_checkpoint, manifest_nbytes,
                                        params_from_jax, save_checkpoint)
    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=CKPT_DIR) as d:
        t0 = time.perf_counter()
        save_checkpoint(d, model, step=1)
        back = params_from_jax(load_jax_checkpoint(d, step=1), model.cfg,
                               device="cuda")
        nbytes = manifest_nbytes(d, step=1)
        same = all(torch.equal(a, b) for a, b in zip(
            back.state_dict().values(), model.state_dict().values()))
        want_bytes = sum(p.numel() * p.element_size()
                         for p in model.parameters())
        log(f"    checkpoint of the stepped card model: {nbytes / 2**30:.2f}"
            f" GiB written, read back through the bridge "
            f"({time.perf_counter() - t0:.1f} s, beside the CPU's step): "
            f"{'bit-equal' if same else 'DIFFERENT'}")
        if not same or nbytes != want_bytes:
            raise AssertionError("the checkpoint does not give the model "
                                 "back")


def train_full(arch, records):
    """bf16, ``arch`` at full width and depth through the training
    launcher: every loss and grad norm finite, the last loss below the
    first, and the exact kernel launches of the path, which become the
    ``launches`` of its records."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launcher
    names = train_counters()
    for module, attr in names.values():
        setattr(module, attr, 0)
    held = []  # allocated bytes after each step, before / after collecting

    def log_step(line):
        # the loop logs a step after timing it: a collection here is
        # outside the timed window
        log("    " + line)
        if line.startswith("step "):
            before = torch.cuda.memory_allocated()
            gc.collect()
            held.append((before, torch.cuda.memory_allocated()))

    rep = launcher.train(arch, "full", steps=TRAIN_STEPS,
                         batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=1e-3,
                         device="cuda", log_fn=log_step)
    counts = read_counts(names)
    log("    allocated after each step, before / after a collection (GiB): "
        + ", ".join(f"{a / 2**30:.4f} / {b / 2**30:.4f}" for a, b in held))
    if len(held) != TRAIN_STEPS or any(b < a for a, b in held):
        raise AssertionError("a collection freed memory after a step: the "
                             "step left tensors in reference cycles")
    want = expected_train_launches(get_config(arch), TRAIN_STEPS)
    log(f"    launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError("training did not go through the kernels as "
                             "its path says")
    hist = rep["history"]
    finite = all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                 for h in hist)
    if len(hist) != TRAIN_STEPS or not finite:
        raise AssertionError(f"a loss or grad norm is not finite: {hist}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError("the loss did not fall")
    steady = hist[1:]  # the first step pays for the first launches
    ms = sorted(h["ms_per_step"] for h in steady)[len(steady) // 2]
    log(f"    {rep['n_params'] / 1e9:.3f} B parameters, median step "
        f"{ms:.1f} ms ({TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} tokens/s) "
        f"over steps 2-{TRAIN_STEPS}, peak {rep['peak_gib']:.2f} GiB")
    for (name, path), r in records.items():
        if path == f"train:{arch}":
            r["launches"] = counts[name]
    return rep["model"]


def first_step(arch: str) -> dict:
    """Runs in a fresh process (``chip_smoke.py --first-step ARCH``):
    ``FIRST_STEPS`` bf16 training steps of ``arch`` at full width and
    depth, B4 x S1024, with Python's collector off, so that nothing a step
    leaves in reference cycles is freed by chance.  After each step: its
    peak allocated bytes, the bytes still allocated, those allocated after
    a collection, and the modules the step imported."""
    from repro_torch.data import token_batches
    from repro_torch.launch.train import PRESETS
    from repro_torch.models.model import Model
    from repro_torch.training.optim import OptimConfig
    from repro_torch.training.train import make_train_step
    cfg = PRESETS["full"](arch)
    model = Model(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(model, OptimConfig())
    batches = list(token_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                                 FIRST_STEPS))
    gc.collect()
    gc.disable()
    steps = []
    for batch in batches:
        n_modules = len(sys.modules)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(batch)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        gc.collect()
        steps.append({"peak": torch.cuda.max_memory_allocated(),
                      "allocated": held,
                      "after_collect": torch.cuda.memory_allocated(),
                      "imported_modules": len(sys.modules) - n_modules})
    return {"arch": arch, "steps": steps}


def first_steps(arch: str):
    """:func:`first_step` in a fresh process, logged; fails if a
    collection frees memory after a step (the step left tensors that only
    reference cycles held)."""
    out = subprocess.run([sys.executable, __file__, "--first-step", arch],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=FIRST_STEP_TIMEOUT_S)
    if out.returncode:
        raise AssertionError(f"--first-step {arch} exited {out.returncode}:"
                             f" {out.stderr[-2000:]}")
    rec = json.loads(out.stdout.splitlines()[-1])
    for i, st in enumerate(rec["steps"], 1):
        log(f"    {arch}, a fresh process, step {i} with the collector off: "
            f"peak {st['peak'] / 2**30:.4f} GiB, allocated after it "
            f"{st['allocated'] / 2**30:.4f} GiB, after a collection "
            f"{st['after_collect'] / 2**30:.4f} GiB; "
            f"{st['imported_modules']} modules imported")
    if any(st["after_collect"] < st["allocated"] for st in rec["steps"]):
        raise AssertionError(f"a collection freed memory after a step of "
                             f"{arch}'s fresh process: {rec}")


def profile_train_step(model):
    """Where the device time of a bf16 full-depth step goes: two more
    steps of the model just trained, the second traced by
    ``torch.profiler``: wall, device busy and idle share, and the kernels'
    time by family and by name."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import token_batches
    from repro_torch.serving.profile import window_report
    from repro_torch.training.optim import OptimConfig
    from repro_torch.training.train import make_train_step
    cfg = model.cfg
    step = make_train_step(model, OptimConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=TRAIN_STEPS))
    batches = list(token_batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, 2))
    step(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batches[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rep = window_report("train step", prof, wall, 1, top=10)
    if "top_kernels" not in rep:
        raise AssertionError("the profiler saw no device time in the step")
    families = {"flash backward": r"flash_bwd_", "flash forward":
                r"flash_bf16", "SSD backward": r"ssd_bwd", "SSD forward":
                r"ssd_bf16|ssd_kernel", "RG-LRU scan": r"rglru", "matmuls":
                r"gemm|nvjet|xmma|cutlass|Gemm"}
    by_family = dict.fromkeys([*families, "other"], 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            fam = next((f for f, pat in families.items()
                        if re.search(pat, e.name)), "other")
            by_family[fam] += e.time_range.elapsed_us() / 1e3
    log(f"    profiled step: wall {rep['wall_ms_per_step']:.1f} ms, device "
        f"busy {rep['device_busy_ms_per_step']:.1f} ms (idle "
        f"{rep['device_idle_share']:.1%}), {rep['kernels_per_step']:.0f} "
        "kernels; by family: " + ", ".join(
            f"{f} {ms:.1f} ms" for f, ms in by_family.items()))
    for k in rep["top_kernels"]:
        log(f"      {k['ms']:.2f} ms x{k['count']} ({k['share_of_busy']:.1%})"
            f" {k['name']}")
    short = [(re.sub(r"^.*::(\w+)<.*$", r"\1", k["name"]), k)
             for k in rep["port_kernels"]]
    log("    the port's kernels in the step: " + "; ".join(
        f"{name} {k['us_per_call'] / 1e3:.3f} ms x{k['count']}"
        for name, k in short))
    del model, step
    torch.cuda.empty_cache()


def phase_train(records: dict):
    log(f"[8] train: {TRAIN_ARCH} and {SSM_ARCH}, the backward kernels, "
        f"fp32 parity, bf16 at full width and depth")
    gen = torch.Generator(device="cuda").manual_seed(8)

    def backward_checks():
        log("  backward kernels vs autograd of the plain versions (beside "
            "the CPU's parity step):")
        timed(grads_flash, gen)
        timed(grads_rglru, gen)
        timed(grads_rope, gen)

    def ssd_checks():
        log("  the SSD backward vs autograd of the plain version (beside "
            "the CPU's parity step):")
        timed(grads_ssd, gen)

    for arch, beside in ((TRAIN_ARCH, backward_checks),
                         (SSM_ARCH, ssd_checks)):
        n_layers, seq = PARITY_SHAPE[arch]
        log(f"  fp32 parity, {arch} at full width, {n_layers} layers, "
            f"{seq} tokens:")
        timed(train_parity, arch, beside)
    timed(times_flash_train, gen, records)
    timed(times_rope_train, gen, records)
    timed(times_rglru_train, gen, records)
    timed(times_ssd_train, gen, records)
    for arch in (TRAIN_ARCH, SSM_ARCH):
        log(f"  {arch} bf16, full width and depth, {TRAIN_STEPS} steps of "
            f"B{TRAIN_BATCH} x S{TRAIN_SEQ}:")
        timed(profile_train_step, timed(train_full, arch, records))
    torch.cuda.empty_cache()
    log(f"  the first {FIRST_STEPS} steps of a fresh process, bf16 B"
        f"{TRAIN_BATCH} x S{TRAIN_SEQ}, full width and depth:")
    for arch in (TRAIN_ARCH, SSM_ARCH):
        timed(first_steps, arch)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    if sys.argv[1:2] == ["--first-step"]:
        print(json.dumps(first_step(sys.argv[2])))
        return 0
    if sys.argv[1:2] == ["--granite"]:
        # granite-4.0-h-small's rows of phase 3 alone: flash and decode
        # attention at its heads and scale, the SSD scan at its shape and
        # the grouped expert products at its cell's cap
        device = phase_device()
        records, errs = {}, dict.fromkeys(KERNELS, 0.0)
        granite_rows(torch.Generator(device="cuda").manual_seed(0), records,
                     errs)
        for r in records.values():
            log(f"  {r['name']} ({r['path']}) [{r['shape']}]: "
                f"{r['ms']:.4f} ms, queued {r['device_ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
        print(json.dumps({"kernels": list(records.values())}))
        print(json.dumps({"ok": True, "device": device}))
        return 0
    t0 = time.perf_counter()
    device = phase_device()
    # the dry run's sweep, host work beside phases 2-4, read in phase 5;
    # the schedulers' processes: phase 7's on the committed tables from
    # phase 6 on, phase 6's on this run's grid from the grid's end
    procs = {"dryrun": start_dryrun()}
    try:
        timed(phase_build)
        records = timed(phase_kernels)
        timed(phase_parity)
        timed(phase_serve, records, procs["dryrun"])
        procs["committed"] = start_serve(*COMMITTED_REPLAY)
        grid = timed(phase_partitions, records, procs)
        timed(phase_interference, records, grid)
        timed(phase_train, records)
        timed(finish_schedules, procs)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"total {time.perf_counter() - t0:.1f} s")
    keys = ("name", "path", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "library_device_ms", "plain_device_ms",
            "partition_sms",
            "partition_ms", "partition_max_abs_err", "fwd_bwd_ms",
            "plain_fwd_bwd_ms", "library_fwd_bwd_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in records.values()]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
