"""Interference on the card: co-run factors and solo features of the served
models on SM partitions (paper §3.2, §4.4, Figs. 6 and 9).

    python -m repro_torch.launch.profile_interference [--archs A,B,...] \\
        [--batches 1,8,32] [--out-dir results/out]

The card's counterpart of ``core/interference.py::profile_pairs_dataset``.
One run on one card writes three files into ``--out-dir``:

  * ``h100_lbp.jsonl``: the L(b, p) grid (``profile_partitions.profile``:
    every arch, by default the JAX package's serving mix, on the six
    partition sizes at batches 1-32);
  * ``h100_corun.jsonl``: the co-run grid.  For each carve of the SMs
    (``core.h100lets.CARVES``: 24 + 108, 56 + 76 and 64 + 68 SMs on the
    H100; their two sides cover the paper's five splits) and each ordered
    pair of archs, the left arch's decode step at each batch of
    ``--batches`` is captured on the left side and the right arch's on the
    right (``profile_partitions.captured``: a cache of its own, so a model
    can sit beside itself), then the pair runs side by side at every pair
    of batches (``profile_partitions.corun``): one line each with both
    sides' arch, percent, SMs, batch, solo and co-run ms and factor (index
    0 the carve's left side).  At most the two models of the pair are held
    (the five of the mix weigh about 71 GB in bf16): a left arch's model
    and graphs live through its row of right archs, a right arch's are
    freed after its nine co-runs.  5 archs, 3 carves and 3 batches make
    25 x 3 x 9 = 675 co-runs;
  * ``h100_features.jsonl``: per arch, partition size and batch (those of
    ``--batches`` and ``FEATURE_BATCH``), the share of the HBM rate one
    decode step uses alone: its bytes (``core.h100intf.step_bytes``) over
    its L(b, p) from the grid above.  The L2 share is not measured
    (``L2_REASON``): ``l2`` is null, and the predictor is DRAM-only.

Then it prints the factors' distribution (Fig. 6: the share of co-run
sides under x1.18, the worst pair) and the fitted predictor's error
(Fig. 9; ``core.h100intf.fit_measured``).  Everything runs on the card; a
partition, capture or replay that fails raises.

``partner(kind, part)`` captures a synthetic step that loads one shared
resource of the card (``PARTNERS``: the front end that launches kernels,
HBM, or the SMs' tensor cores); co-run beside a model's step, it tells
which resource that step contends for (``chip_smoke.py`` phase 7).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import torch

from repro_torch.core.h100intf import (CORUN_BATCHES, CorunTable,
                                       FeatureTable, corun_summary,
                                       features_from_grid, fit_measured)
from repro_torch.core.h100lets import CARVES
from repro_torch.core.interference import FEATURE_BATCH
from repro_torch.launch import profile_partitions as pp

OUT_DIR = "results/out"
#: why the features carry no L2 share
L2_REASON = ("not measured: Nsight Compute (ncu) on the card's machine fails "
             "to initialise its profiler (LibraryNotLoaded), and no other L2 "
             "counter is read")
#: synthetic partners, each loading one resource: 2000 one-element adds
#: (kernel launches, no bytes), four copies of 1 GiB (HBM, four launches),
#: two bf16 matmuls of 8192 (tensor cores, two launches)
PARTNERS = ("launches", "bytes", "math")


def partner(kind: str, part):
    """A step of ``kind`` (``PARTNERS``) captured as a CUDA graph on
    ``part`` after one eager warm-up there, replayed once.  Returns
    (graph, the tensors it reads and writes)."""
    dev = torch.device("cuda", part.device)
    with part, torch.inference_mode():
        if kind == "launches":
            keep = (torch.zeros(1, device=dev),)
            step = lambda: [keep[0].add_(1) for _ in range(2000)]  # noqa: E731
        elif kind == "bytes":
            src = torch.zeros(2**29, dtype=torch.bfloat16, device=dev)
            keep = (src, torch.empty_like(src))
            step = lambda: [keep[1].copy_(keep[0]) for _ in range(4)]  # noqa: E731
        elif kind == "math":
            a = torch.randn(8192, 8192, device=dev).bfloat16()
            keep = (a, torch.empty_like(a))
            step = lambda: [torch.matmul(a, a, out=keep[1])  # noqa: E731
                            for _ in range(2)]
        else:
            raise ValueError(f"no partner {kind!r}; have {PARTNERS}")
        step()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=part.stream):
            step()
        graph.replay()
    part.synchronize()
    return graph, keep


def corun_grid(archs, carves, batches, *, seed: int,
               ident: tuple[str, float], log=print) -> list[dict]:
    """The co-run grid: one record per (carve, left arch and batch, right
    arch and batch).  Models are built from ``seed`` at full width, at
    most the two of a pair at a time; a left arch's model and graphs live
    through its row of right archs."""
    from repro_torch.launch.partition import split
    versions = {"torch": torch.__version__, "cuda": torch.version.cuda}
    records = []
    for carve in carves:
        t0 = time.perf_counter()
        parts = split(carve)
        for al in archs:
            model_l = pp.build(al, device="cuda", seed=seed)
            left = {b: pp.captured(model_l, b, parts[0], seed=seed)
                    for b in batches}
            for ar in archs:
                model_r = (model_l if ar == al
                           else pp.build(ar, device="cuda", seed=seed))
                right = {b: pp.captured(model_r, b, parts[1], seed=seed + 1)
                         for b in batches}
                log(f"  carve {carve}/{100 - carve} ({parts[0].sms} + "
                    f"{parts[1].sms} SMs), {al} | {ar}: "
                    f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB "
                    f"allocated, {time.perf_counter() - t0:.1f} s")
                for bl in batches:
                    for br in batches:
                        f = pp.corun(left[bl][0], parts[0], right[br][0],
                                     parts[1])
                        records.append({
                            "card": ident[0], "power_limit_w": ident[1],
                            **versions, "carve": carve, "arch": [al, ar],
                            "percent": [p.percent for p in parts],
                            "sms": [p.sms for p in parts],
                            "batch": [bl, br], "ctx": pp.CTX, **f})
                        log(f"    {carve}/{100 - carve} {al} b{bl} x"
                            f"{f['factor'][0]:.3f} | {ar} b{br} x"
                            f"{f['factor'][1]:.3f} (launch "
                            f"{f['launch_ms']:.1f} of {max(f['span_ms']):.1f}"
                            " ms)")
                del model_r
                _free(right)
            del model_l
            _free(left)
        log(f"  carve {carve}: done in {time.perf_counter() - t0:.1f} s, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return records


def _free(captures: dict):
    """Free captured graphs, their caches and their pools."""
    for graph, _, _ in captures.values():
        graph.reset()
    captures.clear()
    torch.cuda.empty_cache()


def summary(corun: CorunTable, features: FeatureTable) -> dict:
    """Fig. 6 and Fig. 9 numbers of a measured pair of tables."""
    _, stats = fit_measured(corun, features)
    return {**corun_summary(corun), "fit": stats}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", default=",".join(pp.ARCHS))
    ap.add_argument("--batches", default=",".join(map(str, CORUN_BATCHES)))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    archs = args.archs.split(",")
    batches = [int(b) for b in args.batches.split(",")]
    out = Path(args.out_dir)
    t0 = time.perf_counter()
    log = lambda line: print(line, flush=True)  # noqa: E731

    log("L(b, p) grid")
    grid = pp.profile(archs, seed=args.seed, log=log)
    pp.write(grid, out / "h100_lbp.jsonl")
    log(pp.table(grid))
    ident = (grid[0]["card"], grid[0]["power_limit_w"])

    log(f"co-run grid: {len(archs) ** 2} ordered pairs x {len(CARVES)} "
        f"carves x {len(batches) ** 2} batch pairs")
    records = corun_grid(archs, CARVES, batches, seed=args.seed,
                         ident=ident, log=log)
    if not all(t > 0 and math.isfinite(t) for r in records
               for t in r["solo_ms"] + r["corun_ms"]):
        raise RuntimeError("a co-run has no finite time")
    pp.write(records, out / "h100_corun.jsonl")
    feats = features_from_grid(grid, sorted({*batches, FEATURE_BATCH}),
                               l2_reason=L2_REASON)
    pp.write(feats, out / "h100_features.jsonl")
    print(json.dumps({
        "card": ident[0], "power_limit_w": ident[1], "co_runs": len(records),
        "features": len(feats), "seconds": time.perf_counter() - t0,
        **summary(CorunTable(records), FeatureTable(feats))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
