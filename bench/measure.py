"""The measurements a cell is defined from, each in one process on the card.

    python3 bench/measure.py batch-latency --workload yi9b.prompts --seed 7
    python3 bench/measure.py sweep --workload hubert.clips --seed 7 \\
        --seconds 10 --rates 60,90,120
    python3 bench/measure.py calibrate --workload hubert.clips \\
        --seeds 1,2,3 --control-seeds 1,2 --seconds 8

    python3 bench/measure.py once --config bench/configs/<c>.json \
        --traffic <t> --seed 7 --seconds 30

``batch-latency``: the host wall time of one batch at the stream's cap,
for each length (median of 3 after the warm-up): the SLO's base.
``sweep``: the window at each offered rate, one model build for all; a
JSON line a rate with the end-to-end metrics, the failed requests and the
backlog left when the window closed.  ``calibrate``: a short window for
each seed, the weights, inputs and arrivals made again from it, and the
output check's verdict and readings; on the control seeds the verdict is
the float8 control's, put in the program's place.
These are the readings the check's limit is set from.  ``once``: one
run as ``run.py`` makes it (``--scale --rates F``: every stream's rate
times F).  ``--config`` and ``--traffic`` name files
that no cell of ``BENCHMARK.json`` lists yet, in place of
``--workload``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import cell as cell_mod  # noqa: E402
from bench import check, serve, spec, traffic, weights  # noqa: E402


def batch_latency(cell, args, device):
    sides, _ = cell_mod.build(cell, args.seed, 1.0, device)
    for s in sides:
        with torch.inference_mode(), s.context():
            for length in s.stream["lengths"]:
                n = traffic.cap(s.stream, length)
                rids = np.resize(np.flatnonzero(s.sched.length == length)
                                 if (s.sched.length == length).any()
                                 else np.array([0]), n)
                times = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    s.entry(rids)
                    times.append((time.perf_counter() - t) * 1e3)
                print(json.dumps({"model": s.name, "length": length,
                                  "batch": n, "ms": times,
                                  "median_ms": statistics.median(times)}),
                      flush=True)


def _backlog(side, seconds) -> int:
    late = ~(side.dispatch < seconds)
    return int(np.sum(late & (side.sched.due < seconds)))


def sweep(cell, args, device):
    sides, _ = cell_mod.build(cell, args.seed, args.seconds, device)
    for rate in [float(r) for r in args.rates.split(",")]:
        for i, s in enumerate(sides):
            stream = dict(s.stream, rate_rps=rate * s.stream["rate_rps"]
                          if args.scale else rate)
            s.sched = traffic.schedule(stream, args.seconds, args.seed, i,
                                       weights.POOL)
            s.outputs, s.batches, s.waits, s.lateness = {}, [], [], []
        run = cell_mod.window(cell, sides, args.seconds, False,
                              time.perf_counter())
        cell_mod.report(run)
        print(json.dumps({
            "rate": rate, "seconds": args.seconds,
            "offered_rps": sum(len(s.sched.due) for s in sides)
            / args.seconds,
            "metrics": {k: v["value"] for k, v in
                        cell_mod.metrics(run, False).items()
                        if k != "setup_s"},
            "failed": int(sum(serve.failed(s, args.seconds).sum()
                              for s in sides)),
            "backlog_at_close": sum(_backlog(s, args.seconds)
                                    for s in sides),
            "batch_mean": float(np.mean([len(b.rids) for s in sides
                                         for b in s.batches]))}),
            flush=True)


def calibrate(cell, args, device):
    seeds = [int(x) for x in args.seeds.split(",")]
    control = {int(x) for x in args.control_seeds.split(",") if x}
    sides, _ = cell_mod.build(cell, seeds[0], args.seconds, device)
    for seed in seeds:
        for i, s in enumerate(sides):
            cell_mod.reseed(s, i, seed, args.seconds)
        t = time.perf_counter()
        run = cell_mod.window(cell, sides, args.seconds, False, t)
        cell_mod.report(run)
        t = time.perf_counter()
        correct, numbers = check.verdict(sides, args.seconds, seed,
                                         seed in control)
        print(json.dumps({"seed": seed, "control": seed in control,
                          "correct": correct, "check": numbers,
                          "reference_s": time.perf_counter() - t,
                          "failed": sum(int(serve.failed(
                              s, args.seconds).sum()) for s in sides)}),
              flush=True)


def once(cell, args, device):
    if args.scale:
        for stream in cell.traffic["streams"].values():
            stream["rate_rps"] *= float(args.rates)
    out = cell_mod.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device=device)
    print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("batch-latency", "sweep", "calibrate",
                                     "once"))
    ap.add_argument("--workload")
    ap.add_argument("--config", help="a configuration file, with --traffic")
    ap.add_argument("--traffic")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", default="")
    ap.add_argument("--scale", action="store_true",
                    help="--rates are factors of each stream's own rate "
                         "(once: one factor)")
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    cell = (spec.cell_from_files(args.config, args.traffic)
            if args.config else spec.load_cell(args.workload))
    if not torch.cuda.is_available():
        sys.exit("bench/measure.py: no CUDA card")
    device = "cuda"
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)
    {"batch-latency": batch_latency, "sweep": sweep, "calibrate": calibrate,
     "once": once}[args.what](cell, args, device)


if __name__ == "__main__":
    main()
