"""L(b, p) of the served models, measured on SM partitions of the card.

    python -m repro_torch.launch.profile_partitions [--archs A,B,...] \\
        [--batches 1,2,4,8,16,32] [--out results/out/h100_lbp.jsonl]

The card's counterpart of the JAX package's ``launch/dryrun.py`` as the
source of the scheduler's catalog (``core/h100lets.load_catalog``): where
the JAX package derives L(b, p) from a compiled step's roofline terms, this
measures it.  L(b, p) is one decode step at batch b (as ``core/tpulets``
takes the decode step) on a partition of p% of the card's SMs
(``launch/partition.py``: 20, 40, 50, 60, 80 and 100%):

  * each arch (by default those of the JAX package's serving mix,
    ``core.h100lets.MIX``) at full published width and depth, bf16,
    random weights from ``--seed``; a cache of ``CTX`` = 1024 valid
    positions (1032 slots; a hybrid keeps its windowed ring) filled from
    the seeded generator, so prefill stays out of the grid's time (a
    step's time does not depend on the values);
  * with the partition's context current, a few eager steps warm up and
    are timed on the host (``eager_wall_ms``, median, ending in a
    synchronise), then one step is captured in a ``torch.cuda.CUDAGraph``
    on the partition's stream and replayed: after ``WARMUP`` replays, each
    of ``RUNS`` replays is timed by CUDA events, and ``step_ms`` is their
    median.  The graph's pool is freed before the next cell.  The eager step
    is host-bound (1700-3600 launches a step), which would flatten L(b, p)
    in p; the graph is the port's counterpart of the JAX package's compiled
    step;
  * a step that cannot be captured raises: nothing falls back to the eager
    time, and a partition that cannot be made raises too.

An encoder-only arch (hubert-xlarge) has no decode step: as the JAX
package's ``core/tpulets.load_catalog`` schedules such an arch by its
prefill record, its step here is one ``forward`` of ``FRAMES`` = 1024
frame embeddings a request (about 20 s of 16 kHz audio at HuBERT's 20 ms
frame stride; the same 1024 positions as a decode step's cache), drawn
from the seeded generator, captured and replayed the same way.

One JSON line per (arch, percent, batch): ``card`` and ``power_limit_w``
(``nvidia-smi``), ``arch``, ``percent``, ``sms`` (granted), the ``carve``
and ``side`` it ran on and every carve's granted (left, right) SMs
(``split_sms``; ``core.h100lets.carve_of``: 60% is the right side of the
40/60 carve, so each percent runs on one SM count), ``batch``, ``step``
(``"decode"`` or ``"forward"``) with ``ctx`` and ``cache_slots`` (a
decode step's) or ``frames`` (a forward's), the step's bytes
(``weight_bytes``, ``bytes_per_req``: ``core.h100intf.step_bytes``),
``step_ms`` with ``runs`` and ``run_ms``, ``eager_wall_ms``, and the torch
and CUDA versions.  (Records of the files committed before the forward
step was measured carry no ``step``: they are decode steps.)

``--smoke --device cpu`` writes the same records for the smoke configs
with every partition stubbed to the whole CPU and no graph: ``step_ms`` is
null there ("not measured"; a CPU run gives no device time) and
``eager_wall_ms`` is the host's.  ``corun`` measures two captured
steps in flight at once on the two sides of a split (the co-run factors;
``launch/profile_interference.py`` runs the grid of them).
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.h100intf import step_bytes
from repro_torch.core.h100lets import CARVES, MIX, carve_of, step_kind
from repro_torch.core.latency import PARTITION_SIZES
from repro_torch.models.model import Model

ARCHS = tuple(MIX)
BATCHES = (1, 2, 4, 8, 16, 32)
CTX = 1024          # valid cache positions before the measured step
SLOTS = 1032        # cache slots: the step writes position CTX
FRAMES = 1024       # frames a request of an encoder's forward step
WARMUP = 3          # graph replays before the timed ones
RUNS = 10           # timed replays; step_ms is their median
EAGER_RUNS = 3      # timed eager steps (after one warm-up step)
CORUN_REPLAYS = 20  # replays of each graph in a co-run measurement
OUT = "results/out/h100_lbp.jsonl"


def card_identity() -> tuple[str, float]:
    """(name, power limit in W) as ``nvidia-smi`` gives them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name, power = (x.strip() for x in line.rsplit(",", 1))
    return name, float(power.split()[0])


def build(arch: str, *, device, seed: int = 0, smoke: bool = False) -> Model:
    """``arch`` at full width and depth (its smoke config if ``smoke``),
    bf16, weights from ``seed`` on the device."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = Model(cfg, dtype=torch.bfloat16, device=device)
    return model.init(torch.Generator(device=model.device).manual_seed(seed))


def filled_cache(model: Model, batch: int, seed: int) -> tuple[dict, object]:
    """A decode cache at ``CTX`` valid positions, every tensor filled from
    a generator seeded with ``seed``, and the step's (batch, 1) tokens."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    cache = model.init_cache(batch, SLOTS)
    for layer in cache["layers"]:
        for t in layer.values():
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device,
                                dtype=torch.float32))
    cache["len"] = CTX
    tokens = torch.randint(0, model.cfg.vocab_size, (batch, 1),
                           generator=gen, device=model.device)
    return cache, tokens


def frame_inputs(model: Model, batch: int, seed: int):
    """(batch, ``FRAMES``, d_model) frame embeddings from a generator
    seeded with ``seed``."""
    from repro_torch.models.frontend import audio_frame_embeddings
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return audio_frame_embeddings(gen, batch, FRAMES, model.cfg,
                                  device=model.device, dtype=model.dtype)


class _WholeCPU:
    """The partition step stubbed to the whole CPU (``--device cpu``)."""

    def __init__(self, percent: int):
        self.percent, self.sms = percent, None
        self.carve, self.side = carve_of(percent)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def synchronize(self):
        pass


def eager_wall_ms(step, part, runs: int = EAGER_RUNS) -> float:
    """Median host wall time of one eager call of ``step`` on ``part``
    (its context current), ending in a synchronise, after one warm-up
    call."""
    times = []
    for i in range(runs + 1):
        t0 = time.perf_counter()
        step()
        part.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def capture(model: Model, cache: dict, tokens, part):
    """One decode step captured as a CUDA graph on ``part``'s stream (its
    context current).  Returns (graph, logits of the captured step).

    A recurrent layer's step puts new state tensors in its cache dict
    (from the graph's pool) in place of the ones it read.  The dict gets
    the tensors it held back after the capture, so that the graph's inputs
    stay alive, and unchanged, as long as the cache: every replay reads
    the same state and writes the next one into the pool, as one step
    does.  (Without this the inputs were freed at the capture, and a graph
    replayed after other allocations touched freed memory.)"""
    inputs = [dict(layer) for layer in cache["layers"]]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=part.stream):
        logits, _ = model.decode_step(cache, tokens)
    for layer, held in zip(cache["layers"], inputs):
        layer.update(held)
    return graph, logits


def capture_forward(model: Model, frames, part):
    """An encoder's forward over ``frames`` captured as a CUDA graph on
    ``part``'s stream (its context current).  Returns (graph, logits)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=part.stream):
        logits = model.forward(frame_embeds=frames)
    return graph, logits


def replay_ms(graph, part, runs: int = RUNS,
              warmup: int = WARMUP) -> list[float]:
    """Each of ``runs`` replays of ``graph`` on ``part``, timed by CUDA
    events around it, after ``warmup`` replays."""
    for _ in range(warmup):
        graph.replay()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    for start, end in events:
        start.record()
        graph.replay()
        end.record()
    part.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def measure(model: Model, arch: str, batches, parts, *, seed: int,
            device, ident: tuple[str, float | None],
            split_sms: dict | None = None, log=print) -> list[dict]:
    """The (percent, batch) cells of one arch: one record each."""
    records = []
    versions = {"torch": torch.__version__, "cuda": torch.version.cuda}
    kind = step_kind(model.cfg)
    forward = kind == "forward"
    nbytes = step_bytes(model.cfg, 1, FRAMES if forward else CTX)
    shape = ({"ctx": None, "cache_slots": None, "frames": FRAMES} if forward
             else {"ctx": CTX, "cache_slots": SLOTS, "frames": None})
    for batch in batches:
        with torch.inference_mode():
            # (frames,) of a forward, (cache, tokens) of a decode step
            inputs = ((frame_inputs(model, batch, seed),) if forward
                      else filled_cache(model, batch, seed))
        step = (functools.partial(model.forward, frame_embeds=inputs[0])
                if forward else functools.partial(model.decode_step, *inputs))
        for part in parts:
            with part, torch.inference_mode():
                eager = eager_wall_ms(step, part)
                run_ms = None
                if device.type == "cuda":
                    graph, _ = (capture_forward if forward else capture)(
                        model, *inputs, part)
                    run_ms = replay_ms(graph, part)
                    graph.reset()
                    del graph
            rec = {"card": ident[0], "power_limit_w": ident[1],
                   "arch": arch, "percent": part.percent, "sms": part.sms,
                   "carve": part.carve, "side": part.side,
                   "split_sms": split_sms, "batch": batch, "step": kind,
                   **shape, "layers": model.cfg.n_layers,
                   "dtype": "bfloat16",
                   "weight_bytes": nbytes["weights"],
                   "bytes_per_req": nbytes["per_request"],
                   "step_ms": (statistics.median(run_ms) if run_ms
                               else None),
                   "step_source": ("cuda-graph replay, median" if run_ms
                                   else "not measured (cpu)"),
                   "runs": len(run_ms or ()), "run_ms": run_ms,
                   "eager_wall_ms": eager, "eager_runs": EAGER_RUNS,
                   **versions}
            records.append(rec)
            ms = "-" if rec["step_ms"] is None else f"{rec['step_ms']:.4f}"
            log(f"    {arch} {part.percent}% ({part.sms} SMs) b{batch}: "
                f"{kind} graph {ms} ms, eager wall {eager:.2f} ms")
        del step, inputs
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return records


def make_partitions(percents, device):
    """One partition per size, and every carve's granted (left, right)
    SMs; on the CPU the whole CPU, stubbed, and no SM counts."""
    if device.type != "cuda":
        return [_WholeCPU(p) for p in percents], None
    from repro_torch.launch.partition import partition, split_sms
    index = device.index or 0
    return ([partition(p, index) for p in percents],
            {str(c): list(s) for c, s in split_sms(CARVES, index).items()})


def profile(archs=ARCHS, batches=BATCHES, percents=PARTITION_SIZES, *,
            device="cuda", seed: int = 0, smoke: bool = False,
            log=print) -> list[dict]:
    """Measure the grid; returns the records."""
    device = torch.device(device)
    if device.type == "cuda":
        from repro_torch.models.model import resolve_device
        resolve_device(device)
        device = torch.device("cuda", device.index or 0)
        ident = card_identity()
    else:
        ident = ("cpu", None)
    parts, grants = make_partitions(percents, device)
    records = []
    for arch in archs:
        model = build(arch, device=device, seed=seed, smoke=smoke)
        records += measure(model, arch, batches, parts, seed=seed,
                           device=device, ident=ident, split_sms=grants,
                           log=log)
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return records


def write(records, path: str):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def table(records) -> str:
    """A compact text table: per arch and batch, graph ms at each percent
    (granted SMs in the header)."""
    percents = sorted({r["percent"] for r in records})
    sms = {r["percent"]: r["sms"] for r in records}
    head = "arch / batch".ljust(24) + "".join(
        f"{p}% ({sms[p]})".rjust(14) for p in percents)
    lines = [head]
    cells = {(r["arch"], r["batch"], r["percent"]): r for r in records}
    for arch in dict.fromkeys(r["arch"] for r in records):
        for b in sorted({r["batch"] for r in records if r["arch"] == arch}):
            row = f"{arch} b{b}".ljust(24)
            for p in percents:
                r = cells.get((arch, b, p))
                v = None if r is None else r["step_ms"]
                row += ("-" if v is None else f"{v:.3f}").rjust(14)
            lines.append(row)
    return "\n".join(lines)


def captured(model: Model, batch: int, part, *, seed: int):
    """A decode step at ``batch`` (a filled cache from ``seed``) captured
    as a CUDA graph on ``part`` after one eager warm-up step there, and
    replayed once.  Returns (graph, cache, tokens): the caller keeps the
    cache and tokens, the graph's inputs, as long as the graph."""
    with torch.inference_mode():
        cache, tokens = filled_cache(model, batch, seed)
    with part, torch.inference_mode():
        model.decode_step(cache, tokens)
        graph, _ = capture(model, cache, tokens, part)
        graph.replay()
    part.synchronize()
    return graph, cache, tokens


def _replays(graphs, parts, counts, extra, est
             ) -> tuple[list[float], float, list[float]]:
    """Replay ``graphs[i]`` ``counts[i]`` times back to back on
    ``parts[i]`` between two CUDA events, then ``extra[i]`` times more
    (load for the other side, untimed).  The host launches the sides in
    turn, in the order of their expected start (``est[i]`` ms a replay),
    so they run side by side.  Every partition is synchronised before the
    first launch and after the last.  Returns (ms a timed replay, per side;
    the host's ms to launch them all; each side's timed span in ms)."""
    for part in parts:
        part.synchronize()
    t0 = time.perf_counter()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in graphs]
    total = [c + e for c, e in zip(counts, extra)]
    done = [0] * len(graphs)
    while True:
        left = [i for i in range(len(graphs)) if done[i] < total[i]]
        if not left:
            break
        i = min(left, key=lambda j: done[j] * est[j])
        with parts[i]:
            if done[i] == 0:
                events[i][0].record()
            graphs[i].replay()
            if done[i] == counts[i] - 1:
                events[i][1].record()
        done[i] += 1
    launch_ms = (time.perf_counter() - t0) * 1e3
    for part in parts:
        part.synchronize()
    spans = [start.elapsed_time(end) for start, end in events]
    return [t / n for t, n in zip(spans, counts)], launch_ms, spans


def corun(graph_a, part_a, graph_b, part_b) -> dict:
    """Each captured step's time with the other's in flight on the other
    partition, over its solo time on the same partition.

    Solo: ``CORUN_REPLAYS`` replays alone.  Co-run: both sides replay for
    about ``CORUN_REPLAYS`` of the slower one's solo steps (the faster one
    more times), timed by CUDA events around each side's run, and each
    then keeps replaying for half as long again untimed, so that neither
    side's timed run ends beside an idle partner.  ``launch_ms`` is the
    host's time to launch the co-run (timed and untimed replays): when it
    is well under ``span_ms``, the sides never waited on the host."""
    solo = [_replays([g], [p], [CORUN_REPLAYS], [0], [1.0])[0][0]
            for g, p in ((graph_a, part_a), (graph_b, part_b))]
    span = CORUN_REPLAYS * max(solo)
    counts = [math.ceil(span / t) for t in solo]
    extra = [math.ceil(0.5 * span / t) for t in solo]
    both, launch_ms, spans = _replays([graph_a, graph_b], [part_a, part_b],
                                      counts, extra, solo)
    return {"solo_ms": solo, "corun_ms": both, "replays": counts,
            "extra_replays": extra, "span_ms": spans, "launch_ms": launch_ms,
            "factor": [c / t for c, t in zip(both, solo)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)))
    ap.add_argument("--percents",
                    default=",".join(map(str, PARTITION_SIZES)))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configs (a few layers, narrow widths)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    records = profile(
        args.archs.split(","), [int(b) for b in args.batches.split(",")],
        [int(p) for p in args.percents.split(",")], device=args.device,
        seed=args.seed, smoke=args.smoke)
    write(records, args.out)
    print(table(records))
    print(f"{len(records)} records -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
