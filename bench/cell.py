"""One run of one cell: set-up, the window, the readers, the check.

``run_cell`` is what ``run.py`` calls once the card is found; the tests
call it on the CPU at a small size.  Set-up builds each side's model
through the port (``repro_torch.models.model.Model`` at the
configuration's fields, bf16), copies the seed's weights into it, makes
the input pool and the arrival schedule, and warms up every batch shape
the stream uses.  The window then runs (``serve.serve``), traced with
``trace``.  Then the readers of the cell's metrics, and last the output
check against the reference, after the program's models are freed.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from bench import check, flops, serve, spec, traffic, weights
from bench import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: spec.Cell
    seconds: float
    sides: list
    setup_s: float
    device_kind: str
    trace: trace_mod.Trace | None = None

    @property
    def peak(self) -> dict | None:
        return flops.peaks(self.device_kind)

    def latencies_s(self) -> np.ndarray:
        return np.concatenate([serve.latency_s(s, self.seconds)
                               for s in self.sides])


def forbidden_modules(names) -> list[str]:
    """The forbidden top-level names among module ``names``, each compared
    whole (the part before the first dot)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def build_side(cell: spec.Cell, i: int, side_spec: dict, seed: int,
               seconds: float, device) -> serve.Side:
    """Side ``i`` of the configuration: the port's model at the
    configuration's fields, the seed's weights and inputs, the schedule."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model
    name = side_spec["model"]
    entry = cell.config["models"][name]
    cfg = ModelConfig(name=name, **entry["fields"])
    model = Model(cfg, dtype=getattr(torch, cell.config["dtype"]),
                  device=device)
    part = None
    if side_spec["percent"] < 100:
        from repro_torch.launch.partition import partition
        part = partition(side_spec["percent"])
    side = serve.Side(name=name, entry_spec=entry,
                      stream=cell.traffic["streams"][name], sched=None,
                      model=model, pool=None, part=part)
    return reseed(side, i, seed, seconds)


def reseed(side: serve.Side, i: int, seed: int,
           seconds: float) -> serve.Side:
    """The side's weights, inputs and schedule from ``seed``, and its
    record emptied."""
    dev = next(side.model.parameters()).device
    weights.load_into(side.model, side.entry_spec, seed)
    side.pool = weights.input_pool(side.entry_spec, dev, seed)
    side.sched = traffic.schedule(side.stream, seconds, seed, i,
                                  weights.POOL)
    side.outputs, side.batches, side.waits, side.lateness = {}, [], [], []
    return side


def build(cell: spec.Cell, seed: int, seconds: float, device="cuda"):
    """Every side, warmed up, and the seconds each part of that took."""
    t = time.perf_counter()
    sides = [build_side(cell, i, s, seed, seconds, device)
             for i, s in enumerate(cell.config["sides"])]
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    parts = {"models_weights_inputs_s": time.perf_counter() - t}
    t = time.perf_counter()
    for s in sides:
        serve.warm_up(s)
    parts["warm_up_s"] = time.perf_counter() - t
    return sides, parts


def window(cell: spec.Cell, sides, seconds: float, trace: bool,
           t_start: float) -> Run:
    """The measured window (traced with ``trace`` on a card)."""
    cuda = sides[0].pool.is_cuda
    tracer = trace_mod.Tracer() if trace and cuda else None
    if tracer:
        tracer.start()
    t0 = serve.serve(sides, seconds)
    t1 = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
    run = Run(cell, seconds, sides, t0 - t_start,
              torch.cuda.get_device_name(0) if cuda else "cpu")
    if tracer:
        t = time.perf_counter()
        activity, end = tracer.stop()
        run.trace = trace_mod.reduce(activity, sides, t0, t0, min(t1, end))
        print(f"trace: {len(activity)} device activities to "
              f"{min(t1, end) - t0:.2f} s of the window and drain "
              f"({t1 - t0:.2f} s); the profiler's stop {tracer.stop_s:.2f} "
              f"s, reading and reducing "
              f"{time.perf_counter() - t - tracer.stop_s:.2f} s",
              file=sys.stderr)
    return run


def metrics(run: Run, trace: bool) -> dict:
    out = {}
    for m in (run.cell.per_layer if trace else run.cell.end_to_end):
        value = spec.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _stats(lat_ms) -> str:
    if not len(lat_ms):
        return "none"
    return "p50 %.1f p95 %.1f p99 %.1f ms" % tuple(
        np.percentile(lat_ms, [50, 95, 99]))


def report(run: Run, log=sys.stderr):
    """How the loop went, on an earlier line than the result."""
    for s in run.sides:
        lat = serve.latency_s(s, run.seconds) * 1e3
        late = np.asarray(s.lateness) * 1e3
        print(f"[{s.name}] {len(lat)} requests due in {run.seconds} s, "
              f"{int(serve.failed(s, run.seconds).sum())} failed, "
              f"{len(s.batches)} batches; latency {_stats(lat)}; the loop "
              f"woke late by p50 "
              f"{np.median(late) if len(late) else 0:.3f} / max "
              f"{late.max() if len(late) else 0:.3f} ms over {len(late)} "
              f"waits; set-up {run.setup_s:.2f} s", file=log)


def free_models(sides):
    """Drop the program's models and state before the reference runs."""
    for s in sides:
        s.model = None
    gc.collect()
    if sides[0].pool.is_cuda:
        torch.cuda.empty_cache()


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             control: bool = False, log=sys.stderr) -> dict:
    """One run: set-up, window, metrics, the output check.  The result's
    keys in order, ``check`` last."""
    t_start = time.perf_counter() if t_start is None else t_start
    t_build = time.perf_counter()
    sides, parts = build(cell, seed, seconds, device)
    run = window(cell, sides, seconds, trace, t_start)
    cuda = sides[0].pool.is_cuda
    device_info = {
        "platform": "gpu" if cuda else "cpu", "kind": run.device_kind,
        "count": cell.chips if cuda else 0,
        "memory_peak_bytes": torch.cuda.max_memory_allocated(0) if cuda
        else 0}
    if run.trace:
        device_info.update(busy_s=run.trace.busy_s,
                           window_s=run.trace.window_s)
    out = {"correct": False,
           "attempted": sum(len(s.sched.due) for s in sides),
           "failed": int(sum(serve.failed(s, seconds).sum() for s in sides)),
           "metrics": metrics(run, trace), "device": device_info}
    if run.trace:
        out["breakdown"] = breakdown(run.trace)
    report(run, log)
    print(f"set-up {run.setup_s:.2f} s: imports and card "
          f"{t_build - t_start:.2f}, " + ", ".join(
              f"{k} {v:.2f}" for k, v in parts.items()), file=log)
    free_models(sides)
    t = time.perf_counter()
    out["correct"], numbers = check.verdict(sides, seconds, seed, control)
    print(f"reference check {time.perf_counter() - t:.2f} s", file=log)
    found = forbidden_modules(sys.modules)
    if found:
        raise ImportError(f"the run loaded {found}: the benchmark and the "
                          "port must not import JAX or the JAX package")
    out["check"] = numbers
    return out


def breakdown(tr: trace_mod.Trace, top: int = 10) -> dict:
    ops = sorted(tr.by_name.items(), key=lambda kv: -kv[1][1])[:top]
    gaps = sorted(tr.gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, (_, s) in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}

