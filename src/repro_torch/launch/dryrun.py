"""One-card dry run: every (arch x shape) step traced on torch's ``meta``
device, priced, and checked against the card's memory.

The port's counterpart of the JAX package's ``launch/dryrun.py``.  JAX
lowers and compiles each combination for a 256- or 512-chip mesh and reads
XLA's analyses; the port has no compiler in between, so it runs the step
exactly as it runs on the card (``training/train.py::make_train_step``,
``Model.forward``, ``prefill``, ``decode_step``) on tensors that hold no
data, and counts as it goes:

  * ``flops``: outside the kernels, ``torch.utils.flop_counter``'s count of
    every matmul; inside them, each kernel's own formula (its module's
    ``cost``, charged by the ``meta`` route of ``kernels/ops.py``), which
    counts only the live work (a causal mask's live pairs);
  * ``bytes``: the inputs and outputs of every aten op outside the kernels
    (a row gather or scatter counts its rows, not its table; views and
    metadata ops nothing), plus the kernels' formula bytes.  This is the
    eager port's unfused traffic (``bytes_kind``), not XLA's fused "bytes
    accessed", and the two are not to be compared;
  * ``memory``: ``argument_size_in_bytes`` (parameters, the AdamW state
    when training, the batch and the cache), ``output_size_in_bytes`` (what
    the step made that its result or its arguments' tree hold: the logits,
    a replaced recurrent state), ``alias_size_in_bytes`` (arguments the
    step replaced and freed; as XLA's donated aliases, counted once),
    ``temp_size_in_bytes`` (the rest of the peak): arguments + temps +
    outputs - aliases is ``peak_bytes``, the most the step holds at once,
    from a ``TorchDispatchMode`` that adds each new storage when an op
    makes it and takes it off when it dies (a weakref finalizer).  No
    tensor of a step is held by reference cycles alone, so the peak does
    not move with when Python's collector runs (the first step included:
    ``models/transformer.py`` imports ``torch._dynamo`` before it, and the
    FLOP counter keeps no per-module grad hooks);
  * ``fits_one_card``: that peak at most ``H100_SXM.hbm_gb``, in decimal GB
    (80e9 bytes: the card has 85.0e9, the rest left to the CUDA context,
    the libraries' workspaces and the allocator);
  * ``per_device_argument_bytes``: the arguments on one chip of the mesh
    the flags name (16x16 by default), from ``launch/sharding.py``'s rules;
  * ``roofline`` on ``H100_SXM`` (989 TFLOP/s, 3.35 TB/s) for the one card.

``collective`` is null: one card, no SPMD partitioner, no collective.  Two
JAX pieces have no counterpart: ``collective_stats`` and
``bf16_convert_bytes`` parse XLA's HLO text, which the port does not
have; ``analysis_costs`` extrapolates in depth because XLA counts a loop
body once, while an eager trace counts every layer.  ``model_flops``,
``optimal_model_axis`` and ``optimal_fsdp`` are copied word for word.

A decode step runs at ``cache["len"] = seq_len - 1``: the last position,
where a 4096-slot ring has wrapped (position 524,287 of ``long_500k``).
Nothing is allocated on any device but ``meta``.  Usage:

  python -m repro_torch.launch.dryrun --arch yi-9b --shape long_500k
  python -m repro_torch.launch.dryrun --all --out results/out/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.h100lets import H100_SXM
from repro_torch.kernels import pricing
from repro_torch.launch import sharding as shr
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.specs import INPUT_SHAPES, applicable, input_specs
from repro_torch.models.model import Model
from repro_torch.training.optim import OptimConfig
from repro_torch.training.train import make_train_step

BYTES_KIND = ("eager, unfused: the inputs and outputs of every aten op "
              "outside the kernels, plus each kernel's own bytes; not XLA's "
              "fused bytes accessed")
COLLECTIVE_REASON = "one card: no SPMD partitioner, no collective"
CARD_BYTES = H100_SXM.hbm_gb * 1e9

aten = torch.ops.aten
# write-only ops: the destination is written, not read
_WRITES = {aten.copy_, aten.fill_, aten.zero_}
# row gathers and scatters: the rows they move, not the whole table
_GATHERS = {aten.embedding, aten.index_select, aten.gather}
_SCATTERS = {aten.index_copy_, aten.index_copy, aten.index_add_,
             aten.index_add, aten.scatter_, aten.scatter_add_}
# no data moved: allocation and metadata
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.detach, aten.alias, aten._unsafe_view,
         aten.lift_fresh, aten.set_, aten.resize_}


def model_flops(cfg, shape_name: str) -> float:
    """Useful ("model") FLOPs per step: 6*N*D train, 2*N*D forward."""
    info = INPUT_SHAPES[shape_name]
    n_active = cfg.active_param_count()
    tokens = info["global_batch"] * (
        info["seq_len"] if info["kind"] in ("train", "prefill") else 1)
    mult = 6.0 if info["kind"] == "train" else 2.0
    return mult * n_active * tokens


def optimal_model_axis(cfg, shape_name: str) -> int:
    """Best (data, model) factorization of the pod for this combo (§Perf).

    Heads (train/prefill) or KV heads (decode) must divide the model axis or
    GSPMD replicates attention work / falls back to contracting-dim cache
    shards with per-layer full-logits psums.  Pure-SSM archs keep 16.
    """
    kind = INPUT_SHAPES[shape_name]["kind"]
    if cfg.arch_type == "ssm":
        return 16
    if kind == "decode_long":
        # batch-1 windowed decode: the tiny ring cache makes the GQA psum
        # negligible while weight sharding dominates — keep the full 16.
        return 16
    if cfg.arch_type == "moe" and kind.startswith("decode"):
        # expert-parallel decode: narrowing the model axis multiplies the
        # per-device expert weight reads/gathers — keep 16 (measured: 32x8
        # was 2x worse for arctic decode).
        return 16
    if cfg.arch_type == "hybrid":
        # LRU width wants wide TP; only training's batch (256) tolerates the
        # dp=128 that heads=10 -> model=2 implies.  Measured: train 31x
        # better at 128x2, prefill 5x worse (batch 32 < dp floor).
        return 2 if kind == "train" else 16
    key_dim = cfg.n_kv_heads if kind.startswith("decode") else cfg.n_heads
    for m in (16, 8, 4, 2):
        if key_dim % m == 0:
            return m
    return 16  # replicate attention; everything else still shards


def optimal_fsdp(cfg, shape_name: str):
    """§Perf C3: dense/VLM decode wants 2D weight sharding (d_model over
    data) — weight reads /dp at the cost of tiny per-layer psums."""
    if (INPUT_SHAPES[shape_name]["kind"] == "decode"
            and cfg.arch_type in ("dense", "vlm")):
        return True
    return None


# ----------------------------------------------------------- the step ----


def build_step(model: Model, kind: str, specs: tuple, seq_len: int):
    """The step as the port runs it on ``model``'s device, on the arguments
    of ``input_specs``: returns (step, arguments), ``step()`` running it
    once and ``arguments`` the tree of everything it is given (parameters,
    the AdamW state, the batch, the cache).  A decode cache is set to
    ``seq_len - 1`` positions."""
    params = dict(model.named_parameters())
    if kind == "train":
        (batch,) = specs
        train_step = make_train_step(model, OptimConfig())
        return (lambda: train_step(batch),
                {"params": params, "opt_state": train_step.state,
                 "batch": batch})

    def serving(fn):
        def step():
            with torch.inference_mode():
                return fn()
        return step

    if kind == "encode":
        (batch,) = specs
        return (serving(lambda: model.forward(
            batch.get("tokens"), patch_embeds=batch.get("patch_embeds"),
            frame_embeds=batch.get("frame_embeds"))),
            {"params": params, "batch": batch})
    if kind == "prefill":
        batch, cache = specs
        return (serving(lambda: model.prefill(
            batch["tokens"], cache, patch_embeds=batch.get("patch_embeds"))),
            {"params": params, "batch": batch, "cache": cache})
    cache, tokens = specs
    cache["len"] = seq_len - 1
    return (serving(lambda: model.decode_step(cache, tokens)),
            {"params": params, "cache": cache, "batch": {"tokens": tokens}})


def tensor_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten op moves: its tensor inputs read once and outputs
    written once; a write-only op's destination only written; a row
    gather or scatter its index and the rows it moves (twice: read and
    written); views, allocation and metadata ops nothing."""
    packet = func._overloadpacket
    if func.is_view or packet in _FREE:
        return 0
    ins = [t for t in tree_leaves((args, kwargs))
           if isinstance(t, torch.Tensor)]
    outs = sum(_nbytes(t) for t in tree_leaves(out))
    if packet in _GATHERS or packet in _SCATTERS:
        rest = ins[1:]
        index = next((t for t in rest if not t.is_floating_point()), None)
        rows = (outs if packet in _GATHERS else
                _nbytes(next((t for t in rest if t.is_floating_point()),
                             None)))
        return _nbytes(index) + 2 * rows
    if packet in _WRITES:
        ins = ins[1:]
    return sum(_nbytes(t) for t in ins) + outs


class _FlopsOutsideKernels(FlopCounterMode):
    """``FlopCounterMode`` that skips the ops of a kernel's plain version
    (its CPU route, ``pricing.plain``) and counts the total only.  Its
    per-module tracker is left out: the grad hooks it puts on every
    module's inputs and outputs make reference cycles with the autograd
    graph, which keep a training step's saved tensors alive until Python's
    collector runs, so the step's peak would move with the collector."""

    def __init__(self):
        super().__init__(display=False)
        self.mod_tracker = contextlib.nullcontext()

    def _count_flops(self, func_packet, out, args, kwargs):
        count = self.flop_registry.get(func_packet)
        if count is not None and not pricing.inside():
            self.flop_counts["Global"][func_packet] += count(
                *args, **kwargs, out_val=out)
        return out


class _Meter(TorchDispatchMode):
    """Bytes moved by the aten ops outside the kernels, and the live bytes
    of every storage: the arguments' from the start, each new one from the
    op that makes it until it dies."""

    def __init__(self, arguments):
        super().__init__()
        self.bytes = 0
        self.new: dict[int, int] = {}   # live storages the step made
        self.args: dict[int, int] = {}  # live argument storages
        self.freed_args = 0
        for t in tree_leaves(arguments):
            if isinstance(t, torch.Tensor):
                self._watch(t.untyped_storage(), self.args)
        self.arg_bytes = sum(self.args.values())
        self.live = self.peak = self.arg_bytes

    def _watch(self, st, table):
        key = st._cdata
        if key in self.new or key in self.args:
            return
        table[key] = st.nbytes()
        weakref.finalize(st, self._died, key).atexit = False

    def made_in(self, *trees) -> int:
        """Bytes of the storages the step made that ``trees`` hold (its
        result, and the arguments' tree with the states it replaced)."""
        keys = {t.untyped_storage()._cdata for t in tree_leaves(trees)
                if isinstance(t, torch.Tensor)}
        return sum(self.new[k] for k in keys if k in self.new)

    def _died(self, key):
        if key in self.args:
            n = self.args.pop(key)
            self.freed_args += n
        else:
            n = self.new.pop(key, 0)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not pricing.inside():
            self.bytes += op_bytes(func, args, kwargs, out)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st._cdata not in self.new and st._cdata not in self.args:
                    self._watch(st, self.new)
                    self.live += self.new[st._cdata]
                    self.peak = max(self.peak, self.live)
        return out


def trace(step, arguments) -> dict:
    """Run ``step()`` once under the counters.  Returns its FLOPs and bytes
    (outside the kernels, and the kernels' own, by kernel), its memory and
    its wall time."""
    with pricing.pricing() as ledger, \
            _FlopsOutsideKernels() as flops:
        meter = _Meter(arguments)
        with meter:
            t0 = time.perf_counter()
            out = step()
            wall = time.perf_counter() - t0
            outputs = meter.made_in(out, arguments)
            alias = meter.freed_args
        del out, arguments
    kernels: dict = {}
    for name, ops, nbytes in ledger:
        k = kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += ops
        k["bytes"] += nbytes
    outside = flops.get_total_flops()
    return {
        "trace_s": wall,
        "flops_outside_kernels": outside, "bytes_outside_kernels": meter.bytes,
        "kernels": kernels,
        "flops": outside + sum(k["flops"] for k in kernels.values()),
        "bytes": meter.bytes + sum(k["bytes"] for k in kernels.values()),
        "memory": {
            "argument_size_in_bytes": meter.arg_bytes,
            "output_size_in_bytes": outputs,
            "alias_size_in_bytes": alias,
            "temp_size_in_bytes": meter.peak - (meter.arg_bytes - alias
                                                + outputs),
            "peak_bytes": meter.peak,
        },
    }


# ----------------------------------------------------------- one combo ----


def _mesh(multi_pod: bool, model_axis: int | None) -> Mesh:
    if model_axis is None:
        return make_production_mesh(multi_pod=multi_pod)
    if multi_pod:
        return Mesh.of((2, 256 // model_axis, model_axis),
                       ("pod", "data", "model"))
    return Mesh.of((256 // model_axis, model_axis), ("data", "model"))


def per_device_arguments(model, arguments: dict, mesh, fsdp: bool) -> int:
    """Bytes of the step's arguments (``build_step``'s) on one chip of
    ``mesh``, by ``launch/sharding.py``'s rules."""
    cfg = model.cfg
    p_sh = shr.param_specs(model, mesh, fsdp=fsdp)
    rules = {"batch": lambda t: shr.batch_shardings(cfg, t, mesh),
             "cache": lambda t: shr.cache_shardings(cfg, t, mesh),
             "opt_state": lambda t: shr.opt_shardings(p_sh, mesh)}
    return shr.per_device_bytes(model, p_sh, mesh) + sum(
        shr.per_device_bytes(tree, rules[key](tree), mesh)
        for key, tree in arguments.items() if key != "params")


def lower_combo(arch_id: str, shape_name: str, *, multi_pod: bool = False,
                fsdp_override: bool | None = None,
                model_axis: int | None = None) -> dict:
    """Trace one combination on ``meta``.  Returns a result record."""
    cfg = get_config(arch_id)
    ok, why = applicable(cfg, shape_name)
    mesh = _mesh(multi_pod, model_axis)
    mesh_name = mesh.name
    rec = dict(arch=arch_id, shape=shape_name, mesh=mesh_name)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec

    model = Model(cfg, device="meta")
    kind, specs = input_specs(cfg, shape_name, model=model)
    fsdp = (kind == "train") or cfg.fsdp_serving
    if fsdp_override is not None:
        fsdp = fsdp_override
    step, arguments = build_step(model, kind, specs,
                                 INPUT_SHAPES[shape_name]["seq_len"])
    del specs
    per_device = per_device_arguments(model, arguments, mesh, fsdp)
    parts = {key: tensor_bytes(tree) for key, tree in arguments.items()}
    res = trace(step, arguments)
    del step, arguments

    acc = H100_SXM
    flops, bytes_acc = res["flops"], res["bytes"]
    compute_s = flops / (acc.peak_tflops * 1e12)
    memory_s = bytes_acc / (acc.hbm_gbs * 1e9)
    mf = model_flops(cfg, shape_name)
    terms = dict(compute_s=compute_s, memory_s=memory_s)
    mem = res["memory"]
    rec.update(
        status="ok", step_kind=kind, fsdp=fsdp,
        trace_s=round(res["trace_s"], 2),
        flops=flops, bytes=bytes_acc, bytes_kind=BYTES_KIND,
        flops_outside_kernels=res["flops_outside_kernels"],
        bytes_outside_kernels=res["bytes_outside_kernels"],
        kernels=res["kernels"], memory=mem, argument_bytes=parts,
        fits_one_card=mem["peak_bytes"] <= CARD_BYTES, card_bytes=CARD_BYTES,
        per_device_argument_bytes=per_device,
        collective=None, collective_reason=COLLECTIVE_REASON,
        roofline=dict(
            **terms, dominant=max((v, k) for k, v in terms.items())[1],
            model_flops_global=mf,
            useful_flop_ratio=mf / flops if flops > 0 else -1),
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--model-axis", type=int, default=None,
                    help="re-factorize the chips as (chips/N, N) data x model")
    ap.add_argument("--optimized", action="store_true",
                    help="per-combo optimal model axis (see §Perf)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--force", action="store_true",
                    help="recompute combos already present in --out")
    args = ap.parse_args(argv)

    done = set()
    if args.out and os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass

    combos = []
    if args.all:
        for a in ARCH_IDS:
            for s in INPUT_SHAPES:
                combos.append((a, s))
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        combos = [(args.arch, args.shape)]

    out_f = open(args.out, "a") if args.out else None
    n_ok = n_skip = n_fail = 0
    for arch_id, shape_name in combos:
        mesh_name = None
        try:
            ma = args.model_axis
            fo = None
            if args.optimized:
                cfg_ = get_config(arch_id)
                if ma is None:
                    ma = optimal_model_axis(cfg_, shape_name)
                fo = optimal_fsdp(cfg_, shape_name)
            mesh_name = _mesh(args.multi_pod, ma).name
            if (arch_id, shape_name, mesh_name) in done:
                print(f"[cached] {arch_id} x {shape_name} x {mesh_name}")
                continue
            print(f"[dryrun] {arch_id} x {shape_name} x {mesh_name} ...",
                  flush=True)
            rec = lower_combo(arch_id, shape_name, multi_pod=args.multi_pod,
                              model_axis=ma, fsdp_override=fo)
        except Exception as e:
            rec = dict(arch=arch_id, shape=shape_name, mesh=mesh_name,
                       status="error", error=str(e)[-2000:],
                       traceback=traceback.format_exc()[-4000:])
        if rec["status"] == "ok":
            n_ok += 1
            r = rec["roofline"]
            print(f"  ok: trace={rec['trace_s']}s flops={rec['flops']:.3g} "
                  f"dominant={r['dominant']} terms=({r['compute_s']:.4g}, "
                  f"{r['memory_s']:.4g})s peak="
                  f"{rec['memory']['peak_bytes'] / 1e9:.1f} GB "
                  f"fits_one_card={rec['fits_one_card']}", flush=True)
        elif rec["status"] == "skipped":
            n_skip += 1
            print(f"  skipped: {rec['reason']}")
        else:
            n_fail += 1
            print(f"  ERROR: {rec['error'][:500]}")
        if out_f:
            out_f.write(json.dumps(rec) + "\n")
            out_f.flush()
        else:
            print(json.dumps(rec, indent=2))
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    if out_f:
        out_f.close()
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
