"""h100-lets: the paper's gpu-lets as SM partitions of one H100, with
L(b, p) measured on the card.

The counterpart of the JAX package's ``core/tpulets.py``.  There a tpu-let
is a sub-mesh of a pod and L(b, p) is derived from the compiled dry-run's
roofline terms.  Here a gpu-let is a set of SMs of the card (a green
context, ``launch/partition.py``) and L(b, p) is measured, as the paper
measured it on its 2080 Ti under MPS: ``launch/profile_partitions.py``
replays a CUDA graph of each served model's decode step on each partition
and writes one JSON line per (arch, percent, batch) to
``results/h100_lbp.jsonl``.

The card grants SMs in granules, so the two sides of a split are not the
percents they are named by.  Three carves of the SMs serve the five
splits (:data:`CARVES`): a split whose left side is above 50 is the mirror
of the carve of its right side, so each percent runs on one SM count, and
50 names two sides (the smaller one is measured).  Every record names the
carve and side it was measured on and the SMs the profile run's carves
granted (``split_sms``); :func:`load_catalog` refuses a file in which a
side of a split would be priced from more SMs than it gets.

:class:`MeasuredLatency` serves that table as the card gave it: it neither
smooths it nor makes it monotone.  A batch between two measured sizes runs
as the next measured size up (the graph captured at that batch, padded),
so its latency is that cell's.  SLOs follow the paper's convention, as
``tpulets`` does: 2x the solo full-card latency at batch 32.

A decoder's L(b, p) is a decode step.  An encoder-only arch
(hubert-xlarge) has none: as ``tpulets.load_catalog`` schedules it by its
prefill record, it is scheduled here by its ``forward`` records (one
forward of 1024 frames a request), with the same SLO convention.
"""
from __future__ import annotations

import dataclasses
import json
from bisect import bisect_left

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.hardware import AcceleratorSpec
from repro_torch.core.latency import (PARTITION_SIZES, SPLIT_PAIRS,
                                      LatencyProvider)
from repro_torch.core.profiles import ModelProfile

# The port's card: NVIDIA H100 SXM, under the name that
# torch.cuda.get_device_name gives it (and nvidia-smi, in the records of
# launch/profile_partitions.py).  Peaks from NVIDIA's data sheet, dense
# rates: 989 TFLOP/s bf16, 3.35 TB/s HBM3, 80 GB, NVLink 900 GB/s (450 each
# way).
H100_SXM = AcceleratorSpec(
    name="NVIDIA H100 80GB HBM3", peak_tflops=989.0, hbm_gbs=3350.0,
    hbm_gb=80.0, ici_gbs=450.0)
#: decode batches of the measured grid (the paper's range, up to 32)
LBP_BATCHES: tuple[int, ...] = (1, 2, 4, 8, 16, 32)
#: the calibration batch of the SLO convention
SLO_BATCH = 32
#: the JAX package's serving mix (``benchmarks/tpulet_serving.py``, ``MIX``):
#: arch -> rate weight
MIX = {"yi-9b": 1.0, "chatglm3-6b": 1.0, "mamba2-780m": 4.0,
       "deepseek-moe-16b": 1.0, "recurrentgemma-2b": 2.0}
#: the left percents of the carves that realise the paper's five splits:
#: (20, 80) and (80, 20) are one carve, (40, 60) and (60, 40) another
CARVES: tuple[int, ...] = (20, 40, 50)


def step_kind(cfg) -> str:
    """What L(b, p) times for ``cfg``: its decode step, or an
    encoder-only arch's forward."""
    return "decode" if cfg.has_decoder else "forward"


def carve_of(percent: int, position: int = 0) -> tuple[int, str]:
    """(carve, side) that a gpu-let of ``percent`` runs on; ``position`` is
    its place on its card (0 the first gpu-let, 1 the second), which only
    50 needs.  100 is the whole card: ``(100, "whole")``."""
    if percent == 100:
        return 100, "whole"
    if percent < 50:
        return percent, "left"
    if percent > 50:
        return 100 - percent, "right"
    return 50, ("left", "right")[position]


def granted_sms(split_sms: dict[int, tuple[int, int]], percent: int,
                position: int = 0) -> int:
    """SMs a gpu-let of ``percent`` at ``position`` on its card gets, from
    the granted counts of the carves (``split_sms[carve]`` = (left,
    right)); the whole card is both sides of a carve."""
    carve, side = carve_of(percent, position)
    if side == "whole":
        return sum(next(iter(split_sms.values())))
    return split_sms[carve][side == "right"]


class MeasuredLatency(LatencyProvider):
    """L(b, p) from a measured table: ``table[arch][(percent, batch)]`` in
    ms.  ``sms[percent]`` is the SM count each partition size was measured
    on, ``split_sms[carve]`` the (left, right) SMs each carve granted."""

    partition_sizes = PARTITION_SIZES
    split_pairs = SPLIT_PAIRS
    max_batch = 32

    def __init__(self, table: dict[str, dict[tuple[int, int], float]], *,
                 batch_sizes: tuple[int, ...] = LBP_BATCHES,
                 sms: dict[int, int] | None = None,
                 split_sms: dict[int, tuple[int, int]] | None = None,
                 card: str = "", steps: dict[str, str] | None = None):
        self.table = table
        self.batch_sizes = tuple(sorted(batch_sizes))
        self.sms = dict(sms or {})
        self.split_sms = dict(split_sms or {})
        self.card = card
        # arch -> the step its L(b, p) times ("decode" or "forward")
        self.steps = dict(steps or dict.fromkeys(table, "decode"))

    def latency_ms(self, prof: ModelProfile, batch: int, p: float) -> float:
        if batch <= 0:
            return 0.0
        percent = round(p * 100)
        i = bisect_left(self.batch_sizes, batch)
        if i == len(self.batch_sizes):
            raise ValueError(f"{prof.name}: batch {batch} is above the "
                             f"measured {self.batch_sizes[-1]}")
        try:
            return self.table[prof.name][percent, self.batch_sizes[i]]
        except KeyError:
            raise KeyError(f"{prof.name}: no measured L(b, p) at "
                           f"{percent}% of the card") from None


def _slo_profiles(provider: MeasuredLatency, sizes: dict[str, tuple]
                  ) -> tuple[dict[str, ModelProfile], MeasuredLatency]:
    """Profiles (paper-convention SLOs) + provider for a catalog.

    ``sizes[arch]`` is (weight MB, MB a request) of one decode step
    (read and written; ``h100intf.step_bytes``).
    The analytic model's other fields do not apply to a measured table:
    its compute terms are zero and ``l2_util_base`` is NaN, because no L2
    counter is read on the card (``core/h100intf.py`` holds the measured
    interference features)."""
    profiles = {}
    for arch in provider.table:
        weight_mb, act_mb = sizes[arch]
        prof = ModelProfile(
            name=arch, slo_ms=1.0, flops_per_req=0.0, weight_mb=weight_mb,
            act_mb_per_req=act_mb, par1=1.0, par_exp=0.0, t0_ms=0.0,
            l2_util_base=float("nan"))
        # paper convention: SLO = 2x solo latency at the calibration batch
        solo = provider.latency_ms(prof, SLO_BATCH, 1.0)
        profiles[arch] = dataclasses.replace(prof, slo_ms=2.0 * solo)
    return profiles, provider


#: A hand-written table for the CPU path when no measured file is given:
#: SYNTHETIC, not measured.  Three archetypes of decode steps shaped like
#: the served families: a weight-read-bound 9B dense decoder whose step
#: grows little with the batch, a small SSM that is host-bound at low
#: batch, and a hybrid in between.  Per arch: ms at (percent, batch).
SYNTHETIC_TABLE: dict[str, dict[tuple[int, int], float]] = {
    "synthetic-dense-9b": {
        (p, b): round(6.0 * (1.0 + 0.6 * (100 - p) / 80) + 0.05 * b
                      * (100 / p) ** 0.5, 4)
        for p in PARTITION_SIZES for b in LBP_BATCHES},
    "synthetic-ssm-780m": {
        (p, b): round(1.5 + 0.5 * (1.0 + (100 - p) / 80) + 0.02 * b
                      * (100 / p), 4)
        for p in PARTITION_SIZES for b in LBP_BATCHES},
    "synthetic-hybrid-2b": {
        (p, b): round(2.5 * (1.0 + 0.8 * (100 - p) / 80) + 0.03 * b
                      * (100 / p), 4)
        for p in PARTITION_SIZES for b in LBP_BATCHES},
}
SYNTHETIC_MIX = {"synthetic-dense-9b": 1.0, "synthetic-ssm-780m": 4.0,
                 "synthetic-hybrid-2b": 2.0}
#: SYNTHETIC (weight MB, MB a request) of the three archetypes: a 9B
#: bf16 decoder with a 1024-position GQA cache, a 780M SSM with its state,
#: a 2B hybrid.  Labelled like the table: not measured.
SYNTHETIC_SIZES = {"synthetic-dense-9b": (17_700.0, 200.0),
                   "synthetic-ssm-780m": (1_600.0, 150.0),
                   "synthetic-hybrid-2b": (5_400.0, 10.0)}


def synthetic_catalog() -> tuple[dict[str, ModelProfile], MeasuredLatency]:
    """(profiles, provider) from :data:`SYNTHETIC_TABLE`.

    Lets the h100-let path run end to end on a machine with no measured
    file; clearly labelled synthetic: the numbers are representative of the
    families, not measured."""
    return _slo_profiles(MeasuredLatency(
        {a: dict(t) for a, t in SYNTHETIC_TABLE.items()},
        card="synthetic (not measured)"), SYNTHETIC_SIZES)


def load_catalog(path: str) -> tuple[dict[str, ModelProfile],
                                     MeasuredLatency]:
    """(profiles, provider) from a ``profile_partitions`` results file.

    Refuses a file with records from more than one card (name and power
    limit), a cell measured twice, or a missing (arch, percent, batch) cell
    of the grid: every arch at every partition size and every batch found
    in the file.  It also refuses a file without the carves' granted SMs
    (``split_sms``, one set for the whole file), with one percent measured
    on two SM counts, or in which a side of a ``SPLIT_PAIRS`` split would
    be priced from more SMs than that side is granted.  Each arch's step
    bytes (``weight_bytes``, ``bytes_per_req``) fill its profile.

    A record's ``step`` (absent: a decode step) is what it timed; an arch
    is timed by one kind of step, and an arch of the port's configs by its
    own: a decoder by its decode step, an encoder-only arch by its
    ``forward``."""
    table: dict[str, dict[tuple[int, int], float]] = {}
    cards, batches, sms, grants, sizes = set(), set(), {}, set(), {}
    steps: dict[str, str] = {}
    with open(path) as f:
        for n, line in enumerate(f, 1):
            if not line.strip():
                continue
            r = json.loads(line)
            kind = r.get("step", "decode")
            if steps.setdefault(r["arch"], kind) != kind:
                raise ValueError(f"{path}:{n}: {r['arch']} is timed by "
                                 f"both {kind} and {steps[r['arch']]} steps")
            if r["arch"] in ARCH_IDS:
                own = step_kind(get_config(r["arch"]))
                if kind != own:
                    raise ValueError(f"{path}:{n}: {r['arch']} is timed by "
                                     f"its {own} step, not a {kind} step")
            cards.add((r["card"], r["power_limit_w"]))
            cell = (int(r["percent"]), int(r["batch"]))
            cells = table.setdefault(r["arch"], {})
            if cell in cells:
                raise ValueError(f"{path}:{n}: {r['arch']} at {cell} is "
                                 "measured twice")
            cells[cell] = float(r["step_ms"])
            batches.add(cell[1])
            if sms.setdefault(cell[0], int(r["sms"])) != int(r["sms"]):
                raise ValueError(f"{path}:{n}: {cell[0]}% measured on "
                                 f"{r['sms']} and {sms[cell[0]]} SMs")
            grants.add(json.dumps(r.get("split_sms"), sort_keys=True))
            size = (r["weight_bytes"] / 1e6, r["bytes_per_req"] / 1e6)
            if sizes.setdefault(r["arch"], size) != size:
                raise ValueError(f"{path}:{n}: {r['arch']} has two step "
                                 "byte counts")
    if len(cards) != 1:
        raise ValueError(f"{path}: records from {len(cards)} cards "
                         f"{sorted(cards)}; a catalog is one card's")
    missing = [(a, p, b) for a, cells in table.items()
               for p in PARTITION_SIZES for b in sorted(batches)
               if (p, b) not in cells]
    if missing:
        raise ValueError(f"{path}: {len(missing)} missing (arch, percent, "
                         f"batch) cells, e.g. {missing[:4]}")
    if SLO_BATCH not in batches:
        raise ValueError(f"{path}: no batch {SLO_BATCH}, the SLO's "
                         "calibration batch")
    if len(grants) != 1 or grants == {"null"}:
        raise ValueError(f"{path}: the records give {len(grants)} sets of "
                         "granted split SMs (split_sms); a catalog needs "
                         "one")
    split_sms = {int(c): tuple(v) for c, v in
                 json.loads(grants.pop()).items()}
    for pair in SPLIT_PAIRS:
        for position, percent in enumerate(pair):
            got = granted_sms(split_sms, percent, position)
            if sms[percent] > got:
                raise ValueError(
                    f"{path}: the {percent}% side of split {pair} runs on "
                    f"{got} SMs but is priced from {sms[percent]}")
    (card, power), = cards
    return _slo_profiles(MeasuredLatency(
        table, batch_sizes=tuple(sorted(batches)), sms=sms,
        split_sms=split_sms, card=f"{card}, {power} W", steps=steps), sizes)
