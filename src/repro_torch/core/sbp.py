"""Squishy Bin Packing (SBP) — the Nexus baseline (paper §2.2, §6.1).

Temporal sharing only: every gpu-let is a whole GPU (or, for the Fig. 4
"with partitioning" variant, one of two *evenly split* halves scheduled
independently).  The algorithm follows Nexus:

  1. For each model, find the max-throughput full-bin configuration
     (largest batch with 2*L(b) <= SLO); allocate floor(rate / r_full)
     exclusive bins ("saturated" bins).
  2. The residual rates become fractional tasks with occupancy
     exec_time / duty; sort descending and pack first-fit into remaining
     bins, re-checking duty-cycle feasibility on each merge (the "squishy"
     part: batch sizes and duty cycles are re-derived per bin).
"""
from __future__ import annotations

from collections.abc import Mapping

from repro_torch.core.gpulet import GpuLet, GpuState
from repro_torch.core.scheduler_base import ScheduleResult, SchedulerBase, sorted_by_rate


class SquishyBinPacking(SchedulerBase):
    """Nexus SBP.  ``split_even=True`` gives the Fig. 4 partitioned variant."""

    def __init__(self, *args, split_even: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.split_even = split_even

    @property
    def name(self) -> str:  # type: ignore[override]
        return "sbp+even-split" if self.split_even else "sbp"

    def _bins(self) -> list[GpuState]:
        gpus = []
        for g in range(self.cluster.n_devices):
            if self.split_even:
                lets = [GpuLet(gpu_id=g, size=50, split_from=True),
                        GpuLet(gpu_id=g, size=50, split_from=True)]
            else:
                lets = [GpuLet(gpu_id=g, size=100)]
            gpus.append(GpuState(g, lets))
        return gpus

    def schedule(self, rates: Mapping[str, float]) -> ScheduleResult:
        gpus = self._bins()
        free = [(l, g) for g in gpus for l in g.lets]
        unplaced: dict[str, float] = {}

        # Phase 1: saturated bins.
        residual: list[tuple[str, float]] = []
        for model, rate in sorted_by_rate(rates):
            prof = self.profiles[model]
            p = free[0][0].frac if free else (0.5 if self.split_even else 1.0)
            r_full = self.capacity(model, p)
            if r_full <= 0:
                unplaced[model] = rate
                continue
            n_full = int(rate // r_full)
            left = rate
            for _ in range(n_full):
                if not free:
                    break
                let, gpu = free.pop(0)
                if self.assign(let, gpu, model, r_full * 0.999):
                    left -= r_full * 0.999
                else:
                    free.append((let, gpu))
                    break
            if left > 1e-9:
                residual.append((model, left))

        # Phase 2: first-fit-decreasing merge of residual ("squishy") tasks.
        residual.sort(key=lambda kv: -kv[1])
        for model, left in residual:
            placed = False
            # try partially used bins first (packing), then free bins
            used_first = sorted(
                [(l, g) for g in gpus for l in g.lets],
                key=lambda lg: (lg[0].is_free, -lg[0].total_rate()))
            for let, gpu in used_first:
                take = left
                ok = False
                for _ in range(6):
                    if self.assign(let, gpu, model, take):
                        ok = True
                        break
                    take *= 0.85
                if ok:
                    left -= take
                    if (let, gpu) in free:
                        free.remove((let, gpu))
                    if left <= 1e-9:
                        placed = True
                        break
            if not placed and left > 1e-9:
                unplaced[model] = unplaced.get(model, 0.0) + left
        return ScheduleResult(gpus=gpus, schedulable=not unplaced,
                              unplaced=unplaced, scheduler=self.name)
