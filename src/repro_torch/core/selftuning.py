"""Guided self-tuning — the GSLICE baseline (paper §6.1).

GSLICE statically partitions a GPU *per inference function*: each model
stream owns exactly one gpu-let whose size is tuned (in the original,
dynamically at runtime; in the paper's "guided" variant, from profiles) to
its load.  Two structural limits vs. elastic partitioning, both called out
by the paper:

  * **no temporal sharing** — a gpu-let serves a single model, so low-rate
    models still hold their partition exclusively; and
  * **one gpu-let per model** — per-model throughput caps at the best single
    partition (<= one whole GPU).  This is why "ResNet50 received a 100%
    gpu-let" in ``game`` and self-tuning under-performs there.

The guided variant here sizes each model's gpu-let as the smallest partition
sustaining its rate (profiled L(b, p) given), growing to 100% if needed, and
places partitions best-fit.
"""
from __future__ import annotations

from collections.abc import Mapping

from repro_torch.core.gpulet import fresh_cluster, split
from repro_torch.core.scheduler_base import ScheduleResult, SchedulerBase, sorted_by_rate


class GuidedSelfTuning(SchedulerBase):
    name = "self-tuning"

    def schedule(self, rates: Mapping[str, float]) -> ScheduleResult:
        gpus = fresh_cluster(self.cluster.n_devices)
        unplaced: dict[str, float] = {}
        for model, incoming in sorted_by_rate(rates):
            prof = self.profiles[model]
            left = incoming
            iters = 0
            while left > 1e-9 and iters < 16:
                iters += 1
                p_need = self.lat.min_required_partition(
                    prof, left / self.headroom)
                # A stream heavier than one GPU gets replicated across
                # full-GPU instances (GSLICE replication), each still a
                # single-model partition.
                p_need = 100 if p_need is None else p_need
                free = [(l, g) for g in gpus for l in g.lets if l.is_free]
                free.sort(key=lambda lg: lg[0].size)
                placed = False
                for let, gpu in free:
                    if let.size < p_need:
                        continue
                    if let.size == 100 and p_need < 100:
                        let, _ = split(gpu, p_need, pairs=self.lat.split_pairs)
                    f = self.intf_factor(model, let, gpu)
                    take = min(left, self.capacity(model, let.frac, f))
                    ok = False
                    for _ in range(6):
                        if take <= 1e-9:
                            break
                        if self.assign(let, gpu, model, take):
                            ok = True
                            break
                        take *= 0.92
                    if ok:
                        left -= take
                        placed = True
                        break
                if not placed:
                    break
            if left > 1e-9:
                unplaced[model] = left
        return ScheduleResult(gpus=gpus, schedulable=not unplaced,
                              unplaced=unplaced, scheduler=self.name)
