"""Exhaustive "ideal" scheduler (paper §6.2, Fig. 15/16).

Enumerates every per-GPU partitioning combination (4 cases per GPU -> 4^N
combos for N GPUs, exactly as the paper describes), and for each fixed
partitioning runs the elastic assignment (best-fit + temporal sharing,
without further splits).  A workload is schedulable iff *any* combination
admits it.  This is the upper bound elastic partitioning is compared against.
"""
from __future__ import annotations

import itertools
from collections.abc import Mapping

from repro_torch.core.gpulet import GpuLet, GpuState, enumerate_gpu_partitionings
from repro_torch.core.scheduler_base import ScheduleResult, SchedulerBase, sorted_by_rate


class IdealScheduler(SchedulerBase):
    name = "ideal"

    def _assign_on_fixed(self, gpus: list[GpuState],
                         rates: Mapping[str, float]) -> ScheduleResult:
        """Best-fit + temporal-sharing assignment on a fixed partitioning."""
        unplaced: dict[str, float] = {}
        for model, incoming in sorted_by_rate(rates):
            prof = self.profiles[model]
            assigned = 0.0
            iters = 0
            while incoming > assigned + 1e-9 and iters < 64:
                iters += 1
                remaining = incoming - assigned
                candidates = [(l, g) for g in gpus for l in g.lets]
                # free lets ascending by size first, then temporal merge
                candidates.sort(key=lambda lg: (not lg[0].is_free, lg[0].size))
                take_best = 0.0
                placed = False
                for let, gpu in candidates:
                    f = self.intf_factor(model, let, gpu)
                    cap = self.capacity(model, let.frac, f)
                    take = min(remaining, cap)
                    if take <= 1e-9:
                        continue
                    for _ in range(4):
                        if self.assign(let, gpu, model, take):
                            placed = True
                            break
                        take *= 0.85
                    if placed:
                        assigned += take
                        break
                if not placed:
                    unplaced[model] = remaining
                    break
        return ScheduleResult(gpus=gpus, schedulable=not unplaced,
                              unplaced=unplaced, scheduler=self.name)

    def schedule(self, rates: Mapping[str, float]) -> ScheduleResult:
        cases = enumerate_gpu_partitionings()
        best: ScheduleResult | None = None
        for combo in itertools.product(cases, repeat=self.cluster.n_devices):
            gpus = []
            for gid, sizes in enumerate(combo):
                lets = [GpuLet(gpu_id=gid, size=s, split_from=len(sizes) > 1)
                        for s in sizes]
                gpus.append(GpuState(gid, lets))
            res = self._assign_on_fixed(gpus, rates)
            if res.schedulable:
                return res
            if best is None or (sum(res.unplaced.values())
                                < sum(best.unplaced.values())):
                best = res
        # the ideal search space strictly contains elastic partitioning's
        # (every split elastic makes is one of the enumerated cases), so the
        # ideal result must dominate it: fall back to Alg. 1 if the simple
        # per-combo greedy missed an elastic-feasible packing.
        from repro_torch.core.elastic import ElasticPartitioning
        el = ElasticPartitioning(
            self.profiles, cluster=self.cluster, intf_model=self.intf_model,
            acc=self.acc, headroom=self.headroom, lat=self.lat)
        el_res = el.schedule(rates)
        if el_res.schedulable:
            el_res.scheduler = self.name
            return el_res
        assert best is not None
        return best
