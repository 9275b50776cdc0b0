"""Elastic Partitioning — the paper's scheduler (Algorithm 1).

Faithful implementation of ELASTICPARTITIONING / FINDBESTFIT:

  * models sorted by incoming rate, descending;
  * per model, loop until the full rate is assigned:
      p_eff   <- MAXEFFICIENTPARTITION()        (knee of the rate curve)
      p_req   <- MINREQUIREDPARTITION(rate)     (smallest p sustaining rate)
      p_ideal <- min(p_eff, p_req)
      gpulet  <- FINDBESTFIT(p_ideal, SLO, intf)
  * FINDBESTFIT scans free gpu-lets ascending by size (best fit), splits a
    100% GPU when needed, checks the SLO admission test with the predicted
    interference factor, and finally attempts a temporal MERGE into an
    already-allocated gpu-let (reverting the split when the merge wins).

The ``gpulet`` variant runs with intf_model=None; ``gpulet+int`` passes the
fitted linear interference model (paper §4.4), making admission conservative
but SLO-safe.
"""
from __future__ import annotations

from collections.abc import Mapping

from repro_torch.core.gpulet import GpuLet, GpuState, fresh_cluster, revert_split, split
from repro_torch.core.scheduler_base import ScheduleResult, SchedulerBase, sorted_by_rate


class ElasticPartitioning(SchedulerBase):
    """Algorithm 1.  name: 'gpulet' (no intf) or 'gpulet+int' (with intf)."""

    @property
    def name(self) -> str:  # type: ignore[override]
        return "gpulet+int" if self.intf_model is not None else "gpulet"

    # -- FINDBESTFIT ---------------------------------------------------------

    def _find_best_fit(self, gpus: list[GpuState], model: str, rate: float,
                       p_ideal: int) -> tuple[GpuLet, GpuState, float] | None:
        """Returns (gpulet, gpu, assignable_rate) or None.

        Implements Alg. 1 lines 20-40 including SPLIT, the SLO+interference
        admission check, and the temporal-sharing MERGE fallback.
        """
        prof = self.profiles[model]
        # free gpu-lets sorted ascending by size (line 20)
        free: list[tuple[GpuLet, GpuState]] = [
            (l, g) for g in gpus for l in g.lets if l.is_free]
        free.sort(key=lambda lg: lg[0].size)
        for let, gpu in free:
            if let.size < p_ideal:
                continue
            did_split = False
            if let.size == 100 and p_ideal < 100:
                let_ideal, _let_rest = split(gpu, p_ideal,
                                             pairs=self.lat.split_pairs)
                let, did_split = let_ideal, True
            # admission: largest batch meeting SLO with interference (l.27-28)
            f = self.intf_factor(model, let, gpu)
            b = self.lat.max_batch_under_slo(prof, let.frac, prof.slo_ms, f)
            if b == 0:
                if did_split:
                    revert_split(gpu)
                continue
            cap = self.capacity(model, let.frac, f)
            take = min(rate, cap)
            if take <= 0:
                if did_split:
                    revert_split(gpu)
                continue
            # temporal MERGE (lines 33-39): if an allocated gpu-let can absorb
            # this chunk via temporal sharing, prefer it and revert the split.
            for g2 in gpus:
                for let2 in g2.lets:
                    if let2.is_free or let2 is let:
                        continue
                    if self.feasible_with(let2, g2, [(model, take)]).ok:
                        if did_split:
                            revert_split(gpu)
                        return let2, g2, take
            return let, gpu, take
        # no free gpu-let fits: last resort is a pure temporal MERGE into an
        # already-allocated gpu-let (cluster fully partitioned).
        for g2 in gpus:
            for let2 in g2.lets:
                if let2.is_free:
                    continue
                f = self.intf_factor(model, let2, g2)
                cap = self.capacity(model, let2.frac, f)
                take = min(rate, cap)
                if take <= 0:
                    continue
                if self.feasible_with(let2, g2, [(model, take)]).ok:
                    return let2, g2, take
        return None

    # -- ELASTICPARTITIONING ---------------------------------------------------

    def schedule(self, rates: Mapping[str, float]) -> ScheduleResult:
        gpus = fresh_cluster(self.cluster.n_devices)
        unplaced: dict[str, float] = {}
        for model, incoming in sorted_by_rate(rates):
            prof = self.profiles[model]
            assigned = 0.0
            iters = 0
            while incoming > assigned + 1e-9:
                iters += 1
                if iters > 64:  # guard against pathological micro-chunking
                    unplaced[model] = incoming - assigned
                    break
                remaining = incoming - assigned
                p_eff = self.lat.max_efficient_partition(prof)
                p_req = self.lat.min_required_partition(
                    prof, remaining / self.headroom)
                if p_req is not None:
                    # rate-bound partitions running >85% hot get one size up:
                    # Poisson bursts on tiny partitions have no catch-up room
                    # (beyond-paper robustness tweak; see EXPERIMENTS.md).
                    util = (remaining / self.headroom) / max(
                        self.lat.max_rate(prof, p_req / 100.0), 1e-9)
                    if util > 0.85:
                        bigger = [s for s in self.lat.partition_sizes
                                  if s > p_req]
                        if bigger and bigger[0] < p_eff:
                            p_req = bigger[0]
                p_ideal = min(p_eff, p_req) if p_req is not None else p_eff
                found = self._find_best_fit(gpus, model, remaining, p_ideal)
                if found is None:
                    unplaced[model] = remaining
                    break
                let, gpu, take = found
                # max_rate and the duty-cycle grid disagree by ceil effects;
                # back off a little if the exact capacity misses the grid.
                placed = False
                for _ in range(6):
                    if take <= 1e-9:
                        break
                    if self.assign(let, gpu, model, take):
                        placed = True
                        break
                    take *= 0.85
                if not placed:
                    unplaced[model] = remaining
                    break
                assigned += take
        return ScheduleResult(
            gpus=gpus, schedulable=not unplaced, unplaced=unplaced,
            scheduler=self.name)
