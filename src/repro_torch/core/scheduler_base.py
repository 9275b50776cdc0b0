"""Shared scheduling plumbing: workloads, results, admission tests.

All four schedulers (elastic/gpulet, SBP, guided self-tuning, ideal) share
the same vocabulary: a *workload* (model -> req/s), a *cluster* of GPUs each
holding gpu-lets, and admission tests built from L(b, p) plus the (optional)
interference model.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence

from repro_torch.core.latency import Admission, AnalyticGPULatency, LatencyProvider
from repro_torch.core.gpulet import Assignment, GpuLet, GpuState
from repro_torch.core.hardware import AcceleratorSpec, ClusterSpec, PAPER_CLUSTER
from repro_torch.core.interference import InterferenceModel
from repro_torch.core.profiles import ModelProfile


@dataclasses.dataclass
class ScheduleResult:
    """Outcome of one scheduling pass."""

    gpus: list[GpuState]
    schedulable: bool
    unplaced: dict[str, float] = dataclasses.field(default_factory=dict)
    scheduler: str = ""

    @property
    def gpulets(self) -> list[GpuLet]:
        return [l for g in self.gpus for l in g.lets]

    def used_partition_total(self) -> int:
        """Sum of gpu-let sizes (%) that have at least one assignment."""
        return sum(l.size for l in self.gpulets if not l.is_free)

    def assignments_by_model(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for let in self.gpulets:
            for a in let.assignments:
                out[a.model] = out.get(a.model, 0.0) + a.rate
        return out


class SchedulerBase:
    """Common machinery; subclasses implement ``schedule``."""

    name = "base"

    def __init__(self,
                 profiles: Mapping[str, ModelProfile],
                 cluster: ClusterSpec = PAPER_CLUSTER,
                 intf_model: InterferenceModel | None = None,
                 acc: AcceleratorSpec | None = None,
                 headroom: float = 0.80,
                 lat: LatencyProvider | None = None):
        self.profiles = dict(profiles)
        self.cluster = cluster
        self.intf_model = intf_model
        self.acc = acc or cluster.accelerator
        # pluggable L(b, p): analytic GPU model by default, roofline-derived
        # tpu-let model via core/tpulets.py
        self.lat = lat or AnalyticGPULatency(self.acc)
        # Burst headroom: admission sizes batches/capacity for rate/headroom
        # so Poisson bursts (the paper's arrival model) don't overflow duty
        # cycles.  Applied identically to every scheduler.
        self.headroom = headroom

    # ---- interference ----------------------------------------------------

    def intf_factor(self, model: str, let: GpuLet, gpu: GpuState,
                    extra_partner: str | None = None) -> float:
        """Predicted slowdown of ``model`` on ``let`` given co-partition.

        Uses the max over the partner gpu-let's models (conservative).  With
        no interference model (the plain ``gpulet`` variant) returns 1.0.
        """
        if self.intf_model is None:
            return 1.0
        partner = gpu.partner_of(let)
        if partner is None:
            return 1.0  # unsplit GPU: no spatial co-location possible
        partner_models = list(partner.models)
        if extra_partner is not None:
            partner_models.append(extra_partner)
        prof = self.profiles[model]
        if not partner_models:
            # Prospective interference: the partner gpu-let is still free but
            # will likely be filled later; reserve slack for the *expected*
            # co-runner (mean prediction over the workload's models).  This
            # is the "conservative decision" the paper attributes to
            # gpulet+int — mild enough to cost only a few percent throughput.
            preds = [self.intf_model.predict_pair(
                prof, let.frac, other, partner.frac, self.acc)
                for other in self.profiles.values()]
            return sum(preds) / len(preds)
        worst = 1.0
        for om in partner_models:
            f = self.intf_model.predict_pair(
                prof, let.frac, self.profiles[om], partner.frac, self.acc)
            worst = max(worst, f)
        return worst

    # ---- admission -------------------------------------------------------

    def capacity(self, model: str, frac: float, f: float = 1.0) -> float:
        """Burst-adjusted sustainable req/s for a gpu-let fraction."""
        return self.headroom * self.lat.max_rate(self.profiles[model], frac, f)

    def gpulet_capacity(self, model: str, let: GpuLet, gpu: GpuState) -> float:
        """Max req/s this gpu-let can take for ``model`` (exclusive use)."""
        f = self.intf_factor(model, let, gpu)
        return self.capacity(model, let.frac, f)

    def feasible_with(self, let: GpuLet, gpu: GpuState,
                      extra: Sequence[tuple[str, float]] = ()) -> Admission:
        """Completion-time admission of let's current models plus ``extra``.

        Rates are inflated by 1/headroom so the chosen batch sizes can absorb
        Poisson bursts within one duty cycle.  Each model carries its *own*
        predicted interference factor (the old single worst-case factor
        smeared one model's bad co-location across every co-resident model).
        """
        pairs = [(a.model, a.rate) for a in let.assignments] + list(extra)
        entries = [(self.profiles[m], r / self.headroom) for m, r in pairs]
        factors = [self.intf_factor(m, let, gpu) for m, _ in pairs]
        return self.lat.admit(entries, let.frac, factors)

    def _record(self, let: GpuLet, pairs: Sequence[tuple[str, float]],
                adm: Admission) -> None:
        """Write admitted (duty, batch, in-cycle completion) onto a gpu-let.

        ``est_latency_ms`` stores the admission's promised in-cycle
        completion time (launch offset + interference-inflated execution),
        so the engine and metrics see the same number the scheduler checked
        against the SLO.
        """
        let.assignments = [
            Assignment(model=m, rate=r, batch=b, duty_ms=adm.duty_ms,
                       est_latency_ms=est)
            for (m, r), b, est in zip(pairs, adm.batches, adm.est_latency_ms)]

    def assign(self, let: GpuLet, gpu: GpuState, model: str, rate: float) -> bool:
        """Place (model, rate) on a gpu-let if feasible; records duty/batch.

        With an interference model, the *partner* gpu-let's assignments are
        revalidated under the updated co-location — a later placement must
        not silently push an earlier one over its SLO (this revalidation is
        what lets gpulet+int "filter out" the violating rates of Fig. 13).
        """
        adm = self.feasible_with(let, gpu, [(model, rate)])
        if not adm.ok:
            return False
        saved = list(let.assignments)
        pairs = [(a.model, a.rate) for a in let.assignments] + [(model, rate)]
        self._record(let, pairs, adm)
        if self.intf_model is not None:
            part = gpu.partner_of(let)
            if part is not None and part.assignments:
                adm2 = self.feasible_with(part, gpu)
                if not adm2.ok:
                    let.assignments = saved  # rollback
                    return False
                self._record(part, [(a.model, a.rate)
                                    for a in part.assignments], adm2)
        return True

    # ---- API ---------------------------------------------------------------

    def schedule(self, rates: Mapping[str, float]) -> ScheduleResult:
        raise NotImplementedError

    def is_schedulable(self, rates: Mapping[str, float]) -> bool:
        return self.schedule(rates).schedulable

    def max_scale(self, rates: Mapping[str, float],
                  lo: float = 0.0, hi: float = 64.0,
                  tol: float = 0.01) -> float:
        """Largest lambda s.t. lambda * rates is schedulable (bisection)."""
        base = {m: r for m, r in rates.items() if r > 0}
        if not base:
            return 0.0
        if self.is_schedulable({m: r * hi for m, r in base.items()}):
            return hi
        while hi - lo > tol * max(hi, 1.0):
            mid = 0.5 * (lo + hi)
            if self.is_schedulable({m: r * mid for m, r in base.items()}):
                lo = mid
            else:
                hi = mid
        return lo


def sorted_by_rate(rates: Mapping[str, float]) -> list[tuple[str, float]]:
    """Models sorted by incoming rate, descending (Alg. 1 line 3).

    Rates below 1e-6 req/s are noise (sub-request-per-11-days), not load.
    """
    return sorted(((m, r) for m, r in rates.items() if r > 1e-6),
                  key=lambda kv: -kv[1])
