"""The gpu-let abstraction (paper §4): virtual GPUs from spatial partitions.

A physical GPU holds up to two gpu-lets whose sizes sum to 100%.  gpu-lets
can be SPLIT out of an unsplit (100%) GPU, MERGEd back, and temporally
shared by multiple models (each gpu-let runs a duty-cycle loop over its
assigned models, Fig. 1 + Alg. 1).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.latency import SPLIT_PAIRS


@dataclasses.dataclass
class Assignment:
    """One model's share of a gpu-let."""

    model: str
    rate: float           # req/s routed to this gpu-let for this model
    batch: int            # batch size chosen by the scheduler
    duty_ms: float        # duty cycle of the hosting gpu-let
    est_latency_ms: float  # scheduler-predicted batch latency (incl. intf)


@dataclasses.dataclass
class GpuLet:
    """A spatial partition of one physical GPU."""

    gpu_id: int
    size: int                       # percent of the GPU's compute resource
    assignments: list[Assignment] = dataclasses.field(default_factory=list)
    split_from: bool = False        # True if carved from a 100% gpu-let

    @property
    def frac(self) -> float:
        return self.size / 100.0

    @property
    def models(self) -> list[str]:
        return [a.model for a in self.assignments]

    @property
    def is_free(self) -> bool:
        return not self.assignments

    def total_rate(self) -> float:
        return sum(a.rate for a in self.assignments)


@dataclasses.dataclass
class GpuState:
    """One physical GPU = at most two gpu-lets summing to 100%."""

    gpu_id: int
    lets: list[GpuLet]

    def partner_of(self, let: GpuLet) -> GpuLet | None:
        for other in self.lets:
            if other is not let:
                return other
        return None


def fresh_cluster(n_gpus: int) -> list[GpuState]:
    """All GPUs unsplit: one 100% gpu-let each."""
    return [GpuState(g, [GpuLet(gpu_id=g, size=100)]) for g in range(n_gpus)]


def split(gpu: GpuState, left_size: int,
          pairs: tuple[tuple[int, int], ...] = SPLIT_PAIRS
          ) -> tuple[GpuLet, GpuLet]:
    """SPLIT (Alg. 1 l.24): carve an unsplit GPU into (left, 100-left).

    ``left_size`` is rounded up to the nearest allowed partition size.
    """
    assert len(gpu.lets) == 1 and gpu.lets[0].size == 100, "can only split a whole GPU"
    assert gpu.lets[0].is_free, "cannot split an occupied gpu-let"
    size = next((s for s in sorted({a for a, _ in pairs}) if s >= left_size), None)
    if size is None:
        raise ValueError(f"no split pair supports left size {left_size}")
    right = 100 - size
    a = GpuLet(gpu_id=gpu.gpu_id, size=size, split_from=True)
    b = GpuLet(gpu_id=gpu.gpu_id, size=right, split_from=True)
    gpu.lets = [a, b]
    return a, b


def revert_split(gpu: GpuState) -> GpuLet:
    """REVERTSPLIT (Alg. 1 l.36): undo a split of two *free* gpu-lets."""
    assert len(gpu.lets) == 2
    assert all(l.is_free for l in gpu.lets), "cannot revert occupied gpu-lets"
    whole = GpuLet(gpu_id=gpu.gpu_id, size=100)
    gpu.lets = [whole]
    return whole


def valid_partitioning(gpu: GpuState) -> bool:
    sizes = sorted(l.size for l in gpu.lets)
    if len(sizes) == 1:
        return sizes[0] == 100
    if len(sizes) == 2:
        return tuple(sizes) in {tuple(sorted(p)) for p in SPLIT_PAIRS}
    return False


def enumerate_gpu_partitionings() -> list[tuple[int, ...]]:
    """All per-GPU partitionings the ideal scheduler enumerates (Fig. 15).

    The paper describes "4 GPUs which can be partitioned into 4 cases"; with
    symmetric pairs deduplicated our case list is (100,), (20,80), (40,60),
    (50,50) — exactly four.
    """
    cases = [(100,)]
    seen = set()
    for a, b in SPLIT_PAIRS:
        key = tuple(sorted((a, b)))
        if key not in seen:
            seen.add(key)
            cases.append(key)
    return cases
