"""Per-model performance profiles for the paper's five evaluation models.

Paper Table 4 lists the models and their SLOs; section 6.1 states the SLO is
set by *doubling the solo execution latency at batch 32 on a full GPU*.  The
latency model in latency.py is analytic (roofline-with-saturation); this
module holds the per-model constants and calibrates the per-model efficiency
factor so that ``L(b=32, p=1.0) == SLO/2`` exactly — i.e. the profile is, by
construction, consistent with the paper's own testbed measurements.

FLOP counts / parameter sizes are the standard published numbers for each
network; the parallelism-saturation constants (par1, par_exp) are chosen to
reproduce the qualitative curves of Fig. 3 (small batches cannot use a large
partition — the "flat region"; batch-32 curves keep improving with resource).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import AcceleratorSpec, RTX_2080TI


@dataclasses.dataclass
class ModelProfile:
    """Static profile of one served model.

    Attributes:
      name: short model id (paper uses le/goo/res/ssd/vgg).
      slo_ms: per-model latency SLO (paper Table 4).
      flops_per_req: forward-pass GFLOPs for one request.
      weight_mb: parameter bytes (MB) read once per batch execution.
      act_mb_per_req: activation traffic (MB) per request.
      par1: fraction of the accelerator the model can fill at batch 1.
      par_exp: batch-scaling exponent of achievable parallelism
        (par(b) = min(1, par1 * b**par_exp)).
      t0_ms: fixed launch/framework overhead per batch execution.
      l2_util_base: solo-run L2/on-chip utilization at full partition —
        the feature the interference model consumes (paper §4.4).
      efficiency: calibrated fraction of peak FLOP/s actually achieved;
        set by ``calibrate_profiles`` so L(32, 1.0) == slo/2.
    """

    name: str
    slo_ms: float
    flops_per_req: float
    weight_mb: float
    act_mb_per_req: float
    par1: float
    par_exp: float
    t0_ms: float
    l2_util_base: float
    efficiency: float = 0.60

    def parallelism(self, batch: int) -> float:
        """Fraction of the device this model can usefully occupy at `batch`."""
        return min(1.0, self.par1 * float(batch) ** self.par_exp)


def _mk(name, slo, gflops, weight_mb, act_mb, par1, par_exp, t0, l2):
    return ModelProfile(
        name=name, slo_ms=slo, flops_per_req=gflops, weight_mb=weight_mb,
        act_mb_per_req=act_mb, par1=par1, par_exp=par_exp, t0_ms=t0,
        l2_util_base=l2)


# Paper Table 4.  SLO(ms): goo 44, le 5, res 95, ssd 136, vgg 130.
# FLOPs/params: LeNet-5 ~0.0008 GF/0.06M; GoogLeNet 1.5 GF/7M params;
# ResNet-50 4.1 GF/25.6M; SSD-MobileNet-V1(300) 1.2 GF/6.8M; VGG-16 15.5
# GF/138M.  Weight MB assume fp32.
# par1 values put batch-32 parallelism saturation at ~0.5 (goo/res), ~0.45
# (ssd) and ~0.7 (vgg): PyTorch-eager CNN inference at these batch sizes
# cannot fill a 2080 Ti, which is precisely the paper's §3.1 observation and
# what makes two mid-size gpu-lets outperform one exclusive GPU (Fig. 3/12).
PAPER_MODELS: dict[str, ModelProfile] = {
    "le": _mk("le", 5.0, 0.0008, 0.25, 0.05, 0.020, 0.55, 0.35, 0.10),
    "goo": _mk("goo", 44.0, 1.50, 28.0, 3.0, 0.088, 0.50, 0.80, 0.45),
    "res": _mk("res", 95.0, 4.10, 102.0, 9.0, 0.088, 0.50, 0.90, 0.55),
    "ssd": _mk("ssd", 136.0, 1.20, 27.0, 6.0, 0.080, 0.50, 1.00, 0.40),
    "vgg": _mk("vgg", 130.0, 15.50, 553.0, 6.0, 0.124, 0.50, 0.90, 0.70),
}

#: The calibration batch used by the paper to define the SLO (Section 6.1).
SLO_CALIBRATION_BATCH = 32


def calibrate_profiles(
    profiles: dict[str, ModelProfile] | None = None,
    accelerator: AcceleratorSpec = RTX_2080TI,
) -> dict[str, ModelProfile]:
    """Set each profile's ``efficiency`` so L(32, p=1) == SLO/2.

    The latency model (see latency.py) is
        L(b, p) = t0 + compute(b, p)/efficiency + bytes(b)/BW
    with compute(b, p) = b*flops / (peak * min(p, par(b))).  Solving for
    efficiency with the target latency gives a closed form.
    """
    from repro_torch.core import latency as latmod  # local import, avoids cycle

    profiles = profiles if profiles is not None else PAPER_MODELS
    out: dict[str, ModelProfile] = {}
    b = SLO_CALIBRATION_BATCH
    for name, prof in profiles.items():
        target_ms = prof.slo_ms / 2.0
        mem_ms = latmod.memory_ms(prof, b, 1.0, accelerator)
        avail_ms = target_ms - prof.t0_ms - mem_ms
        raw_compute_ms = latmod.raw_compute_ms(prof, b, 1.0, accelerator)
        if avail_ms <= 0:
            eff = 1.0  # degenerate: memory-bound model; latency model will
            # report > target, keep eff at max.
        else:
            # Floor well below any physical efficiency: tiny models (LeNet)
            # are launch-overhead dominated and need a very small *effective*
            # efficiency for the analytic model to land on the measurement.
            eff = min(1.0, max(0.001, raw_compute_ms / avail_ms))
        out[name] = dataclasses.replace(prof, efficiency=eff)
    return out


def solo_latency_targets() -> dict[str, float]:
    """Paper's implied solo (b=32, full GPU) latencies: SLO/2, ms."""
    return {k: v.slo_ms / 2.0 for k, v in PAPER_MODELS.items()}
