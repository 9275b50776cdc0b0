"""Hardware descriptions for the two targets of this repo.

The paper's testbed is 4x NVIDIA RTX 2080 Ti (Table 3).  The TPU adaptation
targets a 16x16 v5e pod (256 chips) and a 2-pod 512-chip configuration.
Both are described with the same small dataclass so the latency model and the
roofline analysis share one vocabulary.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AcceleratorSpec:
    """One accelerator (a GPU, or one TPU chip)."""

    name: str
    peak_tflops: float          # peak dense compute, TFLOP/s
    hbm_gbs: float              # HBM bandwidth, GB/s
    hbm_gb: float               # HBM capacity, GB
    ici_gbs: float = 0.0        # per-link interconnect bandwidth, GB/s


# Paper Table 3: RTX 2080 Ti — 4352 CUDA cores, 13.45 TFLOP/s fp32,
# 616 GB/s GDDR6, 11 GB.
RTX_2080TI = AcceleratorSpec(
    name="rtx-2080ti", peak_tflops=13.45, hbm_gbs=616.0, hbm_gb=11.0)

# Roofline constants mandated for this reproduction: TPU v5e.
TPU_V5E = AcceleratorSpec(
    name="tpu-v5e", peak_tflops=197.0, hbm_gbs=819.0, hbm_gb=16.0,
    ici_gbs=50.0)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A serving cluster: ``n_devices`` identical accelerators.

    For the paper-faithful reproduction a "device" is one physical GPU that
    can be spatially split into up to two gpu-lets.  For the TPU adaptation a
    "device" is one *pod slice* and gpu-lets are sub-meshes (see tpulets.py).
    """

    accelerator: AcceleratorSpec
    n_devices: int = 4

    @property
    def name(self) -> str:
        return f"{self.n_devices}x{self.accelerator.name}"


PAPER_CLUSTER = ClusterSpec(accelerator=RTX_2080TI, n_devices=4)
