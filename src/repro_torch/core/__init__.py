"""The gpu-let control plane, copied from the JAX package's ``core`` (pure
Python and numpy; imports rewritten to ``repro_torch``), plus
``h100lets``: L(b, p) measured on SM partitions of an H100, and
``h100intf``: interference measured there."""
from repro_torch.core.elastic import ElasticPartitioning
from repro_torch.core.gpulet import Assignment, GpuLet, GpuState, fresh_cluster
from repro_torch.core.h100lets import H100_SXM
from repro_torch.core.hardware import (PAPER_CLUSTER, RTX_2080TI,
                                       AcceleratorSpec, ClusterSpec)
from repro_torch.core.ideal import IdealScheduler
from repro_torch.core.interference import InterferenceModel, fit_default_model
from repro_torch.core.latency import Admission, LatencyProvider
from repro_torch.core.profiles import (PAPER_MODELS, ModelProfile,
                                       calibrate_profiles)
from repro_torch.core.sbp import SquishyBinPacking
from repro_torch.core.scheduler_base import ScheduleResult, SchedulerBase
from repro_torch.core.selftuning import GuidedSelfTuning

__all__ = ["AcceleratorSpec", "Admission", "Assignment", "ClusterSpec",
           "ElasticPartitioning", "GpuLet", "GpuState", "GuidedSelfTuning",
           "H100_SXM", "IdealScheduler", "InterferenceModel", "LatencyProvider", "ModelProfile",
           "PAPER_CLUSTER", "PAPER_MODELS", "RTX_2080TI", "ScheduleResult",
           "SchedulerBase", "SquishyBinPacking", "calibrate_profiles",
           "fit_default_model", "fresh_cluster"]
