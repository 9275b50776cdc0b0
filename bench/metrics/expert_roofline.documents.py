"""The grouped expert products' share of their roofline in
granite.documents: each batch's gate, up and down products of every MoE
layer (3 grouped GEMM launches a layer, 120 a batch), their least time by
the reference's ``expert_cost`` over their device time (CUTLASS grouped
GEMM kernels, matched by name)."""
import re

from bench import kernel_roofline, spec

GROUPED = re.compile(r"GroupProblemShape")


def _layers(entry):
    return sum(k in ("moe", "mamba2") for k in kernel_roofline.kinds(entry))


def _bound(entry, b, length, peak):
    cost = spec.reference(entry).expert_cost(entry, b * length)
    return _layers(entry) * kernel_roofline.least_s(cost, peak)


def read(run):
    return kernel_roofline.share(run, GROUPED, lambda e: 3 * _layers(e),
                                 _bound)
