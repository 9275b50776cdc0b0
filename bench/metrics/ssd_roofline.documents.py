"""The SSD scan kernel's share of its roofline in granite.documents: each
batch's scan calls, one a Mamba-2 layer (36 of 40), their least time by
the reference's ``ssd_cost`` over the device time of the port's forward
scan kernels (``ssd_bf16_kernel``, ``ssd_kernel``)."""
import re

from bench import kernel_roofline, spec

SSD = re.compile(r"\bssd_(?:bf16_)?kernel\b")


def _calls(entry):
    return kernel_roofline.kinds(entry).count("mamba2")


def _bound(entry, b, length, peak):
    cost = spec.reference(entry).ssd_cost(entry, b, length)
    return _calls(entry) * kernel_roofline.least_s(cost, peak)


def read(run):
    return kernel_roofline.share(run, SSD, _calls, _bound)
