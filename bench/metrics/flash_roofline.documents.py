"""The flash kernel's share of its roofline in granite.documents: as
``flash_roofline``, over the batches the trace holds with all the calls of
the attention layers, 4 of granite's 40 (``flash_roofline`` expects one a
layer and finds no batch whole), at head dim 128."""
from bench import flops, kernel_roofline, trace

ATTENTION = ("attn_mlp", "moe", "attn")


def _calls(entry):
    return sum(k in ATTENTION for k in kernel_roofline.kinds(entry))


def _bound(entry, b, length, peak):
    return _calls(entry) * flops.flash_bound_s(entry, b, length, peak)


def read(run):
    return kernel_roofline.share(run, trace.FLASH, _calls, _bound)
