"""The model steps' share of the card's bf16 peak: the matmul operations
of every batch (``flops.step_flops``, frozen) over the sum of the
batches' wall times, dispatch to output on the host, over the peak."""
from bench import flops


def read(run):
    peak = run.peak
    if peak is None:
        return None
    ops = secs = 0.0
    for s in run.sides:
        for b in s.batches:
            ops += flops.step_flops(s.entry_spec, len(b.rids), b.length)
            secs += b.done - b.dispatch
    return 100.0 * ops / secs / peak["bf16_flops"] if secs else None
