"""Launches a layer: the median, over the batches the traced span holds
whole, of the kernels and copies (the argmax's to the host, yi-9b's ring
writes) starting between the port's ``step`` span's start and the
batch's output on the host, over the model's layers.  Sets are left out:
cuBLAS zeroes its workspace with one before some GEMMs at larger shapes
(up to six a layer more), so counting them would make the number follow
the batch sizes the loop happens to form.  In a cell of several sides
the other side's launches would be counted too."""
import bisect
import statistics

from bench import spans

SET = "Memset"


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    starts = sorted(a for n, a, _ in run.trace.activity
                    if not n.startswith(SET))
    lo, hi = run.trace.start, run.trace.start + run.trace.window_s
    counts = []
    for side, b, st in w.pairs:
        a = st.start - w.origin
        if a < lo or b.done > hi:
            continue
        n = bisect.bisect_right(starts, b.done) - bisect.bisect_left(starts, a)
        counts.append(n / spans.n_layers(side))
    return statistics.median(counts) if counts else None
