"""The host's time to issue one layer: the median, over the batches
dispatched inside the traced span, of the port's ``step`` span (entry to
return of ``Model.forward`` / ``Model.prefill``: every launch issued, no
wait on the card) over the model's layers, in microseconds."""
import statistics

from bench import spans


def read(run):
    w = spans.window(run)
    if w is None:
        return None
    lo, hi = run.trace.start, run.trace.start + run.trace.window_s
    per_layer = [(st.end - st.start) / spans.n_layers(side) * 1e6
                 for side, b, st in w.pairs if lo <= b.dispatch <= hi]
    return statistics.median(per_layer) if per_layer else None
