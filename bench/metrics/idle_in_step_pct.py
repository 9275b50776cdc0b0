"""The card's idle time while the port's ``step`` span is open (any side),
over the traced span: the idle time that issuing the model step leaves,
the rest of ``device_idle_pct`` being idle no model step can remove
(arrivals, the loop, the wait on the output)."""
from bench import spans


def read(run):
    w = spans.window(run)
    if w is None or run.trace.window_s <= 0:
        return None
    steps, reach = [], float("-inf")
    for a, b in sorted((st.start - w.origin, st.end - w.origin)
                       for _, _, st in w.pairs):
        if a > reach:
            steps.append([a, b])
        else:
            steps[-1][1] = max(steps[-1][1], b)
        reach = max(reach, b)
    idle = spans.overlap(spans.idle_intervals(run.trace),
                         [(a, b, "step") for a, b in steps])
    return 100.0 * idle.get("step", 0.0) / run.trace.window_s
