"""The flash kernel's share of its roofline, over the batches the trace
holds whole: each batch's attention calls' least time
(``flops.flash_bound_s``, the larger of their bytes and their operations
over the card's peaks) over the device time of the port's flash kernel at
the model's head dim whose launches fall inside that batch.  A batch
counts only if all its layers' calls are there."""
import bisect

from bench import flops, trace


def read(run):
    peak = run.peak
    if run.trace is None or peak is None:
        return None
    bound = secs = 0.0
    for s in run.sides:
        f = s.entry_spec["fields"]
        dh = f.get("d_head") or f["d_model"] // f["n_heads"]
        calls = sorted((a, b - a) for n, a, b in run.trace.activity
                       if (m := trace.FLASH.search(n)) and int(m[1]) == dh)
        starts = [a for a, _ in calls]
        for b in s.batches:
            if b.dispatch < run.trace.start:
                continue
            lo = bisect.bisect_left(starts, b.dispatch)
            hi = bisect.bisect_right(starts, b.done)
            if hi - lo != f["n_layers"]:
                continue
            bound += f["n_layers"] * flops.flash_bound_s(
                s.entry_spec, len(b.rids), b.length, peak)
            secs += sum(d for _, d in calls[lo:hi])
    return 100.0 * bound / secs if secs > 0 else None
