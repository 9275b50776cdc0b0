"""The routing's imbalance in granite.documents: in the worst MoE layer,
the tokens of its busiest expert over the mean of its experts, from the
port's ``expert_tokens`` counter (``repro_torch.obs.host``: summed on the
card by the dropless dispatch while the traced window records, read after
it).  None without a trace or where the program has no such counter."""


def read(run):
    if run.trace is None:
        return None
    try:
        from repro_torch.obs import host
    except ImportError:
        return None
    counters = getattr(host, "counters", None)
    counts = counters("expert_tokens") if counters else None
    if not counts:
        return None
    ratios = [float(t.max()) / float(t.double().mean())
              for t in counts.values() if int(t.sum()) > 0]
    return max(ratios) if ratios else None
