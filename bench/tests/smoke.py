"""The cells at a size the CPU runs in seconds, for the tests.

Every model keeps its kinds, norm, activation, mask and GQA grouping; its
widths, depth and vocabulary shrink, and each stream's lengths, rate, cap
and SLO shrink with them.  Nothing here runs in a cell on the card.
"""
from __future__ import annotations

import copy

from bench import spec

SMOKE_FIELDS = {"d_model": 128, "d_ff": 256}


def smoke_cell(name: str, *, rate: float = 40.0,
               n_layers: int = 2) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    for entry in cell.config["models"].values():
        f = entry["fields"]
        group = f["n_heads"] // f["n_kv_heads"]
        f.update(SMOKE_FIELDS, n_layers=n_layers, n_heads=4,
                 n_kv_heads=4 // min(group, 2),
                 vocab_size=min(f["vocab_size"], 500))
        entry["check"]["sample_requests"] = 4
    for stream in cell.traffic["streams"].values():
        stream.update(rate_rps=rate, lengths=[8, 16, 32], slo_ms=10_000.0,
                      batch_cap={"requests": 4, "tokens": 96}, segment_s=0.25)
    cell.config["sides"] = [dict(s, percent=100)
                            for s in cell.config["sides"]]
    return cell
