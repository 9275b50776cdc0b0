"""The cells at a size the CPU runs in seconds, for the tests.

Every model keeps its kinds, norm, activation, mask and GQA grouping; its
widths, depth and vocabulary shrink (by its reference module's
``smoke(fields)`` where it has one), and each stream's lengths, rate, cap
and SLO shrink with them.  Nothing here runs in a cell on the card.
"""
from __future__ import annotations

import copy
import dataclasses

from bench import spec

SMOKE_FIELDS = {"d_model": 128, "d_ff": 256}


def smoke_cell(name: str, **kw) -> spec.Cell:
    """Cell ``name`` of ``BENCHMARK.json`` at the smoke size."""
    return shrink(spec.load_cell(name), **kw)


def dense(fields: dict):
    """The attention-and-MLP block's shrink."""
    group = fields["n_heads"] // fields["n_kv_heads"]
    fields.update(SMOKE_FIELDS, n_heads=4, n_kv_heads=4 // min(group, 2),
                  vocab_size=min(fields["vocab_size"], 500))


def shrink(cell: spec.Cell, *, rate: float = 40.0,
           n_layers: int = 2) -> spec.Cell:
    """A copy of ``cell`` at the smoke size."""
    cell = dataclasses.replace(cell, config=copy.deepcopy(cell.config),
                               traffic=copy.deepcopy(cell.traffic))
    for entry in cell.config["models"].values():
        f = entry["fields"]
        getattr(spec.reference(entry), "smoke", dense)(f)
        f["n_layers"] = n_layers
        entry["check"]["sample_requests"] = 4
    for stream in cell.traffic["streams"].values():
        stream.update(rate_rps=rate, lengths=[8, 16, 32], slo_ms=10_000.0,
                      batch_cap={"requests": 4, "tokens": 96}, segment_s=0.25)
    cell.config["sides"] = [dict(s, percent=100)
                            for s in cell.config["sides"]]
    return cell
