"""The frozen FLOP and byte formulas against PyTorch's own count and a hand
count."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import flops
from bench.tests.smoke import smoke_cell


def _counted(entry, b: int, s: int) -> int:
    """FLOPs ``torch.utils.flop_counter`` counts in the port's model at
    the smoke size, on the CPU: a decoder's prefill, an encoder's
    forward."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model
    cfg = ModelConfig(name="m", **entry["fields"])
    model = Model(cfg, dtype=torch.float32, device="cpu")
    pool = torch.zeros((b, s), dtype=torch.long)
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        if cfg.has_decoder:
            model.prefill(pool, model.init_cache(b, s))
        else:
            model.forward(frame_embeds=torch.zeros(b, s, cfg.d_model))
    return fc.get_total_flops()


@pytest.mark.parametrize("workload,b,s", [
    ("hubert.clips", 3, 16), ("hubert.clips", 1, 32),
    ("yi9b.prompts", 2, 16), ("yi9b.prompts", 4, 8)])
def test_step_flops_equal_the_flop_counter(workload, b, s):
    """The plain attention the CPU runs computes every query-key pair, so
    the count is compared with ``causal=False``; every other product is
    the model's."""
    cell = smoke_cell(workload)
    (entry,) = cell.config["models"].values()
    assert flops.step_flops(entry, b, s, causal=False) == \
        _counted(entry, b, s)


def test_causal_pairs_and_hand_count():
    assert flops.live_pairs(4, True) == 10
    assert flops.live_pairs(4, False) == 16
    assert flops.live_pairs(6, True, window=2) == 11
    entry = {"fields": {"d_model": 8, "n_heads": 2, "n_kv_heads": 1,
                        "d_ff": 16, "vocab_size": 10, "n_layers": 3,
                        "activation": "gelu", "causal": False,
                        "has_decoder": False}}
    # per layer: q 2*5*8*8, k and v 2*5*8*4 each, o 2*5*8*8, MLP 2*2*5*8*16,
    # attention 4*4*2*25; head at every frame, 256 padded columns
    layer = 640 + 320 + 320 + 640 + 2560 + 800
    assert flops.step_flops(entry, 1, 5) == 3 * layer + 2 * 5 * 8 * 256
    ops, nbytes = flops.flash_cost(entry, 1, 5)
    assert ops == 800 and nbytes == 2 * (2 * 2 * 5 * 4 + 2 * 1 * 5 * 4)


def test_peaks_known_card_only():
    p = flops.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12
    assert flops.peaks("cpu") is None


def test_flash_bound_takes_the_larger():
    entry = smoke_cell("yi9b.prompts").config["models"]["yi-9b"]
    peak = {"bf16_flops": 1e12, "hbm_bytes_per_s": 1e9}
    ops, nbytes = flops.flash_cost(entry, 2, 64)
    assert flops.flash_bound_s(entry, 2, 64, peak) == max(ops / 1e12,
                                                          nbytes / 1e9)

