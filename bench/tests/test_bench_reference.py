"""The reference against the port, the control, and the faults the check
must catch, at the smoke size on the CPU."""
from __future__ import annotations

import pytest
import torch

from bench import cell as cell_mod
from bench import spec, weights
from bench.reference import model as ref_model
from bench.tests.smoke import smoke_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 31337


def _port_fp32(entry):
    """The port's model in float32 holding the benchmark's bf16 weights."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model
    model = Model(ModelConfig(name="m", **entry["fields"]),
                  dtype=torch.float32, device="cpu")
    made = dict(weights.top(entry, "cpu", SEED))
    for i in range(entry["fields"]["n_layers"]):
        made.update({f"layers.{i}.{k}": v for k, v in
                     weights.layer(entry, i, "cpu", SEED).items()})
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(made.pop(n).float())
    assert not made
    return model


@pytest.mark.parametrize("workload", CELLS)
def test_reference_equals_the_port_in_fp32(workload):
    (entry,) = smoke_cell(workload).config["models"].values()
    model = _port_fp32(entry)
    v = entry["fields"]["vocab_size"]
    pool = weights.input_pool(entry, "cpu", SEED)
    if entry["fields"]["has_decoder"]:
        x = pool[:24].view(2, 12)
        with torch.inference_mode():
            port, _ = model.prefill(x, model.init_cache(2, 12))
    else:
        x = pool[:24].view(2, 12, -1)
        with torch.inference_mode():
            port = model.forward(frame_embeds=x.float())
    (ref,), = ref_model.run(entry, lambda i: weights.layer(entry, i, "cpu",
                                                            SEED),
                            weights.top(entry, "cpu", SEED), [x])
    torch.testing.assert_close(port[..., :v], ref, rtol=1e-4, atol=1e-4)


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([[1.0, 1.0625, 1.125, -448.0]])
    w = torch.eye(4)
    y = ref_model.fp8_mm(x, w)
    assert y[0, 0] == 1.0 and y[0, 2] == 1.125 and y[0, 3] == -448.0
    assert y[0, 1] in (1.0, 1.125)


@pytest.mark.parametrize("seed", [SEED, 5, 2**31 + 977])
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_committed_limit(workload, seed):
    """The reference in float8 in the program's place comes out not
    correct by the run's own verdict; the program, at the same inputs,
    reads below the limit.  Eight layers: the error of the lower precision
    grows with depth, as at the cells' 48."""
    cell = smoke_cell(workload, n_layers=8)
    for entry in cell.config["models"].values():
        entry["check"]["sample_requests"] = 80
    out = cell_mod.run_cell(cell, seed, 2.0, False, device="cpu",
                            control=True)
    (name,) = cell.config["models"]
    limit = out["check"][f"max_gap.{name}"]["limit"]
    assert out["correct"] is False
    assert out["check"][f"max_gap.{name}"]["value"] <= limit
    assert out["check"][f"control_max_gap.{name}"]["value"] > limit


def _broken(monkeypatch, fault):
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer
    Model = model_mod.Model
    if fault == "state_unchanged":
        # every block hands its input on: the step leaves the state as is
        monkeypatch.setattr(transformer, "block_apply_seq",
                            lambda block, x, kind, cfg, positions,
                            cache=None, *a, **k: (x, cache, None))
    elif fault == "half_batch":
        forward, prefill = Model.forward, Model.prefill

        def half(out):
            n = out.shape[0]
            keep = (n + 1) // 2
            return torch.cat([out[:keep], out[:keep]])[:n]

        monkeypatch.setattr(Model, "forward", lambda self, *a, **k: half(
            forward(self, *a, **k)))
        monkeypatch.setattr(Model, "prefill", lambda self, t, c, **k: (
            half(prefill(self, t[:(len(t) + 1) // 2].repeat(2, 1)[:len(t)],
                         c, **k)[0]), c))
    elif fault == "token_altered":
        head = Model._head
        monkeypatch.setattr(Model, "_head", lambda self, x: head(
            self, x).roll(1, dims=-1))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_faults_come_out_not_correct(monkeypatch, workload, fault):
    """The whole run with the timed path broken underneath: the check has
    to say so.  (The exchange between chips does not exist on one.)"""
    cell = smoke_cell(workload, rate=150.0)  # batches of several requests
    for entry in cell.config["models"].values():
        entry["check"]["sample_requests"] = 150
    _broken(monkeypatch, fault)
    out = cell_mod.run_cell(cell, SEED, 1.0, False, device="cpu")
    assert out["correct"] is False
