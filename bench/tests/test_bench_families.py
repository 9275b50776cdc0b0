"""Each configuration's own plain reference (``spec.reference``).

The two cells' weights and reference logits are pinned bit for bit at the
smoke size, so that the reference interface changes nothing of theirs.
The MoE fixture (``fixtures/deepseek-moe-16b.json``, not a cell) names its
own module, ``reference/moe.py``, and goes through ``run_cell`` with no
harness file knowing it: made (its float32 router by a stated draw),
loaded, served and checked.
"""
from __future__ import annotations

import hashlib
import io

import pytest
import torch

from bench import cell as cell_mod
from bench import flops, spec, weights
from bench.tests.smoke import shrink, smoke_cell

SEED = 2**31 + 977
# sha256 (``digest``) of layers 0 and 1, of the leaves outside the layers,
# and of the reference's logits of one group of 2 x 12 inputs, at the smoke
# size and SEED, as the harness made them before configurations named
# their reference
PINNED = {
    "hubert.clips": (
        "27d3dba100e7d9207891e70e23e2efa91f907559f2bf0c88686cd26d4b9a191d",
        "0fc44b8b74df6d3c2771acf0a1cf9b993c09f4fa8999862c32647cdcd7b6800b",
        "b4e6fb00b4434fcc2d0b3d7cf646c90c5b7285a1300a54d727bca6d3e46d0c4d",
        "4d68dbeb09d6cf43892976e65eb7dd6ece0674f0bffaa75ab02af417da5ce58e"),
    "yi9b.prompts": (
        "0b26d219b9cfe4f9b5727fabc55ae82b74e0c25b7c34025d3ea7ac47f4026066",
        "e8f2f030863186e13c2d452e575e68cc2da5226d1e5328ee08d3637a1c6afce2",
        "d9841994af477bae6e4b31da0dbb7f5b77af49def02fee0421b9e045dbe7abea",
        "0f0f999170940ea8ea90336622b33c1179e5dce7e57d1869d94fd24d11452af6"),
}
FIXTURES = spec.BENCH / "tests" / "fixtures"
MOE = "bench/tests/fixtures/deepseek-moe-16b.json"


def digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for n in sorted(tensors):
        t = tensors[n].contiguous()
        h.update(f"{n}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _entry(workload: str) -> dict:
    (entry,) = smoke_cell(workload).config["models"].values()
    return entry


def _readings(entry: dict) -> tuple:
    """What the pin holds: the digests of two layers, of the top, of the
    reference's logits of one group."""
    pool = weights.input_pool(entry, "cpu", SEED)
    x = pool[:24].view(2, 12, *pool.shape[1:])
    (ref,), = spec.reference(entry).run(
        entry, lambda i: weights.layer(entry, i, "cpu", SEED),
        weights.top(entry, "cpu", SEED), [x])
    return (digest(weights.layer(entry, 0, "cpu", SEED)),
            digest(weights.layer(entry, 1, "cpu", SEED)),
            digest(weights.top(entry, "cpu", SEED)),
            digest({"logits": ref}))


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_weights_and_reference_are_pinned(workload):
    assert _readings(_entry(workload)) == PINNED[workload]


@pytest.mark.parametrize("workload", sorted(PINNED))
def test_naming_model_py_is_naming_nothing(workload):
    entry = _entry(workload)
    named = dict(entry, reference="bench/reference/model.py")
    assert spec.reference(named) is spec.reference(named)  # loaded once
    assert _readings(named) == _readings(entry)
    for b, s in ((3, 16), (1, 32)):
        assert flops.step_flops(named, b, s) == flops.step_flops(entry, b, s)
        assert flops.flash_cost(named, b, s) == flops.flash_cost(entry, b, s)


@pytest.mark.parametrize("path", [
    "src/repro_torch/models/moe.py", "bench/../src/x.py", "/tmp/x.py",
    "bench/reference/model.json"])
def test_a_reference_is_a_module_under_bench(path):
    with pytest.raises(ValueError, match="under bench/"):
        spec.reference({"reference": path, "fields": {}})


def test_stated_float32_draws_come_after_the_others():
    """``f32:normal`` and ``f32:uniform`` leaves draw from the same
    generator after the bf16 and norm leaves, which stay as drawn
    without them."""
    old = [("a", (64, 8), "normal:0.5"), ("s", (8,), "scale"),
           ("b", (8,), "bias")]
    new = [("u", (4096,), "f32:uniform:-4.6:-2.3"),
           ("n", (4096,), "f32:normal:1.5:0.25"),
           ("u2", (3,), "f32:uniform:0:1")]
    made = weights.make(new[:1] + old + new[1:], "cpu", SEED, 7)
    before = weights.make(old, "cpu", SEED, 7)
    assert all(torch.equal(made[n], before[n]) for n, _, _ in old)
    again = weights.make(new[:1] + old + new[1:], "cpu", SEED, 7)
    assert all(torch.equal(made[n], again[n]) for n in made)
    u, n = made["u"], made["n"]
    assert u.dtype == n.dtype == torch.float32
    assert -4.6 <= u.min() and u.max() <= -2.3
    assert abs(u.mean() + 3.45) < 0.05
    assert abs(u.std() - 2.3 / 12 ** 0.5) < 0.05
    assert abs(n.mean() - 1.5) < 0.02 and abs(n.std() - 0.25) < 0.02


@pytest.mark.parametrize("init", ["f32:gamma:1:2", "f32:normal:1", "bf16:x"])
def test_unknown_draw_is_refused(init):
    with pytest.raises(ValueError, match="init"):
        weights.make([("x", (2,), init)], "cpu", SEED)


def moe_cell(**kw) -> spec.Cell:
    """The MoE fixture at the smoke size, with the end-to-end metrics
    every cell reports."""
    cell = spec.Cell(
        name="deepseek-moe.fixture", chips=1,
        config=spec.load_json(spec.ROOT / MOE),
        traffic=spec.load_json(FIXTURES / "deepseek-moe-prompts.json"),
        end_to_end=[m for m in spec.benchmark()["end_to_end"]
                    if "workloads" not in m], per_layer=[])
    return shrink(cell, **kw)


def test_moe_fixture_runs_whole_and_correct():
    cell = moe_cell()
    (entry,) = cell.config["models"].values()
    assert spec.reference(entry).__name__ == "bench_reference_moe_py"
    assert entry["fields"]["n_experts"] == 8  # the module's own shrink
    out = cell_mod.run_cell(cell, SEED, 1.0, False, device="cpu",
                            log=io.StringIO())
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 20
    assert set(out["metrics"]) == {"goodput_rps", "setup_s"}
    assert out["check"]["sampled_tokens.deepseek-moe-16b"]["value"] == 4


def test_moe_reference_equals_the_port_in_fp32():
    """The port's MoE model in float32 holding the same weights, with a
    capacity that drops nothing: the reference's arithmetic, at four
    layers."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model
    (entry,) = moe_cell(n_layers=4).config["models"].values()
    model = Model(ModelConfig(name="m", **entry["fields"]),
                  dtype=torch.float32, device="cpu")
    made = dict(weights.top(entry, "cpu", SEED))
    for i in range(4):
        made.update({f"layers.{i}.{k}": v for k, v in
                     weights.layer(entry, i, "cpu", SEED).items()})
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(made.pop(n).float())
    assert not made
    x = weights.input_pool(entry, "cpu", SEED)[:48].view(3, 16)
    with torch.inference_mode():
        port, _ = model.prefill(x, model.init_cache(3, 16))
    (ref,), = spec.reference(entry).run(
        entry, lambda i: weights.layer(entry, i, "cpu", SEED),
        weights.top(entry, "cpu", SEED), [x])
    v = entry["fields"]["vocab_size"]
    torch.testing.assert_close(port[..., :v], ref, rtol=1e-4, atol=1e-4)


def _perturbed(fault: str):
    load = weights.load_into

    @torch.no_grad()
    def perturbed(model, c, seed):
        load(model, c, seed)
        for block in model.layers:
            if fault == "experts_swapped":  # expert 0 served by 1's weights
                for name in ("w_gate", "w_up", "w_down"):
                    w = getattr(block.moe, name)
                    w[[0, 1]] = w[[1, 0]]
            else:
                block.moe.w_down[0].neg_()
    return perturbed


@pytest.mark.parametrize("fault", ["experts_swapped", "expert_negated"])
def test_moe_perturbed_expert_is_not_correct(monkeypatch, fault):
    """Limit 1.0 (the fixture's): sound runs read 0.004-0.367 over seeds
    1-12 at this size and 133 prompts, these faults 1.78-3.80 and
    2.18-4.71."""
    cell = moe_cell(rate=150.0)
    for entry in cell.config["models"].values():
        entry["check"]["sample_requests"] = 150
    monkeypatch.setattr(weights, "load_into", _perturbed(fault))
    out = cell_mod.run_cell(cell, SEED, 1.0, False, device="cpu",
                            log=io.StringIO())
    assert out["correct"] is False
    assert out["check"]["max_gap.deepseek-moe-16b"]["value"] > 1.0


def test_a_leaf_the_reference_lacks_is_named(monkeypatch):
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model
    (entry,) = moe_cell().config["models"].values()
    ref = spec.reference(entry)
    leaves = ref.layer_leaves
    monkeypatch.setattr(ref, "layer_leaves", lambda c, i: [
        x for x in leaves(c, i) if x[0] != "moe.router"])
    model = Model(ModelConfig(name="m", **entry["fields"]),
                  dtype=torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match=r"layers\.0.*'moe\.router'"):
        weights.load_into(model, entry, SEED)


def test_moe_capacity_that_drops_is_refused():
    (entry,) = moe_cell().config["models"].values()
    entry["fields"]["capacity_factor"] = 1.25  # under 8 / 2
    with pytest.raises(ValueError, match="capacity_factor"):
        weights.layer(entry, 0, "cpu", SEED)


def test_moe_counts_its_own_block():
    """A hand count: per layer q, k, v, o 4 x 2*5*8*8 (4 heads of 2), the
    causal core 4*2*4*15, the router 2*5*8*4, two routed and one shared
    expert 3 x 3 x 2*5*8*6; the head at the last position, 256 padded
    columns.  The attention call's cost is the frozen one."""
    entry = {"reference": "bench/reference/moe.py", "fields": {
        "d_model": 8, "n_heads": 4, "n_kv_heads": 4, "vocab_size": 10,
        "n_layers": 3, "n_experts": 4, "top_k": 2, "n_shared_experts": 1,
        "moe_d_ff": 6, "d_ff": 6, "causal": True, "has_decoder": True}}
    layer = 4 * 640 + 480 + 320 + 9 * 480
    assert flops.step_flops(entry, 1, 5) == 3 * layer + 2 * 8 * 256
    dense = {k: v for k, v in entry.items() if k != "reference"}
    assert flops.flash_cost(entry, 1, 5) == flops.flash_cost(dense, 1, 5)
