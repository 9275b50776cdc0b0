"""The port's encoder (hubert-xlarge) and VLM (internvl2-76b) on the CPU
against the JAX package.

The same seeded numpy inputs go through both packages in fp32: the flash
attention's plain version at Dh 80 without a causal mask against the
JAX Pallas kernel in interpret mode and its oracle (``tests/
test_kernels.py``'s tolerances), the two smoke models against the JAX
``Model`` (``PARITY``, ``tests/test_kernel_integration.py``'s, and
prefill + decode against forward at ``tests/test_models_smoke.py``'s),
weights carried across by the bridge.  Then what the catalog reads of an
encoder: its forward's bytes, its ``forward`` rows in an L(b, p) file,
and ``serve``'s refusal to price interference for an arch with no co-run
rows.
"""
import dataclasses
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro_torch.checkpoint import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import ElasticPartitioning, SquishyBinPacking  # noqa: E402
from repro_torch.core import h100intf  # noqa: E402
from repro_torch.core.h100lets import MIX, load_catalog  # noqa: E402
from repro_torch.core.latency import PARTITION_SIZES  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.launch import profile_partitions as pp  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model, frontend  # noqa: E402
from repro_torch.serving import executor  # noqa: E402

PARITY = dict(rtol=2e-4, atol=2e-4)   # tests/test_kernel_integration.py
ROOT = Path(__file__).resolve().parent.parent
LBP = ROOT / "results" / "h100_lbp.jsonl"
CORUN = ROOT / "results" / "h100_corun.jsonl"
FEATURES = ROOT / "results" / "h100_features.jsonl"
AUDIO, VLM = "hubert-xlarge", "internvl2-76b"


def port_config(jcfg):
    fields = dataclasses.asdict(jcfg)
    del fields["kernel_impl"], fields["analysis_unroll"]
    return type(get_config(AUDIO))(**fields)


def jax_and_port(jcfg, key=0):
    jm = JaxModel(jcfg, dtype=jnp.float32)
    params = jm.init(jax.random.key(key))
    tm = params_from_jax(jax.tree.map(np.asarray, params), port_config(jcfg),
                         device="cpu")
    return jm, params, tm


def normals(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# ------------------------------------------------------------ the kernel --


@pytest.mark.parametrize("b,h,hkv,s", [(2, 4, 4, 128),   # hubert's MHA
                                       (1, 4, 2, 256)])  # GQA, two blocks
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_at_head_dim_80_without_a_causal_mask(b, h, hkv, s,
                                                          dtype):
    """Dh 80 (hubert-xlarge), ``causal=False``: the plain version against
    the Pallas kernel in interpret mode and the oracle."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
           else dict(rtol=3e-2, atol=3e-2))
    arrays = [jnp.asarray(normals(i, b, n, s, 80), jdt)
              for i, n in enumerate((h, hkv, hkv))]
    jq, jk, jv = arrays
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                  for a in arrays)
    got = tflash.flash_attention_torch(tq, tk, tv, causal=False)
    assert got.dtype == tdt and got.shape == tq.shape
    np.testing.assert_allclose(
        f32(got), f32(pallas_flash(jq, jk, jv, causal=False,
                                   interpret=True)), **tol)
    np.testing.assert_allclose(
        f32(got), f32(ref.flash_attention_ref(jq, jk, jv, causal=False)),
        **tol)


def test_flash_kernel_is_built_for_hubert():
    cfg = get_config(AUDIO)
    assert cfg.head_dim == 80 and not cfg.causal
    assert cfg.head_dim in tflash.HEAD_DIMS


# --------------------------------------------------------------- hubert --


def hubert_smoke(kernel_impl="jnp"):
    """The smoke config at hubert's head dim, 80."""
    return dataclasses.replace(jax_smoke(AUDIO), d_head=80,
                               kernel_impl=kernel_impl)


@pytest.mark.parametrize("kernel_impl", ["jnp", "interpret"])
def test_hubert_forward_matches_jax(kernel_impl):
    """Frame embeddings in, per-frame logits out, not causal, RoPE on the
    frames as the JAX package applies it."""
    jcfg = hubert_smoke(kernel_impl)
    jm, params, tm = jax_and_port(jcfg)
    assert tm.cfg.head_dim == 80 and not tm.cfg.causal
    frames = normals(1, 2, 24, jcfg.d_model)
    want, _ = jm.forward(params, {"frame_embeds": jnp.asarray(frames)})
    got = tm.forward(frame_embeds=torch.from_numpy(frames))
    assert got.shape == (2, 24, jcfg.padded_vocab)
    np.testing.assert_allclose(f32(got), f32(want), **PARITY)
    # not causal: a later frame changes an earlier frame's logits
    later = frames.copy()
    later[:, -1] += 1.0
    moved = tm.forward(frame_embeds=torch.from_numpy(later))
    assert not torch.allclose(moved[:, 0], got[:, 0])


def test_hubert_has_no_decode_step():
    model = Model(get_smoke_config(AUDIO), dtype=torch.float32, device="cpu")
    assert not model.cfg.has_decoder and not hasattr(model, "embed")
    cache = model.init_cache(1, 8)
    with pytest.raises(ValueError, match="encoder-only"):
        model.decode_step(cache, torch.zeros(1, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="frame_embeds"):
        model.forward(torch.zeros(1, 4, dtype=torch.int32))


def test_hubert_init_fills_its_head_with_the_jax_scale():
    cfg = get_smoke_config(AUDIO)
    model = Model(cfg, dtype=torch.float32, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    assert model.head.shape == (cfg.d_model, cfg.padded_vocab)
    assert abs(float(model.head.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert torch.equal(model.final_norm.bias, torch.zeros(cfg.d_model))


# ------------------------------------------------------------- internvl --


def test_internvl_forward_with_patches_matches_jax():
    jcfg = jax_smoke(VLM)
    jm, params, tm = jax_and_port(jcfg, key=1)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                             (2, 9)).astype(np.int32)
    patches = normals(3, 2, jcfg.n_frontend_tokens, jcfg.d_model)
    want, _ = jm.forward(params, {"tokens": jnp.asarray(toks),
                                  "patch_embeds": jnp.asarray(patches)})
    got = tm.forward(torch.from_numpy(toks),
                     patch_embeds=torch.from_numpy(patches))
    assert got.shape == (2, jcfg.n_frontend_tokens + 9, jcfg.padded_vocab)
    np.testing.assert_allclose(f32(got), f32(want), **PARITY)


def test_internvl_prefill_and_decode_match_jax_and_its_forward():
    """Patches then text in the prefill (RoPE positions and the cache run
    over both), then one decode step; the JAX cache is never prefilled
    past its size (ROADMAP C.1)."""
    jcfg = jax_smoke(VLM)
    jm, params, tm = jax_and_port(jcfg, key=4)
    n, s, b = jcfg.n_frontend_tokens, 17, 2
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                             (b, s + 1)).astype(np.int32)
    patches = normals(6, b, n, jcfg.d_model)
    size = n + s + 8
    jc = jm.init_cache(b, size)
    jpre, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :s]),
                                   "patch_embeds": jnp.asarray(patches)}, jc)
    jdec, _ = jm.decode_step(params, jc, jnp.asarray(toks[:, s:]))
    tc = tm.init_cache(b, size)
    tp = torch.from_numpy(patches)
    tpre, tc = tm.prefill(torch.from_numpy(toks[:, :s]), tc, patch_embeds=tp)
    assert tc["len"] == n + s == int(jc["len"])
    tdec, tc = tm.decode_step(tc, torch.from_numpy(toks[:, s:]))
    np.testing.assert_allclose(f32(tpre), f32(jpre), **PARITY)
    np.testing.assert_allclose(f32(tdec), f32(jdec), **PARITY)
    ref1 = tm.forward(torch.from_numpy(toks[:, :s]), patch_embeds=tp)
    ref2 = tm.forward(torch.from_numpy(toks), patch_embeds=tp)
    torch.testing.assert_close(tpre[:, 0], ref1[:, -1], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(tdec[:, 0], ref2[:, -1], rtol=1e-3,
                               atol=1e-3)


# ---------------------------------------------------------------- bridge --


@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_bridge_round_trip(arch):
    """A bf16 JAX tree carried across: the model dtype from the tree
    (hubert's from its ``head``, having no embedding), every leaf
    bit-identical."""
    jcfg = jax_smoke(arch)
    params = JaxModel(jcfg, dtype=jnp.bfloat16).init(jax.random.key(7))
    tree = jax.tree.map(np.asarray, params)
    model = params_from_jax(tree, get_smoke_config(arch), device="cpu")
    assert model.dtype == torch.bfloat16
    head = model.head if arch == AUDIO else model.embed.head
    want = np.asarray(params["head"] if arch == AUDIO
                      else params["embed"]["head"])
    np.testing.assert_array_equal(
        head.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16))
    np.testing.assert_array_equal(
        model.layers[1].attn.wo.view(torch.int16).numpy().view(np.uint16),
        np.asarray(params["layers"]["attn"]["wo"][1]).view(np.uint16))


# ------------------------------------------------------------- executor --


def test_executor_answers_clips_with_a_label_per_frame():
    rep = executor.serve(AUDIO, requests=3, batch=2, prompt_lens=(6, 9),
                         output_len=4, seed=1, device="cpu", smoke=True)
    assert rep.encoder and rep.decode_steps == 0
    assert rep.prefill_batches == 2 and len(rep.batch_ms) == 2
    assert [len(r.tokens) for r in rep.results] == [6, 9, 6]
    assert all(0 <= t < 504 for r in rep.results for t in r.tokens)
    s = rep.summary()
    assert s["frames_per_s"] > 0 and s["all_finite"]
    again = executor.serve(AUDIO, requests=3, batch=2, prompt_lens=(6, 9),
                           output_len=4, seed=1, device="cpu", smoke=True)
    assert [r.tokens for r in again.results] == \
        [r.tokens for r in rep.results]


def test_executor_serves_the_vlm_behind_its_patches():
    rep = executor.serve(VLM, requests=2, batch=2, prompt_lens=(5,),
                         output_len=3, seed=0, device="cpu", smoke=True,
                         n_layers=1)
    assert rep.decode_steps == 2 and not rep.encoder
    assert all(len(r.tokens) == 3 for r in rep.results)
    assert rep.reduced and rep.reduced[0].startswith("n_layers 2 -> 1")
    reqs = executor.make_requests(2, (5,), 3, 100, 0,
                                  get_smoke_config(VLM))
    assert {r.n_patches for r in reqs} == {16}
    with pytest.raises(ValueError, match="outside"):
        executor.depth_reduction(VLM, 3, "cpu", smoke=True)


def test_frontends_are_seeded_stand_ins():
    cfg = get_smoke_config(VLM)
    a = frontend.vision_patch_embeddings(torch.Generator().manual_seed(3),
                                         2, 16, cfg, device="cpu")
    b = frontend.vision_patch_embeddings(torch.Generator().manual_seed(3),
                                         2, 16, cfg, device="cpu")
    assert a.shape == (2, 16, cfg.d_model) and a.dtype == torch.bfloat16
    assert torch.equal(a, b)
    f = frontend.audio_frame_embeddings(torch.Generator().manual_seed(3), 1,
                                        7, get_smoke_config(AUDIO),
                                        device="cpu", dtype=torch.float32)
    assert f.shape == (1, 7, 256) and abs(float(f.std()) - 1) < 0.2


# -------------------------------------------------------------- catalog --


def test_step_bytes_of_the_encoder_forward():
    """Every parameter, the head included, plus T x d_model frame inputs
    and T x padded_vocab logits a request, against the config's model on
    the meta device."""
    cfg = get_config(AUDIO)
    model = Model(cfg, device="meta")
    params = list(model.parameters())
    assert h100intf.param_count(cfg) == (
        sum(p.numel() for p in params if p.dtype == torch.bfloat16),
        sum(p.numel() for p in params if p.dtype == torch.float32))
    got = h100intf.step_bytes(cfg, 4, 1024)
    assert got["weights"] == sum(p.numel() * p.element_size()
                                 for p in params)
    assert got["per_request"] == 1024 * (1280 + 512) * 2
    assert got["total"] == got["weights"] + 4 * got["per_request"]


def _smoke_lbp(tmp_path, monkeypatch, card=("NVIDIA H100 80GB HBM3",
                                            700.0)):
    """A ``profile_partitions --smoke --device cpu`` file of hubert and
    yi-9b (16 frames a clip, to keep the CPU run short), with stand-in
    step times and SM counts where the CPU measures none (labelled as
    such)."""
    monkeypatch.setattr(pp, "FRAMES", 16)
    out = tmp_path / "smoke_lbp.jsonl"
    with redirect_stdout(io.StringIO()):
        assert pp.main(["--smoke", "--device", "cpu", "--archs",
                        f"{AUDIO},yi-9b", "--batches", "1,32",
                        "--out", str(out)]) == 0
    sms = {20: 24, 40: 56, 50: 64, 60: 76, 80: 108, 100: 132}
    recs = []
    for r in map(json.loads, out.read_text().splitlines()):
        base = {AUDIO: 6.0, "yi-9b": 12.0}[r["arch"]]
        recs.append(dict(
            r, card=card[0], power_limit_w=card[1], sms=sms[r["percent"]],
            split_sms={"20": [24, 108], "40": [56, 76], "50": [64, 68]},
            step_ms=base * 100 / r["percent"] + 0.1 * r["batch"],
            step_source="stand-in (CPU run)"))
    out.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return out, recs


def test_load_catalog_takes_the_encoder_by_its_forward(tmp_path,
                                                       monkeypatch):
    path, recs = _smoke_lbp(tmp_path, monkeypatch)
    assert {(r["arch"], r["step"], r["frames"], r["ctx"]) for r in recs} == {
        (AUDIO, "forward", 16, None), ("yi-9b", "decode", None, pp.CTX)}
    profiles, provider = load_catalog(str(path))
    assert provider.steps == {AUDIO: "forward", "yi-9b": "decode"}
    fwd = h100intf.step_bytes(get_smoke_config(AUDIO), 1, 16)
    assert (profiles[AUDIO].weight_mb, profiles[AUDIO].act_mb_per_req) == (
        fwd["weights"] / 1e6, fwd["per_request"] / 1e6)
    assert profiles[AUDIO].slo_ms == 2 * (6.0 + 3.2)
    # an encoder timed by a decode step, or a decoder by a forward, is
    # refused
    for arch, kind in ((AUDIO, "decode"), ("yi-9b", "forward")):
        bad = [dict(r, step=kind) if r["arch"] == arch else r for r in recs]
        path.write_text("".join(json.dumps(r) + "\n" for r in bad))
        with pytest.raises(ValueError, match="timed by its"):
            load_catalog(str(path))


def _serve(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = serve.main(argv)
    return rc, out.getvalue().splitlines()


def test_serve_plans_the_encoder_and_refuses_its_interference(
        tmp_path, monkeypatch):
    path, _ = _smoke_lbp(tmp_path, monkeypatch)
    rc, lines = _serve(["--results", str(path), "--rates",
                        f"{AUDIO}=40,yi-9b=5"])
    assert rc == 0
    assert any(line.startswith(f"  {AUDIO} ") and "(forward step)" in line
               for line in lines)
    assert any("hubert-xlarge r=" in line for line in lines)
    with pytest.raises(SystemExit, match=f"co-run rows or features for "
                                         f"{AUDIO}"):
        _serve(["--results", str(path), "--rates", f"{AUDIO}=40,yi-9b=5",
                "--corun", str(CORUN), "--features", str(FEATURES)])


def test_committed_catalog_holds_the_encoder_forward_rows(tmp_path):
    """hubert-xlarge's forward rows at 1024 frames in every cell of the
    grid, from the card of the mix's rows; the mix's max scales and plan
    are those of the file without them."""
    recs = [json.loads(line) for line in LBP.read_text().splitlines()]
    enc = [r for r in recs if r["arch"] == AUDIO]
    assert {(r["percent"], r["batch"]) for r in enc} == {
        (p, b) for p in PARTITION_SIZES for b in (1, 2, 4, 8, 16, 32)}
    assert all(r["step"] == "forward" and r["frames"] == 1024
               and r["step_ms"] > 0 and r["layers"] == 48 for r in enc)
    profiles, provider = load_catalog(str(LBP))
    assert provider.steps[AUDIO] == "forward"
    assert {r["card"] for r in recs} == {r["card"] for r in enc}
    mix_only = tmp_path / "mix.jsonl"
    mix_only.write_text("".join(line + "\n" for line in
                                LBP.read_text().splitlines()
                                if json.loads(line)["arch"] != AUDIO))
    plans = []
    for path in (LBP, mix_only):
        profs, prov = load_catalog(str(path))
        mix = {m: profs[m] for m in MIX}
        lam = {cls.__name__: cls(mix, cluster=serve.cluster_of(4),
                                 lat=prov).max_scale(MIX, 0.0,
                                                     serve.SEARCH_HI)
               for cls in (ElasticPartitioning, SquishyBinPacking)}
        plan = serve.plan(profs, prov, {
            m: r * lam["ElasticPartitioning"] * 0.99
            for m, r in MIX.items()}, 4)
        # (repr: the measured profiles' l2_util_base is NaN)
        plans.append((repr(mix), {m: prov.table[m] for m in MIX}, lam,
                       [(let.size, [(a.model, a.batch, a.duty_ms)
                                    for a in let.assignments])
                        for gpu in plan.gpus for let in gpu.lets]))
    assert plans[0] == plans[1] and plans[0][2]["ElasticPartitioning"] > 0
    rc, lines = _serve(["--results", str(LBP), "--rates", f"{AUDIO}=100"])
    assert rc == 0 and any("hubert-xlarge r=" in line for line in lines)
    with pytest.raises(SystemExit, match=f"co-run rows or features for "
                                         f"{AUDIO}"):
        _serve(["--results", str(LBP), "--rates", f"{AUDIO}=100,yi-9b=1",
                "--corun", str(CORUN), "--features", str(FEATURES)])
