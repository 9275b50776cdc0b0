"""The port's launch and analysis slice (``launch/{specs,mesh,sharding,
dryrun}.py``) and the kernels' ``meta`` route, on the CPU, against the JAX
package.

* specs: ``INPUT_SHAPES`` and the applicability and decode-window rules of
  all 10 x 4 combinations equal JAX's; the batch stand-ins' shapes and
  dtypes equal JAX's ``ShapeDtypeStruct``s; the step kinds equal; the
  port's per-layer cache equals JAX's ``Model.cache_shapes`` once stacked,
  leaf for leaf and in bytes, at full size; JAX's ``tests/
  test_specs_and_parsers.py`` cases through the port.
* sharding: every parameter's spec of every arch at full size, on 16x16
  and 2x16x16, with and without FSDP, equals JAX's ``param_spec_for`` on
  its leaf (without the layer entry of a stacked leaf); the same for the
  cache and batch rules (JAX's ``NamedSharding`` stood in by its spec, the
  mesh by a ``FakeMesh`` as JAX's ``tests/test_sharding_rules.py`` does);
  ``per_device_bytes`` equals the bytes JAX's specs give; that file's
  cases through the port.
* the dry run: the copied functions' source equals JAX's; JAX's
  ``optimal_model_axis`` cases; at the smoke size a ``meta`` trace and a
  CPU run of the same step count the same FLOPs and bytes outside the
  kernels and the same arguments; at full size ``lower_combo`` is ok for
  one arch of each family at each applicable shape, its parameter bytes
  JAX's ``param_shapes`` bytes, and it allocates on ``meta`` only.
* the meta route: ``ops`` prices a ``meta`` tensor (the plain version's
  shapes and dtypes, nothing computed, no launch), the backward Functions
  give meta gradients; the dry run's counters charge nothing for a CPU
  step that is one plain version; each kernel's cost formula against a
  hand count at a small shape.
"""
import functools
import inspect
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.tree_util import tree_flatten_with_path  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import dryrun as jdry  # noqa: E402
from repro.launch import sharding as jshr  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.checkpoint.bridge import _jax_path  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops, pricing  # noqa: E402
from repro_torch.kernels import rglru_scan as trg  # noqa: E402
from repro_torch.kernels import rope as trope  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.launch import dryrun, mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding as shr  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

SHAPES = tuple(specs.INPUT_SHAPES)
COMBOS = [(a, s) for a in ARCH_IDS for s in SHAPES]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}
# one arch of each family
FAMILIES = ("yi-9b", "deepseek-moe-16b", "mamba2-780m", "recurrentgemma-2b",
            "internvl2-76b", "hubert-xlarge")


class FakeMesh:
    """The JAX test's stand-in: axis names and sizes, no devices."""

    def __init__(self, multi_pod: bool):
        self.axis_names = (("pod", "data", "model") if multi_pod
                           else ("data", "model"))
        self.shape = dict(zip(self.axis_names,
                              (2, 16, 16) if multi_pod else (16, 16)))


def jax_names(path) -> list[str]:
    return jshr._path_names(path)


def jax_key(names) -> str:
    """A JAX leaf's path as ``checkpoint/bridge.py::_jax_path`` writes it."""
    return "/".join(n.strip("[]") for n in names)


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return tree_flatten_with_path(JaxModel(jax_config(arch)).param_shapes())[0]


@functools.lru_cache(maxsize=None)
def meta_model(arch):
    return Model(get_config(arch), device="meta")


def tdtype(leaf):
    """The torch dtype of a JAX leaf's."""
    return DTYPES[str(jnp.dtype(leaf.dtype))]


def sds_bytes(leaf) -> int:
    return math.prod(leaf.shape) * jnp.dtype(leaf.dtype).itemsize


@pytest.fixture
def spec_only(monkeypatch):
    """JAX's sharding helpers with ``NamedSharding`` stood in by its spec,
    so they run against a ``FakeMesh``."""
    monkeypatch.setattr(jshr, "NamedSharding",
                        lambda mesh, spec: tuple(spec))


# ------------------------------------------------------------------ specs --


def test_input_shapes_equal_jax():
    assert specs.INPUT_SHAPES == jspecs.INPUT_SHAPES
    assert specs.LONG_DECODE_WINDOW == jspecs.LONG_DECODE_WINDOW


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_specs_equal_jax(arch, shape):
    """Applicability, the decode window, the step kind, the batch stand-ins
    and, at full size, the cache: per-layer leaves that stack into JAX's
    ``cache_shapes`` (bytes too), ``len`` aside."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert specs.applicable(cfg, shape) == jspecs.applicable(jcfg, shape)
    assert specs.decode_window(cfg, shape) == jspecs.decode_window(jcfg,
                                                                   shape)
    if not specs.applicable(cfg, shape)[0]:
        return
    kind, args = specs.input_specs(cfg, shape, model=meta_model(arch))
    jkind, jargs = jspecs.input_specs(jcfg, shape)
    assert kind == jkind
    batch = args[0] if kind != "decode" else {"tokens": args[1]}
    jbatch = jargs[0] if kind != "decode" else {"tokens": jargs[1]}
    assert set(batch) == set(jbatch)
    for key, t in batch.items():
        assert t.device.type == "meta"
        assert (tuple(t.shape), t.dtype) == (jbatch[key].shape,
                                             tdtype(jbatch[key]))
    if kind in ("train", "encode"):
        return
    cache = args[1] if kind == "prefill" else args[0]
    jcache = jargs[1] if kind == "prefill" else jargs[0]
    layers = cache["layers"]
    assert len(layers) == cfg.n_layers and cache["len"] == 0
    if isinstance(jcache["layers"], dict):        # stacked
        for name, leaf in jcache["layers"].items():
            assert all(tuple(c[name].shape) == leaf.shape[1:]
                       for c in layers)
            assert {tdtype(leaf)} == {c[name].dtype for c in layers}
    else:
        for c, jc in zip(layers, jcache["layers"], strict=True):
            assert {k: (tuple(t.shape), t.dtype) for k, t in c.items()} == {
                k: (v.shape, tdtype(v)) for k, v in jc.items()}
    port_bytes = sum(t.numel() * t.element_size()
                     for c in layers for t in c.values())
    assert port_bytes == sum(sds_bytes(leaf) for leaf in
                             jax.tree.leaves(jcache["layers"]))


def test_applicability_matrix():
    """JAX's case: 38 runnable combos + hubert's two decode skips."""
    runnable = skipped = 0
    for a in ARCH_IDS:
        for s in SHAPES:
            ok, why = specs.applicable(get_config(a), s)
            if ok:
                runnable += 1
            else:
                skipped += 1
                assert a == "hubert-xlarge" and "encoder-only" in why
    assert runnable == 38 and skipped == 2


@pytest.mark.parametrize("arch,shape,want", [
    ("yi-9b", "long_500k", 4096), ("mamba2-780m", "long_500k", None),
    ("recurrentgemma-2b", "long_500k", None), ("yi-9b", "decode_32k", None)])
def test_decode_window_policy(arch, shape, want):
    assert specs.decode_window(get_config(arch), shape) == want


def test_batch_specs_modalities():
    vlm = specs.batch_specs(get_config("internvl2-76b"), 32, 32768)
    assert vlm["tokens"].shape[1] + vlm["patch_embeds"].shape[1] == 32768
    audio = specs.batch_specs(get_config("hubert-xlarge"), 8, 1024)
    assert audio["frame_embeds"].shape == (8, 1024, 1280)
    assert audio["labels"].dtype == torch.int32
    assert all(t.device.type == "meta" for t in (*vlm.values(),
                                                 *audio.values()))


@pytest.mark.parametrize("arch,shape,kind", [
    ("yi-9b", "train_4k", "train"), ("yi-9b", "prefill_32k", "prefill"),
    ("yi-9b", "decode_32k", "decode"),
    ("hubert-xlarge", "prefill_32k", "encode")])
def test_input_specs_kinds(arch, shape, kind):
    assert specs.input_specs(get_config(arch), shape)[0] == kind


def test_long500k_cache_is_windowed():
    """JAX's case in the port's layout: every layer's KV ring (B, S, Hkv,
    Dh) holds 4096 slots."""
    _, (cache, tokens) = specs.input_specs(get_config("command-r-35b"),
                                           "long_500k")
    assert all(t.shape[1] == 4096 for c in cache["layers"]
               for t in c.values())
    assert tokens.shape == (1, 1)


def test_specs_on_a_device_are_zeros():
    """Given a model on the CPU, the stand-ins are zero tensors there."""
    cfg = get_smoke_config("yi-9b")
    kind, (batch, cache) = specs.step_specs(
        cfg, "prefill", 2, 16, model=Model(cfg, device="cpu"))
    assert kind == "prefill"
    leaves = [*batch.values(), *(t for c in cache["layers"]
                                 for t in c.values())]
    assert all(t.device.type == "cpu" and not t.any() for t in leaves)


# ------------------------------------------------------------- the mesh --


def test_meshes():
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    mp = tmesh.make_production_mesh(multi_pod=True)
    assert (mp.axis_names, mp.name) == (("pod", "data", "model"), "2x16x16")
    assert tmesh.dp_axes(mp) == ("pod", "data")
    sub = tmesh.make_submesh(64, model_axis=8)
    assert (sub.shape, sub.name) == ({"data": 8, "model": 8}, "8x8")
    with pytest.raises(AssertionError):
        tmesh.make_submesh(60)


# --------------------------------------------------------------- sharding --


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_jax(arch, multi_pod, fsdp):
    """Every port parameter's spec is JAX's ``param_spec_for`` on the leaf
    it is (a stacked leaf's without its layer entry), and the per-device
    bytes are the ones JAX's specs give."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    mesh, fake = (tmesh.make_production_mesh(multi_pod=multi_pod),
                  FakeMesh(multi_pod))
    model = meta_model(arch)
    got = shr.param_specs(model, mesh, fsdp=fsdp)
    jleaves = {}
    jax_bytes = 0
    for path, leaf in jax_params(arch):
        names = jax_names(path)
        spec = tuple(jshr.param_spec_for(names, leaf.shape, fake, jcfg,
                                         fsdp))
        jleaves[jax_key(names)] = (leaf, spec)
        n = shr.shards(spec, mesh)
        assert sds_bytes(leaf) % n == 0
        jax_bytes += sds_bytes(leaf) // n
    stacked = shr.is_stacked(cfg)
    assert len(got) == sum(1 for _ in model.named_parameters())
    for name, p in model.named_parameters():
        key, layer = _jax_path(name, stacked)
        leaf, spec = jleaves[key]
        if layer is not None:
            assert leaf.shape[1:] == tuple(p.shape)
            spec = spec[1:]
        assert got[name] == spec, name
    assert shr.per_device_bytes(model, got, mesh) == jax_bytes


def jax_cache(arch, shape):
    jcfg = jax_config(arch)
    info = jspecs.INPUT_SHAPES[shape]
    return JaxModel(jcfg).cache_shapes(
        info["global_batch"], info["seq_len"],
        window=jspecs.decode_window(jcfg, shape))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a != "hubert-xlarge"])
def test_cache_and_batch_specs_equal_jax(arch, multi_pod, spec_only):
    """The decode cache (``decode_32k``, per layer against JAX's stacked or
    listed leaves) and the batches of every applicable shape: the port's
    specs are JAX's, and so are the per-device bytes."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    mesh, fake = (tmesh.make_production_mesh(multi_pod=multi_pod),
                  FakeMesh(multi_pod))
    _, (cache, _) = specs.input_specs(cfg, "decode_32k",
                                      model=meta_model(arch))
    jc = jax_cache(arch, "decode_32k")
    got = shr.cache_shardings(cfg, cache, mesh)
    want = jshr.cache_shardings(jcfg, jc, fake)
    assert got["len"] == want["len"] == ()
    jax_bytes = 0
    if isinstance(jc["layers"], dict):
        for name, leaf in jc["layers"].items():
            spec = want["layers"][name]
            for i in range(cfg.n_layers):
                assert got[f"layers/[{i}]/{name}"] == spec[1:]
            jax_bytes += sds_bytes(leaf) // shr.shards(spec, mesh)
    else:
        for i, layer in enumerate(jc["layers"]):
            for name, leaf in layer.items():
                spec = want["layers"][i][name]
                assert got[f"layers/[{i}]/{name}"] == spec
                jax_bytes += sds_bytes(leaf) // shr.shards(spec, mesh)
    assert shr.per_device_bytes(cache, got, mesh) == jax_bytes
    for shape in SHAPES:
        kind, args = specs.input_specs(cfg, shape, model=meta_model(arch))
        _, jargs = jspecs.input_specs(jcfg, shape)
        batch, jbatch = ((args[0], jargs[0]) if kind != "decode" else
                         ({"tokens": args[1]}, {"tokens": jargs[1]}))
        got_b = shr.batch_shardings(cfg, batch, mesh)
        want_b = jshr.batch_shardings(jcfg, jbatch, fake)
        assert got_b == want_b
        assert shr.per_device_bytes(batch, got_b, mesh) == sum(
            sds_bytes(jbatch[k]) // shr.shards(want_b[k], mesh)
            for k in jbatch)


# JAX's tests/test_sharding_rules.py, through the port
YI = get_config("yi-9b")
RULES = [
    (["layers", "attn", "wq"], (48, 4096, 32, 128), False,
     (None, None, "model", None)),
    (["layers", "attn", "wk"], (48, 4096, 4, 128), False,
     (None, None, None, None)),
    (["layers", "attn", "wo"], (48, 32, 128, 4096), False,
     (None, "model", None, None)),
    (["layers", "attn", "wq"], (48, 4096, 32, 128), True,
     (None, "data", "model", None)),
    (["layers", "mlp", "w_down"], (48, 11008, 4096), True,
     (None, "model", "data")),
    (["layers", "moe", "w_gate"], (28, 64, 2048, 1408), False,
     (None, "model", None, None)),
    (["layers", "moe", "w_down"], (28, 64, 1408, 2048), True,
     (None, "model", None, "data")),
    (["layers", "moe", "shared", "w_up"], (28, 2048, 2816), False,
     (None, None, "model")),
    (["embed", "tok"], (64000, 4096), False, ("model", None)),
    (["embed", "head"], (4096, 64000), True, ("data", "model")),
    (["layers", "ln1", "scale"], (48, 4096), False, (None, None)),
    (["layers", "attn", "wq"], (26, 2560, 10, 256), False,
     (None, None, None, None)),
    (["layers", "ssm", "w_x"], (48, 1536, 3072), False, (None, None, "model")),
    (["layers", "ssm", "a_log"], (48, 48), False, (None, "model")),
    (["layers", "ssm", "w_bc"], (48, 1536, 256), False, (None, None, None)),
]


@pytest.mark.parametrize("names,shape,fsdp,want", RULES)
def test_sharding_rules(names, shape, fsdp, want):
    got = shr.param_spec_for(names, shape, tmesh.make_production_mesh(), YI,
                             fsdp)
    assert got == want
    assert got == tuple(jshr.param_spec_for(names, shape, FakeMesh(False),
                                            jax_config("yi-9b"), fsdp))


# ---------------------------------------------------------------- dry run --


@pytest.mark.parametrize("name", ["model_flops", "optimal_model_axis",
                                  "optimal_fsdp"])
def test_copied_functions_are_jax_word_for_word(name):
    assert (inspect.getsource(getattr(dryrun, name))
            == inspect.getsource(getattr(jdry, name)))


@pytest.mark.parametrize("arch,shape,want", [
    ("arctic-480b", "prefill_32k", 8), ("command-r-35b", "decode_32k", 8),
    ("yi-9b", "decode_32k", 4), ("yi-9b", "train_4k", 16),
    ("mamba2-780m", "decode_32k", 16), ("deepseek-moe-16b", "decode_32k", 16),
    ("yi-9b", "long_500k", 16)])
def test_optimal_model_axis(arch, shape, want):
    assert dryrun.optimal_model_axis(get_config(arch), shape) == want
    assert jdry.optimal_model_axis(jax_config(arch), shape) == want


def traced(arch, kind, device):
    """The dry run's counts of one smoke-size step (batch 2 x 32) built on
    ``device`` (weights drawn from a seed off ``meta``)."""
    cfg = get_smoke_config(arch)
    model = Model(cfg, dtype=torch.float32, device=device)
    if device != "meta":
        model.init(torch.Generator().manual_seed(0))
    kind, args = specs.step_specs(cfg, kind, 2, 32, model=model)
    step, arguments = dryrun.build_step(model, kind, args, 32)
    return dryrun.trace(step, arguments)


@pytest.mark.parametrize("arch,kind", [
    ("yi-9b", "prefill"), ("yi-9b", "decode"),
    ("deepseek-moe-16b", "prefill"), ("deepseek-moe-16b", "decode"),
    ("mamba2-780m", "prefill"), ("mamba2-780m", "decode"),
    ("mamba2-780m", "train"), ("recurrentgemma-2b", "prefill"),
    ("recurrentgemma-2b", "decode"), ("internvl2-76b", "prefill"),
    ("internvl2-76b", "decode"), ("hubert-xlarge", "prefill")])
def test_meta_trace_counts_what_a_cpu_run_does(arch, kind):
    """The same step at the smoke size on ``meta`` and on the CPU (plain
    versions, whose work inside the kernels' entries is not counted): the
    same FLOPs and bytes outside the kernels, the same argument bytes; the
    CPU run charges no kernel, the meta run one call per kernel launch."""
    meta, cpu = traced(arch, kind, "meta"), traced(arch, kind, "cpu")
    assert meta["flops_outside_kernels"] == cpu["flops_outside_kernels"] > 0
    assert meta["bytes_outside_kernels"] == cpu["bytes_outside_kernels"] > 0
    assert (meta["memory"]["argument_size_in_bytes"]
            == cpu["memory"]["argument_size_in_bytes"])
    assert cpu["kernels"] == {}
    cfg = get_smoke_config(arch)
    kinds = cfg.layer_types()
    n_attn = sum(k in ("attn_mlp", "moe", "attn") for k in kinds)
    calls = {k: v["calls"] for k, v in meta["kernels"].items()}
    if kind == "decode":
        want = {"decode_attention": n_attn, "rope": n_attn} if n_attn else {}
    elif kind == "train":
        want = {"ssd_scan": 2 * len(kinds), "ssd_scan_backward": len(kinds)}
    else:
        want = {k: v for k, v in (("flash_attention", n_attn),
                                  ("rope", n_attn),
                                  ("ssd_scan", kinds.count("ssm")),
                                  ("rglru_scan", kinds.count("rglru"))) if v}
    assert calls == want


@functools.lru_cache(maxsize=None)
def jax_param_bytes(arch) -> int:
    return sum(sds_bytes(leaf) for _, leaf in jax_params(arch))


@pytest.mark.parametrize("arch,shape", [(a, s) for a in FAMILIES
                                        for s in SHAPES])
def test_lower_combo_full_size(arch, shape):
    """Every family at every shape, full size: ok (hubert's decode shapes
    skipped with JAX's reason), its parameter bytes JAX's, its memory
    consistent, its roofline on the H100."""
    rec = dryrun.lower_combo(arch, shape)
    assert (rec["arch"], rec["shape"], rec["mesh"]) == (arch, shape, "16x16")
    if not specs.applicable(get_config(arch), shape)[0]:
        assert rec["status"] == "skipped"
        assert rec["reason"] == jspecs.applicable(jax_config(arch), shape)[1]
        return
    assert rec["status"] == "ok", rec
    assert rec["argument_bytes"]["params"] == jax_param_bytes(arch)
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == sum(
        rec["argument_bytes"].values())
    assert mem["temp_size_in_bytes"] >= 0
    assert mem["peak_bytes"] == (mem["argument_size_in_bytes"]
                                 + mem["temp_size_in_bytes"]
                                 + mem["output_size_in_bytes"]
                                 - mem["alias_size_in_bytes"])
    assert rec["fits_one_card"] == (mem["peak_bytes"] <= 80e9)
    r = rec["roofline"]
    assert r["compute_s"] == pytest.approx(rec["flops"] / 989e12)
    assert r["memory_s"] == pytest.approx(rec["bytes"] / 3.35e12)
    assert r["model_flops_global"] == jdry.model_flops(jax_config(arch),
                                                       shape)
    assert rec["collective"] is None
    assert 0 < rec["per_device_argument_bytes"] < mem[
        "argument_size_in_bytes"]
    assert rec["flops"] >= rec["flops_outside_kernels"] > 0


@pytest.mark.parametrize("arch,shape,fits", [
    ("yi-9b", "long_500k", True), ("command-r-35b", "long_500k", True),
    ("mamba2-780m", "decode_32k", True), ("recurrentgemma-2b",
                                          "decode_32k", True),
    ("yi-9b", "decode_32k", False), ("internvl2-76b", "long_500k", False)])
def test_fits_one_card(arch, shape, fits):
    """The issue's reckoning: parameters and cache against 80 GB."""
    assert dryrun.lower_combo(arch, shape)["fits_one_card"] == fits


def test_lower_combo_allocates_on_meta_only():
    """No op of a dry run makes a tensor anywhere but on ``meta``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    devices = set()

    class Devices(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            devices.update(t.device.type for t in tree_leaves(out)
                           if isinstance(t, torch.Tensor))
            return out

    with Devices():
        rec = dryrun.lower_combo("mamba2-780m", "train_4k")
    assert rec["status"] == "ok" and devices == {"meta"}


def test_dryrun_main_appends_and_skips_done(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    argv = ["--arch", "hubert-xlarge", "--shape", "decode_32k", "--out",
            str(out)]
    assert dryrun.main(argv) == 0
    assert "done: 0 ok, 1 skipped, 0 failed" in capsys.readouterr().out
    assert dryrun.main(argv) == 0
    assert "[cached] hubert-xlarge x decode_32k x 16x16" in (
        capsys.readouterr().out)
    assert dryrun.main([*argv, "--force", "--multi-pod"]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]


@pytest.mark.parametrize("multi_pod,model_axis,name", [
    (False, None, "16x16"), (True, None, "2x16x16"), (False, 8, "32x8"),
    (True, 4, "2x64x4")])
def test_mesh_names_follow_jax(multi_pod, model_axis, name):
    """The record's mesh as JAX's ``lower_combo`` names it."""
    rec = dryrun.lower_combo("hubert-xlarge", "decode_32k",
                             multi_pod=multi_pod, model_axis=model_axis)
    assert rec["mesh"] == name


# -------------------------------------------------------- the meta route --


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_ops_price_meta_tensors():
    """Each entry on ``meta``: the plain version's shapes and dtypes,
    nothing launched, one charge; on the CPU the plain route, no charge."""
    rng = np.random.default_rng(0)

    def cpu(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dtype)

    q, k = cpu(1, 4, 16, 64), cpu(1, 2, 16, 64)
    qd, kc = cpu(2, 4, 64), cpu(2, 16, 2, 64)
    lens = torch.tensor([16, 9], dtype=torch.int32)
    xh, dt, a = cpu(1, 70, 2, 64), cpu(1, 70, 2).abs(), -cpu(2).abs()
    bm, a2 = cpu(1, 70, 128), cpu(1, 40, 8).sigmoid()
    calls = {
        "flash_attention": lambda on: ops.flash_attention(
            on(q), on(k), on(k), window=8),
        "decode_attention": lambda on: ops.decode_attention(
            on(qd), on(kc), on(kc), on(lens)),
        "ssd_scan": lambda on: ops.ssd_scan(on(xh), on(dt), on(a), on(bm),
                                            on(bm)),
        "rglru_scan": lambda on: ops.rglru_scan(on(a2), on(a2)),
        "rope": lambda on: ops.rope(
            on(q.transpose(1, 2)), on(k.transpose(1, 2)),
            on(torch.arange(16).expand(1, 16)), 1e4),
    }
    mods = (tflash, tdec, tssd, trg, trope)
    before = [m.launches for m in mods]
    for name, call in calls.items():
        with pricing.pricing() as ledger:
            want = call(lambda t: t)
        assert ledger == []
        with pricing.pricing() as ledger:
            got = call(lambda t: t.to("meta"))
        assert [entry[0] for entry in ledger] == [name]
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert (g.device.type, g.shape, g.dtype) == ("meta", w.shape,
                                                         w.dtype)
    assert [m.launches for m in mods] == before


def _kernel_only_step(kernel):
    """(step, arguments): a CPU step that is one kernel call and nothing
    else (its backward, for ``*_backward``)."""
    rng = np.random.default_rng(1)

    def cpu(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32))

    if kernel == "flash_attention":
        args = (cpu(1, 4, 16, 64), cpu(1, 2, 16, 64), cpu(1, 2, 16, 64))
        return lambda: ops.flash_attention(*args), args
    if kernel == "decode_attention":
        args = (cpu(2, 4, 64), cpu(2, 16, 2, 64), cpu(2, 16, 2, 64),
                torch.tensor([16, 9], dtype=torch.int32))
        return lambda: ops.decode_attention(*args), args
    if kernel.startswith("rope"):
        q, k = cpu(2, 16, 4, 64), cpu(2, 16, 2, 64)
        positions = torch.arange(16).expand(2, 16)
        if kernel == "rope":
            return lambda: ops.rope(q, k, positions, 1e4), (q, k)
        q.requires_grad_()
        qr, _ = ops.rope(q, k, positions, 1e4)
        dq = torch.ones_like(qr)
        return (lambda: torch.autograd.grad(qr, q, dq, retain_graph=True),
                (qr, q, dq))
    args = (cpu(1, 70, 2, 64), cpu(1, 70, 2).abs(), -cpu(2).abs(),
            cpu(1, 70, 128), cpu(1, 70, 128))
    if kernel == "ssd_scan":
        return lambda: ops.ssd_scan(*args), args
    xh = args[0].requires_grad_()
    y, _ = ops.ssd_scan(*args)
    dy = torch.ones_like(y)
    return (lambda: torch.autograd.grad(y, xh, dy, retain_graph=True),
            (y, xh, dy))


@pytest.mark.parametrize("kernel", ["flash_attention", "decode_attention",
                                    "ssd_scan", "ssd_scan_backward"])
def test_the_flop_counter_skips_the_plain_versions(kernel):
    """The dry run's FLOP counter (``FlopCounterMode`` with its hook
    ``_count_flops`` overridden) charges nothing for a step that is one
    plain version, whose matmuls torch's own counter does count: the
    override is called."""
    step, arguments = _kernel_only_step(kernel)
    with dryrun.FlopCounterMode(display=False) as plain:
        step()
    assert plain.get_total_flops() > 0
    counted = dryrun.trace(step, arguments)
    assert counted["flops_outside_kernels"] == 0
    assert counted["kernels"] == {}
    if not kernel.endswith("_backward"):
        assert counted["bytes_outside_kernels"] == 0


@pytest.mark.parametrize("kernel", ["rope", "rope_backward"])
def test_the_byte_counter_skips_the_plain_rope(kernel):
    """RoPE's plain version has no matmul for torch's FLOP counter to
    count, but its chain has bytes: the dry run charges nothing for a CPU
    step that is the plain version (the forward's bytes too), and counts
    the same chain called outside ``pricing.plain``."""
    step, arguments = _kernel_only_step(kernel)
    counted = dryrun.trace(step, arguments)
    assert counted["flops_outside_kernels"] == 0
    assert counted["kernels"] == {}
    if kernel == "rope":
        assert counted["bytes_outside_kernels"] == 0
    q = arguments[0] if kernel == "rope" else arguments[1].detach()
    bare = dryrun.trace(lambda: trope.apply_rope(q, torch.arange(16), 1e4),
                        (q,))
    assert bare["bytes_outside_kernels"] > 0


def test_meta_backward_through_the_functions():
    """Under grad a meta tensor goes through ``FlashAttention``,
    ``SSDScan``, ``RGLRUScan`` and ``RoPE``: meta gradients of the inputs'
    shapes, and each backward charged once."""
    q, k = meta(2, 4, 32, 64), meta(2, 2, 32, 64)
    xh, dt, a = meta(2, 64, 2, 64), meta(2, 64, 2, dtype=torch.float32), \
        meta(2, dtype=torch.float32)
    bm, g = meta(2, 64, 128), meta(2, 40, 16, dtype=torch.float32)
    cases = [
        (lambda *t: ops.flash_attention(*t), (q, k, k),
         "flash_attention_backward"),
        (lambda *t: ops.ssd_scan(*t)[0], (xh, dt, a, bm, bm),
         "ssd_scan_backward"),
        (lambda *t: ops.rglru_scan(*t)[0], (g, g), "rglru_scan_backward"),
        (lambda *t: ops.rope(*t, torch.arange(32, device="meta").expand(
            2, 32), 1e4)[0], (q.transpose(1, 2), k.transpose(1, 2)),
         "rope_backward"),
    ]
    for fn, inputs, name in cases:
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        with pricing.pricing() as ledger:
            out = fn(*leaves)
            grads = torch.autograd.grad(out, leaves, torch.ones_like(out))
        assert [e[0] for e in ledger][-1] == name
        assert [e[0] for e in ledger].count(name) == 1
        for gr, t in zip(grads, leaves):
            assert (gr.device.type, gr.shape, gr.dtype) == (
                "meta", t.shape, t.dtype)


def visible_pairs(s, causal, window) -> int:
    pos = torch.arange(s)
    return int(tflash._visible(pos, pos, causal, window).sum())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
def test_flash_cost_is_a_hand_count(causal, window):
    """Live pairs counted from the kernel's mask; bytes of q, k, v and the
    output as tensors."""
    b, h, hkv, s, dh = 2, 4, 2, 13, 64
    q, k = meta(b, h, s, dh), meta(b, hkv, s, dh)
    with pricing.pricing() as ledger:
        o = ops.flash_attention(q, k, k, causal=causal, window=window)
    pairs = visible_pairs(s, causal, window)
    assert pairs == {(True, None): 91, (True, 5): 55, (False, None): 169}[
        (causal, window)]
    assert ledger == [("flash_attention", 4 * dh * pairs * b * h,
                       nbytes(q, k, k, o))]
    assert tflash.bwd_cost(b, h, hkv, s, dh, causal=causal,
                           window=window) == (
        10 * dh * pairs * b * h, nbytes(q, o, k, k, q, k, k))


def test_decode_cost_at_a_wrapped_ring():
    """A ring of 16 slots after 40 tokens: every slot valid in each row;
    4 Dh operations a query head and slot, the keys and values once."""
    b, h, hkv, s, dh = 2, 8, 2, 16, 128
    q, kc = meta(b, h, dh), meta(b, s, hkv, dh)
    lens = torch.full((b,), min(40, s), dtype=torch.int32, device="meta")
    with pricing.pricing() as ledger:
        o = ops.decode_attention(q, kc, kc, lens)
    valid = sum(min(40, s) for _ in range(b))
    assert ledger == [("decode_attention", 4 * dh * h * valid,
                       nbytes(q, kc, kc, o))]
    with pricing.pricing() as ledger:
        ops.decode_attention(q, kc, kc, lens, window=6)
    assert ledger[0][1:] == tdec.cost(b, h, hkv, dh, b * 6)


def ssd_products(b, s, h, p, n, backward: bool) -> int:
    """Chunk by chunk, the (m, k, n) of every product the SSD kernels do,
    counted at 2 m k n."""
    ell, ops_ = 64, 0
    for _ in range(s // ell):
        mm = [(ell, n, ell)]                                  # C B^T
        per_head = ([(ell, ell, p), (ell, n, p), (n, ell, p)]  # M'x, CH, upd
                    if not backward else
                    [(ell, p, ell), (ell, ell, p), (ell, ell, n),
                     (ell, ell, n)] + [(ell, n, p)] * 6)
        mm += per_head * h
        ops_ += b * sum(2 * x * y * z for x, y, z in mm)
    return ops_


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_cost_is_a_hand_count(with_h0):
    b, s, h, p, n = 2, 128, 3, 64, 128
    xh, dt, a = meta(b, s, h, p), meta(b, s, h, dtype=torch.float32), \
        meta(h, dtype=torch.float32)
    bm = meta(b, s, n)
    h0 = meta(b, h, n, p, dtype=torch.float32) if with_h0 else None
    with pricing.pricing() as ledger:
        y, hf = ops.ssd_scan(xh, dt, a, bm, bm, h0)
    ins = (xh, dt, a, bm, bm) + ((h0,) if with_h0 else ())
    assert ledger == [("ssd_scan", ssd_products(b, s, h, p, n, False),
                       nbytes(*ins, y, hf))]
    # the backward: x, dt, a, B, C, dy (fp32), h0 read; dx, ddt, da, dB,
    # dC (in the inputs' dtypes) and dh0 written
    dy = meta(b, s, h, p, dtype=torch.float32)
    want_bytes = nbytes(xh, dt, a, bm, bm, dy, xh, dt, a, bm, bm) + (
        2 * nbytes(h0) if with_h0 else 0)
    assert tssd.bwd_cost(b, s, h, p, n, with_h0=with_h0) == (
        ssd_products(b, s, h, p, n, True), want_bytes)
    # fp32 x / B / C: the CUDA-core recurrence, 4 N P a (position, head)
    assert tssd.cost(b, s, h, p, n, dtype=torch.float32)[0] == \
        4 * b * s * h * n * p


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_cost_is_a_hand_count(with_h0):
    """One multiply-add an element forward, two backward; the tensors'
    bytes."""
    bsz, s, w = 2, 40, 16
    a = meta(bsz, s, w, dtype=torch.float32)
    h0 = meta(bsz, w, dtype=torch.float32) if with_h0 else None
    with pricing.pricing() as ledger:
        h_seq, h_last = ops.rglru_scan(a, a, h0)
    ins = (a, a) + ((h0,) if with_h0 else ())
    assert ledger == [("rglru_scan", 2 * a.numel(),
                       nbytes(*ins, h_seq, h_last))]
    # backward: a, h_seq, g, g_last (+ h0) read; da, db, dh0 written
    want = nbytes(a, h_seq, h_seq, h_last, a, a, h_last) + (
        nbytes(h0) if with_h0 else 0)
    assert trg.bwd_cost(bsz, s, w, with_h0=with_h0) == (4 * a.numel(), want)


def test_rope_cost_is_a_hand_count():
    """Six operations a rotated pair and one an angle; q and k read and
    written once, the positions and the frequency table read once."""
    b, s, h, hkv, dh = 2, 7, 4, 2, 80
    q, k = meta(b, s, h, dh), meta(b, s, hkv, dh)
    pos = torch.arange(s, device="meta").expand(b, s)
    with pricing.pricing() as ledger:
        qo, ko = ops.rope(q, k, pos, 1e4)
    pairs = b * s * (h + hkv) * dh // 2
    assert ledger == [("rope", 6 * pairs + b * s * dh // 2,
                       nbytes(q, k, qo, ko) + 8 * b * s + 4 * dh // 2)]
    assert trope.cost(b, s, h, hkv, dh, itemsize=4)[1] == (
        nbytes(q, k, qo, ko) * 2 + 8 * b * s + 4 * dh // 2)
