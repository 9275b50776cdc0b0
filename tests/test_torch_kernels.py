"""The port's attention kernels on the CPU: plain versions vs. JAX.

``flash_attention_torch`` and ``decode_attention_torch`` (the plain
PyTorch versions of the CUDA kernels) are held against the JAX package's
Pallas kernels in interpret mode and against its pure-jnp oracles, on the
same numpy inputs, at the tolerances of ``tests/test_kernels.py``.
``ops.rope``'s CPU route is two calls of the plain ``apply_rope``, held
against the JAX ``apply_rope``; under grad it is autograd of the plain
version, which the rotation back (the CUDA backward's algorithm) equals.
The
CUDA kernels themselves need the card: ``chip_smoke.py`` holds them against
these plain versions there.  Shapes stay small: interpret mode is slow.
"""
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.models.layers import apply_rope as jax_apply_rope  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.configs import ARCH_IDS, NOT_YET_PORTED, get_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.models.config import ATTN_KINDS  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import rope as trope  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype):
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-5)


def inputs(seed, dtype, *shapes):
    """numpy normals rounded once to ``dtype``, as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    out = []
    for shape in shapes:
        j = jnp.asarray(rng.standard_normal(shape, np.float32), jdt)
        t = torch.from_numpy(np.array(j, np.float32)).to(tdt)
        out.append((j, t))
    return out


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("b,h,hkv,s,dh", [
    (2, 4, 2, 128, 64),     # GQA
    (1, 4, 4, 256, 64),     # MHA, two KV blocks
    (1, 4, 1, 128, 128),    # MQA
    (1, 4, 1, 128, 160),    # stablelm-12b's head dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_and_ref(b, h, hkv, s, dh, dtype, causal):
    (jq, tq), (jk, tk), (jv, tv) = inputs(0, dtype, (b, h, s, dh),
                                          (b, hkv, s, dh), (b, hkv, s, dh))
    got = tflash.flash_attention_torch(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = pallas_flash(jq, jk, jv, causal=causal, interpret=True)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(f32(got), f32(pallas), **tol(dtype))
    np.testing.assert_allclose(f32(got), f32(oracle), **tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_sliding_window(dtype):
    (jq, tq), (jk, tk), (jv, tv) = inputs(1, dtype, (1, 4, 256, 64),
                                          (1, 1, 256, 64), (1, 1, 256, 64))
    got = tflash.flash_attention_torch(tq, tk, tv, causal=True, window=48)
    pallas = pallas_flash(jq, jk, jv, causal=True, window=48, interpret=True)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=True, window=48)
    np.testing.assert_allclose(f32(got), f32(pallas), **tol(dtype))
    np.testing.assert_allclose(f32(got), f32(oracle), **tol(dtype))


@pytest.mark.parametrize("window", [None, 17])
def test_flash_plain_ragged_length(window):
    """Any S: the Pallas kernel needs S to be a multiple of its block; the
    port's kernel does not, so the plain version is held against the
    oracle at S = 100."""
    (jq, tq), (jk, tk), (jv, tv) = inputs(2, "float32", (2, 4, 100, 64),
                                          (2, 2, 100, 64), (2, 2, 100, 64))
    got = tflash.flash_attention_torch(tq, tk, tv, causal=True,
                                       window=window)
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    np.testing.assert_allclose(f32(got), f32(oracle), **tol("float32"))


def test_flash_plain_reads_strided_views():
    """The model hands (B, S, H, Dh) storage as (B, H, S, Dh) views."""
    (_, tq), (_, tk), (_, tv) = inputs(3, "float32", (2, 96, 4, 64),
                                       (2, 96, 2, 64), (2, 96, 2, 64))
    views = [t.transpose(1, 2) for t in (tq, tk, tv)]
    got = tflash.flash_attention_torch(*views, causal=True)
    want = tflash.flash_attention_torch(*[v.contiguous() for v in views],
                                        causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("b,h,hkv,s,dh,window,lens", [
    (3, 8, 2, 256, 64, None, (1, 128, 256)),     # GQA: 1, middle, full
    (2, 4, 4, 256, 128, None, (200, 77)),        # MHA
    (2, 4, 1, 512, 64, 128, (512, 300)),         # MQA with a window
    (3, 4, 2, 256, 64, 64, (1, 63, 65)),         # window edge cases
    (2, 8, 2, 256, 160, None, (256, 100)),       # stablelm-12b: G4 Dh160
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_and_ref(b, h, hkv, s, dh, window, lens,
                                             dtype):
    (jq, tq), (jk, tk), (jv, tv) = inputs(4, dtype, (b, h, dh),
                                          (b, s, hkv, dh), (b, s, hkv, dh))
    lengths = np.asarray(lens, np.int32)
    got = tdecode.decode_attention_torch(tq, tk, tv,
                                         torch.from_numpy(lengths),
                                         window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    jl = jnp.asarray(lengths)
    pallas = pallas_decode(jq, jk, jv, jl, window=window, interpret=True)
    oracle = ref.decode_attention_ref(jq, jk, jv, jl, window=window)
    np.testing.assert_allclose(f32(got), f32(pallas), **tol(dtype))
    np.testing.assert_allclose(f32(got), f32(oracle), **tol(dtype))


def test_ops_dispatches_cpu_tensors_to_plain_versions():
    (_, tq), (_, tk), (_, tv) = inputs(5, "float32", (1, 4, 64, 64),
                                       (1, 2, 64, 64), (1, 2, 64, 64))
    before = (tflash.launches, tdecode.launches)
    got = ops.flash_attention(tq, tk, tv, causal=True, window=9)
    want = tflash.flash_attention_torch(tq, tk, tv, causal=True, window=9)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    cache = tk.transpose(1, 2)
    lengths = torch.tensor([40], dtype=torch.int32)
    got = ops.decode_attention(tq[:, :, 0], cache, cache, lengths)
    want = tdecode.decode_attention_torch(tq[:, :, 0], cache, cache, lengths)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (tflash.launches, tdecode.launches) == before


def test_kernel_wrappers_refuse_what_the_kernels_cannot_take():
    """A CUDA wrapper never runs a plain version: a CPU tensor is refused,
    and so is a device that has no implementation (``meta`` has one: it is
    priced, see ``tests/test_torch_launch.py``)."""
    q = torch.zeros(1, 4, 8, 64)
    k = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tflash.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="CUDA device"):
        tdecode.decode_attention_cuda(q[:, :, 0], k.transpose(1, 2),
                                      k.transpose(1, 2),
                                      torch.ones(1, dtype=torch.int32))
    # a stand-in for a tensor on a device the port has no route for
    other = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="no implementation"):
        ops.flash_attention(other, other, other)
    with pytest.raises(ValueError, match="no implementation"):
        ops.decode_attention(other, other, other,
                             torch.ones(1, dtype=torch.int32))


#: (name, positions (B, S) of B 2 x S 6): a prefill's shared arange, a
#: decode step at a long cache, a VLM's text behind 1024 patches
ROPE_POSITIONS = {
    "prefill": lambda: torch.arange(6).expand(2, 6),
    "decode": lambda: torch.full((2, 6), 3071, dtype=torch.int64),
    "offset": lambda: torch.arange(1024, 1030).expand(2, 6),
}


@pytest.mark.parametrize("where", sorted(ROPE_POSITIONS))
@pytest.mark.parametrize("dh", [64, 80, 128, 160, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_cpu_route_is_the_plain_version(dtype, dh, where):
    """On the CPU ``ops.rope`` is ``apply_rope`` of q and of k, bit for
    bit, with no launch; both match the JAX ``apply_rope`` (GQA: 4 query
    heads, 2 key heads)."""
    (jq, tq), (jk, tk) = inputs(7, dtype, (2, 6, 4, dh), (2, 6, 2, dh))
    positions = ROPE_POSITIONS[where]()
    before = (trope.launches, trope.bwd_launches)
    got_q, got_k = ops.rope(tq, tk, positions, 10_000.0)
    assert (trope.launches, trope.bwd_launches) == before
    for got, x, jx in ((got_q, tq, jq), (got_k, tk, jk)):
        assert got.dtype == x.dtype and got.shape == x.shape
        torch.testing.assert_close(
            got, trope.apply_rope(x, positions, 10_000.0), rtol=0, atol=0)
        want = jax_apply_rope(jx, jnp.asarray(positions.numpy()), 10_000.0)
        np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


@pytest.mark.parametrize("where", sorted(ROPE_POSITIONS))
def test_rope_backward_on_cpu_is_autograd_of_the_plain_version(where):
    """Under grad the CPU's ``ops.rope`` is autograd of ``apply_rope``, not
    the ``RoPE`` Function: output and gradients bit for bit, fp32, on a
    random upstream gradient, with no launch.  The rotation by minus the
    angle (the CUDA backward's algorithm) equals those gradients to fp32
    tolerance."""
    rng = np.random.default_rng(3)
    q, k, gq, gk = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                    for shape in ((2, 6, 4, 80), (2, 6, 2, 80)) * 2)
    positions = ROPE_POSITIONS[where]()
    leaves = [q.clone().requires_grad_(), k.clone().requires_grad_()]
    before = (trope.launches, trope.bwd_launches)
    out = ops.rope(*leaves, positions, 10_000.0)
    assert all("RoPE" not in type(o.grad_fn).__name__ for o in out)
    got = torch.autograd.grad(out, leaves, (gq, gk))
    assert (trope.launches, trope.bwd_launches) == before
    plain = [q.clone().requires_grad_(), k.clone().requires_grad_()]
    ref_out = [trope.apply_rope(x, positions, 10_000.0) for x in plain]
    want = torch.autograd.grad(ref_out, plain, (gq, gk))
    for o, r in zip(out, ref_out):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    back = trope.rope_torch(gq, gk, -positions, 10_000.0)
    for g, w in zip(back, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_rope_wrapper_refuses_what_the_kernel_cannot_take():
    """The CUDA wrapper refuses a CPU tensor, forward and backward; the op
    refuses a device with no route."""
    q, k = torch.zeros(1, 4, 2, 64), torch.zeros(1, 4, 1, 64)
    positions = torch.arange(4).expand(1, 4)
    with pytest.raises(ValueError, match="not a CUDA device"):
        trope.rope_cuda(q, k, positions, 10_000.0)
    with pytest.raises(ValueError, match="not a CUDA device"):
        trope.rope_backward_cuda(q, k, positions, 10_000.0)
    other = types.SimpleNamespace(device=torch.device("xpu"),
                                  requires_grad=False)
    with pytest.raises(ValueError, match="no implementation"):
        ops.rope(other, other, positions, 10_000.0)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Without the CUDA toolkit the kernels' build raises; nothing falls
    back to the plain version."""
    import torch.utils.cpp_extension as cpp_ext
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["flash_attention", "decode_attention"])
    assert not (tmp_path / "build").exists()


def test_decode_split_plan_covers_the_cache():
    for b, hkv, s, g in [(4, 4, 1032, 8), (1, 1, 1, 1), (8, 8, 64, 2),
                         (2, 2, 5000, 16), (4, 8, 1032, 4), (1, 1, 9000, 10)]:
        n_split, chunk = tdecode.split_plan(b, hkv, s, g)
        assert 1 <= n_split <= tdecode.MAX_SPLIT  # one cluster at most
        assert n_split * chunk >= s
        assert (n_split - 1) * chunk < s  # no split starts past the cache


_BWD_SOURCE = (_build.CSRC / "flash_attention_bwd.cu").read_text()
#: the head dims and dtype codes the backward's entry dispatches
BWD_HEAD_DIMS = {int(d) for d in re.findall(
    r"^\s*REPRO_FLASH_BWD_CASE\((\d+)\)", _BWD_SOURCE, re.M)}
BWD_DTYPES = {0, 1} if re.search(
    r"dtype == 0 \? launch_fp32<DD>\(a, s\)[\s\\]*: "
    r"launch_bf16<DD>\(a, s\)", _BWD_SOURCE) else set()

#: ported archs that run on the CPU only, and why
CPU_ONLY = {"arctic-480b": "about 960 GB of bf16 weights, twelve 80 GB "
                           "cards' worth; its GQA group of 7 is no decode "
                           "kernel instantiation"}


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if a not in NOT_YET_PORTED])
def test_attention_kernels_are_built_for_every_ported_arch(arch):
    """The executor serves any ported arch, so each attention arch's head
    dim and group must be ones the CUDA kernels are built for (the JAX
    kernels take any head dim).  An arch without attention layers needs
    neither; ``moe`` layers are attention layers.  An encoder-only arch
    (hubert-xlarge) runs no decode step, so it needs the flash head dim
    alone.  An arch whose weights fit no card but that runs on one at a
    cut depth (internvl2-76b, 24 of its 80 layers) is held to the kernel
    tables like any other; one held to the CPU (``CPU_ONLY``) is not."""
    cfg = get_config(arch)
    kinds = set(cfg.layer_types())
    if not kinds & set(ATTN_KINDS):
        assert cfg.arch_type == "ssm"
        return
    if arch in CPU_ONLY:
        assert 2 * cfg.param_count() > 80e9, CPU_ONLY[arch]
        return
    assert cfg.head_dim in tflash.HEAD_DIMS
    # the backward kernels (training) take every forward head dim, in both
    # of the forward's dtypes, each dispatched by the CUDA entry
    assert cfg.head_dim in BWD_HEAD_DIMS and BWD_DTYPES == set(
        tflash._DTYPES.values())
    if not cfg.has_decoder:
        assert cfg.arch_type == "audio" and not cfg.causal
        return
    assert cfg.n_heads // cfg.n_kv_heads in tdecode.GROUPS[cfg.head_dim]
