"""The port's attention kernels on the CPU: plain versions vs. JAX.

``flash_attention_torch`` and ``decode_attention_torch`` (the plain
PyTorch versions of the CUDA kernels) are held against the JAX package's
Pallas kernels in interpret mode and against its pure-jnp oracles, on the
same numpy inputs, at the tolerances of ``tests/test_kernels.py``.  The
CUDA kernels themselves need the card: ``chip_smoke.py`` holds them against
these plain versions there.  Shapes stay small: interpret mode is slow.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402

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
    and so is a device that has no implementation."""
    q = torch.zeros(1, 4, 8, 64)
    k = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tflash.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="CUDA device"):
        tdecode.decode_attention_cuda(q[:, :, 0], k.transpose(1, 2),
                                      k.transpose(1, 2),
                                      torch.ones(1, dtype=torch.int32))
    meta = torch.zeros(1, 4, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        ops.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="no implementation"):
        ops.decode_attention(meta[:, :, 0], meta, meta,
                             torch.ones(1, dtype=torch.int32))


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
    for b, hkv, s in [(4, 4, 1032), (1, 1, 1), (8, 8, 64), (2, 2, 5000)]:
        n_split, chunk = tdecode.split_plan(b, hkv, s)
        assert n_split >= 1 and n_split * chunk >= s
        assert (n_split - 1) * chunk < s  # no split starts past the cache
