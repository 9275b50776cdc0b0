"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda``: a CUDA kernel has no CPU mode, so
without an NVIDIA card each test skips.  The file imports torch, numpy and
``repro_torch`` only (no JAX), so that it also runs on a machine with the
card and without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of the JAX package's ``tests/test_kernels.py``:
fp32 kernels 1e-4 / 1e-5, the SSD scan 1e-4 on outputs divided by max
|reference|, the RG-LRU scan 1e-5.  The shapes are the new kernels' and
recurrentgemma's attention head shape (Dh 256, ten query heads on one KV
head), at a small batch and length; ``chip_smoke.py`` checks the serving
shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import rglru_scan as trglru  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402

pytestmark = pytest.mark.cuda

FP32 = dict(rtol=1e-4, atol=1e-5)  # test_kernels.py:19-21
SSD_TOL = 1e-4                     # test_kernels.py:87-90, scale-normalised
SCAN = dict(rtol=1e-5, atol=1e-5)  # test_kernels.py:104


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


def on(device, rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            * scale).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_version(cuda, dtype):
    """mamba2's head shape (P 64, N 128), a ragged S, an initial state,
    and B / C as slices of one projection."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 2, 130, 4, 64, 128
    xh = on(cuda, rng, b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(on(cuda, rng, b, s, h))
    a = -torch.exp(on(cuda, rng, h))
    bc = on(cuda, rng, b, s, 2 * n, scale=0.3).to(dtype)
    h0 = on(cuda, rng, b, h, n, p)
    args = (xh, dt, a, bc[..., :n], bc[..., n:], h0)
    before = tssd.launches
    got = tssd.ssd_scan_cuda(*args)
    want = tssd.ssd_scan_torch(*args)
    torch.cuda.synchronize()
    assert tssd.launches == before + 1
    for g, w in zip(got, want):
        scale = float(w.abs().max()) + 1e-9
        torch.testing.assert_close(g / scale, w / scale, rtol=SSD_TOL,
                                   atol=SSD_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_matches_plain_version(cuda, dtype):
    rng = np.random.default_rng(1)
    a = (torch.sigmoid(on(cuda, rng, 2, 300, 2560)) * 0.2 + 0.8).to(dtype)
    bb = on(cuda, rng, 2, 300, 2560, scale=0.1).to(dtype)
    h0 = on(cuda, rng, 2, 2560)
    got = trglru.rglru_scan_cuda(a, bb, h0)
    want = trglru.rglru_scan_torch(a, bb, h0)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **SCAN)


@pytest.mark.parametrize("window", [2048, 128])
def test_attention_kernels_at_the_hybrid_head_shape(cuda, window):
    rng = np.random.default_rng(2)
    q, k, v = (on(cuda, rng, 2, 300, n, 256).transpose(1, 2)
               for n in (10, 1, 1))
    torch.testing.assert_close(
        tflash.flash_attention_cuda(q, k, v, window=window),
        tflash.flash_attention_torch(q, k, v, window=window), **FP32)
    q = on(cuda, rng, 2, 10, 256)
    kc, vc = on(cuda, rng, 2, 300, 1, 256), on(cuda, rng, 2, 300, 1, 256)
    lengths = torch.tensor([300, 41], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(
        tdecode.decode_attention_cuda(q, kc, vc, lengths, window=window),
        tdecode.decode_attention_torch(q, kc, vc, lengths, window=window),
        **FP32)
