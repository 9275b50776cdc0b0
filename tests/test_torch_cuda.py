"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda``: a CUDA kernel has no CPU mode, so
without an NVIDIA card each test skips.  The file imports torch, numpy and
``repro_torch`` only (no JAX), so that it also runs on a machine with the
card and without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of the JAX package's ``tests/test_kernels.py``:
fp32 kernels 1e-4 / 1e-5, bf16 3e-2 / 3e-2 (attention: on outputs divided
by each row's RMS over Dh, as ``chip_smoke.py`` checks them), the SSD scan
1e-4 on outputs divided by max |reference|, the RG-LRU scan 1e-5.  Shapes
are small in batch and length and real in head dim and group (every head
dim and group the attention kernels are built for), and the scans run at
the edges of their chunks (64 positions for SSD, 32 steps for RG-LRU);
``chip_smoke.py`` checks the serving shapes.  The RoPE kernel is held to
its plain version bit for bit: it repeats that version's fp32 arithmetic
rounding for rounding (``csrc/rope.cu``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as tdecode  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import rglru_scan as trglru  # noqa: E402
from repro_torch.kernels import rope as trope  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402

pytestmark = pytest.mark.cuda

FP32 = dict(rtol=1e-4, atol=1e-5)  # test_kernels.py:19-21
SSD_TOL = 1e-4                     # test_kernels.py:87-90, scale-normalised
SCAN = dict(rtol=1e-5, atol=1e-5)  # test_kernels.py:104
BF16 = 3e-2                        # test_kernels.py:19-21


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


def on(device, rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            * scale).to(device)


def ssd_args(device, rng, b, s, h, dtype, with_h0, bc_width=2 * 128,
             bc_offset=0):
    """mamba2's head shape (P 64, N 128), B / C as slices of one
    projection of width ``bc_width`` starting at ``bc_offset``."""
    p, n = 64, 128
    xh = on(device, rng, b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(on(device, rng, b, s, h))
    a = -torch.exp(on(device, rng, h))
    bc = on(device, rng, b, s, bc_width, scale=0.3).to(dtype)
    h0 = on(device, rng, b, h, n, p) if with_h0 else None
    return (xh, dt, a, bc[..., bc_offset:bc_offset + n],
            bc[..., bc_offset + n:bc_offset + 2 * n], h0)


def check_ssd(args):
    """One call is one launch; y and h_final within 1e-4 of max |ref|."""
    before = tssd.launches
    got = tssd.ssd_scan_cuda(*args)
    want = tssd.ssd_scan_torch(*args)
    torch.cuda.synchronize()
    assert tssd.launches == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        scale = float(w.abs().max()) + 1e-9
        torch.testing.assert_close(g / scale, w / scale, rtol=SSD_TOL,
                                   atol=SSD_TOL)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 130])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_version(cuda, dtype, with_h0, s):
    """mamba2's head shape (P 64, N 128), S of one position, one chunk less
    one, one chunk, one chunk and one, and two chunks and two; with and
    without an initial state; B / C as slices of one projection."""
    rng = np.random.default_rng(s)
    check_ssd(ssd_args(cuda, rng, 2, s, 4, dtype, with_h0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_with_unaligned_b_c(cuda, dtype):
    """B / C at an odd offset in a projection of odd width: no 16-byte
    copies, the bf16 kernel stages them element by element."""
    rng = np.random.default_rng(7)
    check_ssd(ssd_args(cuda, rng, 2, 130, 4, dtype, True,
                       bc_width=2 * 128 + 3, bc_offset=3))


def check_rglru(a, bb, h0):
    before = trglru.launches
    got = trglru.rglru_scan_cuda(a, bb, h0)
    want = trglru.rglru_scan_torch(a, bb, h0)
    torch.cuda.synchronize()
    assert trglru.launches == before + 1  # one a call, both passes
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, **SCAN)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 130, 300, 4096])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_matches_plain_version(cuda, dtype, with_h0, s):
    """recurrentgemma's width; S inside one chunk, at its edges, across
    several, and 4096 (chunks of 128); a and b as slices of one tensor."""
    rng = np.random.default_rng(s + 1)
    ab = on(cuda, rng, 2, s, 2, 2560)
    ab[:, :, 0] = torch.sigmoid(ab[:, :, 0]) * 0.2 + 0.8
    ab[:, :, 1] *= 0.1
    ab = ab.to(dtype)
    a, bb = ab[:, :, 0], ab[:, :, 1]
    h0 = on(cuda, rng, 2, 2560) if with_h0 else None
    check_rglru(a, bb, h0)


@pytest.mark.parametrize("a_range", [(0.999, 1.0), (0.0, 0.01)])
def test_rglru_kernel_with_a_near_one_and_near_zero(cuda, a_range):
    """Long memory (the carry is nearly the whole state) and none (the
    carry vanishes): 1000 steps over 16 chunks."""
    rng = np.random.default_rng(5)
    lo, hi = a_range
    a = torch.from_numpy(rng.uniform(lo, hi, (2, 1000, 2560))
                         .astype(np.float32)).to(cuda)
    bb = on(cuda, rng, 2, 1000, 2560, scale=0.1)
    check_rglru(a, bb, on(cuda, rng, 2, 2560))


def test_rglru_kernel_with_odd_width(cuda):
    """W 2561: no 4-lane loads, each thread takes one lane."""
    rng = np.random.default_rng(6)
    a = torch.sigmoid(on(cuda, rng, 2, 300, 2561)) * 0.2 + 0.8
    check_rglru(a, on(cuda, rng, 2, 300, 2561, scale=0.1),
                on(cuda, rng, 2, 2561))


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


def close_rows(got, want, dtype):
    """fp32: rtol 1e-4 / atol 1e-5.  bf16: rtol = atol = 3e-2 on outputs
    divided by their row's RMS over the head dim."""
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **FP32)
        return
    rms = want.float().pow(2).mean(-1, keepdim=True).sqrt() + 1e-9
    torch.testing.assert_close(got.float() / rms, want.float() / rms,
                               rtol=BF16, atol=BF16)


# head dim -> (query heads, KV heads) of an arch that uses it
FLASH_HEADS = {64: (8, 2), 80: (16, 16), 128: (8, 1), 160: (8, 2),
               256: (10, 1)}


@pytest.mark.parametrize("dh", sorted(FLASH_HEADS))
@pytest.mark.parametrize("s", [77, 1000])
@pytest.mark.parametrize("window", [None, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_matches_plain_version(cuda, dh, s, window, dtype):
    """The model's (B, S, H, Dh) storage read as (B, H, S, Dh) views, an S
    that is a multiple of no tile, causal with and without a window."""
    h, hkv = FLASH_HEADS[dh]
    rng = np.random.default_rng(dh + s)
    q, k, v = (on(cuda, rng, 2, s, n, dh).to(dtype).transpose(1, 2)
               for n in (h, hkv, hkv))
    before = tflash.launches
    got = tflash.flash_attention_cuda(q, k, v, causal=True, window=window)
    want = tflash.flash_attention_torch(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert tflash.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    close_rows(got, want, dtype)


@pytest.mark.parametrize("dh", sorted(FLASH_HEADS))
def test_flash_bf16_kernel_without_causal_mask(cuda, dh):
    """Contiguous (B, H, S, Dh) inputs and no mask: only the ragged last
    key tile is masked."""
    h, hkv = FLASH_HEADS[dh]
    rng = np.random.default_rng(dh)
    q = on(cuda, rng, 1, h, 200, dh).bfloat16()
    k, v = (on(cuda, rng, 1, hkv, 200, dh).bfloat16() for _ in range(2))
    close_rows(tflash.flash_attention_cuda(q, k, v, causal=False),
               tflash.flash_attention_torch(q, k, v, causal=False),
               torch.bfloat16)


@pytest.mark.parametrize("s", [77, 1000])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_at_the_encoder_head_shape(cuda, s, dtype):
    """hubert-xlarge's heads (16 query and 16 KV heads of Dh 80), not
    causal, from the model's (B, S, H, Dh) storage: every key tile is
    live and only the ragged last one is masked."""
    rng = np.random.default_rng(s)
    q, k, v = (on(cuda, rng, 2, s, 16, 80).to(dtype).transpose(1, 2)
               for _ in range(3))
    before = tflash.launches
    got = tflash.flash_attention_cuda(q, k, v, causal=False)
    want = tflash.flash_attention_torch(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert tflash.launches == before + 1
    close_rows(got, want, dtype)


def decode_cases():
    for dh, groups in sorted(tdecode.GROUPS.items()):
        for g in groups:
            yield dh, g


@pytest.mark.parametrize("dh,g", list(decode_cases()))
@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_matches_plain_version(cuda, dh, g, window, dtype):
    """Every (head dim, group) the kernel is built for; rows of length 1,
    one that ends inside a split, and a full cache."""
    rng = np.random.default_rng(dh * g)
    b, hkv, s = 3, 2, 1032
    q = on(cuda, rng, b, hkv * g, dh).to(dtype)
    kc, vc = (on(cuda, rng, b, s, hkv, dh).to(dtype) for _ in range(2))
    lengths = torch.tensor([1, 517, s], dtype=torch.int32, device=cuda)
    before = tdecode.launches
    got = tdecode.decode_attention_cuda(q, kc, vc, lengths, window=window)
    want = tdecode.decode_attention_torch(q, kc, vc, lengths, window=window)
    torch.cuda.synchronize()
    assert tdecode.launches == before + 1
    close_rows(got, want, dtype)


@pytest.mark.parametrize("n_split", [1, 3, 8, 16])
def test_decode_kernel_any_split(cuda, n_split):
    """The merge across a cluster of any size up to 16 blocks, at
    recurrentgemma's head shape, the 2048-slot ring full and half full."""
    rng = np.random.default_rng(n_split)
    q = on(cuda, rng, 2, 10, 256).bfloat16()
    kc, vc = (on(cuda, rng, 2, 2048, 1, 256).bfloat16() for _ in range(2))
    lengths = torch.tensor([2048, 1024], dtype=torch.int32, device=cuda)
    close_rows(tdecode.decode_attention_cuda(q, kc, vc, lengths,
                                             window=2048, n_split=n_split),
               tdecode.decode_attention_torch(q, kc, vc, lengths,
                                              window=2048), torch.bfloat16)


def test_one_decode_call_is_one_kernel_launch(cuda):
    """The splits are merged inside the launch: one kernel on the card per
    call (read from the profiler), and no other kernel."""
    rng = np.random.default_rng(3)
    q = on(cuda, rng, 4, 32, 128).bfloat16()
    kc, vc = (on(cuda, rng, 4, 1032, 4, 128).bfloat16() for _ in range(2))
    lengths = torch.full((4,), 1032, dtype=torch.int32, device=cuda)
    tdecode.decode_attention_cuda(q, kc, vc, lengths)  # build, warm up
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tdecode.decode_attention_cuda(q, kc, vc, lengths)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "decode_kernel" in kernels[0], kernels


# ---------------------------------------------------- SM partitions ----
# The kernels on a gpu-let: a green context holding part of the card's SMs
# (repro_torch.launch.partition).  The smallest partition is the paper's
# 20%, 24 SMs of the H100's 132.


@pytest.fixture(scope="module")
def smallest():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    from repro_torch.launch.partition import partition
    return partition(20)


@pytest.mark.parametrize("left", [20, 40, 50, 60, 80])
def test_split_partitions_are_disjoint(cuda, left):
    """One split gives two disjoint SM sets, each of the count the driver
    granted, together the whole card."""
    from repro_torch.launch.partition import sm_ids, split
    a, b = split(left)
    ia, ib = sm_ids(a), sm_ids(b)
    assert not ia & ib
    assert (len(ia), len(ib)) == (a.sms, b.sms)
    total = torch.cuda.get_device_properties(0).multi_processor_count
    assert a.sms + b.sms == total
    # the driver grants the carve's side of the smaller percent in granules
    # of 8; the other side is the rest of the card
    granted = a if left <= 50 else b
    assert granted.sms % 8 == 0
    assert abs(granted.sms - min(left, 100 - left) / 100 * total) <= 8
    # a split is made once and kept: the same pair again; a left side
    # above 50 is the mirror of the carve of its right side
    assert split(left) == (a, b)
    if left != 50:
        assert split(100 - left) == (b, a)


def _kernel_case(name, rng, device):
    """(kernel call, plain call, compare) at a serving head shape."""
    if name == "flash_attention":
        q, k, v = (on(device, rng, 2, 300, n, 128).bfloat16().transpose(1, 2)
                   for n in (32, 4, 4))
        return (lambda: tflash.flash_attention_cuda(q, k, v),
                lambda: tflash.flash_attention_torch(q, k, v),
                lambda g, w: close_rows(g, w, torch.bfloat16))
    if name == "decode_attention":
        q = on(device, rng, 4, 32, 128).bfloat16()
        kc, vc = (on(device, rng, 4, 1032, 4, 128).bfloat16()
                  for _ in range(2))
        lengths = torch.tensor([1032, 517, 1, 1000], dtype=torch.int32,
                               device=device)
        return (lambda: tdecode.decode_attention_cuda(q, kc, vc, lengths),
                lambda: tdecode.decode_attention_torch(q, kc, vc, lengths),
                lambda g, w: close_rows(g, w, torch.bfloat16))
    if name == "ssd_scan":
        args = ssd_args(device, rng, 2, 300, 48, torch.bfloat16, True)

        def cmp(got, want):
            for g, w in zip(got, want):
                scale = float(w.abs().max()) + 1e-9
                torch.testing.assert_close(g / scale, w / scale,
                                           rtol=SSD_TOL, atol=SSD_TOL)
        return (lambda: tssd.ssd_scan_cuda(*args),
                lambda: tssd.ssd_scan_torch(*args), cmp)
    if name == "ssd_scan_backward":
        args = ssd_args(device, rng, 2, 300, 48, torch.bfloat16, True)
        dy = on(device, rng, 2, 300, 48, 64)
        dh = on(device, rng, 2, 48, 128, 64)

        def cmp(got, want):
            for g, w in zip(got, want):
                scale = float(w.abs().max()) + 1e-9
                torch.testing.assert_close(g / scale, w / scale,
                                           rtol=SSD_TOL, atol=SSD_TOL)
        return (lambda: tssd.ssd_scan_bwd_cuda(*args, dy, dh),
                lambda: plain_ssd_grads(args, dy, dh), cmp)
    a = torch.sigmoid(on(device, rng, 2, 4096, 2560)) * 0.2 + 0.8
    bb = on(device, rng, 2, 4096, 2560, scale=0.1)

    def cmp(got, want):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **SCAN)
    if name == "rglru_scan_backward":
        h_seq = trglru.rglru_scan_torch(a, bb)[0]
        g_seq, g_last = on(device, rng, 2, 4096, 2560), on(device, rng, 2,
                                                            2560)

        def plain():
            leaves = [t.clone().requires_grad_(True) for t in (a, bb)]
            return torch.autograd.grad(trglru.rglru_scan_torch(*leaves),
                                       leaves, (g_seq, g_last))
        return (lambda: trglru.rglru_scan_backward_cuda(a, h_seq, None,
                                                        g_seq, g_last)[:2],
                plain, cmp)
    return (lambda: trglru.rglru_scan_cuda(a, bb),
            lambda: trglru.rglru_scan_torch(a, bb), cmp)


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "ssd_scan", "rglru_scan",
                                  "ssd_scan_backward", "rglru_scan_backward"])
def test_kernel_on_smallest_partition_after_whole_card(cuda, smallest, name):
    """Each kernel launched first on the whole card, then on 24 SMs (the
    per-context attributes must be set again there), against its plain
    version.  The RG-LRU cases run 128 chunks, so their look-backs wait on
    blocks that a small partition runs in many waves; the SSD backward's
    384 blocks run there in several waves too."""
    call, plain, cmp = _kernel_case(name, np.random.default_rng(11), cuda)
    whole = call()
    torch.cuda.synchronize()
    with smallest:
        got = call()
        smallest.synchronize()
    want = plain()
    cmp(whole, want)
    cmp(got, want)


@pytest.mark.parametrize("dh,g", list(decode_cases()))
def test_decode_every_group_on_smallest_partition(cuda, smallest, dh, g):
    """The split plan of 24 SMs, with clusters no larger than the
    partition holds."""
    rng = np.random.default_rng(dh + g)
    b, hkv, s = 4, 2, 1032
    with smallest:
        q = on(cuda, rng, b, hkv * g, dh).bfloat16()
        kc, vc = (on(cuda, rng, b, s, hkv, dh).bfloat16() for _ in range(2))
        lengths = torch.tensor([1, 517, s, 1000], dtype=torch.int32,
                               device=cuda)
        limit = tdecode.max_cluster(torch.bfloat16, dh, g)
        n_split, _ = tdecode.split_plan(b, hkv, s, g, sms=smallest.sms,
                                        max_split=limit)
        assert 1 <= n_split <= limit <= tdecode.MAX_SPLIT
        got = tdecode.decode_attention_cuda(q, kc, vc, lengths)
        smallest.synchronize()
        if limit < tdecode.MAX_SPLIT:
            with pytest.raises(ValueError):
                tdecode.decode_attention_cuda(q, kc, vc, lengths,
                                              n_split=limit + 1)
    close_rows(got, tdecode.decode_attention_torch(q, kc, vc, lengths),
               torch.bfloat16)


@pytest.mark.parametrize("arch,layers", [("yi-9b", 2), ("mamba2-780m", 2),
                                         ("recurrentgemma-2b", 3),
                                         ("deepseek-moe-16b", 2)])
def test_captured_decode_step_equals_eager_bitwise(cuda, smallest, arch,
                                                   layers):
    """A decode step at full width (a few layers, bf16) captured as a CUDA
    graph on the partition gives the eager step's logits bit for bit, and
    still does after other allocations and ``empty_cache`` (a recurrent
    layer's state inputs must stay alive while the graph does)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import profile_partitions as pp
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = Model(cfg, dtype=torch.bfloat16, device="cuda")
    model.init(torch.Generator(device="cuda").manual_seed(0))
    with torch.inference_mode():
        cache, tokens = pp.filled_cache(model, 8, seed=1)
        held = [dict(layer) for layer in cache["layers"]]
        with smallest:
            eager, _ = model.decode_step(cache, tokens)
            for layer, h in zip(cache["layers"], held):
                layer.update(h)  # the step's inputs again
            graph, logits = pp.capture(model, cache, tokens, smallest)
            graph.replay()
            smallest.synchronize()
            assert torch.equal(logits, eager)
        junk = [torch.randn(1 << 22, device="cuda") for _ in range(16)]
        del junk
        torch.cuda.empty_cache()
        with smallest:
            graph.replay()
            smallest.synchronize()
        assert torch.equal(logits, eager)
        graph.reset()


def test_scans_in_flight_on_both_sides_of_a_split(cuda):
    """The RG-LRU look-back (a bounded spin that traps) and the SSD scan
    in flight at once on the two sides of the 20/80 split, each on
    either side, against their plain versions."""
    from repro_torch.launch.partition import split
    rng = np.random.default_rng(12)
    a = torch.sigmoid(on(cuda, rng, 2, 4096, 2560)) * 0.2 + 0.8
    bb = on(cuda, rng, 2, 4096, 2560, scale=0.1)
    ssd_in = ssd_args(cuda, rng, 2, 300, 48, torch.bfloat16, True)
    rg_want = trglru.rglru_scan_torch(a, bb)
    ssd_want = tssd.ssd_scan_torch(*ssd_in)
    small, large = split(20)
    for rg_part, ssd_part in ((small, large), (large, small)):
        outs = []
        for _ in range(5):
            with rg_part:
                rg_out = trglru.rglru_scan_cuda(a, bb)
            with ssd_part:
                outs.append((rg_out, tssd.ssd_scan_cuda(*ssd_in)))
        rg_part.synchronize()
        ssd_part.synchronize()
        for rg_out, ssd_out in outs:
            for g, w in zip(rg_out, rg_want):
                torch.testing.assert_close(g, w, **SCAN)
            for g, w in zip(ssd_out, ssd_want):
                scale = float(w.abs().max()) + 1e-9
                torch.testing.assert_close(g / scale, w / scale,
                                           rtol=SSD_TOL, atol=SSD_TOL)


# ------------------------------------------------------------- gradients --


def close_grad_rows(got, want, dtype):
    """Gradients at the attention tolerances: fp32 1e-4 / 1e-5 (against
    the plain version in fp64, ``plain_grads``); bf16 3e-2 / 3e-2 on
    values divided by their row's RMS, floored at 1e-2 of the whole
    tensor's, since a row's exact gradient may vanish (query 0's dq under a
    causal mask: it sees key 0 alone, so dS = P (dP - D) = 0) and leave
    only rounding to divide by."""
    if dtype == torch.float32:
        torch.testing.assert_close(got.double(), want.double(), **FP32)
        return
    w = want.float()
    floor = 1e-2 * float(w.pow(2).mean().sqrt())
    rms = w.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(floor) + 1e-9
    torch.testing.assert_close(got.float() / rms, w / rms, rtol=BF16,
                               atol=BF16)


def plain_grads(q, k, v, do, **mask):
    """dq, dk, dv by autograd of the plain version on the same inputs, in
    fp64 for fp32 inputs (the fp32 plain version itself misses fp64 by
    more than the fp32 tolerance at S 1000)."""
    dtype = torch.float64 if q.dtype == torch.float32 else q.dtype
    leaves = [t.detach().to(dtype).requires_grad_(True) for t in (q, k, v)]
    out = tflash.flash_attention_torch(*leaves, **mask)
    return torch.autograd.grad(out, leaves, do.to(dtype))


@pytest.mark.parametrize("dh", sorted(FLASH_HEADS))
@pytest.mark.parametrize("s", [77, 130])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_matches_autograd_of_plain_version(cuda, dh, s,
                                                          causal, window,
                                                          dtype):
    """Every head dim the backward is built for, each with an arch's
    group, from the model's (B, S, H, Dh) storage; ragged tiles; causal,
    windowed and full masks; one backward entry call per gradient."""
    h, hkv = FLASH_HEADS[dh]
    rng = np.random.default_rng(dh + s + 7)
    q, k, v = (on(cuda, rng, 2, s, n, dh).to(dtype).transpose(1, 2)
               for n in (h, hkv, hkv))
    do = on(cuda, rng, 2, s, h, dh).to(dtype).transpose(1, 2)
    mask = dict(causal=causal, window=window)
    before = tflash.bwd_launches
    got = tflash.flash_attention_bwd_cuda(q, k, v, do, **mask)
    want = plain_grads(q, k, v, do, **mask)
    torch.cuda.synchronize()
    assert tflash.bwd_launches == before + 1
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.shape == x.shape and g.dtype == dtype
        assert g.stride() == x.stride()
        close_grad_rows(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_at_the_hybrid_shape_past_its_window(cuda, dtype):
    """recurrentgemma's heads (10 query heads on one KV head, Dh 256), a
    window of 128 binding over 300 positions."""
    rng = np.random.default_rng(31)
    q, k, v = (on(cuda, rng, 1, 300, n, 256).to(dtype).transpose(1, 2)
               for n in (10, 1, 1))
    do = on(cuda, rng, 1, 300, 10, 256).to(dtype).transpose(1, 2)
    got = tflash.flash_attention_bwd_cuda(q, k, v, do, window=128)
    for g, w in zip(got, plain_grads(q, k, v, do, window=128)):
        close_grad_rows(g, w, dtype)


@pytest.mark.parametrize("dh", sorted(FLASH_HEADS))
@pytest.mark.parametrize("group", [1, 8, 10, 16])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
def test_flash_backward_bf16_at_every_group(cuda, dh, group, causal,
                                            window):
    """The tensor-core backward at every head dim it is built for and the
    groups of the archs (1, 8, 10, 16 query heads a KV head, two KV
    heads), causal, windowed and full, S ragged against its 64-row
    tiles."""
    rng = np.random.default_rng(dh + group)
    q, k, v = (on(cuda, rng, 2, 130, n, dh).bfloat16().transpose(1, 2)
               for n in (2 * group, 2, 2))
    do = on(cuda, rng, 2, 130, 2 * group, dh).bfloat16().transpose(1, 2)
    mask = dict(causal=causal, window=window)
    got = tflash.flash_attention_bwd_cuda(q, k, v, do, **mask)
    want = plain_grads(q, k, v, do, **mask)
    torch.cuda.synchronize()
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.stride() == x.stride()
        close_grad_rows(g, w, torch.bfloat16)


@pytest.mark.parametrize("h,hkv,dh", [(10, 1, 256), (16, 16, 80),
                                      (32, 2, 128)])
def test_flash_backward_bf16_is_deterministic(cuda, h, hkv, dh):
    """Two calls on the same inputs give bitwise-equal dq, dk and dv (the
    group's partials are summed in a fixed order, no atomics)."""
    rng = np.random.default_rng(h + dh)
    q, k, v = (on(cuda, rng, 2, 300, n, dh).bfloat16().transpose(1, 2)
               for n in (h, hkv, hkv))
    do = on(cuda, rng, 2, 300, h, dh).bfloat16().transpose(1, 2)
    first = tflash.flash_attention_bwd_cuda(q, k, v, do)
    second = tflash.flash_attention_bwd_cuda(q, k, v, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_op_with_grad_runs_both_kernels(cuda):
    """``ops.flash_attention`` on inputs that require grad: the forward
    kernel once and the backward entry once, no plain version."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(32)
    q, k, v = (on(cuda, rng, 2, 90, n, 64).transpose(1, 2)
               .requires_grad_(True) for n in (8, 2, 2))
    fwd, bwd = tflash.launches, tflash.bwd_launches
    out = ops.flash_attention(q, k, v)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (tflash.launches, tflash.bwd_launches) == (fwd + 1, bwd + 1)
    for g, w in zip((q.grad, k.grad, v.grad),
                    plain_grads(q, k, v, 2 * out.detach())):
        close_grad_rows(g, w, torch.float32)


def rglru_grads(a, bb, h0, g_seq, g_last):
    """The backward kernel (checked to be one launch of its own entry and
    no forward scan) beside autograd of the plain recurrence: (got,
    want), each (da, db[, dh0])."""
    h_seq, _ = trglru.rglru_scan_cuda(a, bb, h0)
    before, fwd = trglru.bwd_launches, trglru.launches
    got = trglru.rglru_scan_backward_cuda(a, h_seq, h0, g_seq, g_last)
    assert (trglru.bwd_launches, trglru.launches) == (before + 1, fwd)
    # fp32 leaves (bf16 a and b widened exactly): fp32 gradients
    leaves = [t.float().clone().requires_grad_(True) for t in (a, bb)]
    if h0 is not None:
        leaves.append(h0.clone().requires_grad_(True))
    outs = trglru.rglru_scan_torch(*leaves[:2],
                                   leaves[2] if h0 is not None else None)
    want = torch.autograd.grad(outs, leaves, (g_seq, g_last))
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("s", [1, 31, 32, 33, 130, 1000, 4096])
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_backward_matches_autograd_of_plain_version(cuda, s, with_h0):
    """The backward entry (the reverse recurrence read straight from a,
    g and h_seq) against autograd of the plain recurrence, fp32,
    recurrentgemma's width, S around the 32-step chunk and past a
    32-chunk look-back window; one launch and no forward scan a call."""
    rng = np.random.default_rng(s + 40)
    a = torch.sigmoid(on(cuda, rng, 2, s, 2560)) * 0.2 + 0.8
    bb = on(cuda, rng, 2, s, 2560, scale=0.1)
    h0 = on(cuda, rng, 2, 2560) if with_h0 else None
    got, want = rglru_grads(a, bb, h0, on(cuda, rng, 2, s, 2560),
                            on(cuda, rng, 2, 2560))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **SCAN)


@pytest.mark.parametrize("a_range", [(0.999, 1.0), (0.0, 0.01)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_backward_odd_width_a_near_one_and_zero(cuda, a_range, dtype):
    """An odd width (a tile's last lanes idle), a near 1 (the gradient
    carries over the whole sequence and grows to about 100 here) and near
    0 (it vanishes), a in both dtypes, with h0.  Held against the
    recurrence in float64, each gradient divided by its max: at a near 1
    the fp32 plain recurrence itself is about 1e-4 off in absolute terms,
    so an absolute 1e-5 against it would measure its rounding, not the
    kernel's."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.uniform(*a_range, (2, 300, 2561))
                         .astype(np.float32)).to(cuda).to(dtype)
    bb = on(cuda, rng, 2, 300, 2561, scale=0.1).to(dtype)
    h0 = on(cuda, rng, 2, 2561)
    g_seq, g_last = on(cuda, rng, 2, 300, 2561), on(cuda, rng, 2, 2561)
    got, _ = rglru_grads(a, bb, h0, g_seq, g_last)
    leaves = [t.double().requires_grad_(True) for t in (a, bb, h0)]
    h, hs = leaves[2], []
    for t in range(a.shape[1]):
        h = leaves[0][:, t] * h + leaves[1][:, t]
        hs.append(h)
    exact = torch.autograd.grad((torch.stack(hs, 1), h), leaves,
                                (g_seq.double(), g_last.double()))
    for g, w in zip(got, exact):
        scale = float(w.abs().max()) + 1e-30
        torch.testing.assert_close(g.double() / scale, w / scale, **SCAN)


def test_rglru_backward_of_h_last_alone(cuda):
    """A loss on h_last only through ``ops.rglru_scan``: autograd hands
    the Function a zero gradient of h_seq; one forward and one backward
    launch, the gradients within the scan tolerance of the plain
    version's."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(12)
    a = (torch.sigmoid(on(cuda, rng, 2, 100, 2560)) * 0.2 + 0.8)
    bb, h0 = on(cuda, rng, 2, 100, 2560, scale=0.1), on(cuda, rng, 2, 2560)
    leaves = [t.clone().requires_grad_(True) for t in (a, bb, h0)]
    before = (trglru.launches, trglru.bwd_launches)
    _, h_last = ops.rglru_scan(*leaves)
    got = torch.autograd.grad(h_last.square().sum(), leaves)
    assert (trglru.launches, trglru.bwd_launches) == (before[0] + 1,
                                                      before[1] + 1)
    plain = [t.clone().requires_grad_(True) for t in (a, bb, h0)]
    want = torch.autograd.grad(trglru.rglru_scan_torch(*plain)[1].square()
                               .sum(), plain)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **SCAN)


def plain_ssd_grads(args, dy, dh_final, dtype=torch.float32):
    """Autograd of ``ssd_scan_torch`` on ``args`` widened to ``dtype``
    (exact for bf16 inputs): dx, ddt, da, dB, dC (and dh0 with h0).  The
    CPU tests of the backward call it too (in fp64): it needs no card."""
    leaves = [t.detach().to(dtype).requires_grad_(True)
              for t in args if t is not None]
    h0 = leaves[5] if len(leaves) == 6 else None
    y, h_final = tssd.ssd_scan_torch(*leaves[:5], h0)
    outs, grads = [y], [dy.to(dtype)]
    if dh_final is not None:
        outs.append(h_final)
        grads.append(dh_final.to(dtype))
    return torch.autograd.grad(outs, leaves, grads)


def check_ssd_backward(args, dy, dh_final):
    """One call is one backward launch (no forward launch); every gradient
    fp32 and within 1e-4 of its max |ref| of autograd of the plain
    version."""
    before = (tssd.launches, tssd.bwd_launches)
    got = tssd.ssd_scan_bwd_cuda(*args, dy, dh_final)
    want = plain_ssd_grads(args, dy, dh_final)
    torch.cuda.synchronize()
    assert (tssd.launches, tssd.bwd_launches) == (before[0], before[1] + 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        scale = float(w.abs().max()) + 1e-9
        torch.testing.assert_close(g / scale, w / scale, rtol=SSD_TOL,
                                   atol=SSD_TOL)
    return got


@pytest.mark.parametrize("s", [1, 63, 64, 65, 130])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_matches_autograd(cuda, dtype, with_dh, with_h0, s):
    """The SSD backward kernel at mamba2's head shape, S at the chunk
    edges, with and without h0 and a gradient of h_final, B / C as slices
    of one projection."""
    rng = np.random.default_rng(100 + s)
    args = ssd_args(cuda, rng, 2, s, 3, dtype, with_h0)
    dy = on(cuda, rng, 2, s, 3, 64)
    dh_final = on(cuda, rng, 2, 3, 128, 64) if with_dh else None
    check_ssd_backward(args, dy, dh_final)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_with_unaligned_b_c_is_deterministic(cuda, dtype):
    """B / C at an odd offset in a projection of odd width; a second call
    on the same inputs gives bitwise-equal gradients (the heads' partials
    are summed in order, no atomics)."""
    rng = np.random.default_rng(8)
    args = ssd_args(cuda, rng, 2, 200, 5, dtype, True,
                    bc_width=2 * 128 + 3, bc_offset=3)
    dy = on(cuda, rng, 2, 200, 5, 64)
    dh_final = on(cuda, rng, 2, 5, 128, 64)
    got = check_ssd_backward(args, dy, dh_final)
    again = tssd.ssd_scan_bwd_cuda(*args, dy, dh_final)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_ssd_backward_at_the_training_shape_is_deterministic(cuda):
    """mamba2-780m's training shape (bf16 x / B / C, B4 S1024 H48 P64
    N128, no h0): the tensor-core kernel against autograd of the plain
    version, and a second call bitwise equal (the column blocks' and
    heads' partials are summed in order, no atomics)."""
    rng = np.random.default_rng(1024)
    args = ssd_args(cuda, rng, 4, 1024, 48, torch.bfloat16, False)
    dy = on(cuda, rng, 4, 1024, 48, 64)
    got = check_ssd_backward(args, dy, None)
    again = tssd.ssd_scan_bwd_cuda(*args, dy, None)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_op_with_grad_runs_both_kernels(cuda, dtype):
    """``ops.ssd_scan`` with grad on the card: one forward launch, one
    backward launch, and each gradient in its input's dtype."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(43)
    xh, dt, a, bmat, cmat, _ = ssd_args(cuda, rng, 1, 100, 2, dtype, False)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (xh, dt, a, bmat, cmat)]
    before = (tssd.launches, tssd.bwd_launches)
    y, h_final = ops.ssd_scan(*leaves)
    assert (tssd.launches, tssd.bwd_launches) == (before[0] + 1, before[1])
    dy = on(cuda, rng, 1, 100, 2, 64)
    grads = torch.autograd.grad(y, leaves, dy)
    assert (tssd.launches, tssd.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    want = plain_ssd_grads((xh, dt, a, bmat, cmat, None), dy, None)
    for g, leaf, w in zip(grads, leaves, want):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape
        scale = float(w.abs().max()) + 1e-9
        tol = SSD_TOL if g.dtype == torch.float32 else 2.0 ** -8
        torch.testing.assert_close(g.float() / scale, w / scale, rtol=tol,
                                   atol=tol)


def test_ssm_train_step_on_the_card_matches_the_cpu(cuda):
    """mamba2's smoke config at the kernels' head shape (P 64, N 128) in
    fp32: the loss and every gradient of one step on the card against the
    same weights on the CPU, over 90 tokens (a ragged chunk), and the
    step's exact kernel launches (each block's forward runs twice under
    remat)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_smoke_config("mamba2-780m"),
                              ssm_d_state=128, ssm_headdim=64)
    card = Model(cfg, dtype=torch.float32, device=cuda)
    card.init(torch.Generator(device=cuda).manual_seed(0))
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    toks = np.random.default_rng(44).integers(0, cfg.vocab_size, (2, 90))
    counts = (tssd.launches, tssd.bwd_launches)
    losses = []
    for model in (card, cpu):
        model.requires_grad_(True)
        loss = model.loss_fn({"tokens": torch.from_numpy(toks).to(
            model.device)})
        loss.backward()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    # 2 SSM layers: forwards twice, backwards once
    assert (tssd.launches - counts[0], tssd.bwd_launches - counts[1]) == \
        (4, 2)
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
    for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
        err = float((p.grad.cpu() - q.grad).abs().max())
        assert err <= 1e-3 * float(q.grad.abs().max()), name


def test_hybrid_train_step_on_the_card_matches_the_cpu(cuda):
    """recurrentgemma's smoke config in fp32: the loss and every gradient
    of one step on the card against the same weights on the CPU, and the
    step's exact kernel launches (each block's forward runs twice under
    remat)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import Model
    cfg = get_smoke_config("recurrentgemma-2b")
    card = Model(cfg, dtype=torch.float32, device=cuda)
    card.init(torch.Generator(device=cuda).manual_seed(0))
    cpu = Model(cfg, dtype=torch.float32, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in card.state_dict().items()})
    toks = np.random.default_rng(42).integers(0, cfg.vocab_size, (2, 90))
    counts = (tflash.launches, tflash.bwd_launches, trglru.launches,
              trglru.bwd_launches)
    losses = []
    for model in (card, cpu):
        model.requires_grad_(True)
        loss = model.loss_fn({"tokens": torch.from_numpy(toks).to(
            model.device)})
        loss.backward()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    rose = tuple(n - b for n, b in zip(
        (tflash.launches, tflash.bwd_launches, trglru.launches,
         trglru.bwd_launches), counts))
    # 1 attention and 2 RG-LRU layers: forwards twice, backwards once
    assert rose == (2, 1, 4, 2)
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
    for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
        err = float((p.grad.cpu() - q.grad).abs().max())
        assert err <= 1e-3 * float(q.grad.abs().max()), name


# ------------------------------------------------------------------ rope --

#: head dim -> (query heads, key heads): GQA at every head dim the port
#: serves (hubert-xlarge's 80 with as many key heads as query heads)
ROPE_HEADS = {64: (8, 2), 80: (16, 16), 128: (32, 4), 160: (32, 8),
              256: (10, 1)}


def rope_positions(device, where, b, s):
    """A prefill's arange shared by the rows (batch stride 0), a decode
    step at a cache in the thousands, or a VLM's text behind its 1024
    patches."""
    if where == "prefill":
        return torch.arange(s, device=device).expand(b, s)
    if where == "decode":
        return torch.full((b, s), 3071, dtype=torch.int64, device=device)
    return torch.arange(1024, 1024 + s, device=device).expand(b, s)


def check_rope(q, k, positions, theta=10_000.0):
    """One call is one launch, and equals two plain calls bit for bit."""
    before = trope.launches
    got = trope.rope_cuda(q, k, positions, theta)
    torch.cuda.synchronize()
    assert trope.launches == before + 1
    for g, x in zip(got, (q, k)):
        want = trope.apply_rope(x, positions, theta)
        assert g.shape == x.shape and g.dtype == x.dtype
        assert g.is_contiguous()
        torch.testing.assert_close(g, want, rtol=0, atol=0)


@pytest.mark.parametrize("where,s", [("prefill", 77), ("prefill", 1000),
                                     ("decode", 1), ("offset", 300)])
@pytest.mark.parametrize("dh", sorted(ROPE_HEADS))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_kernel_equals_plain_version(cuda, dtype, dh, where, s):
    rng = np.random.default_rng(40)
    h, hkv = ROPE_HEADS[dh]
    b = 4 if where == "decode" else 2
    q = on(cuda, rng, b, s, h, dh).to(dtype)
    k = on(cuda, rng, b, s, hkv, dh).to(dtype)
    check_rope(q, k, rope_positions(cuda, where, b, s))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_kernel_reads_strided_and_unaligned_views(cuda, dtype):
    """q and k as head slices of one tensor, positions of their own a row
    (theta 1e6); then views one element off 16-byte alignment (one pair a
    thread)."""
    rng = np.random.default_rng(41)
    qk = on(cuda, rng, 3, 130, 12, 128).to(dtype)
    positions = torch.from_numpy(rng.integers(0, 40_000, (3, 130))).to(cuda)
    check_rope(qk[:, :, :8], qk[:, :, 8:], positions, theta=1e6)
    wide = on(cuda, rng, 3, 130, 12, 129).to(dtype)
    check_rope(wide[:, :, :8, 1:], wide[:, :, 8:, 1:], positions)


def test_rope_op_is_one_launch_for_q_and_k(cuda):
    """``ops.rope`` without grad: one forward launch, no backward."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(42)
    q = on(cuda, rng, 2, 50, 16, 80).bfloat16()
    k = on(cuda, rng, 2, 50, 16, 80).bfloat16()
    positions = rope_positions(cuda, "prefill", 2, 50)
    fwd, bwd = trope.launches, trope.bwd_launches
    for n in range(1, 4):
        ops.rope(q, k, positions, 10_000.0)
        assert (trope.launches, trope.bwd_launches) == (fwd + n, bwd)


@pytest.mark.parametrize("where", ["prefill", "offset"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_backward_matches_autograd_of_plain_version(cuda, dtype, where):
    """``ops.rope`` with grad goes through ``RoPE``: one forward and one
    backward launch; the gradients (the rotation back) equal autograd of
    the plain version bit for bit (the same products and sums, the sine
    negated: exact)."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(43)
    h, hkv = ROPE_HEADS[256]
    q0 = on(cuda, rng, 2, 200, h, 256).to(dtype)
    k0 = on(cuda, rng, 2, 200, hkv, 256).to(dtype)
    gq = on(cuda, rng, 2, 200, h, 256).to(dtype)
    gk = on(cuda, rng, 2, 200, hkv, 256).to(dtype)
    positions = rope_positions(cuda, where, 2, 200)
    leaves = [q0.clone().requires_grad_(), k0.clone().requires_grad_()]
    fwd, bwd = trope.launches, trope.bwd_launches
    out = ops.rope(*leaves, positions, 10_000.0)
    got = torch.autograd.grad(out, leaves, (gq, gk))
    torch.cuda.synchronize()
    assert (trope.launches, trope.bwd_launches) == (fwd + 1, bwd + 1)
    plain = [q0.clone().requires_grad_(), k0.clone().requires_grad_()]
    want = torch.autograd.grad(
        [trope.apply_rope(x, positions, 10_000.0) for x in plain], plain,
        (gq, gk))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---------------------------------------------------- granite-4.0-h-small ---


def test_grouped_expert_products_equal_a_product_an_expert(cuda):
    """``moe.grouped_mm`` on the card (one ``torch._grouped_mm`` launch)
    against a product an expert, bf16, bit for bit: uneven groups and an
    expert with no row."""
    from repro_torch.models import moe
    rng = np.random.default_rng(0)
    e, d, f = 9, 256, 128
    ids = np.sort(rng.choice([0, 1, 1, 1, 2, 4, 5, 6, 7, 8], size=300))
    ends = torch.tensor(np.searchsorted(ids, np.arange(e), side="right"),
                        dtype=torch.int32, device=cuda)
    x = on(cuda, rng, 300, d).bfloat16()
    w = (on(cuda, rng, e, d, f) * d ** -0.5).bfloat16()
    got = moe.grouped_mm(x, w, ends)
    start = 0
    for i, end in enumerate(ends.tolist()):
        assert torch.equal(got[start:end], x[start:end] @ w[i])
        start = end


def test_grouped_expert_products_refuse_fp32_on_the_card(cuda):
    """On the card only bf16 has a grouped product; fp32 raises rather than
    take a product an expert, which reads the offsets on the host."""
    from repro_torch.models import moe
    x = torch.ones(4, 8, device=cuda)
    ends = torch.tensor([4], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        moe.grouped_mm(x, torch.ones(1, 8, 8, device=cuda), ends)


def test_dropless_moe_on_the_card_equals_the_cpu(cuda):
    """granite's smoke MoE layer, dropless, bf16: the card's grouped products
    against the CPU's product an expert, within bf16 rounding."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_smoke_config("granite-4.0-h-small"),
                              n_experts=8, top_k=2)
    layer = moe.MoE(cfg, device="cpu", dtype=torch.bfloat16)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 33, cfg.d_model).bfloat16()
    want, _ = moe.moe_apply(layer, x, cfg, False)
    got, _ = moe.moe_apply(layer.to(cuda), x.to(cuda), cfg, False)
    scale = float(want.float().abs().max())
    assert float((got.cpu().float() - want.float()).abs().max()) <= \
        BF16 * scale


@pytest.mark.parametrize("scale", [None, 1 / 128])
def test_attention_kernels_take_a_stated_scale(cuda, scale):
    """Flash and decode at granite's head shape (32 / 8 heads of 128) at
    1/sqrt(Dh) and at a stated 1/Dh, against their plain versions."""
    rng = np.random.default_rng(1)
    q = on(cuda, rng, 2, 32, 77, 128).bfloat16()
    k = on(cuda, rng, 2, 8, 77, 128).bfloat16()
    v = on(cuda, rng, 2, 8, 77, 128).bfloat16()
    got = tflash.flash_attention_cuda(q, k, v, causal=True, scale=scale)
    want = tflash.flash_attention_torch(q, k, v, causal=True, scale=scale)
    rms = want.float().square().mean(-1, keepdim=True).sqrt()
    assert float(((got.float() - want.float()) / rms).abs().max()) < BF16
    kc, vc = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    lens = torch.tensor([77, 40], dtype=torch.int32, device=cuda)
    got = tdecode.decode_attention_cuda(q[:, :, -1], kc, vc, lens,
                                        scale=scale)
    want = tdecode.decode_attention_torch(q[:, :, -1], kc, vc, lens,
                                          scale=scale)
    rms = want.float().square().mean(-1, keepdim=True).sqrt()
    assert float(((got.float() - want.float()) / rms).abs().max()) < BF16
