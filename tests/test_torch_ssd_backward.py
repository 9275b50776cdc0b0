"""The SSD scan's backward on the CPU.

``ssd_scan_bwd_chunks`` is the CPU emulation of the backward kernel
``csrc/ssd_scan_bwd.cu``: its equations, chunk by chunk, vectorised over
batch and head.  It is held against autograd of the plain forward
``ssd_scan_torch`` in fp64 (the same function, so to fp64 rounding:
1e-10 on values divided by each gradient's max, floored at 1), and
against ``jax.vjp`` of the JAX package's ``ssd_chunked`` (what the JAX
package trains through) in fp32 at the scan's scale-normalised tolerance
(rtol = atol = 1e-4 on values divided by max |JAX|,
``tests/test_kernels.py:87-90``).  ``SSDScan``, the
``torch.autograd.Function`` that ``ops.ssd_scan`` takes with grad, returns
each gradient in its input's dtype.  Two checks hold the bf16 kernel's
design on the CPU: the backward separates over the columns of P (its
blocks own 32 columns each), and the chunk algebra with every product
computed as its tensor cores do (fp32 operands split into bf16 hi + lo)
stays within the scan's tolerance of fp64, where one bf16 rounding does
not.  Inputs come from ``numpy.random.default_rng``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from test_torch_cuda import plain_ssd_grads  # noqa: E402
from test_torch_ssm import assert_scaled, scan_inputs  # noqa: E402

EXACT = 1e-10  # fp64, the same function: scale-normalised
NAMES = ("dx", "ddt", "da", "dB", "dC", "dh0")


def grad_inputs(seed, b, s, h, p, n, with_h0, with_dh):
    """The scan's inputs and the incoming gradients dy and dh_final."""
    args = scan_inputs(seed, b, s, h, p, n, with_h0=with_h0)
    rng = np.random.default_rng(seed + 1000)
    dy = rng.standard_normal((b, s, h, p), np.float32)
    dh = (rng.standard_normal((b, h, n, p), np.float32) if with_dh
          else None)
    return args, dy, dh


def torch_of(x, dtype=torch.float64):
    return None if x is None else torch.from_numpy(x).to(dtype)


def autograd_of_plain(args, dy, dh):
    """Autograd of ``ssd_scan_torch`` in fp64: dx, ddt, da, dB, dC (dh0)."""
    return plain_ssd_grads([torch_of(x) for x in args], torch_of(dy),
                           torch_of(dh), torch.float64)


@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 150])
def test_bwd_chunks_match_autograd_in_fp64(s, with_h0, with_dh):
    """S of one position, a chunk less one, one chunk, a chunk and one,
    and a ragged third chunk; with and without h0 and a gradient of
    h_final."""
    args, dy, dh = grad_inputs(s, 2, s, 3, 8, 5, with_h0, with_dh)
    got = tssd.ssd_scan_bwd_chunks(*(torch_of(x) for x in args),
                                   torch_of(dy), torch_of(dh))
    want = autograd_of_plain(args, dy, dh)
    assert len(want) == (6 if with_h0 else 5)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        # da is exactly zero at S 1 without h0 (one position, a zero state:
        # no decay is ever applied), so the scale is floored at 1
        scale = max(float(w.abs().max()), 1.0)
        torch.testing.assert_close(g / scale, w / scale, rtol=EXACT,
                                   atol=EXACT, msg=name)


@pytest.mark.parametrize("s,with_h0,with_dh", [
    (150, True, True), (150, False, False), (64, True, False),
    (65, False, True), (1, True, True)])
def test_bwd_chunks_match_jax_vjp(s, with_h0, with_dh):
    """fp32 against ``jax.vjp`` of ``ssd_chunked`` (chunk 64), every
    gradient divided by its max |JAX|: dx, ddt, da, dB, dC and dh0."""
    args, dy, dh = grad_inputs(s + 7, 2, s, 3, 16, 8, with_h0, with_dh)
    jargs = [jnp.asarray(x) for x in args if x is not None]

    def scan(*xs):
        return ssd_chunked(*xs[:5], xs[5] if len(xs) == 6 else None,
                           chunk=64)

    (_, h_final), vjp = jax.vjp(scan, *jargs)
    want = vjp((jnp.asarray(dy), jnp.zeros_like(h_final) if dh is None
                else jnp.asarray(dh)))
    got = tssd.ssd_scan_bwd_chunks(
        *(torch_of(x, torch.float32) for x in args),
        torch_of(dy, torch.float32), torch_of(dh, torch.float32))
    assert len(want) == (6 if with_h0 else 5)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert_scaled(g.numpy(), w)


def test_ssd_op_with_grad_returns_each_gradient_in_its_dtype():
    """bf16 x / B / C (B / C slices of one projection), fp32 dt and a, no
    h0: ``ops.ssd_scan`` with grad goes through ``SSDScan`` on the CPU,
    launches no kernel, and gives bf16 dx, dB, dC and fp32 ddt, da within
    one bf16 rounding of the emulation's fp32 values."""
    args, dy, _ = grad_inputs(11, 2, 70, 3, 16, 8, False, False)
    xh, dt, a, bm, cm, _ = args
    bc = torch.from_numpy(np.concatenate([bm, cm], -1)).bfloat16()
    leaves = [torch.from_numpy(xh).bfloat16(), torch.from_numpy(dt),
              torch.from_numpy(a), bc[..., :8], bc[..., 8:]]
    leaves = [t.requires_grad_(True) for t in leaves]
    before = (tssd.launches, tssd.bwd_launches)
    y, _ = ops.ssd_scan(*leaves)
    assert y.grad_fn is not None and "SSDScan" in type(y.grad_fn).__name__
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    assert (tssd.launches, tssd.bwd_launches) == before
    want = tssd.ssd_scan_bwd_chunks(*(t.detach() for t in leaves), None,
                                    torch.from_numpy(dy), None)
    for name, g, leaf, w in zip(NAMES, grads, leaves, want):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, name
        rtol = 2.0 ** -8 if g.dtype == torch.bfloat16 else 0.0
        torch.testing.assert_close(g.float(), w, rtol=rtol, atol=0.0,
                                   msg=name)


def test_ssd_op_with_grad_of_h_final_alone():
    """A loss on h_final only (no gradient reaches y) with h0 requiring
    grad: the Function takes dy as zero and returns dh0; fp32 against
    autograd of the plain version, scale-normalised (dC, on which h_final
    does not depend, exactly zero)."""
    args, _, dh = grad_inputs(12, 2, 90, 3, 16, 8, True, True)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in args]
    _, h_final = ops.ssd_scan(*leaves)
    got = torch.autograd.grad(h_final, leaves, torch.from_numpy(dh))
    plain = [torch.from_numpy(x).requires_grad_(True) for x in args]
    _, hf_plain = tssd.ssd_scan_torch(*plain)
    want = torch.autograd.grad(hf_plain, plain, torch.from_numpy(dh),
                               allow_unused=True)
    assert want[4] is None and not got[4].any()
    for name, g, w in zip(NAMES, got, want):
        if w is not None:
            assert float(w.abs().max()) > 0, name
            assert_scaled(g.numpy(), w.numpy())


# ------------------------------------------ the bf16 kernel's design on CPU --

SSD_TOL = 1e-4  # tests/test_kernels.py:87-90, on values divided by max |ref|
COLUMN_SPLIT = 1e-12  # fp64, the same sums in another order


@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 150])
def test_bwd_separates_over_the_columns_of_p(s, with_h0, with_dh):
    """The identity the bf16 kernel's column blocks rest on: the backward
    on each 32-column half of P (x, dy, h0 and dh_final sliced; dt, a, B
    and C whole) recombines to the whole call, dx and dh0 by concatenating
    the halves, ddt, da, dB and dC by summing them; fp64, each gradient
    within 1e-12 of its max."""
    args, dy, dh = grad_inputs(s + 50, 2, s, 3, 64, 8, with_h0, with_dh)
    full = [torch_of(x) for x in args]
    whole = tssd.ssd_scan_bwd_chunks(*full, torch_of(dy), torch_of(dh))
    halves = []
    for cols in (slice(0, 32), slice(32, 64)):
        xh, dt, a, bm, cm, h0 = full
        halves.append(tssd.ssd_scan_bwd_chunks(
            xh[..., cols], dt, a, bm, cm,
            None if h0 is None else h0[..., cols],
            torch_of(dy)[..., cols],
            None if dh is None else torch_of(dh)[..., cols]))
    parts = list(zip(*halves))
    joined = [torch.cat(parts[0], -1)] + [p0 + p1 for p0, p1 in parts[1:5]]
    joined.append(torch.cat(parts[5], -1))
    for name, got, want in zip(NAMES, joined, whole):
        scale = max(float(want.abs().max()), 1e-300)
        torch.testing.assert_close(got / scale, want / scale,
                                   rtol=COLUMN_SPLIT, atol=COLUMN_SPLIT,
                                   msg=name)


def bf16_parts(t):
    """An operand as the bf16 kernel feeds the tensor cores: itself if it
    is exactly bf16 (x, B, C as the model hands them), else hi = bf16(t)
    and lo = bf16(t - hi)."""
    t = t.float()
    hi = t.bfloat16().float()
    return [t] if torch.equal(hi, t) else [hi, (t - hi).bfloat16().float()]


def tensor_core_product(eq, u, v):
    """``torch.einsum(eq, u, v)`` as ``mma.sync`` computes it in the bf16
    kernel: each fp32 operand split into hi + lo, the passes hi v (+ lo v)
    where one operand is exact and hi hi + hi lo + lo hi where neither is,
    each a product of bf16 values summed in fp32."""
    out = None
    for i, a_ in enumerate(bf16_parts(u)):
        for j, b_ in enumerate(bf16_parts(v)):
            if i + j < 2:
                r = torch.einsum(eq, a_, b_)
                out = r if out is None else out + r
    return out


def tensor_core_case(with_h0, with_dh, product):
    """(the chunk algebra through ``product``, autograd of the plain
    version in fp64) at mamba2's head shape, bf16 x / B / C, S 1030."""
    args, dy, dh = grad_inputs(77, 1, 1030, 3, 64, 128, with_h0, with_dh)
    xh, dt, a, bm, cm, h0 = args
    bf = [torch.from_numpy(v).bfloat16() for v in (xh, bm, cm)]
    inputs = [bf[0], torch.from_numpy(dt), torch.from_numpy(a), bf[1], bf[2],
              None if h0 is None else torch.from_numpy(h0)]
    got = tssd.ssd_scan_bwd_chunks(*inputs, torch.from_numpy(dy),
                                   torch_of(dh, torch.float32),
                                   product=product)
    want = plain_ssd_grads([None if v is None else v.double()
                            for v in inputs], torch_of(dy), torch_of(dh),
                           torch.float64)
    return got, want


@pytest.mark.parametrize("with_h0,with_dh", [(False, False), (True, True)])
def test_bwd_chunks_with_tensor_core_products_match_fp64(with_h0, with_dh):
    """The chunk algebra with every product computed as the bf16 kernel
    computes it (``tensor_core_product``) at mamba2's head shape (P 64,
    N 128), bf16 x / B / C, S 1030 (16 chunks and a ragged one), three
    heads: each gradient within ``SSD_TOL`` of autograd of the plain
    version in fp64, on values divided by its max."""
    got, want = tensor_core_case(with_h0, with_dh, tensor_core_product)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32, name
        scale = float(w.abs().max())
        torch.testing.assert_close(g.double() / scale, w / scale,
                                   rtol=SSD_TOL, atol=SSD_TOL, msg=name)


def test_bwd_chunks_with_one_bf16_rounding_miss_fp64():
    """Why the kernel splits its fp32 operands: the same algebra with
    each operand rounded once to bf16 misses fp64 by 2e-4 to 4e-3 of a
    gradient's max, far outside ``SSD_TOL``."""
    def rounded(eq, u, v):
        return torch.einsum(eq, u.float().bfloat16().float(),
                            v.float().bfloat16().float())
    got, want = tensor_core_case(True, True, rounded)
    misses = [float((g.double() - w).abs().max() / w.abs().max())
              for g, w in zip(got, want)]
    assert min(misses) > SSD_TOL, misses
