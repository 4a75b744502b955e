"""Port parity of local response normalization on the CPU.

``veles_tpu_torch.ops.lrn``'s plain versions of the K6/K7 kernels
against the JAX package's Pallas kernels (``ops/lrn_pallas.py``, run
with ``interpret=True``), and ``veles_tpu_torch.nn.lrn.lrn_raw`` (the
lax formulation on CPU tensors, one autograd Function) against the
reference's ``lrn_raw`` under ``jax.vjp``, on the same numpy inputs.

Tolerances. At float32 both sides run the same f32 formula and differ
in the order of the window sums only: the forward within
``tests/test_ops.py``'s 1e-5 relative (1e-6 absolute), the backward
within 1e-4 relative / 1e-5 absolute. At bfloat16 (``lrn_raw``) both
sides round the same intermediates to bf16 (the window sum, the scale
``u^-beta``, the products), but a window sum that lands on another f32
value by sum order can round to the neighbouring bf16 value, and the
product ``x * t`` then differs by a bf16 ulp or two: 2^-8 = 3.9e-3
relative each, so the bound is 1e-2 of the output's (or gradient's)
largest magnitude.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from veles_tpu.nn.lrn import lrn_raw as jlrn_raw
from veles_tpu_torch.nn.lrn import lrn_raw
from veles_tpu_torch.ops import lrn

lrn_pallas = importlib.import_module("veles_tpu.ops.lrn_pallas")

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

K, ALPHA, BETA = 2.0, 1e-4, 0.75


def _inputs(seed, shape, scale=2.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, dy


@pytest.mark.parametrize("shape,n", [((3, 5, 7, 96), 5),
                                     ((2, 3, 4, 256), 5),
                                     ((4, 3, 37), 5),
                                     ((3, 5, 7, 96), 4),
                                     ((6, 50), 1),
                                     ((5, 7), 9)])
def test_plain_kernels_match_pallas_interpret(shape, n):
    """K6/K7's plain versions against the Pallas kernels, f32: C = 96
    and 256 (AlexNet's), a C that is no multiple of 32, an even window,
    a window of one and a window wider than the channels."""
    alpha = ALPHA * 50  # a larger alpha makes the window term count
    x, dy = _inputs(n, shape)
    y_ref = np.asarray(lrn_pallas.lrn_fwd(jnp.asarray(x), K, n, alpha, BETA,
                                          interpret=True))
    dx_ref = np.asarray(lrn_pallas.lrn_bwd(
        jnp.asarray(x), jnp.asarray(dy), K, n, alpha, BETA,
        interpret=True))
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    y = lrn.lrn_fwd(xt, K, n, alpha, BETA)
    dx = lrn.lrn_bwd(xt, dyt, K, n, alpha, BETA)
    assert y.dtype == dx.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx.numpy(), dx_ref, rtol=1e-4, atol=1e-5)


def test_plain_kernels_are_the_formula_and_its_gradient():
    """The plain forward's autograd gradient equals the plain analytic
    backward (the K7 formula is the derivative of K6's), within f32
    rounding of the two orders of evaluation."""
    x, dy = _inputs(3, (4, 3, 3, 96))
    alpha = ALPHA * 100
    xt = torch.from_numpy(x).requires_grad_()
    y = lrn._plain_fwd(xt, K, 5, alpha, BETA)
    (g,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    dx = lrn._plain_bwd(xt.detach(), torch.from_numpy(dy), K, 5, alpha,
                        BETA)
    np.testing.assert_allclose(dx.numpy(), g.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("c", [96, 600])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lrn_raw_matches_reference(c, dtype):
    """Forward and gradient of ``lrn_raw`` against the reference's
    custom_vjp: the banded window sum (C = 96) and the reduce-window
    branch (C = 600)."""
    x, dy = _inputs(c, (4, 3, 3, c), scale=3.0)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    y_ref, vjp = jax.vjp(lambda v: jlrn_raw(v, K, 5, ALPHA * 50, BETA),
                         jnp.asarray(x, jd))
    dx_ref = np.asarray(vjp(jnp.asarray(dy, jd))[0].astype(jnp.float32))
    y_ref = np.asarray(y_ref.astype(jnp.float32))
    xt = torch.from_numpy(x).to(td).requires_grad_()
    y = lrn_raw(xt, K, 5, ALPHA * 50, BETA)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(dy).to(td))
    assert y.dtype == dx.dtype == td
    y, dx = y.detach().float().numpy(), dx.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(dx, dx_ref, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(y - y_ref).max() <= 1e-2 * np.abs(y_ref).max()
        assert np.abs(dx - dx_ref).max() <= 1e-2 * np.abs(dx_ref).max()


@pytest.mark.parametrize("impl", [None, "plain"])
def test_lrn_raw_saves_only_x(impl):
    """The autograd Function keeps x and nothing else for the backward
    (the reference's residual), on both CPU paths; the "plain" path is
    the kernels' formula and agrees with the lax one at f32."""
    x, dy = _inputs(5, (2, 3, 3, 96))
    xt = torch.from_numpy(x).requires_grad_()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y = lrn_raw(xt, K, 5, ALPHA, BETA, impl=impl)
    assert len(saved) == 1 and saved[0] is xt
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    y_lax = lrn_raw(xt, K, 5, ALPHA, BETA)
    np.testing.assert_allclose(y.detach().numpy(), y_lax.detach().numpy(),
                               rtol=1e-6, atol=1e-7)
    assert np.isfinite(dx.numpy()).all()


def test_kernel_wrappers_refuse_what_the_kernels_cannot_take():
    x = torch.zeros((2, 3, 8))
    with pytest.raises(ValueError, match="CUDA"):
        lrn.lrn_fwd(x, K, 5, ALPHA, BETA, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        lrn_raw(x, K, 5, ALPHA, BETA, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        lrn.lrn_bwd(x, x, K, 5, ALPHA, BETA, impl="pallas")
    with pytest.raises(ValueError, match="CUDA device"):
        lrn.lrn_fwd_cuda(x, K, 5, ALPHA, BETA)
    # rows are read in place: the channel axis needs unit stride and the
    # leading axes one row stride, or the wrapper raises (no hidden copy)
    assert lrn._rows("lrn_fwd", x).shape == (6, 8)
    with pytest.raises(ValueError, match="unit stride"):
        lrn._rows("lrn_fwd", x.transpose(1, 2))
    with pytest.raises(ValueError, match="row stride"):
        lrn._rows("lrn_fwd", x[:, :2])
    assert lrn._rows("lrn_fwd", x[:1, :2]).shape == (2, 8)


A = 0x7f0000001000  # a base address aligned to 4 KiB


@pytest.mark.parametrize("dtype,c,strides,ptrs,vec", [
    # AlexNet's rows, contiguous and aligned: 16 bytes a lane
    (torch.bfloat16, 96, (96, 96), (A, A + 2 ** 20), 8),
    (torch.bfloat16, 256, (256, 256, 256), (A, A, A), 8),
    (torch.float32, 96, (96, 96), (A, A), 4),
    (torch.float32, 256, (256, 256, 256), (A, A, A), 4),
    # a base one element off: the narrowest instance
    (torch.bfloat16, 96, (96, 96), (A + 2, A), 1),
    (torch.float32, 96, (96, 96), (A, A + 4), 1),
    # a base 4 or 8 bytes off
    (torch.bfloat16, 96, (96, 96), (A + 4, A), 2),
    (torch.bfloat16, 96, (96, 96), (A + 8, A), 4),
    (torch.float32, 96, (96, 96), (A + 8, A), 2),
    # a row stride that is no multiple of 16 bytes
    (torch.bfloat16, 96, (100, 96), (A, A), 4),
    (torch.bfloat16, 96, (97, 96), (A, A), 1),
    (torch.float32, 96, (98, 96), (A, A), 2),
    (torch.float32, 96, (99, 96), (A, A), 1),
    # C that 16 bytes do not divide
    (torch.bfloat16, 37, (37, 37), (A, A), 1),
    (torch.bfloat16, 6, (6, 6), (A, A), 2),
    (torch.bfloat16, 4, (4, 4), (A, A), 4),
    (torch.bfloat16, 264, (264, 264), (A, A), 8),
    (torch.bfloat16, 4104, (4104, 4104), (A, A), 8),
    (torch.float32, 3, (3, 3), (A, A), 1),
    (torch.float32, 6, (6, 6), (A, A), 2),
    (torch.float32, 8, (8, 8), (A, A), 4),
    # a single row's stride, and a stride of 0, constrain nothing
    (torch.float32, 8, (0, 8), (A, A), 4),
])
def test_lrn_plan_picks_the_widest_aligned_lane_vector(dtype, c, strides,
                                                      ptrs, vec):
    """K6/K7's lane vector: 16 bytes where C, every row stride and every
    base address allow it, else the widest of 8, 4 and 2 bytes that
    they allow, down to one element."""
    assert lrn.lrn_plan(dtype, c, strides, ptrs) == vec


@pytest.mark.parametrize("beta", [0.75, 0.5])
def test_power_through_log2_and_exp2_stays_within_the_kernel_budget(beta):
    """The kernels' power: t = exp2(-beta * log2(u)) and t / u =
    exp2((-beta - 1) * log2(u)), all in f32, against the plain
    versions' ``u ** -beta`` and ``t / u`` (f32) and against float64,
    over u from 1 to 1e4: u is at least k (2 in AlexNet's spec and in
    the card tests), and 1e4 covers window sums of x^2 up to 5e8 at
    AlexNet's alpha / n = 2e-5 (up to 2e6 at the card tests' 5e-3 / n,
    n >= 1). Each stays within a few f32 ulps, far inside the f32 LRN
    tolerance (1e-5 of the output's scale)."""
    u = torch.logspace(0, 4, 200001, dtype=torch.float64).float()
    nbeta = torch.tensor(-beta, dtype=torch.float32)
    log2u = torch.log2(u)
    t = torch.exp2(nbeta * log2u)
    tu = torch.exp2((nbeta - 1) * log2u)
    assert t.dtype == tu.dtype == torch.float32
    t_plain = u ** -beta
    tu_plain = t_plain / u
    exact = u.double() ** -beta
    for got, plain, ref in ((t, t_plain, exact), (tu, tu_plain, exact / u)):
        assert float(((got.double() - ref) / ref).abs().max()) <= 2e-6
        assert float(((got - plain) / plain).abs().max()) <= 2e-6
