"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a GPU and skips without one; the file
imports no JAX, so the machine with the card runs it alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: at float32 the kernels and the plain path differ only in
the order of f32 sums (1e-5 absolute on unit-scale outputs); at
bfloat16 both round p and the output to bf16 at different points of
their own sums, so outputs agree to a few bf16 ulps (2e-2 absolute)
while the f32 residuals l, m agree to bf16 input rounding of the
scores (1e-3 relative on l, 1e-3 absolute on m). The backward
kernels' gradients are sums of up to T terms of the same products:
at float32 they agree with the plain backward to 1e-4 of the
gradient's scale; at bfloat16 the kernel rounds p and dS to bf16 where
the plain path keeps p in f32, and both round the result, so they
agree to 2e-2 of the scale.
"""

import numpy as np
import pytest
import torch

from veles_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t,causal", [(64, True), (200, True),
                                      (130, False), (1, True)])
def test_flash_fwd_kernel_matches_plain(cuda, dtype, d, t, causal):
    rng = np.random.default_rng(t * d)
    q, k, v = (_randn(rng, (2, t, 3, d), dtype, cuda) for _ in range(3))
    o, l, m = fa.flash_attention_fwd(q, k, v, causal=causal, impl="cuda")
    po, pl, pm = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        block_q=64, block_k=64,
                                        impl="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), po.float(), **TOL[dtype])
    torch.testing.assert_close(l, pl, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(m, pm, atol=1e-3, rtol=1e-3)


def test_flash_fwd_kernel_reads_strided_views(cuda):
    """q/k/v as views into one fused [B,T,3,H,D] projection (the
    transformer's layout) give the same result as contiguous copies."""
    rng = np.random.default_rng(1)
    qkv = _randn(rng, (2, 100, 3, 4, 32), torch.float32, cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o = fa.flash_attention(q, k, v, causal=True, impl="cuda")
    ref = fa.flash_attention(q.contiguous(), k.contiguous(),
                             v.contiguous(), causal=True, impl="cuda")
    torch.testing.assert_close(o, ref, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_decode_kernel_matches_plain(cuda, dtype, d):
    rng = np.random.default_rng(d)
    b, s, h = 6, 300, 3
    k = _randn(rng, (b, s, h, d), dtype, cuda)
    v = _randn(rng, (b, s, h, d), dtype, cuda)
    q = _randn(rng, (b, h, d), dtype, cuda)
    lengths = torch.tensor([0, 1, 17, 256, 299, 300], dtype=torch.int32,
                           device=cuda)
    out = fa.flash_decode(q, k, v, lengths, impl="cuda")
    ref = fa.flash_decode(q, k, v, lengths, impl="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert float(out[0].abs().max()) == 0.0


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel(a, b):
    """Max error over the reference's scale, floored at 1: a gradient
    that is exactly zero (dQ at T = 1) compares in absolute terms."""
    return float((a.float() - b.float()).abs().max() /
                 b.float().abs().max().clamp_min(1.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t,causal", [(64, True), (200, True),
                                      (130, False), (1, True)])
def test_flash_bwd_kernels_match_plain(cuda, dtype, d, t, causal):
    """K2 (dK, dV) and K3 (dQ) against ``_plain_bwd`` on the same
    residuals, ragged T included."""
    rng = np.random.default_rng(t * d + 1)
    q, k, v, do = (_randn(rng, (2, t, 3, d), dtype, cuda)
                   for _ in range(4))
    o, l, m = fa.flash_attention_fwd(q, k, v, causal=causal, impl="cuda")
    di = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float()).contiguous()
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, l, m, di, causal)
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, l, m, di, causal)
    pq, pk, pv = fa._plain_bwd(q, k, v, o, l, m, do, causal, t, t)
    torch.cuda.synchronize()
    for name, a, b in (("dq", dq, pq), ("dk", dk, pk), ("dv", dv, pv)):
        assert a.dtype == dtype
        assert _rel(a, b) <= BWD_TOL[dtype], name


@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_bf16_kernels_read_strided_views(cuda, d):
    """The training layout at bf16 (the tensor-core kernels): q, k, v
    strided views of one fused [B,T,3,H,D] projection and a contiguous
    dO. K1, K2 and K3 give bitwise what they give on contiguous copies,
    and K2/K3 agree with the plain backward on the views."""
    rng = np.random.default_rng(d + 7)
    qkv = _randn(rng, (2, 200, 3, 4, d), torch.bfloat16, cuda)
    do = _randn(rng, (2, 200, 4, d), torch.bfloat16, cuda)
    out = {}
    for layout in ("views", "copies"):
        q, k, v = (qkv[:, :, i] for i in range(3))
        if layout == "copies":
            q, k, v = (x.contiguous() for x in (q, k, v))
        o, l, m = fa.flash_fwd_cuda(q, k, v, True)
        di = torch.einsum("bqhd,bqhd->bhq", do.float(),
                          o.float()).contiguous()
        dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, l, m, di, True)
        dq = fa.flash_bwd_dq_cuda(q, k, v, do, l, m, di, True)
        out[layout] = (o, l, m, dq, dk, dv)
    for a, b in zip(out["views"], out["copies"]):
        assert torch.equal(a, b)
    q, k, v = (qkv[:, :, i] for i in range(3))
    o, l, m = out["views"][:3]
    plain = fa._plain_bwd(q, k, v, o, l, m, do, True, 200, 200)
    for name, a, b in zip(("dq", "dk", "dv"), out["views"][3:], plain):
        assert _rel(a, b) <= BWD_TOL[torch.bfloat16], name


def test_flash_attention_grad_through_kernels(cuda):
    """Autograd through K1/K2/K3 from strided views of one fused QKV
    tensor equals autograd through the plain path."""
    rng = np.random.default_rng(5)
    base = _randn(rng, (2, 150, 3, 2, 64), torch.float32, cuda)
    do = _randn(rng, (2, 150, 2, 64), torch.float32, cuda)
    grads = {}
    for impl in ("cuda", "plain"):
        qkv = base.clone().requires_grad_()
        out = fa.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                 causal=True, impl=impl)
        (out * do).sum().backward()
        grads[impl] = qkv.grad
    assert _rel(grads["cuda"], grads["plain"]) <= 1e-4


def test_kernels_count_launches_and_reject_bad_input(cuda):
    fa.reset_launches()
    x = torch.zeros((1, 8, 1, 32), device=cuda)
    fa.flash_attention(x, x, x, impl="cuda")
    fa.flash_decode(x[:, 0], x, x, torch.ones(1, dtype=torch.int32,
                                              device=cuda))
    counts = {"flash_fwd": 1, "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
              "flash_decode": 1}
    assert fa.LAUNCHES == counts
    xg = x.clone().requires_grad_()
    fa.flash_attention(xg, xg, xg, causal=True).sum().backward()
    counts.update(flash_fwd=2, flash_bwd_dkv=1, flash_bwd_dq=1)
    assert fa.LAUNCHES == counts
    bad = torch.zeros((1, 8, 1, 48), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(bad, bad, bad)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention(x.half(), x.half(), x.half())
    stats = torch.zeros((1, 1, 8), device=cuda)
    with pytest.raises(ValueError, match="l, m, di"):
        fa.flash_bwd_dq_cuda(x, x, x, x, stats, stats, stats[..., :4], True)
    assert fa.LAUNCHES == counts
