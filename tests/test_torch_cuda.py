"""The port's CUDA kernels against their plain PyTorch versions, on the
card (and the paged engine and sampler that run beside K5). Every test here needs a GPU and skips without one; the file
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

import os

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


#: sequence lengths at the edges of the bf16 kernels' tiles: K1 takes
#: 128 query rows (two warpgroups of 64) and 128-key tiles, K3 128 query
#: rows and 64-key tiles, K2 128 keys (two warpgroups of 64) and 64-row
#: query tiles; 1 leaves one row of one tile
EDGE_T = [1, 63, 64, 127, 128, 129, 1000]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", EDGE_T)
def test_tma_forward_tiling_edges(cuda, t, d, causal):
    """K1's bf16 kernel (TMA ring, wgmma) against the plain forward at
    the edges of its tiles, at every head dim; a second launch on the
    same inputs agrees bitwise."""
    rng = np.random.default_rng(1000 * d + 2 * t + causal)
    q, k, v = (_randn(rng, (2, t, 3, d), torch.bfloat16, cuda)
               for _ in range(3))
    o, l, m = fa.flash_fwd_cuda(q, k, v, causal)
    again = fa.flash_fwd_cuda(q, k, v, causal)
    po, pl, pm = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        block_q=64, block_k=64,
                                        impl="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), po.float(), **TOL[torch.bfloat16])
    torch.testing.assert_close(l, pl, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(m, pm, atol=1e-3, rtol=1e-3)
    for a, b in zip((o, l, m), again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", EDGE_T)
def test_tma_dq_tiling_edges_and_dkv_on_its_residuals(cuda, t, d, causal):
    """K3's and K2's bf16 kernels (TMA ring, wgmma) at the edges of their
    tiles, fed by K1's l and m, against ``_plain_bwd`` on the same
    residuals; a second launch of each agrees bitwise."""
    rng = np.random.default_rng(1000 * d + 2 * t + causal + 7)
    q, k, v, do = (_randn(rng, (2, t, 3, d), torch.bfloat16, cuda)
                   for _ in range(4))
    o, l, m = fa.flash_fwd_cuda(q, k, v, causal)
    di = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float()).contiguous()
    dq = fa.flash_bwd_dq_cuda(q, k, v, do, l, m, di, causal)
    again = fa.flash_bwd_dq_cuda(q, k, v, do, l, m, di, causal)
    dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, l, m, di, causal)
    dk2, dv2 = fa.flash_bwd_dkv_cuda(q, k, v, do, l, m, di, causal)
    pq, pk, pv = fa._plain_bwd(q, k, v, o, l, m, do, causal, t, t)
    torch.cuda.synchronize()
    assert torch.equal(dq, again)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    for name, a, b in (("dq", dq, pq), ("dk", dk, pk), ("dv", dv, pv)):
        assert a.dtype == torch.bfloat16
        assert _rel(a, b) <= BWD_TOL[torch.bfloat16], name


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [129, 1000])
def test_tma_kernels_read_strided_views_bitwise(cuda, t, d):
    """q, k, v as strided views of one fused [B, T, 3, H, D] projection
    and dO as a view of a wider buffer go through TMA in place: K1, K2
    and K3 give bitwise what they give on contiguous copies."""
    rng = np.random.default_rng(t + d)
    qkv = _randn(rng, (2, t, 3, 4, d), torch.bfloat16, cuda)
    wide = _randn(rng, (2, t, 2, 4, d), torch.bfloat16, cuda)
    views = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], wide[:, :, 1])
    out = {}
    for layout, (q, k, v, do) in (
            ("views", views),
            ("copies", tuple(x.contiguous() for x in views))):
        o, l, m = fa.flash_fwd_cuda(q, k, v, True)
        di = torch.einsum("bqhd,bqhd->bhq", do.float(),
                          o.float()).contiguous()
        out[layout] = (o, l, m, fa.flash_bwd_dq_cuda(q, k, v, do, l, m, di,
                                                     True),
                       *fa.flash_bwd_dkv_cuda(q, k, v, do, l, m, di, True))
    for a, b in zip(out["views"], out["copies"]):
        assert torch.equal(a, b)


def test_tma_kernels_copy_misaligned_operands(cuda):
    """An operand whose base is 2 bytes off a 16-byte boundary cannot be
    read by TMA in place: the wrapper copies it, and K1, K2 and K3 give
    bitwise what they give on an aligned tensor of the same values."""
    rng = np.random.default_rng(11)
    shape = (2, 150, 2, 64)
    q, k, v, do = (_randn(rng, shape, torch.bfloat16, cuda)
                   for _ in range(4))
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    q_off = flat[1:].view(shape)
    q_off.copy_(q)
    assert q_off.data_ptr() % 16 == 2
    res = []
    for qq in (q, q_off):
        o, l, m = fa.flash_fwd_cuda(qq, k, v, True)
        di = torch.einsum("bqhd,bqhd->bhq", do.float(),
                          o.float()).contiguous()
        res.append((o, l, m, fa.flash_bwd_dq_cuda(qq, k, v, do, l, m, di,
                                                  True),
                    *fa.flash_bwd_dkv_cuda(qq, k, v, do, l, m, di, True)))
    for a, b in zip(*res):
        assert torch.equal(a, b)


def test_tma_kernels_refuse_a_foreign_tile(cuda, monkeypatch):
    """A tensor-map layout whose box is not the kernel's own tile is
    refused by the kernel: the wrapper raises, counts no launch and
    falls back to nothing."""
    rng = np.random.default_rng(12)
    q, k, v, do = (_randn(rng, (1, 100, 2, 64), torch.bfloat16, cuda)
                   for _ in range(4))
    o, l, m = fa.flash_fwd_cuda(q, k, v, True)
    di = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float()).contiguous()
    before = dict(fa.LAUNCHES)
    monkeypatch.setitem(fa.TMA_TILES, "flash_fwd", (64, 64))
    monkeypatch.setitem(fa.TMA_TILES, "flash_bwd_dq", (128, 128))
    monkeypatch.setitem(fa.TMA_TILES, "flash_bwd_dkv", (128, 64))
    with pytest.raises(RuntimeError, match="flash_fwd kernel launch"):
        fa.flash_fwd_cuda(q, k, v, True)
    with pytest.raises(RuntimeError, match="flash_bwd_dq kernel launch"):
        fa.flash_bwd_dq_cuda(q, k, v, do, l, m, di, True)
    with pytest.raises(RuntimeError, match="flash_bwd_dkv kernel launch"):
        fa.flash_bwd_dkv_cuda(q, k, v, do, l, m, di, True)
    assert fa.LAUNCHES == before


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
              "flash_decode": 1, "flash_decode_paged": 0}
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
    pages = torch.zeros((3, 8, 1, 32), device=cuda)
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    fa.flash_decode_paged(x[:, 0], pages, pages, table, [5])
    counts.update(flash_decode_paged=1)
    assert fa.LAUNCHES == counts
    with pytest.raises(ValueError, match="power-of-two"):
        fa.flash_decode_paged(x[:, 0], pages[:, :6], pages[:, :6], table,
                              [5])
    with pytest.raises(ValueError, match="int32 block_tables"):
        fa.flash_decode_paged_cuda(x[:, 0], pages, pages, table.long(),
                                   table[:, 0])
    assert fa.LAUNCHES == counts


def _paged_case(rng, dtype, d, device, ps=16, n_pages=40):
    """A pool, a scrambled table with sentinels past each sequence's
    last block, and lengths 0, 1, a full page, n_blk * ps (the whole
    table), a ragged one, one reaching into a sentinel block (the id
    clamps to the last page), and one sequence whose only page is the
    pool's last."""
    b, h, n_blk = 7, 3, 6
    pages = [_randn(rng, (n_pages, ps, h, d), dtype, device)
             for _ in range(2)]
    ids = rng.permutation(n_pages - 1)
    table = np.full((b, n_blk), n_pages, np.int32)
    lengths = [0, 1, ps, n_blk * ps, 3 * ps + 5, 2 * ps + 3, ps - 2]
    used = [1, 1, 1, n_blk, 4, 2, 0]   # row 5 reads into a sentinel
    k = 0
    for i, n in enumerate(used):
        table[i, :n] = ids[k:k + n]
        k += n
    table[6, 0] = n_pages - 1
    q = _randn(rng, (b, h, d), dtype, device)
    return (q, pages[0], pages[1],
            torch.from_numpy(table).to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_decode_paged_kernel_matches_plain(cuda, dtype, d):
    """K5 against the plain paged path: scrambled table, sentinel ids,
    lengths of 0 and of n_blk * ps, the pool's last page; two launches
    agree bitwise."""
    rng = np.random.default_rng(d + 3)
    q, kp, vp, table, lengths = _paged_case(rng, dtype, d, cuda)
    out = fa.flash_decode_paged(q, kp, vp, table, lengths, impl="cuda")
    again = fa.flash_decode_paged(q, kp, vp, table, lengths, impl="cuda")
    ref = fa.flash_decode_paged(q, kp, vp, table, lengths, impl="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert torch.equal(out, again)
    assert float(out[0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_paged_kernel_equals_slab_kernel(cuda, dtype):
    """K5 over pages that hold K4's slab in order runs K4's loop on the
    same rows: the outputs agree bitwise."""
    rng = np.random.default_rng(4)
    b, s, h, d, ps = 5, 256, 4, 128, 16
    k = _randn(rng, (b, s, h, d), dtype, cuda)
    v = _randn(rng, (b, s, h, d), dtype, cuda)
    q = _randn(rng, (b, h, d), dtype, cuda)
    lengths = torch.tensor([0, 1, 100, 256, 17], dtype=torch.int32,
                           device=cuda)
    n_blk = s // ps
    table = torch.arange(b * n_blk, dtype=torch.int32,
                         device=cuda).reshape(b, n_blk)
    slab = fa.flash_decode(q, k, v, lengths, impl="cuda")
    paged = fa.flash_decode_paged(q, k.reshape(b * n_blk, ps, h, d),
                                  v.reshape(b * n_blk, ps, h, d), table,
                                  lengths, impl="cuda")
    torch.cuda.synchronize()
    assert torch.equal(slab, paged)


#: K4/K5 split the key axis into chunks of C keys: lengths of 0, on and
#: around a chunk edge, over several chunks, and the full capacity
#: (None), over a ragged capacity (neither chunks nor stages divide it)
C = fa.DECODE_CHUNK
SPLIT_LENGTHS = [0, C - 1, C, C + 1, 3 * C + 5, None]
SPLIT_S = 4 * C + 37


def _split_case(rng, dtype, d, device, ps, extra_blocks=13):
    """q, a slab [B, SPLIT_S, 3, d] at SPLIT_LENGTHS, and the same K/V as
    a pool of ps-row pages in a scrambled order, each sequence's table
    followed by at least a chunk's worth of sentinels, so the pool's
    capacity n_blk * ps is not the slab's S and has more chunks."""
    b, h = len(SPLIT_LENGTHS), 3
    s = SPLIT_S
    k, v = (_randn(rng, (b, s, h, d), dtype, device) for _ in range(2))
    q = _randn(rng, (b, h, d), dtype, device)
    lengths = torch.tensor([s if n is None else n for n in SPLIT_LENGTHS],
                           dtype=torch.int32, device=device)
    used = -(-s // ps)
    n_blk = used + max(extra_blocks, -(-C // ps))
    pools = []
    perm = torch.from_numpy(rng.permutation(b * used)).to(device)
    for x in (k, v):
        rows = torch.zeros((b, used * ps, h, d), dtype=dtype, device=device)
        rows[:, :s] = x
        pool = torch.empty((b * used, ps, h, d), dtype=dtype, device=device)
        pool[perm] = rows.reshape(b * used, ps, h, d)
        pools.append(pool)
    table = torch.full((b, n_blk), b * used, dtype=torch.int32,
                       device=device)
    table[:, :used] = perm.reshape(b, used).to(torch.int32)
    assert fa.decode_chunks(n_blk * ps) > fa.decode_chunks(s)
    return q, k, v, lengths, pools[0], pools[1], table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_decode_split_edges_match_plain(cuda, dtype, d):
    """K4 and K5 at lengths C - 1, C, C + 1, several chunks and the full
    capacity, against the plain paths; a second launch of each is
    bitwise equal to the first; K5 equals K4 bitwise although its
    capacity (and chunk count) is larger."""
    rng = np.random.default_rng(d + 17)
    q, k, v, lengths, kp, vp, table = _split_case(rng, dtype, d, cuda, 16)
    slab = fa.flash_decode_cuda(q, k, v, lengths)
    slab2 = fa.flash_decode_cuda(q, k, v, lengths)
    paged = fa.flash_decode_paged_cuda(q, kp, vp, table, lengths)
    paged2 = fa.flash_decode_paged_cuda(q, kp, vp, table, lengths)
    ref = fa.flash_decode(q, k, v, lengths, impl="plain")
    ref_paged = fa.flash_decode_paged(q, kp, vp, table, lengths,
                                      impl="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(slab.float(), ref.float(), **TOL[dtype])
    torch.testing.assert_close(paged.float(), ref_paged.float(),
                               **TOL[dtype])
    assert torch.equal(slab, slab2) and torch.equal(paged, paged2)
    assert torch.equal(slab, paged)
    assert float(slab[0].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,d,ps", [
    (torch.bfloat16, 128, 16), (torch.float32, 128, 16),
    (torch.bfloat16, 32, 1), (torch.bfloat16, 64, 2),
    (torch.float32, 64, 256), (torch.bfloat16, 128, 512)])
def test_flash_decode_paged_equals_slab_across_page_sizes(cuda, dtype, d,
                                                          ps):
    """K5 over pages of one 64-byte row, pages smaller than a stage, and
    pages larger than a chunk equals K4 on the same K/V bitwise."""
    rng = np.random.default_rng(ps + d)
    q, k, v, lengths, kp, vp, table = _split_case(rng, dtype, d, cuda, ps,
                                                  extra_blocks=3)
    slab = fa.flash_decode_cuda(q, k, v, lengths)
    paged = fa.flash_decode_paged_cuda(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    assert torch.equal(slab, paged)


def test_flash_decode_kernels_replay_in_a_cuda_graph(cuda):
    """K4 and K5 captured in one CUDA graph: the lengths and the block
    table are data, rewritten in place between replays, and a replay
    equals eager calls on the new values bitwise."""
    rng = np.random.default_rng(5)
    q, k, v, lengths, kp, vp, table = _split_case(
        rng, torch.bfloat16, 128, cuda, 16)
    fa.flash_decode_cuda(q, k, v, lengths)                  # warm-up
    fa.flash_decode_paged_cuda(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        slab = fa.flash_decode_cuda(q, k, v, lengths)
        paged = fa.flash_decode_paged_cuda(q, kp, vp, table, lengths)
    for step in range(2):
        new_lengths = torch.tensor([5 + step, 2 * C, C + 7, SPLIT_S - step,
                                    1, 0], dtype=torch.int32, device=cuda)
        lengths.copy_(new_lengths)
        table.copy_(table.roll(1 + step, dims=0))
        graph.replay()
        want_slab = fa.flash_decode_cuda(q, k, v, lengths)
        want_paged = fa.flash_decode_paged_cuda(q, kp, vp, table, lengths)
        torch.cuda.synchronize()
        assert torch.equal(slab, want_slab)
        assert torch.equal(paged, want_paged)
        assert float(slab[5].abs().max()) == 0.0


def test_flash_decode_kernels_take_empty_batches_and_unaligned_caches(
        cuda):
    """An empty batch returns [0, H, D] and leaves the next call on the
    same pool right; a slab whose rows are not 16 bytes apart (D = 32
    in a 36-wide buffer) is copied and gives what the aligned slab
    gives."""
    rng = np.random.default_rng(8)
    d = 32
    q, k, v, lengths, kp, vp, table = _split_case(rng, torch.bfloat16, d,
                                                  cuda, 16)
    empty = fa.flash_decode_cuda(q[:0], k[:0], v[:0], lengths[:0])
    empty_paged = fa.flash_decode_paged_cuda(q[:0], kp, vp, table[:0],
                                             lengths[:0])
    assert empty.shape == (0, 3, d) and empty_paged.shape == (0, 3, d)
    wide = torch.zeros(k.shape[:3] + (36,), dtype=k.dtype, device=cuda)
    wide[..., :d] = k
    want = fa.flash_decode_cuda(q, k, v, lengths)
    unaligned = fa.flash_decode_cuda(q, wide[..., :d], v, lengths)
    paged = fa.flash_decode_paged_cuda(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    assert torch.equal(unaligned, want) and torch.equal(paged, want)


def test_sampler_draws_equal_on_cpu_and_card(cuda):
    """The same f32 logits and knobs give the same tokens on the CPU and
    on the card: the random stream is integer arithmetic and the noise
    is added in f64."""
    from veles_tpu_torch.serve.engine import _sample_tokens

    rng = np.random.default_rng(6)
    n, v = 64, 8192
    logits = torch.from_numpy(
        (rng.standard_normal((n, v)) * 3).astype(np.float32))
    knobs = (torch.from_numpy(rng.uniform(0.0, 1.5, n).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 60, n).astype(np.int32)),
             torch.from_numpy(rng.uniform(0.3, 1.0, n).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 2 ** 32, n)),
             torch.arange(n, dtype=torch.int64))
    cpu = _sample_tokens(logits, *knobs)
    card = _sample_tokens(logits.to(cuda), *(x.to(cuda) for x in knobs))
    assert torch.equal(cpu, card.cpu())


def test_paged_engine_through_the_kernel_equals_plain(cuda):
    """Greedy decoding through K5 on the card equals the plain paged
    path token for token (f32, a small model with K5's head dims)."""
    from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)
    from veles_tpu_torch.serve import PagedGenerativeEngine

    small = dict(vocab=97, embed=128, heads=2, layers=2, seq_len=256)
    params = init_params(TransformerConfig(**small), seed=1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 97, n).astype(np.int32)
               for n in (3, 40, 130)]
    outs = {}
    for impl in ("cuda", "plain"):
        engine = PagedGenerativeEngine(
            TransformerConfig(attention_impl=impl, **small), params,
            max_slots=4, device=cuda)
        # captures the rounds: a capture's warm-up rounds launch too
        engine.warm()
        fa.reset_launches()
        outs[impl] = [g.tolist() for g in engine.generate(prompts, 24)]
        launches = fa.LAUNCHES["flash_decode_paged"]
        assert launches == (2 * 23 if impl == "cuda" else 0)
    assert outs["cuda"] == outs["plain"]


# ---------------------------------------------------------------------------
# the classifier slice: LRN (K6, K7), the uniform fill (K8), the trainer
# ---------------------------------------------------------------------------

#: K6/K7 vs their plain versions, as a share of the output's largest
#: magnitude: the window sums are bitwise the plain versions' (x^2
#: rounded alike, f32 terms added from the window's low end with
#: round-to-nearest), and the power (base-2 log and exp on the
#: special-function unit, against pow and a division) differs by a few
#: f32 ulps: a few f32 ulps of the result, or where that moves a bf16
#: rounding (of the result or of K7's inner), one bf16 ulp (2^-8).
LRN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n", [((3, 5, 7, 96), 5),
                                     ((2, 3, 11, 256), 5),
                                     ((1000, 37), 5),
                                     ((33, 96), 4),
                                     ((7, 600), 9),
                                     ((5, 3), 1),
                                     ((37, 8), 5),
                                     ((45, 16), 3),
                                     ((19, 24), 7),
                                     ((41, 96), 9),
                                     ((13, 256), 11),
                                     ((7, 264), 2),
                                     ((3, 4104), 5),
                                     ((5, 3, 96), 6),
                                     ((29, 96), 13)])
def test_lrn_kernels_match_plain(cuda, dtype, shape, n):
    """K6 and K7 against the plain versions: AlexNet's channel counts,
    row counts that leave a warp's last chunk part full, C from 3 to
    4104 (a row of 1 to 513 lanes), windows of 1 to 11 (halos reaching
    up to five lanes away at one element a lane) and 13 (the wide
    kernels); a second launch is bitwise equal."""
    from veles_tpu_torch.ops import lrn
    rng = np.random.default_rng(n * len(shape))
    x = _randn(rng, shape, dtype, cuda) * 3
    dy = _randn(rng, shape, dtype, cuda)
    k, alpha, beta = 2.0, 5e-3, 0.75
    lrn.reset_launches()
    y = lrn.lrn_fwd(x, k, n, alpha, beta, impl="cuda")
    dx = lrn.lrn_bwd(x, dy, k, n, alpha, beta, impl="cuda")
    assert lrn.LAUNCHES == {"lrn_fwd": 1, "lrn_bwd": 1}
    again = (lrn.lrn_fwd(x, k, n, alpha, beta, impl="cuda"),
             lrn.lrn_bwd(x, dy, k, n, alpha, beta, impl="cuda"))
    py = lrn.lrn_fwd(x, k, n, alpha, beta, impl="plain")
    pdx = lrn.lrn_bwd(x, dy, k, n, alpha, beta, impl="plain")
    torch.cuda.synchronize()
    assert y.dtype == dx.dtype == dtype
    assert _rel(y, py) <= LRN_TOL[dtype]
    assert _rel(dx, pdx) <= LRN_TOL[dtype]
    assert torch.equal(again[0], y) and torch.equal(again[1], dx)


def _lrn_both(lrn, x, dy, n=5):
    return (lrn.lrn_fwd(x, 2.0, n, 5e-3, 0.75, impl="cuda"),
            lrn.lrn_bwd(x, dy, 2.0, n, 5e-3, 0.75, impl="cuda"))


def test_lrn_kernels_read_rows_in_place(cuda):
    """A row-strided view (every other row of a bigger tensor) gives the
    same result as its contiguous copy; a tensor whose rows cannot be
    viewed with one stride is refused, not copied."""
    from veles_tpu_torch.ops import lrn
    rng = np.random.default_rng(3)
    base = _randn(rng, (40, 96), torch.float32, cuda)
    view = base[::2]
    y = lrn.lrn_fwd(view, 2.0, 5, 1e-3, 0.75, impl="cuda")
    ref = lrn.lrn_fwd(view.contiguous(), 2.0, 5, 1e-3, 0.75, impl="cuda")
    assert torch.equal(y, ref)
    dx = lrn.lrn_bwd(view, view, 2.0, 5, 1e-3, 0.75, impl="cuda")
    assert torch.equal(dx, lrn.lrn_bwd(view.contiguous(), view.contiguous(),
                                       2.0, 5, 1e-3, 0.75, impl="cuda"))
    with pytest.raises(ValueError, match="row stride"):
        lrn.lrn_fwd(base.reshape(4, 10, 96)[:, :5], 2.0, 5, 1e-3, 0.75,
                    impl="cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lrn.lrn_fwd(base.half(), 2.0, 5, 1e-3, 0.75, impl="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,n", [(96, 5), (256, 5), (264, 9), (8, 11)])
def test_lrn_kernels_take_unaligned_bases_and_strides_bitwise(cuda, dtype,
                                                              c, n):
    """A base one element off 16 bytes, and rows whose stride is no
    multiple of 16 bytes, take a narrower instance of the same kernels
    (``lrn_plan``), read in place, and give bitwise what the aligned
    contiguous tensors give."""
    from veles_tpu_torch.ops import lrn
    rng = np.random.default_rng(c + n)
    m = 77
    x = _randn(rng, (m, c), dtype, cuda) * 3
    dy = _randn(rng, (m, c), dtype, cuda)
    want = _lrn_both(lrn, x, dy, n)
    size = x.element_size()
    for offset, stride in ((1, c), (0, c + 3), (1, c + 1)):
        bufs = [torch.zeros(m * stride + 1, dtype=dtype, device=cuda)
                for _ in range(2)]
        xv, dyv = (b[offset:offset + m * stride].view(m, stride)[:, :c]
                   for b in bufs)
        xv.copy_(x)
        dyv.copy_(dy)
        vec = lrn.lrn_plan(dtype, c, (stride,), (xv.data_ptr(),))
        assert vec * size < 16
        got = _lrn_both(lrn, xv, dyv, n)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_lrn_kernels_replay_in_a_cuda_graph(cuda):
    """K6 and K7 captured in one CUDA graph (bf16 LRN2 rows and an f32
    ragged shape): replays after the inputs are rewritten in place equal
    eager launches on the new values bitwise."""
    from veles_tpu_torch.ops import lrn
    rng = np.random.default_rng(11)
    cases = [(_randn(rng, (6, 9, 256), torch.bfloat16, cuda) * 3,
              _randn(rng, (6, 9, 256), torch.bfloat16, cuda)),
             (_randn(rng, (101, 37), torch.float32, cuda) * 3,
              _randn(rng, (101, 37), torch.float32, cuda))]
    for x, dy in cases:
        _lrn_both(lrn, x, dy)                       # warm-up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [_lrn_both(lrn, x, dy) for x, dy in cases]
    for step in range(2):
        for x, dy in cases:
            x.copy_(x.roll(1 + step, dims=0))
            dy.mul_(-0.5)
        graph.replay()
        want = [_lrn_both(lrn, x, dy) for x, dy in cases]
        torch.cuda.synchronize()
        for (y, dx), (wy, wdx) in zip(outs, want):
            assert torch.equal(y, wy) and torch.equal(dx, wdx)


@pytest.mark.parametrize("shape", [(1,), (7, 3), (1536, 4096),
                                   (4 * 33 * 256 + 3,)])
@pytest.mark.parametrize("low,high", [(0.0, 1.0), (-2.0, 3.0)])
def test_uniform_fill_kernel_equals_plain_bitwise(cuda, shape, low, high):
    from veles_tpu_torch.ops import rng
    for seed in (0, 12345, 2 ** 63 + 5):
        rng.reset_launches()
        out = rng.uniform_fill(seed, shape, low=low, high=high,
                               device=cuda)
        assert rng.LAUNCHES["uniform_fill"] == 1
        ref = rng.uniform_fill(seed, shape, low=low, high=high,
                               device=cuda, impl="plain")
        assert torch.equal(out, ref)
        assert torch.equal(out.cpu(), rng.uniform_fill(
            seed, shape, low=low, high=high, device="cpu"))


def test_classifier_step_kernels_match_plain(cuda):
    """One FusedClassifierTrainer step of a small conv net (conv, LRN,
    pools, FC, dropout 0.5) at f32 through the kernels and through
    their plain versions from one seed: the dropout masks are equal
    bitwise, LRN's window sums are bitwise the plain versions' and its
    power differs by a few f32 ulps (base-2 log and exp on the
    special-function unit), so the losses and the
    updated params agree to 1e-5 of their scale; the launches are two
    of K6, two of K7 and one of K8 per step."""
    from veles_tpu_torch.models.flagship import fused_from_layer_dicts
    from veles_tpu_torch.ops import lrn, rng
    from veles_tpu_torch.parallel.fused import FusedClassifierTrainer

    torch.backends.cudnn.allow_tf32 = False
    layers = [
        {"type": "conv_relu", "n_kernels": 16, "kx": 5, "sliding": (2, 2),
         "padding": 2},
        {"type": "lrn"},
        {"type": "max_pooling", "kx": 3, "sliding": (2, 2)},
        {"type": "conv_relu", "n_kernels": 96, "kx": 3, "padding": 1},
        {"type": "lrn"},
        {"type": "max_pooling", "kx": 3, "sliding": (2, 2)},
        {"type": "all2all_relu", "output_sample_shape": 64},
        {"type": "dropout", "dropout_ratio": 0.5},
        {"type": "softmax", "output_sample_shape": 10}]
    specs, params, _ = fused_from_layer_dicts(layers, (32, 32, 3))
    data = np.random.default_rng(0)
    x = data.random((8, 32, 32, 3), dtype=np.float32)
    y = data.integers(0, 10, 8)
    runs = {}
    for impl in ("cuda", "plain"):
        t = FusedClassifierTrainer(specs, params, learning_rate=0.01,
                                   momentum=0.9, weight_decay=5e-4,
                                   compute_dtype="float32",
                                   kernel_impl=impl, device=cuda)
        lrn.reset_launches()
        rng.reset_launches()
        loss = float(t.step(x, y)["loss"])
        launches = dict(lrn.LAUNCHES, **rng.LAUNCHES)
        runs[impl] = (loss, t.params_numpy(), launches)
    (lk, pk, nk), (lp, pp, np_) = runs["cuda"], runs["plain"]
    assert nk == {"lrn_fwd": 2, "lrn_bwd": 2, "uniform_fill": 1}
    assert set(np_.values()) == {0}
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for a, b in zip(pk, pp):
        for key in a:
            assert np.abs(a[key] - b[key]).max() <= \
                1e-5 * max(np.abs(b[key]).max(), 1e-30)


# ---------------------------------------------------------------------------
# captured CUDA graphs: the decode rounds, the train step, the forward
# buckets, and K1-K3 replayed
# ---------------------------------------------------------------------------
#
# Captured against eager, bitwise: a replay runs the kernels (and the
# cuBLAS products) the eager step launches, on the same shapes and
# inputs, in the same order, so every rounding is the same.

GRAPH_LM = dict(vocab=256, embed=128, heads=2, layers=2, seq_len=256)


def _graph_lm(**kw):
    from veles_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(compute="bfloat16", **dict(GRAPH_LM, **kw))


def _lm_prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, GRAPH_LM["vocab"], n).astype(np.int32)
            for n in lens]


def test_slab_decode_graph_equals_eager_across_admits_and_a_swap(cuda):
    """32 slab decode steps, captured and eager, with slots joining and
    retiring and a swap_params between replays: the same tokens and
    flags at every step; the steps after the swap run the new weights
    (they differ from a captured engine that kept the old ones)."""
    from veles_tpu_torch.models.transformer import init_params
    from veles_tpu_torch.serve import GenerativeEngine

    cfg = _graph_lm()
    params, params_b = init_params(cfg, seed=1), init_params(cfg, seed=2)
    prompts = _lm_prompts(3, (7, 40, 100, 3))
    runs = []
    for graphs, swap in ((True, True), (False, True), (True, False)):
        engine = GenerativeEngine(cfg, params, max_slots=4, device=cuda,
                                  cuda_graphs=graphs)
        out = []
        slots, first = engine.admit(prompts[:2])
        out.append(first.tolist())
        for step in range(32):
            if step == 6:
                out.append(engine.admit(prompts[2:])[1].tolist())
            if step == 12:
                engine.release(slots[0])
            if step == 20 and swap:
                engine.swap_params(params_b)
            out.append((engine.decode().tolist(),
                        engine.last_finite.tolist()))
        assert (engine._graph is not None) == graphs
        runs.append(out)
    assert runs[0] == runs[1]
    # out[22] is the first step after the swap (out[7] the admission)
    assert runs[0][:22] == runs[2][:22] and runs[0][22:] != runs[2][22:]


@pytest.mark.parametrize("mode", ["greedy", "sampled", "spec"])
def test_paged_rounds_graph_equal_eager_with_cow_and_preemption(cuda, mode):
    """Paged rounds (greedy, two sampled slots, speculative self-draft),
    captured and eager, over a 16-page pool that must preempt and
    prompts whose tails ride a donor's page (copy-on-write between
    replays): the same tokens, the same COW and preemption counts."""
    from veles_tpu_torch.models.transformer import init_params
    from veles_tpu_torch.serve import PagedGenerativeEngine

    cfg = _graph_lm()
    params = init_params(cfg, seed=4)
    donor = _lm_prompts(5, (64,))[0]
    prompts = [donor, donor[:40], donor[:50], _lm_prompts(6, (30,))[0]]
    sampling = [None] * 4
    if mode == "sampled":
        sampling[1] = dict(temperature=0.8, top_k=40, top_p=0.9, seed=3)
        sampling[3] = dict(temperature=1.1, seed=4)
    kw = {}
    if mode == "spec":
        kw = dict(draft_params=params, draft_config=cfg, draft_tokens=3)
        sampling = [{"draft": True}] * 4
    runs = []
    for graphs in (True, False):
        engine = PagedGenerativeEngine(cfg, params, max_slots=4,
                                       page_size=16, n_pages=16,
                                       device=cuda, cuda_graphs=graphs, **kw)
        toks = [g.tolist() for g in engine.generate(prompts, 48,
                                                    sampling=sampling)]
        runs.append((toks, engine.pool.cow_total, engine.preempted_total,
                     len(engine._graphs)))
        assert engine.pool.free_pages == 16
    (tg, cg, pg, ng), (te, ce, pe, ne) = runs
    assert tg == te and cg == ce >= 1 and pg == pe >= 1
    assert ng >= 1 and ne == 0


@pytest.mark.parametrize("moe", [0, 2])
def test_train_step_graph_equals_eager(cuda, moe):
    """3 LM train steps and one step_many of 4, captured and eager
    (remat="attn", chunked cross-entropy; and the MoE stack): the same
    losses and parameters, bitwise; one capture, no host sync inside."""
    from veles_tpu_torch.models.transformer import (TransformerTrainer,
                                                    _tree_leaves)

    cfg = _graph_lm(moe_experts=moe, ce_chunk=64)
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, 256, (5, 2, 257))).to(cuda)
    runs = []
    for graphs in (True, False):
        trainer = TransformerTrainer(cfg, device=cuda, seed=3,
                                     learning_rate=1e-3, cuda_graphs=graphs)
        losses = [trainer.step(tokens[i])["loss"] for i in range(3)]
        trainer.learning_rate = 5e-4
        many = trainer.step_many(tokens[1:])
        losses = torch.cat([torch.stack(losses), many["loss"]])
        runs.append((losses, [p.detach().clone()
                              for p in _tree_leaves(trainer.params)],
                     float(trainer._step), len(trainer._graphs)))
    (lg, pg, sg, ng), (le, pe, se, ne) = runs
    assert torch.equal(lg, le) and sg == se == 7.0
    assert all(torch.equal(a, b) for a, b in zip(pg, pe))
    assert ng == 1 and ne == 0
    assert bool(torch.isfinite(lg).all()) and float(lg[-1]) < float(lg[0])


def test_capture_outlasts_a_dead_cycle_holding_a_graph(cuda):
    """A graph that only a dead reference cycle holds (an engine dropped
    with its threads) is not destroyed in the middle of another
    capture by an automatic collection (which would invalidate that
    capture): the collector waits until the capture ends."""
    import gc
    import weakref

    from veles_tpu_torch.graphs import StepGraph

    x = torch.randn(256, 256, device=cuda)

    class Holder:
        pass

    old = Holder()
    old.graph = StepGraph(lambda a: a @ a, inputs=(x,))
    old.cycle = old
    alive, keep = weakref.ref(old), [old]
    del old
    calls = []

    def step(a):
        calls.append(len(calls))
        if len(calls) == StepGraph.WARMUP + 1:      # the capture
            keep.pop()                    # now only its own cycle holds it
            # far more container allocations than a collection's
            # threshold: a collection would run here
            junk = [[i] for i in range(20 * gc.get_threshold()[0])]
            del junk
        return a * 2 + 1

    threshold = gc.get_threshold()
    gc.set_threshold(10)
    try:
        graph = StepGraph(step, inputs=(x,))
    finally:
        gc.set_threshold(*threshold)
    assert alive() is not None
    x.copy_(torch.randn(256, 256, device=cuda))
    out = graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, x * 2 + 1)
    gc.collect()
    assert alive() is None


def test_inference_engine_buckets_graph_equal_eager(cuda):
    """The 10-class 64 x 64 AlexNet served through buckets 1-64,
    captured (one graph per bucket, one pool) and eager: equal outputs
    for every request size; K6 counted twice per replay."""
    from veles_tpu_torch.models.flagship import alexnet_fused
    from veles_tpu_torch.ops import lrn
    from veles_tpu_torch.serve import InferenceEngine

    specs, params, _ = alexnet_fused(n_classes=10, image_size=64)
    engines = [InferenceEngine.from_specs(specs, params, device=cuda,
                                          cuda_graphs=g) for g in (True, False)]
    for engine in engines:
        assert engine.warmup((64, 64, 3), 64) == 7
        assert engine.buckets == [1, 2, 4, 8, 16, 32, 64]
    rng = np.random.default_rng(9)
    for n in (1, 3, 8, 13, 33, 64):
        x = rng.random((n, 64, 64, 3), dtype=np.float32)
        lrn.reset_launches()
        got = engines[0].apply(x)
        assert lrn.LAUNCHES["lrn_fwd"] == 2
        want = engines[1].apply(x)
        assert got.shape == (n, 10) and np.array_equal(got, want)
    assert engines[0].compile_count == 7


def test_flash_kernels_k1_k3_replay_in_a_cuda_graph(cuda):
    """K1 (forward), K2 (dK/dV) and K3 (dQ), bf16 at D = 128, captured
    in one graph: their TMA tensor maps are encoded on the host at
    capture and baked into the graph, so a replay reads the addresses
    of that capture. The inputs are rewritten in place (the addresses
    stay) and every replay equals eager calls on the new values
    bitwise."""
    rng = np.random.default_rng(11)
    shape = (2, 200, 2, 128)
    q, k, v, do = (_randn(rng, shape, torch.bfloat16, cuda)
                   for _ in range(4))
    ptrs = [t.data_ptr() for t in (q, k, v, do)]

    def run():
        o, l, m = fa.flash_attention_fwd(q, k, v, causal=True, impl="cuda")
        di = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float())
        dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, do, l, m, di.contiguous(),
                                       True)
        dq = fa.flash_bwd_dq_cuda(q, k, v, do, l, m, di.contiguous(), True)
        return o, dq, dk, dv

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for step in range(3):
        for t in (q, k, v, do):
            t.copy_(_randn(rng, shape, torch.bfloat16, cuda))
        assert [t.data_ptr() for t in (q, k, v, do)] == ptrs
        graph.replay()
        want = run()
        torch.cuda.synchronize()
        for got, ref in zip(outs, want):
            assert torch.equal(got, ref), step


def test_step_graph_counts_launches_under_replay(cuda):
    """A StepGraph takes back the wrapper counts of its capture and
    adds them on every replay; the warm-up calls launch and count."""
    from veles_tpu_torch.graphs import StepGraph
    from veles_tpu_torch.ops import lrn

    rng = np.random.default_rng(12)
    x = _randn(rng, (64, 96), torch.bfloat16, cuda)
    q = _randn(rng, (4, 3, 64), torch.bfloat16, cuda)
    kc = _randn(rng, (4, 300, 3, 64), torch.bfloat16, cuda)
    lengths = torch.tensor([1, 100, 299, 300], dtype=torch.int32,
                           device=cuda)

    def step():
        return (lrn.lrn_fwd_cuda(x, 2.0, 5, 1e-4, 0.75),
                fa.flash_decode_cuda(q, kc, kc, lengths))

    fa.reset_launches()
    lrn.reset_launches()
    graph = StepGraph(step)
    assert fa.LAUNCHES["flash_decode"] == StepGraph.WARMUP
    assert lrn.LAUNCHES["lrn_fwd"] == StepGraph.WARMUP
    for _ in range(5):
        y, o = graph.replay()
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_decode"] == StepGraph.WARMUP + 5
    assert lrn.LAUNCHES["lrn_fwd"] == StepGraph.WARMUP + 5
    assert torch.equal(o, fa.flash_decode_cuda(q, kc, kc, lengths))
    assert torch.equal(y, lrn.lrn_fwd_cuda(x, 2.0, 5, 1e-4, 0.75))


def test_step_graphs_built_on_two_threads_at_once(cuda):
    """Two threads build StepGraphs at the same moment (a respawn and a
    rollout): the captures take turns, each keeps its own tally, and
    both replay right."""
    import threading

    from veles_tpu_torch.graphs import StepGraph
    from veles_tpu_torch.ops import lrn

    rng = np.random.default_rng(13)
    x = _randn(rng, (64, 96), torch.bfloat16, cuda)
    q = _randn(rng, (4, 3, 64), torch.bfloat16, cuda)
    kc = _randn(rng, (4, 300, 3, 64), torch.bfloat16, cuda)
    lengths = torch.tensor([1, 100, 299, 300], dtype=torch.int32,
                           device=cuda)
    steps = {"lrn": lambda: lrn.lrn_fwd_cuda(x, 2.0, 5, 1e-4, 0.75),
             "decode": lambda: fa.flash_decode_cuda(q, kc, kc, lengths)}
    fa.reset_launches()
    lrn.reset_launches()
    barrier = threading.Barrier(2)
    graphs, errors = {}, []

    def build(name):
        try:
            barrier.wait(60)
            graphs[name] = StepGraph(steps[name])
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(n,)) for n in steps]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert lrn.LAUNCHES["lrn_fwd"] == StepGraph.WARMUP
    assert fa.LAUNCHES["flash_decode"] == StepGraph.WARMUP
    for _ in range(3):
        y = graphs["lrn"].replay()
        o = graphs["decode"].replay()
    torch.cuda.synchronize()
    assert lrn.LAUNCHES["lrn_fwd"] == StepGraph.WARMUP + 3
    assert fa.LAUNCHES["flash_decode"] == StepGraph.WARMUP + 3
    assert torch.equal(y, steps["lrn"]())
    assert torch.equal(o, steps["decode"]())


# -- scheduler tenancy on the card --------------------------------------------

def _tenancy_lm():
    return _graph_lm(embed=1024, heads=8, layers=8, seq_len=1024)


def test_quantum_release_waits_for_the_device(cuda, monkeypatch):
    """A serve quantum granted right after a train quantum that ran a
    ``step_many(4)``: the lease ends only once the training window is
    done on the device, so the serve quantum's wall time holds its own
    work, not the window (which it does hold when the wait is taken
    out), and the train tenant's device-ms covers the window."""
    import threading
    import time

    from veles_tpu_torch.models.transformer import TransformerTrainer
    from veles_tpu_torch.sched import Scheduler
    from veles_tpu_torch.sched import scheduler as sched_mod

    trainer = TransformerTrainer(_tenancy_lm(), device=cuda, seed=0)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, 256, (4, 8, 1025))).to(cuda)
    trainer.step_many(tokens)                    # capture + warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.step_many(tokens)
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1000.0
    x = torch.randn(256, 256, device=cuda)

    def one_run():
        sched = Scheduler()
        train = sched.register("train")
        serve = sched.register("serve", weight=4)
        trainer.sched_tenant = train
        out = {}

        def serve_one():
            float((x @ x)[0, 0])                 # this thread's handle
            out["ready"] = True
            with serve.quantum() as lease:
                float((x @ x)[0, 0])
                out["ms"] = (time.monotonic() - lease.acquired_at) * 1e3

        th = threading.Thread(target=serve_one)
        with train.quantum():
            th.start()
            while not serve.waiting:
                time.sleep(0.0005)
            trainer.step_many(tokens)            # a nested quantum
        th.join(timeout=60)
        snap = sched.snapshot()["tenants"]
        sched.stop()
        trainer.sched_tenant = None
        return out["ms"], snap["train"]["device_ms"]

    serve_ms, train_ms = one_run()
    assert window_ms > 10.0, window_ms
    assert serve_ms < 0.25 * window_ms, (serve_ms, window_ms)
    assert train_ms > 0.8 * window_ms, (train_ms, window_ms)
    monkeypatch.setattr(sched_mod, "_wait_for_device", lambda: None)
    serve_ms, _ = one_run()
    assert serve_ms > 0.5 * window_ms, (serve_ms, window_ms)


def test_lm_capture_inside_a_quantum_while_another_tenant_replays(cuda):
    """The LM trainer captures its step inside its quantum while a
    serve tenant replays its captured decode rounds between the
    trainer's quanta: the trainer's losses and parameters equal a solo
    run's bitwise, and the served tokens equal a solo engine's (f32:
    the batches around a sequence change with the clients' timing, and
    bf16 greedy tokens may differ across prefill batch shapes)."""
    import threading

    from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerTrainer,
                                                    _tree_leaves,
                                                    init_params)
    from veles_tpu_torch.sched import Scheduler
    from veles_tpu_torch.serve import GenerativeEngine, TokenBatcher

    cfg = TransformerConfig(compute="float32", ce_chunk=64, **GRAPH_LM)
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, 256, (5, 2, 257))).to(cuda)
    prompts = _lm_prompts(4, (5, 33, 70, 12))

    def train(tenant):
        trainer = TransformerTrainer(cfg, device=cuda, seed=3,
                                     learning_rate=1e-3)
        trainer.sched_tenant = tenant
        losses = [trainer.step(tokens[i])["loss"] for i in range(3)]
        losses = torch.cat([torch.stack(losses),
                            trainer.step_many(tokens[1:])["loss"]])
        return (losses, [p.detach().clone()
                         for p in _tree_leaves(trainer.params)],
                len(trainer._graphs))

    params = init_params(cfg, seed=1)
    solo_engine = GenerativeEngine(cfg, params, max_slots=4, device=cuda)
    solo_tokens = [g.tolist() for g in solo_engine.generate(prompts, 40)]
    solo = train(None)

    sched = Scheduler()
    train_tenant = sched.register("train", weight=1)
    serve_tenant = sched.register("serve", weight=4)
    engine = GenerativeEngine(cfg, params, max_slots=4, device=cuda)
    batcher = TokenBatcher(engine, tenant=serve_tenant)
    with serve_tenant.quantum():                 # its captures
        engine.warm()
    served = []
    stop = threading.Event()

    def client(i):
        while not stop.is_set():
            served.append((i, batcher.submit(prompts[i], max_tokens=40,
                                             timeout=300).tolist()))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    try:
        while serve_tenant.quanta < 8:           # replays under way
            stop.wait(0.001)
        got = train(train_tenant)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=300)
        batcher.stop()
    snap = sched.snapshot()["tenants"]
    sched.stop()
    assert got[2] == solo[2] == 1
    assert torch.equal(got[0], solo[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], solo[1]))
    assert len(served) >= len(prompts)
    assert all(toks == solo_tokens[i] for i, toks in served)
    assert snap["train"]["quanta"] == 4 and snap["serve"]["quanta"] > 8


def test_prng_uniform_launches_k8_and_equals_plain_philox(cuda):
    """``prng`` device fills on the card go through K8: one launch per
    ``uniform``, bitwise the plain Philox under the stream's key at the
    unit-graph phase's [8192, 4096]; ``bernoulli`` is one fill,
    ``normal`` two."""
    import zlib

    from veles_tpu_torch import prng
    from veles_tpu_torch.ops import rng as rng_ops

    stream = prng.RandomGenerator("smoke", seed=11)
    key = rng_ops.fold_in(11, zlib.crc32(b"smoke"))
    rng_ops.reset_launches()
    got = stream.uniform((8192, 4096), device=cuda)
    assert rng_ops.LAUNCHES["uniform_fill"] == 1
    want = rng_ops.uniform_fill(rng_ops.fold_in(key, 1), (8192, 4096),
                                device=cuda, impl="plain")
    assert torch.equal(got, want)
    mask = stream.bernoulli((1536, 4096), p=0.5, device=cuda)
    z = stream.normal((1 << 20,), device=cuda)
    assert rng_ops.LAUNCHES["uniform_fill"] == 4
    assert torch.equal(mask.cpu(), rng_ops.uniform_fill(
        rng_ops.fold_in(key, 2), (1536, 4096), device="cpu") < 0.5)
    assert bool(torch.isfinite(z).all())
    assert abs(float(z.mean())) < 5e-3 and abs(float(z.std()) - 1) < 5e-3


# --------------------------------------------- the unit-graph classifier

def _small_alexnet_workflow(device, dropout=0.5):
    """The 10-class 64 x 64 AlexNetWorkflow (60 TRAIN, 20 VALID images,
    minibatch 20) on ``device``, from fresh streams of seed 3."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models.alexnet import (AlexNetWorkflow,
                                                alexnet_layers)
    root.common.random.seed = 3
    prng.reset()
    wf = AlexNetWorkflow(
        n_classes=10, image_size=64, max_epochs=1,
        layers=alexnet_layers(10, dropout=dropout),
        loader_kwargs=dict(n_train=60, n_valid=20, minibatch_size=20,
                           image_size=64))
    wf.initialize(device=device)
    return wf


def _step(wf, klass):
    """Serve minibatches until one of ``klass``, then run its units in
    the graph's order (the backward units only when the decision does
    not skip them)."""
    wf.loader.run()
    while wf.loader.minibatch_class != klass:
        wf.loader.run()
    for unit in wf.forwards:
        unit.run()
    wf.evaluator.run()
    wf.decision.run()
    if not bool(wf.decision.gd_skip):
        for gd in wf.gds:
            gd.run()


@pytest.fixture
def f32_units(cuda):
    from veles_tpu_torch.config import root
    saved = (root.common.engine.compute_type,
             torch.backends.cudnn.allow_tf32)
    root.common.engine.compute_type = "float32"
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    root.common.engine.compute_type, torch.backends.cudnn.allow_tf32 = saved


def test_unit_graph_train_minibatch_kernels_match_plain(f32_units):
    """One TRAIN minibatch of the small AlexNet workflow at f32 on
    ``Device()`` (K6, K7, K8) against the same on the CPU (the plain
    versions): the dropout masks bitwise, the logits and the new weights
    within 1e-4 of their scale, err_input of the first LRN's backward
    within 1e-3 (one ReLU whose input lies within rounding of 0 may take
    slope 1 on one side and 0 on the other)."""
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.nn.dropout import Dropout

    runs = []
    for device in (Device(), Device(backend="cpu")):
        wf = _small_alexnet_workflow(device)
        _step(wf, 2)
        runs.append(dict(
            masks=[np.array(u.mask.map_read()) for u in wf.forwards
                   if isinstance(u, Dropout)],
            probs=np.array(wf.forwards[-1].output.map_read()),
            weights=[np.array(u.weights.map_read()) for u in wf.forwards
                     if hasattr(u, "weights")],
            lrn_err=np.array(wf.gds[-2].err_input.map_read()),
            loss=wf.evaluator.loss, n_err=wf.evaluator.n_err))
        wf.thread_pool.shutdown()
    card, cpu = runs

    def share(a, b):
        return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)

    assert len(card["masks"]) == 2
    assert all(np.array_equal(a, b)
               for a, b in zip(card["masks"], cpu["masks"]))
    assert card["n_err"] == cpu["n_err"]
    assert abs(card["loss"] - cpu["loss"]) <= 1e-4 * abs(cpu["loss"])
    assert share(card["probs"], cpu["probs"]) < 1e-4
    for a, b in zip(card["weights"], cpu["weights"]):
        assert share(a, b) < 1e-4
    assert share(card["lrn_err"], cpu["lrn_err"]) < 1e-3


def test_unit_graph_launches_per_minibatch(f32_units):
    """K6, K7 and K8 launched by the units of one minibatch: 2/2/2 for
    a TRAIN one (two LRN forwards, their two backward units, two dropout
    masks), 2/0/0 for a VALID one (the backward units are skipped)."""
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.ops import lrn as lrn_ops
    from veles_tpu_torch.ops import rng as rng_ops

    wf = _small_alexnet_workflow(Device())
    for klass, want in ((1, (2, 0, 0)), (2, (2, 2, 2)), (2, (2, 2, 2))):
        lrn_ops.reset_launches()
        rng_ops.reset_launches()
        _step(wf, klass)
        torch.cuda.synchronize()
        assert (lrn_ops.LAUNCHES["lrn_fwd"], lrn_ops.LAUNCHES["lrn_bwd"],
                rng_ops.LAUNCHES["uniform_fill"]) == want, klass
    wf.thread_pool.shutdown()


def test_gd_lrn_unit_launches_k7_alone(f32_units):
    """GDLRNormalizer on the card: one K7 and no K6 a run, its err_input
    the plain backward's."""
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.memory import Array
    from veles_tpu_torch.nn.lrn import GDLRNormalizer
    from veles_tpu_torch.ops import lrn as lrn_ops

    device = Device()
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((8, 27, 27, 256)) * 3).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    wf = AcceleratedWorkflow(None, name="gd-lrn")
    unit = GDLRNormalizer(wf)
    unit.input, unit.err_output = Array(x), Array(dy)
    unit.input.initialize(device)
    unit.err_output.initialize(device)
    assert unit.initialize(device=device) is None
    lrn_ops.reset_launches()
    unit.run()
    torch.cuda.synchronize()
    assert lrn_ops.LAUNCHES == {"lrn_fwd": 0, "lrn_bwd": 1}
    want = lrn_ops.lrn_bwd(torch.from_numpy(x).to(device.torch_device),
                           torch.from_numpy(dy).to(device.torch_device),
                           2.0, 5, 1e-4, 0.75, impl="plain")
    got = unit.err_input.devmem
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


# ------------------------------------------------- the input pipeline
#
# The loader step on the card: bench.py's loader layout (uint8 images on
# the card, range_linear on the way in) at 64 x 64 with the 10-class
# AlexNet, whose two LRN layers and two dropout layers launch K6, K7
# and K8 twice a step. Trajectories are compared bitwise with cuDNN set
# deterministic (and restored after): every path takes the same ops on
# the same inputs.

PIPE_IMAGE = 64
PIPE_BATCH = 16


def _pipe_loader(device, n=3 * PIPE_BATCH, seed=2):
    """A uint8 FullBatchLoader of ``n`` images on ``device`` (a torch
    device: the card, or the CPU for the units' own Device)."""
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.loader import TRAIN, FullBatchLoader

    rng = np.random.default_rng(seed)
    shape = (n, PIPE_IMAGE, PIPE_IMAGE, 3)

    class Images(FullBatchLoader):
        def load_data(self):
            self.has_labels = True
            self.original_data = rng.integers(0, 256, shape,
                                              dtype=np.uint8)
            self.original_labels = rng.integers(0, 10, n).astype(np.int32)
            self.class_lengths[:] = [0, 0, n]

    loader = Images(AcceleratedWorkflow(None, name="pipe"),
                    minibatch_size=PIPE_BATCH, shuffle_limit=0,
                    normalization_type="range_linear",
                    normalization_parameters=dict(source=(0.0, 255.0),
                                                  interval=(0.0, 1.0)))
    unit_device = Device() if device.type == "cuda" \
        else Device(backend="cpu")
    assert loader.initialize(device=unit_device) is None
    loader.minibatch_class = TRAIN
    return loader


def _pipe_trainer(device, **kw):
    from veles_tpu_torch.models.flagship import alexnet_fused
    from veles_tpu_torch.parallel.fused import FusedClassifierTrainer

    specs, params, _ = alexnet_fused(n_classes=10, image_size=PIPE_IMAGE)
    return FusedClassifierTrainer(specs, params, learning_rate=0.01,
                                  momentum=0.9, weight_decay=5e-4,
                                  device=device, **kw)


@pytest.fixture
def deterministic(cuda):
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield cuda
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        saved


def test_loader_step_launches_two_of_k6_k7_k8_a_step(cuda):
    """2/2/2 K6/K7/K8 around one K = 1 loader step, 2K/2K/2K around one
    K = 4 dispatch."""
    from veles_tpu_torch.ops import lrn, rng

    for k in (1, 4):
        trainer = _pipe_trainer(cuda)
        loader = _pipe_loader(cuda)
        step = trainer.make_loader_step(loader, steps_per_dispatch=k)
        for _ in range(2):  # warm
            if k == 1:
                loader.run()
            step()
        torch.cuda.synchronize()
        lrn.reset_launches()
        rng.reset_launches()
        if k == 1:
            loader.run()
        out = step()
        torch.cuda.synchronize()
        assert (lrn.LAUNCHES["lrn_fwd"], lrn.LAUNCHES["lrn_bwd"],
                rng.LAUNCHES["uniform_fill"]) == (2 * k, 2 * k, 2 * k)
        assert bool(torch.isfinite(out["loss"]).all())


def test_loader_step_gathers_the_served_batch_bitwise(deterministic):
    """The window the loader step gathers is the loader's own served
    minibatch, bitwise, and the step on it equals ``loader.run()`` +
    ``trainer.step`` on the served batch bitwise over 6 steps (a
    second trainer from the same seed)."""
    cuda = deterministic
    served = _pipe_loader(cuda)
    fused = _pipe_loader(cuda)
    fused.external_gather = True
    for _ in range(4):
        served.run()
        fused.run()
        start = fused.minibatch_offset - fused.minibatch_size
        x, labels = fused.gather(start, fused.minibatch_size)
        assert torch.equal(x, served.minibatch_data.devmem)
        assert torch.equal(labels, served.minibatch_labels.devmem)
    runs = []
    for two_dispatch in (False, True):
        trainer = _pipe_trainer(cuda)
        loader = _pipe_loader(cuda)
        step = None if two_dispatch else trainer.make_loader_step(loader)
        losses = []
        for _ in range(6):
            loader.run()
            m = trainer.step(loader.minibatch_data.devmem,
                             loader.minibatch_labels.devmem) \
                if two_dispatch else step()
            losses.append(m["loss"])
        runs.append((torch.stack(losses), trainer.params))
    (la, pa), (lb, pb) = runs
    assert torch.equal(la, lb)
    for a, b in zip(pa, pb):
        for key in a:
            assert torch.equal(a[key], b[key])


def test_loader_k_steps_equal_single_steps_bitwise(deterministic):
    """K = 4 through ``multi_step`` against 4 K = 1 loader steps, twice
    over (8 steps), dropout on: bitwise."""
    cuda = deterministic
    runs = []
    for k in (1, 4):
        trainer = _pipe_trainer(cuda)
        loader = _pipe_loader(cuda)
        step = trainer.make_loader_step(loader, steps_per_dispatch=k)
        losses = []
        for _ in range(8 // k):
            if k == 1:
                loader.run()
            losses.extend(step()["loss"].reshape(-1))
        runs.append((torch.stack(losses), trainer))
    (la, ta), (lb, tb) = runs
    assert torch.equal(la, lb)
    for a, b in zip(ta.params + ta.velocity, tb.params + tb.velocity):
        for key in a:
            assert torch.equal(a[key], b[key])


def test_loader_steps_never_sync_the_host(cuda):
    """50 steady-state K = 1 loader steps and 4 K = 4 dispatches under
    ``set_sync_debug_mode("error")`` (nan_policy="skip": the sentinel
    never reads its flag): no call waits for the card, so the host
    runs ahead of it."""
    for k in (1, 4):
        trainer = _pipe_trainer(cuda, nan_policy="skip")
        loader = _pipe_loader(cuda)
        step = trainer.make_loader_step(loader, steps_per_dispatch=k)
        for _ in range(3):  # warm: first allocations, cuDNN plans
            if k == 1:
                loader.run()
            step()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(50 if k == 1 else 4):
                if k == 1:
                    loader.run()
                out = step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert bool(torch.isfinite(out["loss"]).all())


def test_prefetch_ring_feeds_step_many_like_the_sequential_path(
        deterministic):
    """PrefetchingServer (depth 2, a bf16 cast on the producer thread)
    -> ``get_many(4)`` -> ``step_many``, twice, against serve ->
    ``step`` on the bf16 batches: bitwise. The server is started on a
    side stream; the producer enqueues on it (``server.stream``), the
    consumer steps on it, and no producer thread is left after
    ``stop()``."""
    import threading

    from veles_tpu_torch.loader import PrefetchingServer

    cuda = deterministic
    seq = _pipe_trainer(cuda)
    loader = _pipe_loader(cuda)
    losses = []
    for _ in range(8):
        loader.run()
        losses.append(seq.step(
            loader.minibatch_data.devmem.to(torch.bfloat16),
            loader.minibatch_labels.devmem)["loss"])
    side = torch.cuda.Stream()
    ring = _pipe_trainer(cuda)
    got = []
    with torch.cuda.stream(side):
        server = PrefetchingServer(
            _pipe_loader(cuda), depth=2,
            transform=lambda d: d.to(torch.bfloat16)).start()
        try:
            assert server.stream == side
            for _ in range(2):
                batches = server.get_many(4, timeout=300)
                assert all(b.data.dtype == torch.bfloat16 for b in batches)
                got.extend(ring.step_many([b.data for b in batches],
                                          [b.labels for b in batches])
                           ["loss"])
        finally:
            server.stop()
    torch.cuda.synchronize()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("prefetch")]
    assert torch.equal(torch.stack(got), torch.stack(losses))
    for a, b in zip(ring.params, seq.params):
        for key in a:
            assert torch.equal(a[key], b[key])


def test_from_specs_normalizer_captured_equals_eager(cuda):
    """The 10-class 64 x 64 AlexNet behind ``from_specs(normalizer=
    mean_disp)``: captured buckets against eager, bitwise; a swap of the
    statistics changes both answers alike (the graphs read them)."""
    from veles_tpu_torch import normalization
    from veles_tpu_torch.models.flagship import alexnet_fused
    from veles_tpu_torch.serve import InferenceEngine

    specs, params, _ = alexnet_fused(n_classes=10, image_size=64)
    rng = np.random.default_rng(4)
    norm = normalization.normalizer("mean_disp")
    norm.analyze((rng.random((32, 64, 64, 3)) * 255).astype(np.float32))
    engines = [InferenceEngine.from_specs(specs, params, device=cuda,
                                          normalizer=norm, cuda_graphs=g)
               for g in (True, False)]
    x = (rng.random((5, 64, 64, 3)) * 255).astype(np.float32)
    first = [e.apply(x) for e in engines]
    assert np.array_equal(first[0], first[1])
    assert engines[0].compile_count == 1
    stats = {k: v.cpu().numpy() * 0.5
             for k, v in engines[0].params[-1].items()}
    for e in engines:
        e.swap_params(params + [stats])
    second = [e.apply(x) for e in engines]
    assert np.array_equal(second[0], second[1])
    assert not np.array_equal(first[0], second[0])
    assert engines[0].compile_count == 1


def test_mean_disp_normalizer_and_input_joiner_card_equal_cpu(cuda):
    """Both units on ``Device()`` against the same units on
    ``Device(backend="cpu")``, f32: bitwise (one subtraction and one
    product; a copy)."""
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.input_joiner import InputJoiner
    from veles_tpu_torch.mean_disp_normalizer import MeanDispNormalizer
    from veles_tpu_torch.memory import Array

    rng = np.random.default_rng(6)
    dataset = (rng.random((64, 12, 12, 3)) * 255).astype(np.float32)
    extra = rng.standard_normal((32, 7)).astype(np.float32)
    out = []
    for device in (Device(), Device(backend="cpu")):
        wf = AcceleratedWorkflow(None, name="units")
        norm = MeanDispNormalizer.from_dataset(wf, dataset)
        norm.input = Array(dataset[:32])
        norm.input.initialize(device)
        assert norm.initialize(device=device) is None
        norm.run()
        joiner = InputJoiner(wf, num_inputs=2)
        joiner.input_0 = norm.output
        joiner.input_1 = Array(extra)
        joiner.input_1.initialize(device)
        assert joiner.initialize(device=device) is None
        joiner.run()
        assert joiner.output.devmem.device.type == \
            device.torch_device.type
        out.append((np.array(norm.output.map_read()),
                    np.array(joiner.output.map_read())))
    (nc, jc), (np_, jp) = out
    assert np.array_equal(nc, np_) and np.array_equal(jc, jp)
    assert jc.shape == (32, 12 * 12 * 3 + 7)


# --------------------------------------------- the four unit families

def _family_side(device, seed=4):
    """A fresh workflow and streams of ``seed`` on ``device``, and a
    factory of initialized Arrays there."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.config import root
    from veles_tpu_torch.memory import Array

    root.common.random.seed = seed
    prng.reset()

    def array(data):
        arr = Array(np.ascontiguousarray(data))
        arr.initialize(device)
        return arr

    return AcceleratedWorkflow(None, name="families"), array


def _share(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_deconv_and_depooling_twins_card_equal_cpu(f32_units):
    """The conv autoencoder's decoder shapes ([50, 14, 14, 8] -> a 3x3
    stride-2 deconv to [50, 28, 28, 1]) at f32, two GDDeconv steps, on
    ``Device()`` against ``Device(backend="cpu")``: outputs, err_input
    and weights within 1e-4 of their scale, the weights' velocities
    within 1e-3 (cuDNN's and the CPU's weight-gradient sums over 50 x
    28 x 28 terms differ in order); Depooling and GDDepooling
    bitwise."""
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.nn import Deconv, Depooling, gd_for

    rng = np.random.default_rng(7)
    x = rng.standard_normal((50, 14, 14, 8)).astype(np.float32)
    err = (rng.standard_normal((50, 28, 28, 1)) * 0.1).astype(np.float32)
    runs = []
    for device in (Device(), Device(backend="cpu")):
        wf, array = _family_side(device)
        fwd = Deconv(wf, n_kernels=1, kx=3, sliding=(2, 2),
                     weights_filling="gaussian", weights_stddev=0.02)
        fwd.input = array(x)
        assert fwd.initialize(device=device) is None
        fwd.run()
        out = np.array(fwd.output.map_read())
        gd = gd_for(fwd, wf, learning_rate=3e-4, momentum=0.9)
        gd.err_output = array(err)
        assert gd.initialize(device=device) is None
        for _ in range(2):
            gd.run()
        depool = Depooling(wf, kx=2)
        depool.input = array(x)
        assert depool.initialize(device=device) is None
        depool.run()
        gdp = gd_for(depool, wf)
        gdp.err_output = depool.output
        assert gdp.initialize(device=device) is None
        gdp.run()
        runs.append(dict(
            out=out, err_input=np.array(gd.err_input.map_read()),
            weights=np.array(gd.weights.map_read()),
            bias=np.array(gd.bias.map_read()),
            vel=np.array(gd.velocity_weights.map_read()),
            depool=np.array(depool.output.map_read()),
            undepool=np.array(gdp.err_input.map_read())))
    card, cpu = runs
    assert card["out"].shape == (50, 28, 28, 1)
    for key in ("out", "err_input", "weights", "bias"):
        assert _share(card[key], cpu[key]) < 1e-4, key
    assert _share(card["vel"], cpu["vel"]) < 1e-3
    assert np.array_equal(card["depool"], cpu["depool"])
    assert np.array_equal(card["undepool"], x)
    assert np.array_equal(cpu["undepool"], x)


def test_lstm_and_gd_lstm_card_equal_cpu(f32_units):
    """The row-wise LSTM classifier's layer (28 steps of 28 pixels,
    hidden 128, batch 50) at f32 with three GDLSTM steps (momentum,
    decay) on the card and on the CPU: outputs, err_input, weights and
    velocities within 1e-4 of their scale."""
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.nn import LSTM, gd_for

    rng = np.random.default_rng(8)
    x = rng.random((50, 28, 28)).astype(np.float32)
    err = (rng.standard_normal((50, 28, 128)) * 0.01).astype(np.float32)
    runs = []
    for device in (Device(), Device(backend="cpu")):
        wf, array = _family_side(device)
        fwd = LSTM(wf, hidden=128)
        fwd.input = array(x)
        assert fwd.initialize(device=device) is None
        gd = gd_for(fwd, wf, learning_rate=0.01, momentum=0.9,
                    weight_decay=1e-3)
        gd.err_output = array(err)
        assert gd.initialize(device=device) is None
        for _ in range(3):
            fwd.run()
            gd.run()
        runs.append({attr: np.array(getattr(gd, attr).map_read())
                     for attr in ("weights_x", "weights_h", "bias",
                                  "velocity_wx", "velocity_wh",
                                  "velocity_b", "err_input")})
        runs[-1]["out"] = np.array(fwd.output.map_read())
    card, cpu = runs
    for key in cpu:
        assert _share(card[key], cpu[key]) < 1e-4, key


def test_rbm_step_card_equal_cpu_with_k8_fill(f32_units):
    """One CD-1 step of RBM(n_hidden=500) over 100 binary 784-pixel
    rows: on the card one K8 launch, its fill bitwise the CPU's plain
    Philox fill; the updates within 1e-5 of their scale (a sample where
    the fill lies within rounding of h0p could flip; on these inputs
    none does, and the test counts them)."""
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.nn import RBM, RBMTrainer
    from veles_tpu_torch.ops import rng as rng_ops

    rng = np.random.default_rng(9)
    x = (rng.random((100, 784)) > 0.7).astype(np.float32)
    runs = []
    for device in (Device(), Device(backend="cpu")):
        wf, array = _family_side(device)
        rbm = RBM(wf, n_hidden=500)
        rbm.input = array(x)
        assert rbm.initialize(device=device) is None
        rbm.run()
        h0p = np.array(rbm.output.map_read())
        trainer = RBMTrainer(wf)
        trainer.link_attrs(rbm, "input", "weights", "vbias", "hbias")
        trainer.batch_size = 100
        assert trainer.initialize(device=device) is None
        fills = []
        uniform = trainer.rand.uniform

        def recording(*a, **k):
            fills.append(uniform(*a, **k))
            return fills[-1]

        trainer.rand.uniform = recording
        rng_ops.reset_launches()
        trainer.run()
        launches = rng_ops.LAUNCHES["uniform_fill"]
        runs.append(dict(fill=fills[0].cpu().numpy(), h0p=h0p,
                         launches=launches, err=trainer.recon_err,
                         **{a: np.array(getattr(rbm, a).map_read())
                            for a in ("weights", "vbias", "hbias")}))
    card, cpu = runs
    assert card["launches"] == 1 and cpu["launches"] == 0
    assert np.array_equal(card["fill"], cpu["fill"])
    assert _share(card["h0p"], cpu["h0p"]) < 1e-5
    near = np.abs(cpu["fill"] - cpu["h0p"]) <= 1e-6
    assert int(near.sum()) == 0
    for key in ("weights", "vbias", "hbias"):
        assert _share(card[key], cpu[key]) < 1e-5, key
    assert abs(card["err"] - cpu["err"]) <= 1e-5 * cpu["err"]


def test_som_winners_card_equal_cpu(f32_units):
    """KohonenForward's 8 x 8 default map over 100 784-pixel rows, three
    KohonenTrainer steps, on the card and on the CPU: the winners of
    every step equal, the codebook within 1e-4 of its scale."""
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.nn import KohonenForward, KohonenTrainer

    rng = np.random.default_rng(10)
    data = rng.random((3, 100, 784)).astype(np.float32)
    runs = []
    for device in (Device(), Device(backend="cpu")):
        wf, array = _family_side(device)
        som = KohonenForward(wf)
        som.input = array(data[0])
        assert som.initialize(device=device) is None
        trainer = KohonenTrainer(wf)
        trainer.link_attrs(som, "input", "codebook")
        trainer.grid = som.grid_positions
        trainer.batch_size = 100
        assert trainer.initialize(device=device) is None
        winners, errs = [], []
        for x in data:
            som.input.reset(x)
            som.input.initialize(device)
            trainer.run()
            winners.append(trainer.winners.cpu().numpy())
            errs.append(trainer.avg_quantization_err)
        runs.append((winners, errs, np.array(som.codebook.map_read())))
    (wc, ec, cc), (wp, ep, cp) = runs
    assert all(np.array_equal(a, b) for a, b in zip(wc, wp))
    assert max(abs(a - b) / b for a, b in zip(ec, ep)) < 1e-4
    assert _share(cc, cp) < 1e-4


# -- the state half: snapshots, async capture, engines from a snapshot -----

def _small_mnist(**kwargs):
    from veles_tpu_torch.models.mnist import MnistWorkflow
    wf = MnistWorkflow(layers=(32, 10), max_epochs=2, fail_iterations=100,
                       loader_kwargs=dict(n_train=300, n_valid=100,
                                          minibatch_size=50), **kwargs)
    wf.thread_pool = None
    return wf


def test_snapshot_round_trip_of_a_trained_workflow(f32_units, tmp_path):
    """A workflow trained on the card snapshots host data only (the
    pickler refuses CUDA tensors), restores with bitwise the trained
    weights, and a restored copy resumed from its epoch-1 snapshot ends
    where the uninterrupted run ended."""
    import glob

    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.snapshotter import Snapshotter
    prng.reset()
    wf = _small_mnist(snapshot_dir=str(tmp_path), snapshot_prefix="m")
    wf.initialize(device=Device())
    assert wf.forwards[0].weights.devmem.is_cuda
    wf.run()
    trained = [np.array(getattr(u, a).map_read()) for u in wf.forwards
               for a in ("weights", "bias")]
    path = wf.snapshotter.save()
    restored = Snapshotter.load(path)
    assert all(r.tobytes() == np.array(getattr(u, a).map_read()).tobytes()
               for r, (u, a) in zip(trained, [
                   (u, a) for u in restored.forwards
                   for a in ("weights", "bias")]))
    prng.reset()
    resumed = Snapshotter.load(
        sorted(glob.glob(str(tmp_path / "m_1_*.pickle.gz")))[0])
    resumed.thread_pool = None
    resumed.stopped = False
    resumed.initialize(device=Device())
    assert resumed.forwards[0].weights.devmem.is_cuda
    resumed.run()
    assert resumed.decision.epoch_errors == wf.decision.epoch_errors
    for a, b in zip(trained, [np.array(getattr(u, at).map_read())
                              for u in resumed.forwards
                              for at in ("weights", "bias")]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_async_capture_of_a_cuda_tensor_is_immune_to_in_place_updates(
        cuda, tmp_path):
    """``AsyncCheckpointer.save`` clones a CUDA tensor on the device at
    capture: in-place updates issued right after ``save()`` returns (on
    the same stream and on another) do not reach the written value."""
    from veles_tpu_torch.checkpoint import AsyncCheckpointer
    ck = AsyncCheckpointer(str(tmp_path), prefix="c")
    w = torch.randn(4096, 4096, device=cuda)
    shards = [torch.randn(512, 64, device=cuda, dtype=torch.bfloat16)
              for _ in range(2)]
    want = w.cpu().numpy()
    want_shards = np.concatenate([s.float().cpu().numpy() for s in shards])
    ticket = ck.save(arrays={"w": w, "s": shards})
    w.mul_(-2.0).add_(3.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for s in shards:
            s.fill_(9.0)
    assert ticket.wait(60.0) and ticket.error is None
    arrays, _, _, _ = ck.store.load_latest()
    assert arrays["w"].tobytes() == want.tobytes()
    assert arrays["s"].tobytes() == want_shards.tobytes()
    torch.cuda.synchronize()
    assert float(w[0, 0]) == float(-2.0 * want[0, 0] + 3.0)
    ck.stop()


def test_nonfinite_guard_on_device_tensors(cuda, tmp_path):
    """The guard's one device reduction flags a NaN and an Inf in CUDA
    tensors (the max-abs of ``torch._foreach_norm`` propagates both),
    and passes finite ones."""
    from veles_tpu_torch.snapshotter import Snapshotter
    wf = _small_mnist()
    snap = Snapshotter(wf, directory=str(tmp_path))
    leaves = {"a": torch.randn(1000, device=cuda),
              "b": torch.randn(3, 7, device=cuda, dtype=torch.bfloat16),
              "c": torch.randn(5, device=cuda)}
    snap._guarded_leaves = lambda: list(leaves.items())
    assert snap.nonfinite_params() == []
    leaves["a"][500] = float("nan")
    leaves["b"][2, 6] = float("-inf")
    assert snap.nonfinite_params() == ["a", "b"]


def test_from_snapshot_equals_from_workflow_on_the_card(f32_units,
                                                        tmp_path):
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.parallel.fused import train_fused
    from veles_tpu_torch.serve.engine import InferenceEngine
    from veles_tpu_torch.snapshotter import Snapshotter
    prng.reset()
    wf = _small_mnist()
    wf.initialize(device=Device())
    train_fused(wf)
    path = Snapshotter(wf, directory=str(tmp_path), prefix="m",
                       compression=None).save()
    live = InferenceEngine.from_workflow(wf)
    restored = InferenceEngine.from_snapshot(path)
    rows = np.random.default_rng(4).random((9, 28, 28)).astype(np.float32)
    got = live.apply(rows)
    assert got.tobytes() == restored.apply(rows).tobytes()
    assert live.compile_count == restored.compile_count >= 1


def test_lm_load_state_keeps_the_captured_step_tensors(cuda):
    """``TransformerUnit._load_state`` copies into the tensors the
    captured train step reads (their ``data_ptr`` unchanged), and the
    next replay trains from the loaded values: a step from a state and
    the same step after saving and loading it give equal losses."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.models.lm import TransformerWorkflow
    from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                    _tree_leaves)
    prng.reset()
    wf = TransformerWorkflow(
        config=TransformerConfig(vocab=64, embed=128, heads=2, layers=2,
                                 seq_len=64),
        max_epochs=1, loader_kwargs=dict(n_tokens=65 * 64,
                                         minibatch_size=8))
    wf.thread_pool = None
    wf.initialize(device=Device())
    wf.run()
    unit = wf.trainer_unit
    trainer = unit._trainer_
    assert trainer._graphs, "the train step was not captured"

    def ptrs():
        return [t.data_ptr() for t in _tree_leaves(trainer.params) +
                _tree_leaves(trainer.opt_m) + _tree_leaves(trainer.opt_v)]

    before = ptrs()
    state = unit._host_state()
    tokens = wf.loader.minibatch_data.devmem[:8].clone()
    first = float(trainer.step(tokens)["loss"])
    second = float(trainer.step(tokens)["loss"])
    unit._load_state(state)
    assert ptrs() == before
    assert float(trainer.step(tokens)["loss"]) == first
    assert float(trainer.step(tokens)["loss"]) == second


# ---------------------------------------------------------------------------
# the mesh on the card: host-staged collectives and the ring's hops
# ---------------------------------------------------------------------------

def staged_world(rank):
    """A rank of a 2-rank gloo world on the card: each collective on
    CUDA tensors (staged through pinned host buffers), its input still
    being computed by a queued kernel when the collective starts."""
    from veles_tpu_torch.parallel import collectives
    from veles_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    mesh = make_mesh(MeshConfig(data=2))
    ax = mesh.axis("data")
    dev = mesh.device
    collectives.reset_staged()
    big = torch.ones(4096, 4096, device=dev)
    # a slow producer queued ahead of the value the collectives read
    base = (big @ big)[:3, :4] / 4096
    x = base * (torch.arange(12., device=dev).reshape(3, 4) + 100 * rank)
    out = {"device": str(dev)}
    y = collectives.all_reduce_sum(x, ax)
    out["psum"] = (str(y.device), y.cpu().numpy())
    out["gather_bf16"] = collectives.all_gather_cat(
        x.to(torch.bfloat16) / 3, ax, 0).float().cpu().numpy()
    out["exchange"] = collectives.exchange(x, ax, 1 - rank,
                                           1 - rank).cpu().numpy()
    out["scatter"] = collectives.reduce_scatter_sum(x, ax, 1).cpu().numpy()
    out["staged"] = dict(collectives.STAGED_BYTES)
    return out


def test_collectives_stage_cuda_tensors_through_host(cuda):
    from veles_tpu_torch.parallel import collectives
    from veles_tpu_torch.parallel.multiprocess import run_world
    x = torch.randn(1000, 37, device=cuda).to(torch.bfloat16)
    host = collectives.to_host(x)
    assert host.device.type == "cpu" and host.is_pinned()
    back = collectives.to_device(host, cuda)
    torch.cuda.synchronize()
    assert torch.equal(back, x)
    ranks = run_world(staged_world, 2, "gloo", None, timeout_s=180)
    xs = [np.arange(12, dtype=np.float32).reshape(3, 4) + 100 * r
          for r in range(2)]
    for rank, out in enumerate(ranks):
        assert out["device"] == "cuda:0"
        device, total = out["psum"]
        assert device.startswith("cuda")
        np.testing.assert_array_equal(total, xs[0] + xs[1])
        want = torch.cat([torch.from_numpy(a).to(torch.bfloat16) / 3
                          for a in xs]).float().numpy()
        np.testing.assert_array_equal(out["gather_bf16"], want)
        np.testing.assert_array_equal(out["exchange"], xs[1 - rank])
        np.testing.assert_array_equal(
            out["scatter"], (xs[0] + xs[1])[:, 2 * rank:2 * rank + 2])
        assert out["staged"]["to_host"] > 0
        assert out["staged"]["to_device"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_hops_through_the_kernels_match_plain(cuda, dtype):
    """The second rank of a 2-chunk ring: its causal hop (own chunk) and
    its full hop (chunk 0) through K1, merged, against the plain path
    and against attention over the whole sequence; then each hop's
    backward through K2/K3 with the merged (global) l and m against
    ``_plain_bwd``'s with the same statistics."""
    from veles_tpu_torch.parallel.ring_attention import (hop_bwd,
                                                         merge_hop,
                                                         merged_output)
    rng = np.random.default_rng(11)
    b, t, h, d = 2, 256, 4, 128
    q0, k0, v0, q1, k1, v1, do = (_randn(rng, (b, t, h, d), dtype, cuda)
                                  for _ in range(7))
    hops = ((k1, v1, True), (k0, v0, False))
    merged = {}
    for impl in ("cuda", "plain"):
        acc = torch.zeros(q1.shape, dtype=torch.float32, device=cuda)
        l_acc = torch.zeros((b, h, t), dtype=torch.float32, device=cuda)
        m_acc = torch.full((b, h, t), float("-inf"), device=cuda)
        for kk, vv, causal in hops:
            acc, l_acc, m_acc = merge_hop(acc, l_acc, m_acc,
                                          *fa.flash_attention_fwd(
                                              q1, kk, vv, causal,
                                              block_k=64, impl=impl))
        merged[impl] = merged_output(acc, l_acc, m_acc, dtype)
    whole, _, _ = fa.flash_attention_fwd(
        torch.cat([q0, q1], 1), torch.cat([k0, k1], 1),
        torch.cat([v0, v1], 1), True, block_q=64, block_k=64,
        impl="plain")
    torch.cuda.synchronize()
    (o, l, m), (po, pl, pm) = merged["cuda"], merged["plain"]
    torch.testing.assert_close(o.float(), po.float(), **TOL[dtype])
    torch.testing.assert_close(o.float(), whole[:, t:].float(), **TOL[dtype])
    torch.testing.assert_close(l, pl, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(m, pm, atol=1e-3, rtol=1e-3)
    from veles_tpu_torch.ops.flash_attention import LAUNCHES
    before = dict(LAUNCHES)
    for kk, vv, causal in hops:
        got = hop_bwd(q1, kk, vv, po, pl, pm, do, causal, 64, "cuda")
        want = hop_bwd(q1, kk, vv, po, pl, pm, do, causal, 64, "plain")
        torch.cuda.synchronize()
        for name, a, c in zip(("dq", "dk", "dv"), got, want):
            assert a.dtype == dtype
            assert _rel(a, c) <= BWD_TOL[dtype], (name, causal)
    assert LAUNCHES["flash_bwd_dkv"] - before["flash_bwd_dkv"] == 2
    assert LAUNCHES["flash_bwd_dq"] - before["flash_bwd_dq"] == 2


def test_fleet_respawn_captures_while_two_siblings_stream(cuda):
    """Three LocalReplicas of a captured slab engine behind the router;
    one is killed and respawned (its fresh engine warmed, its decode
    round captured on the supervisor thread, after the dead engine was
    released there) while the two siblings stream: every stream is
    token-exact against an engine alone, the respawned replica serves
    the same tokens, and no capture is invalidated."""
    import json
    import threading
    import time
    import urllib.request

    from veles_tpu_torch.models.transformer import init_params
    from veles_tpu_torch.serve import (FleetManager, GenerativeEngine,
                                       LocalReplica, Router, RouterServer)
    config = _graph_lm()
    params = init_params(config, seed=3)
    prompt = _lm_prompts(7, (40,))[0]
    want = GenerativeEngine(config, params, max_slots=4,
                            device=cuda).generate([prompt], 120)[0].tolist()
    built = []

    def make():
        engine = GenerativeEngine(config, params, max_slots=4, device=cuda)
        engine.warm()
        built.append(engine)
        return engine

    handles = [LocalReplica(n, make, generative=True, watchdog_s=None)
               for n in ("g0", "g1", "g2")]
    server = RouterServer(Router(health_interval_s=0.05))
    fleet = FleetManager(server.router, replicas=handles,
                         respawn_backoff_s=0.05)

    def post(url, doc):
        req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                     headers={"Content-Type":
                                              "application/json"})
        return urllib.request.urlopen(req, timeout=120)

    def wait(pred, what):
        deadline = time.monotonic() + 120
        while not pred():
            assert time.monotonic() < deadline, what
            time.sleep(0.01)

    try:
        wait(lambda: server.router.routable_count() == 3, "routable")
        streams, started = {"g0": [], "g2": []}, []
        respawned = threading.Event()

        def stream(name):
            # streams back to back until the respawn is done, so the
            # capture overlaps the siblings' replays
            first = threading.Event()
            started.append(first)
            while True:
                toks = []
                with post("http://%s/generate"
                          % fleet.handle(name).address,
                          {"prompt": prompt.tolist(), "max_tokens": 120,
                           "stream": True}) as resp:
                    for line in resp:
                        rec = json.loads(line)
                        if "token" in rec:
                            toks.append(rec["token"])
                            first.set()
                streams[name].append(toks)
                if respawned.is_set():
                    return

        threads = [threading.Thread(target=stream, args=(n,))
                   for n in ("g0", "g2")]
        for t in threads:
            t.start()
        wait(lambda: len(started) == 2 and all(e.is_set()
                                               for e in started),
             "the siblings never streamed")
        n_built = len(built)
        handles[1].kill()
        wait(lambda: len(built) > n_built and handles[1].alive and
             server.router.routable_count() == 3, "no respawn")
        respawned.set()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        for name, runs in streams.items():
            assert runs and all(toks == want for toks in runs), name
        assert built[-1]._graph is not None
        with post("http://%s/generate" % handles[1].address,
                  {"prompt": prompt.tolist(), "max_tokens": 120}) as resp:
            assert json.loads(resp.read())["tokens"][0] == want
    finally:
        fleet.stop()
        server.stop()


# -- the AOT plane on the card ------------------------------------------------

def _lrn_package(path, seed=0):
    """A package of conv -> LRN -> softmax on 8 x 8 x 3 rows."""
    from veles_tpu_torch.aot.package import write_package
    rng = np.random.default_rng(seed)
    w0 = (rng.standard_normal((3, 3, 3, 16)) / 5).astype(np.float32)
    w1 = (rng.standard_normal((8 * 8 * 16, 10)) / 32).astype(np.float32)
    units = [{"class": "Conv", "uuid": "veles.tpu.conv", "name": "conv",
              "properties": {"activation": "relu", "strides_hw": [1, 1],
                             "padding": "SAME"},
              "arrays": {"weights": "0000_weights.npy"}},
             {"class": "LRN", "uuid": "veles.tpu.lrn", "name": "lrn",
              "properties": {"k": 2.0, "n": 5, "alpha": 1e-4,
                             "beta": 0.75}, "arrays": {}},
             {"class": "Softmax", "uuid": "veles.tpu.all2all",
              "name": "fc", "properties": {"activation": "softmax"},
              "arrays": {"weights": "0001_weights.npy"}}]
    write_package(path, {"workflow": "Lrn", "checksum": "", "precision":
                         "float32", "units": units},
                  [("0000_weights.npy", w0), ("0001_weights.npy", w1)])
    return path


@pytest.fixture
def aot_plan_dir(tmp_path):
    from veles_tpu_torch import aot
    from veles_tpu_torch.ops import _build
    yield str(tmp_path / "cache")
    aot.deactivate()
    _build.set_library_dir(None)


def test_aot_package_engine_records_its_k6_capture(cuda, tmp_path,
                                                   aot_plan_dir):
    """A package's engine on the card captures one graph a bucket with
    one K6 a replay, bitwise the spec engine's; the capture's record
    holds that tally and the LRN library's key, and a second engine on
    the same directory hits it."""
    from veles_tpu_torch import aot
    from veles_tpu_torch.analysis.recompile import CaptureWatcher
    from veles_tpu_torch.aot.export import unpack_record
    from veles_tpu_torch.ops import _build
    from veles_tpu_torch.ops import lrn as lrn_ops
    from veles_tpu_torch.serve.engine import InferenceEngine
    pkg = _lrn_package(str(tmp_path / "lrn.zip"))
    x = np.random.default_rng(1).standard_normal((3, 8, 8, 3)).astype(
        np.float32)
    plan = aot.configure(cache_dir=aot_plan_dir)
    engine = InferenceEngine.from_package(pkg)
    with CaptureWatcher() as watcher:
        out = engine.apply(x)
    assert watcher.graph_count == 1 and engine.aot_misses == 1
    lrn_ops.reset_launches()
    assert np.array_equal(engine.apply(x), out)
    assert lrn_ops.LAUNCHES["lrn_fwd"] == 1
    record = unpack_record(plan.cache.get(engine._fingerprint(),
                                          "forward/4x8x8x3"))
    assert record["launches"] == {"lrn_fwd": 1} and record["captured"]
    assert record["kernels"] == {"lrn": _build.library_key("lrn")}
    assert _build.toolchain()["capability"] == "sm_90"
    aot.configure(cache_dir=aot_plan_dir)
    again = InferenceEngine.from_package(pkg)
    again.input_hint = None
    assert aot.warm_engine(again) == 1 and again.aot_hits == 1
    assert np.array_equal(again.apply(x), out)


def test_aot_kernel_dir_builds_once_then_loads(cuda, tmp_path, monkeypatch):
    """Libraries under a chosen directory: built by nvcc once, then
    found (no nvcc) by a process that has not counted them."""
    from veles_tpu_torch.analysis.recompile import CaptureWatcher
    from veles_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "_COUNTED", set())
    _build.set_library_dir(str(tmp_path / "kernels"))
    try:
        with CaptureWatcher() as cold:
            path = _build.build(["rng"])["rng"]
        assert os.path.dirname(path) == str(tmp_path / "kernels")
        assert cold.fresh_build_count == 1
        _build._COUNTED.clear()
        with CaptureWatcher() as warm:
            assert _build.build(["rng"])["rng"] == path
        assert warm.fresh_build_count == 0 and warm.cached_build_count == 1
    finally:
        _build.set_library_dir(None)


def test_aot_lm_step_record_and_planned_run_bitwise(cuda, aot_plan_dir):
    """A captured LM step's record holds one replay's K1-K3 tally; a
    trainer under the plan takes bitwise the unplanned trainer's
    steps."""
    from veles_tpu_torch import aot
    from veles_tpu_torch.aot.export import (transformer_trainer_fingerprint,
                                            unpack_record)
    from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerTrainer)
    config = TransformerConfig(vocab=64, embed=64, heads=2, layers=2,
                               seq_len=64, compute="bfloat16")
    tokens = np.random.default_rng(2).integers(0, 64, (2, 2, 65))
    plain = TransformerTrainer(config, seed=4)
    want = plain.step_many(tokens)["loss"].cpu()
    plan = aot.configure(cache_dir=aot_plan_dir)
    planned = TransformerTrainer(config, seed=4)
    got = planned.step_many(tokens)["loss"].cpu()
    assert torch.equal(got, want)
    from veles_tpu_torch.aot.export import _tree_leaves
    for a, b in zip(_tree_leaves([plain.params, plain.opt_m]),
                    _tree_leaves([planned.params, planned.opt_m])):
        assert torch.equal(a, b)
    record = unpack_record(plan.cache.get(
        transformer_trainer_fingerprint(planned), "lm_step_many/2x65"))
    assert record["launches"] == {"flash_bwd_dkv": 2, "flash_bwd_dq": 2,
                                  "flash_fwd": 4}
    assert sorted(record["kernels"]) == ["flash_bwd", "flash_fwd"]


# ---------------------------------------------------------------------------
# the memory plan against the card, and the kernel builds' locks
# ---------------------------------------------------------------------------

def test_plan_footprint_touches_no_device_memory(cuda):
    """``PagedGenerativeEngine.plan_footprint`` of an engine on the card
    runs on meta shadows: allocated and reserved bytes are unmoved."""
    from veles_tpu_torch.aot import registry
    from veles_tpu_torch.models.transformer import init_params
    from veles_tpu_torch.serve import PagedGenerativeEngine
    config = registry._lm_config()
    engine = PagedGenerativeEngine(config, init_params(config, seed=0),
                                   max_slots=4, page_size=16, device=cuda)
    engine.admit([np.arange(1, 17, dtype=np.int32)])
    torch.cuda.synchronize()
    before = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    plan = engine.plan_footprint()
    assert (torch.cuda.memory_allocated(),
            torch.cuda.memory_reserved()) == before
    assert plan["peak_mb"] >= plan["resident_mb"] > 0


def _registry_names():
    from veles_tpu_torch.aot.registry import canonical_computations
    return [c.name for c in canonical_computations()]


@pytest.mark.parametrize("name", _registry_names())
def test_registry_plan_within_2x_of_the_card(cuda, name):
    """Each registry entry's plan (from a CPU build) against one call of
    the entry built on the card (a captured entry's first call is its
    capture: resident set plus pool), less the cuBLAS workspaces the
    call took: peak within 2x, resident within 1.5x
    (tests/test_memplan.py:563-575's bounds)."""
    import gc

    from veles_tpu_torch.analysis import memplan
    from veles_tpu_torch.aot.registry import canonical_computations
    comp = {c.name: c for c in canonical_computations()}[name]
    fn, args = comp.build("cpu")
    plan = memplan.estimate_callable(fn, args)
    del fn, args
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    fn, args = comp.build("cuda")
    got = memplan.measure_call(fn, args, base=base)
    assert got["peak_net"] / 2 <= plan["peak_bytes"] <= got["peak_net"] * 2, \
        (plan, got)
    assert got["after_net"] / 1.5 <= plan["resident_bytes"] <= \
        got["after_net"] * 1.5, (plan, got)


def test_library_of_a_built_kernel_is_not_held_by_another_build(
        cuda, monkeypatch):
    """A loaded kernel's ``library()`` returns while another kernel's
    build is under way (each build holds its own name's lock)."""
    import threading
    import time

    from veles_tpu_torch.ops import _build
    loaded = _build.library("rng")
    real_build = _build.build
    entered, release = threading.Event(), threading.Event()

    def slow_build(names):
        if names == ["slow_kernel"]:
            entered.set()
            release.wait(60)
            raise RuntimeError("stand-in build")
        return real_build(names)

    monkeypatch.setattr(_build, "build", slow_build)
    errors = []
    thread = threading.Thread(target=lambda: errors.append(
        pytest.raises(RuntimeError, _build.library, "slow_kernel")))
    thread.start()
    try:
        assert entered.wait(60)
        t0 = time.monotonic()
        assert _build.library("rng") is loaded
        assert time.monotonic() - t0 < 1.0
    finally:
        release.set()
        thread.join(60)
    assert errors


def _rest_post(url, rows):
    import json
    import urllib.request
    req = urllib.request.Request(
        url, data=json.dumps({"input": rows.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return np.asarray(json.load(resp)["output"], np.float32)


def test_restful_api_on_the_card_matches_the_cpu(f32_units):
    """``RESTfulAPI.for_workflow`` of a workflow initialized on the card
    serves from an engine on the card, and its replies equal the same
    workflow's on the CPU (same seed, f32 weights) within 2e-2 of their
    scale: the engine computes in bf16 on a CUDA device and in f32 on
    the CPU (``InferenceEngine.from_specs``'s policy), so the bound is
    bf16's."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.restful_api import RESTfulAPI
    x = np.random.default_rng(3).random((5, 28, 28), dtype=np.float32)
    outs = []
    for device in (Device(), Device(backend="cpu")):
        prng.reset()
        wf = _small_mnist()
        wf.initialize(device=device)
        api = RESTfulAPI.for_workflow(wf, max_delay_ms=1.0)
        api.initialize()
        try:
            assert api.engine_.device.type == device.torch_device.type
            outs.append(_rest_post(api.url, x))
        finally:
            api.stop()
    card, cpu = outs
    assert card.shape == (5, 10)
    assert np.abs(card - cpu).max() <= 2e-2 * np.abs(cpu).max()


def test_services_on_a_card_trained_workflow_publish_no_tensor(f32_units,
                                                               tmp_path):
    """The plotters and the status reporter around a workflow trained
    on the card: every spec and every status document is plain JSON
    (the plotters read the decision's host numbers; a tensor would make
    the sink or the reporter raise)."""
    import json

    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.models.mnist import MnistWorkflow
    from veles_tpu_torch.plotting import InlineSink
    from veles_tpu_torch.web_status import WebStatusServer
    prng.reset()
    status = WebStatusServer()
    root.common.web.status_url = status.url
    root.common.web.status_interval = 0.1
    try:
        launcher = Launcher()
        wf = MnistWorkflow(launcher, layers=(32, 10), max_epochs=3,
                           plotters=True,
                           loader_kwargs=dict(n_train=300, n_valid=100,
                                              minibatch_size=50))
        sink = InlineSink()
        try:
            launcher.initialize()
            assert wf.forwards[0].weights.devmem.is_cuda
            wf.graphics_sink_ = sink
            launcher.run()
        finally:
            launcher.stop()
        assert {s["name"] for s in sink.specs} == {"validation_error",
                                                   "confusion"}
        json.dumps(sink.specs)
        (doc,) = status.store.snapshot().values()
        assert "cuda" in doc["device"] and doc["epoch"] is not None
        json.dumps(doc)
    finally:
        root.common.web.status_url = None
        root.common.web.status_interval = 10.0
        status.close()
