"""The decode kernels' key-axis split (K4 and K5, ``flash_decode.cu``),
modelled in plain PyTorch on the CPU, and the host layout they read
their operands through.

The kernels cut the key axis into chunks of ``DECODE_CHUNK`` keys
counted from key 0, give each chunk a partial softmax state (m, l, o)
and merge the partials in ascending chunk order with
``flash_block_update``'s formula, skipping empty ones. ``split_decode``
below is that algorithm op for op in f32 PyTorch; it is held against
the JAX package's ``flash_decode`` and ``flash_decode_paged`` (lax
path) on the same numpy inputs. Both sides compute the same softmax in
f32 and differ only in how the sums are grouped: 1e-4 absolute on
unit-scale outputs (the port's f32 parity bound), over lengths of 0, on
and around chunk edges, the full capacity, and sentinel table ids.

The operand tests pin what the kernels read in place: caches whose
base and strides are multiples of 16 bytes (the kernels' load width);
any other cache is copied.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

J = importlib.import_module("veles_tpu.ops.flash_attention")
P = importlib.import_module("veles_tpu_torch.ops.flash_attention")

torch.set_num_threads(1)

C = P.DECODE_CHUNK


def split_decode(q, k, v, lengths, chunk):
    """The kernels' split and merge: q [B,H,D]; k, v [B,S,H,D]; lengths
    [B] (clamped to S). Returns [B,H,D] f32."""
    b, s, h, _ = k.shape
    lengths = torch.clamp(torch.as_tensor(lengths), 0, s)
    q_pos = torch.zeros(1, dtype=torch.int64)   # causal=False: unused
    parts = []
    for c0 in range(0, s, chunk):
        k_pos = torch.arange(c0, min(s, c0 + chunk))
        parts.append(P.flash_block_update(
            q[:, None], k[:, k_pos], v[:, k_pos], q_pos, k_pos,
            torch.full((b, h, 1), -math.inf), torch.zeros((b, h, 1)),
            torch.zeros((b, 1) + q.shape[1:]), causal=False,
            kv_len=lengths))
    m = torch.full((b, h, 1), -math.inf)
    l = torch.zeros((b, h, 1))
    o = torch.zeros((b, 1) + q.shape[1:])
    for pm, pl, po in parts:
        live = pl > 0                       # empty partials are skipped
        m_new = torch.where(live, torch.maximum(m, pm), m)
        safe = torch.where(torch.isfinite(m_new), m_new,
                           torch.zeros_like(m_new))
        a = torch.where(torch.isfinite(m), torch.exp(m - safe),
                        torch.zeros_like(m))
        a = torch.where(live, a, torch.ones_like(a))
        w = torch.where(live, torch.exp(pm - safe), torch.zeros_like(pm))
        l = l * a + pl * w
        # an empty partial's o is never read (it may hold 0 * NaN)
        a_o, w_o, live_o = (x.transpose(1, 2)[..., None]
                            for x in (a, w, live))
        o = o * a_o + torch.where(live_o, po * w_o, torch.zeros_like(po))
        m = m_new
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    return (o / l_safe.transpose(1, 2)[..., None])[:, 0]


def gathered(k_pages, table):
    """A pool read through a block table as the kernel reads it (ids
    clamped to the pool): [B, n_blk * ps, H, D]."""
    p, ps, h, d = k_pages.shape
    ids = torch.clamp(torch.as_tensor(table).long(), 0, p - 1)
    return k_pages[ids].reshape(ids.shape[0], -1, h, d)


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


EDGE_LENGTHS = [0, 1, C - 1, C, C + 1, 2 * C + 5, 3 * C + 37]


@pytest.mark.parametrize("chunk", [C, 16])
def test_split_decode_matches_jax(chunk):
    """Lengths of 0, on and around chunk edges and the full ragged
    capacity (S not a multiple of the chunk or of a stage)."""
    rng = np.random.default_rng(chunk)
    b, s, h, d = len(EDGE_LENGTHS), 3 * C + 37, 2, 16
    k, v = _randn(rng, (b, s, h, d)), _randn(rng, (b, s, h, d))
    q = _randn(rng, (b, h, d))
    lengths = np.array(EDGE_LENGTHS, np.int32)
    want = J.flash_decode(*map(jnp.asarray, (q, k, v, lengths)),
                          impl="lax")
    got = split_decode(*map(torch.from_numpy, (q, k, v, lengths)), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert float(got[0].abs().max()) == 0.0


def test_split_decode_matches_the_port_plain_path():
    """The split and the port's plain decode (one online scan over
    256-key tiles) agree within f32 sum order."""
    rng = np.random.default_rng(3)
    b, s, h, d = 4, 5 * C, 3, 32
    k, v = (torch.from_numpy(_randn(rng, (b, s, h, d))) for _ in range(2))
    q = torch.from_numpy(_randn(rng, (b, h, d)))
    lengths = torch.tensor([s, C + 1, 0, 4 * C - 1], dtype=torch.int32)
    torch.testing.assert_close(split_decode(q, k, v, lengths, C),
                               P.flash_decode(q, k, v, lengths),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("ps", [1, 16, 64, 256])
def test_split_paged_decode_matches_jax(ps):
    """The split over a pool read through a scrambled block table (the
    kernel's row address), against the reference's paged decode: pages
    smaller and larger than a stage and than a chunk, sentinel ids past
    each sequence's last block, one length reaching into a sentinel
    block (the id clamps to the pool's last page), a length of 0."""
    rng = np.random.default_rng(ps)
    h, d = 2, 16
    n_blk = max(1, (3 * C + 40) // ps)
    cap = n_blk * ps
    lengths = [0, 1, min(C, cap), min(C + 1, cap), cap, cap - ps // 2 - 1]
    b = len(lengths)
    n_pages = b * n_blk
    kp, vp = _randn(rng, (n_pages, ps, h, d)), _randn(rng, (n_pages, ps,
                                                            h, d))
    ids = rng.permutation(n_pages)
    table = np.full((b, n_blk), n_pages, np.int32)     # the sentinel P
    for i, n in enumerate(lengths):
        used = -(-n // ps)
        if i == b - 1:
            used = max(0, used - 1)                    # reads a sentinel
        table[i, :used] = ids[i * n_blk:i * n_blk + used]
    q = _randn(rng, (b, h, d))
    lens = np.array(lengths, np.int32)
    want = J.flash_decode_paged(*map(jnp.asarray, (q, kp, vp, table, lens)),
                                impl="lax")
    tkp, tvp = torch.from_numpy(kp), torch.from_numpy(vp)
    got = split_decode(torch.from_numpy(q), gathered(tkp, table),
                       gathered(tvp, table), torch.from_numpy(lens), C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert float(got[0].abs().max()) == 0.0


def test_split_is_blind_to_capacity():
    """K5 equals K4 bitwise even where the pool's capacity differs from
    the slab's: chunks are counted from key 0, so the larger capacity
    only adds empty partials, which the merge skips."""
    rng = np.random.default_rng(11)
    b, s, h, d, ps = 4, 3 * C, 2, 16, 16
    k, v = (torch.from_numpy(_randn(rng, (b, s, h, d))) for _ in range(2))
    q = torch.from_numpy(_randn(rng, (b, h, d)))
    lengths = torch.tensor([s, C, 1, 2 * C + 3], dtype=torch.int32)
    n_blk = s // ps + 12           # capacity past S, stale rows as NaN
    pad = n_blk * ps - s
    pool_k = torch.cat([k, torch.full((b, pad, h, d), float("nan"))], 1)
    pool_v = torch.cat([v, torch.full((b, pad, h, d), float("nan"))], 1)
    table = torch.arange(b * n_blk, dtype=torch.int32).reshape(b, n_blk)
    pages_k = pool_k.reshape(b * n_blk, ps, h, d)
    pages_v = pool_v.reshape(b * n_blk, ps, h, d)
    assert P.decode_chunks(n_blk * ps) > P.decode_chunks(s)
    slab = split_decode(q, k, v, lengths, C)
    paged = split_decode(q, gathered(pages_k, table),
                         gathered(pages_v, table), lengths, C)
    assert torch.equal(slab, paged)


# -- the decode kernels' host operands --------------------------------------

def _elements_through(x, y):
    """y's elements read as the kernels address them: base pointer and
    strides (sequence or page, row, head), unit stride on D."""
    return torch.as_strided(y, x.shape, y.stride(), y.storage_offset())


def test_decode_constants():
    """A chunk is a power of two that every instance's stages divide:
    U = 4 rows a group, G = 128 threads / (D / 16-byte lanes) groups."""
    assert C & (C - 1) == 0
    for es in (2, 4):
        for d in P.KERNEL_HEAD_DIMS:
            groups = 128 // (d * es // 16)
            assert C % (4 * groups) == 0


@pytest.mark.parametrize("capacity,chunks", [(1, 1), (C - 1, 1), (C, 1),
                                             (C + 1, 2), (2048, 2048 // C)])
def test_decode_chunks_follow_the_capacity(capacity, chunks):
    assert P.decode_chunks(capacity) == chunks


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_decode_slab_layout(dtype, d):
    """A contiguous slab [B, S, H, D] is read in place: a row is a
    multiple of 16 bytes, so are all its strides."""
    x = torch.zeros((3, 300, 4, d), dtype=dtype)
    es = x.element_size()
    y = P._decode_operand(x)
    assert y is x
    assert all(st * es % 16 == 0 for st in y.stride()[:3])
    assert d * es % 16 == 0
    assert torch.equal(_elements_through(x, y), x)


@pytest.mark.parametrize("ps", [1, 2, 16, 32, 128, 512])
def test_decode_pool_layout(ps):
    """A pool [P, ps, H, D] is read in place as the model passes it: the
    pool minus its trash page, and a strided view of heads."""
    d, h = 64, 2
    pool = torch.zeros((41, ps, h, d), dtype=torch.bfloat16)
    view = pool[:40]
    assert P._decode_operand(view) is view
    wide = torch.zeros((40, ps, 2 * h, d), dtype=torch.bfloat16)
    heads = wide[:, :, h:]                  # base 256 bytes in
    assert P._decode_operand(heads) is heads
    assert torch.equal(_elements_through(heads, P._decode_operand(heads)),
                       heads)


def test_decode_operand_off_16_bytes_is_copied():
    """Rows 72 bytes apart (D = 32 inside a padded 36-wide bf16 buffer)
    break the kernels' 16-byte loads: the cache is copied, and the copy
    is read whole."""
    x = torch.randn((2, 40, 3, 36)).to(torch.bfloat16)[..., :32]
    y = P._decode_operand(x)
    assert y is not x and torch.equal(y, x) and y.is_contiguous()
    assert y.stride()[:3] == (3840, 96, 32)


def test_decode_operand_off_16_byte_base_is_copied():
    """A cache whose base sits 2 bytes into its storage is copied to an
    aligned one; its strides stay those of a contiguous tensor."""
    flat = torch.zeros(2 * 70 * 3 * 64 + 1, dtype=torch.bfloat16)
    odd = flat[1:].view(2, 70, 3, 64)
    y = P._decode_operand(odd)
    assert y is not odd and torch.equal(y, odd)
    assert y.data_ptr() % 16 == 0 and y.stride() == odd.stride()
