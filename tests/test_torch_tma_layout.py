"""The TMA tensor-map layout of the bf16 Hopper kernels (K1 forward, K2
dK/dV, K3 dQ), computed on the host by ``ops/flash_attention.py:tma_layout`` and
encoded as it is by the kernels: dims, byte strides, boxes and the
alignment rule that decides when an operand is copied. Pure host code,
so it runs on the CPU: the layout's strides must address exactly the
elements the tensor's own strides do."""

import pytest
import torch

from veles_tpu_torch.ops import flash_attention as fa

BF16 = torch.bfloat16


def _elements_through(layout, x):
    """x read back through the layout's dims and byte strides (as TMA
    addresses it from x's base address), from x's own storage."""
    d, h, t, b = layout[:4]
    sh, st, sb = (s // x.element_size() for s in layout[4:7])
    return torch.as_strided(x, (b, t, h, d), (sb, st, sh, 1),
                            x.storage_offset())


@pytest.mark.parametrize("d,swizzle,cols", [(32, 64, 32), (64, 128, 64),
                                            (128, 128, 64)])
def test_contiguous_operand(d, swizzle, cols):
    x = torch.zeros((2, 100, 4, d), dtype=BF16)
    layout = fa.tma_layout(x.shape, x.stride(), 2, x.data_ptr(), 128)
    assert layout == (d, 4, 100, 2, 2 * d, 2 * 4 * d, 2 * 100 * 4 * d,
                      cols, 1, 128, 1, swizzle)
    # a row wider than the swizzle span loads as whole boxes of it
    assert d % layout[7] == 0 and layout[7] * 2 == layout[11]
    y, again = fa._tma_operand(x, 128)
    assert y is x and again == layout


@pytest.mark.parametrize("which", [0, 1, 2])
def test_views_of_a_fused_projection(which):
    """q, k, v as the model passes them: strided views of one
    [B, T, 3, H, D] projection, read in place (no copy)."""
    b, t, h, d = 3, 257, 8, 128
    qkv = torch.randn((b, t, 3, h, d)).to(BF16)
    x = qkv[:, :, which]
    rows = fa.TMA_TILES["flash_fwd"][which > 0]
    layout = fa.tma_layout(x.shape, x.stride(), 2, x.data_ptr(), rows)
    assert layout[:4] == (d, h, t, b)
    assert layout[4:7] == (2 * d, 2 * 3 * h * d, 2 * t * 3 * h * d)
    assert layout[9] == rows
    y, _ = fa._tma_operand(x, rows)
    assert y is x
    assert torch.equal(_elements_through(layout, x), x)


@pytest.mark.parametrize("t", [1, 63, 64, 127, 128, 129, 1000])
def test_ragged_sequence_lengths(t):
    """T is the map's own dim, so a box that runs past T (or past a
    short sequence altogether) loads zeros instead of the next
    sequence's rows; the box keeps the kernel's tile."""
    x = torch.zeros((2, t, 3, 64), dtype=BF16)
    for entry, (rows_q, rows_k) in fa.TMA_TILES.items():
        lq = fa.tma_layout(x.shape, x.stride(), 2, x.data_ptr(), rows_q)
        lk = fa.tma_layout(x.shape, x.stride(), 2, x.data_ptr(), rows_k)
        assert lq[2] == lk[2] == t, entry
        assert (lq[9], lk[9]) == (rows_q, rows_k), entry
        assert lq[4:7] == (128, 128 * 3, 128 * 3 * t)


def test_kernel_tiles_fit_a_box():
    """A TMA box is at most 256 elements a side; each kernel's block
    holds one tile of two 64-row warpgroups (the query tile of K1 and
    K3, the key tile of K2) and streams the other in multiples of 64."""
    for entry, (rows_q, rows_k) in fa.TMA_TILES.items():
        held = rows_k if entry == "flash_bwd_dkv" else rows_q
        assert held == 128, entry
        for rows in (rows_q, rows_k):
            assert 0 < rows <= 256 and rows % 64 == 0, entry


@pytest.mark.parametrize("entry", sorted(fa.TMA_TILES))
def test_kernel_operands_take_their_tiles(entry):
    """The operands of each TMA kernel as its wrapper packs them for the
    C entry: q (and dO) boxed by the query tile, k and v by the key
    tile, in that order; views of one fused projection and a view of a
    wider dO buffer are read in place."""
    b, t, h, d = 2, 130, 4, 64
    qkv = torch.randn((b, t, 3, h, d)).to(BF16)
    wide = torch.randn((b, t, 2, h, d)).to(BF16)
    xs = [qkv[:, :, i] for i in range(3)]
    if entry != "flash_fwd":
        xs.append(wide[:, :, 1])
    out, maps = fa._tma_operands(entry, *xs)
    assert all(y is x for y, x in zip(out, xs))
    values = memoryview(maps).cast("q")
    assert len(values) == 12 * len(xs)
    rows_q, rows_k = fa.TMA_TILES[entry]
    for x, rows, i in zip(xs, (rows_q, rows_k, rows_k, rows_q),
                          range(len(xs))):
        layout = tuple(values[12 * i:12 * i + 12])
        assert layout[9] == rows
        assert torch.equal(_elements_through(layout, x), x)


def test_kernel_operands_copy_only_what_tma_cannot_read():
    """K2's operands with dO 2 bytes off a 16-byte boundary: dO alone is
    copied, and its layout is that of the copy."""
    shape = (2, 70, 2, 32)
    q, k, v = (torch.randn(shape).to(BF16) for _ in range(3))
    flat = torch.randn(2 * 70 * 2 * 32 + 1).to(BF16)
    do = flat[1:].view(shape)
    assert do.data_ptr() % 16 == 2
    out, maps = fa._tma_operands("flash_bwd_dkv", q, k, v, do)
    assert out[0] is q and out[1] is k and out[2] is v
    assert out[3] is not do and torch.equal(out[3], do)
    layout = tuple(memoryview(maps).cast("q")[36:48])
    assert layout == fa.tma_layout(shape, out[3].stride(), 2,
                                   out[3].data_ptr(), 64)


def test_misaligned_base_is_copied():
    flat = torch.randn(2 * 50 * 2 * 64 + 1).to(BF16)
    x = flat[1:].view(2, 50, 2, 64)              # base 2 bytes off
    assert x.data_ptr() % 16 == 2
    assert fa.tma_layout(x.shape, x.stride(), 2, x.data_ptr(), 128) is None
    y, layout = fa._tma_operand(x, 128)
    assert y is not x and torch.equal(y, x) and y.is_contiguous()
    assert layout == (64, 2, 50, 2, 128, 256, 12800, 64, 1, 128, 1, 128)


def test_misaligned_row_stride_is_copied():
    """Rows 72 bytes apart (D = 32 inside a padded 36-wide buffer) break
    the 16-byte stride rule."""
    x = torch.randn((2, 40, 3, 36)).to(BF16)[..., :32]
    assert fa.tma_layout(x.shape, x.stride(), 2, x.data_ptr(), 64) is None
    y, layout = fa._tma_operand(x, 64)
    assert torch.equal(y, x)
    assert layout[4:7] == (64, 192, 7680)


@pytest.mark.parametrize("case", ["expanded", "head_dim_stride"])
def test_unreadable_strides_are_copied(case):
    if case == "expanded":                        # stride 0 on T
        x = torch.randn((2, 1, 4, 64)).to(BF16).expand(2, 9, 4, 64)
    else:                                         # D not at unit stride
        x = torch.randn((2, 9, 64, 4)).to(BF16).transpose(2, 3)
    assert fa.tma_layout(x.shape, x.stride(), 2, x.data_ptr(), 128) is None
    y, layout = fa._tma_operand(x, 128)
    assert torch.equal(y, x) and layout is not None


def test_unit_dims_take_the_packed_stride():
    """A dim of size 1 is never stepped: an odd stride there (as views
    and reshapes may give it) does not force a copy."""
    buf = torch.randn(64 * 3 * 32).to(BF16)
    x = torch.as_strided(buf, (1, 64, 1, 32), (7, 96, 5, 1))
    layout = fa.tma_layout(x.shape, x.stride(), 2, x.data_ptr(), 128)
    assert layout[4:7] == (64, 192, 64 * 64)
    y, _ = fa._tma_operand(x, 128)
    assert y is x


def test_negative_stride_is_refused():
    """TMA steps forward only (PyTorch makes no such view; the rule
    holds for any caller of the layout)."""
    shape = (2, 9, 4, 64)
    assert fa.tma_layout(shape, (-9 * 256, 256, 64, 1), 2, 4096,
                         128) is None
    assert fa.tma_layout(shape, (9 * 256, 256, 64, 1), 2, 4096,
                         128) is not None


def test_stride_limit():
    shape = (2, 4, 2, 64)
    huge = (fa.TMA_STRIDE_LIMIT // 2, 256, 128, 1)
    assert fa.tma_layout(shape, huge, 2, 0, 128) is None
    fits = (fa.TMA_STRIDE_LIMIT // 2 - 8, 256, 128, 1)
    assert fa.tma_layout(shape, fits, 2, 0, 128)[6] == \
        fa.TMA_STRIDE_LIMIT - 16


def test_maps_flatten_for_the_c_entry():
    x = torch.zeros((1, 8, 2, 128), dtype=BF16)
    layouts = [fa.tma_layout(x.shape, x.stride(), 2, x.data_ptr(), rows)
               for rows in (128, 64, 64, 128)]
    maps = fa._tma_maps(layouts)
    assert len(maps) == 4 * 12 * 8
    values = memoryview(maps).cast("q")
    assert tuple(values[12:24]) == layouts[1]


@pytest.mark.parametrize("d,width,cols,swizzle", [
    (8, 32, 32, 64), (48, 64, 64, 128), (80, 128, 64, 128),
    (96, 128, 64, 128), (136, 256, 64, 128), (256, 256, 64, 128)])
def test_padded_head_dims_take_their_width_s_box(d, width, cols, swizzle):
    """A head dim that runs on a wider instance keeps its own dim D in
    the map (so the columns past it load as zeros) and takes the
    instance's box and swizzle: 80 on the 128-wide instance reads two
    boxes of 64 columns, the second 16 in the row and 48 past it."""
    x = torch.zeros((2, 100, 4, d), dtype=BF16)
    assert fa.kernel_width(d) == width
    layout = fa.tma_layout(x.shape, x.stride(), 2, x.data_ptr(), 128,
                           width)
    assert layout == (d, 4, 100, 2, 2 * d, 2 * 4 * d, 2 * 100 * 4 * d,
                      cols, 1, 128, 1, swizzle)
    assert width % cols == 0 and cols * 2 == swizzle
    with pytest.raises(ValueError, match="cannot read rows"):
        fa.tma_layout(x.shape, x.stride(), 2, x.data_ptr(), 128, d - 8)


@pytest.mark.parametrize("d,tiles", [(80, (128, 128)), (96, (128, 128)),
                                     (136, (64, 64)), (256, (64, 64))])
def test_forward_operands_take_the_tiles_of_their_width(d, tiles):
    """K1's operands at a padded and at the widest head dim, views of one
    fused projection read in place: q boxed by the query tile, k and v
    by the key tile of the instance (64 x 64 at 256 columns, where one
    64-row consumer warpgroup fits the card's shared memory and
    registers)."""
    b, t, h = 2, 130, 2
    qkv = torch.randn((b, t, 3, h, d)).to(BF16)
    xs = [qkv[:, :, i] for i in range(3)]
    assert fa.tma_tiles("flash_fwd", fa.kernel_width(d)) == tiles
    out, maps = fa._tma_operands("flash_fwd", *xs)
    assert all(y is x for y, x in zip(out, xs))
    values = memoryview(maps).cast("q")
    width = fa.kernel_width(d)
    for x, rows, i in zip(xs, (tiles[0], tiles[1], tiles[1]), range(3)):
        layout = tuple(values[12 * i:12 * i + 12])
        assert layout[0] == d and layout[9] == rows
        assert layout[7] == min(64, width)
        assert torch.equal(_elements_through(layout, x), x)
    # the backward's tiles change at the same width (64 rows a side)
    for entry in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.tma_tiles(entry, 128) == fa.TMA_TILES[entry]
        assert fa.tma_tiles(entry, 256) == fa.TMA_TILES_256[entry] == \
            (64, 64)
