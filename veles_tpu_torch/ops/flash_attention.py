"""Flash attention: blocked online-softmax attention that never
materializes the ``[B, H, T, T]`` score matrix, its gradient, and its
single-query decode form over a KV slab or through a block table over
a shared page pool.

Port of ``veles_tpu/ops/flash_attention.py`` (forward, backward, slab
decode, paged decode and the speculative verify chunk). Two
implementations per entry, chosen by the tensors' device or by an
explicit ``impl=``:

- ``impl="cuda"``: the hand-written Hopper kernels in ``csrc/``
  (``flash_fwd.cu`` for the forward, ``flash_bwd.cu`` for the dK/dV
  and dQ backward, ``flash_decode.cu`` for slab and paged decode),
  taken for every CUDA tensor. The bf16 forward, dK/dV and dQ kernels
  read their operands through TMA tensor maps whose layout
  :func:`tma_layout` computes. A launch that fails raises; nothing
  falls back.
- ``impl="plain"``: the blocked algorithm in plain PyTorch, op for op
  the JAX package's lax path (``flash_block_update`` looped over K
  tiles, ``_lax_bwd`` for the gradient). It runs for CPU tensors, and
  on the card only when asked for, as the oracle the kernels are
  checked against.

:func:`flash_verify_paged` has no kernel in the JAX package either: it
is the plain blocked path on every device, by the reference's own
choice.

:func:`flash_attention` is differentiable through one
``torch.autograd.Function`` (the reference's ``custom_vjp``) whose
residuals are only ``q, k, v, o, l, m``; the backward recomputes the
score tiles. Shapes follow the repo convention ``[B, T, H, D]``. Every
kernel wrapper counts its launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import math
import struct
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from veles_tpu_torch.ops import _build, launches

#: Default sequence tile of the plain path (the kernels tile on their
#: own: see :data:`TMA_TILES`, per-key for decode).
DEFAULT_BLOCK = 512

#: Default K/V tile of the plain decode path.
DEFAULT_DECODE_BLOCK = 256

#: Widths every kernel (K1-K5) is instantiated for. A head dim d runs
#: on the next width (:func:`kernel_width`), its columns past d read as
#: zeros and never stored.
KERNEL_HEAD_DIMS = (32, 64, 128, 256)

#: The widest head dim a kernel takes: shared memory caps the tiles.
MAX_HEAD_DIM = 256

#: Head dims the kernels take are multiples of this: a bf16 row of TMA
#: (and a 16-byte lane of the decode kernels) is a multiple of 16 bytes.
HEAD_DIM_MULTIPLE = 8

#: Kernel launches since the last :func:`reset_launches`, by kernel.
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dkv": 0,
                            "flash_bwd_dq": 0, "flash_decode": 0,
                            "flash_decode_paged": 0}

#: Keys per block of the decode kernels K4 and K5: the key axis splits
#: into chunks of this many keys counted from key 0, one block per
#: (chunk, head, sequence), whose partial softmax states a second kernel
#: merges in chunk order (``flash_decode.cu`` CHUNK; the kernels refuse
#: another value).
DECODE_CHUNK = 128

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Rows of the TMA boxes of the bf16 Hopper kernels, (query tile, key
#: tile), at instance widths up to 128: K1 (``flash_fwd.cu``) and K3
#: (``flash_bwd.cu``) hold 128 query rows and stream key tiles, K2
#: (``flash_bwd.cu``) holds 128 keys and streams query tiles. The
#: kernels refuse a layout whose box is not their tile.
TMA_TILES = {"flash_fwd": (128, 128), "flash_bwd_dq": (128, 64),
             "flash_bwd_dkv": (64, 128)}

#: The same at width 256, where the card's shared memory and registers
#: hold one 64-row tile a side: K1 and K3 one 64-row consumer
#: warpgroup over 64-key tiles (``FwdTma``, ``DqTma``), K2 64 keys whose
#: two warpgroups split the products (``DkvTma``).
TMA_TILES_256 = {"flash_fwd": (64, 64), "flash_bwd_dq": (64, 64),
                 "flash_bwd_dkv": (64, 64)}

#: The widest TMA swizzle span in bytes: a wider bf16 row loads as
#: several boxes of this many bytes (two at D = 128).
TMA_SWIZZLE_MAX = 128

#: TMA's limit on a global stride, in bytes (exclusive).
TMA_STRIDE_LIMIT = 1 << 40


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_width(d: int) -> int:
    """The instance width head dim ``d`` runs on: the next of
    :data:`KERNEL_HEAD_DIMS` (``flash_common.cuh`` kernel_width), for d a
    multiple of 8 from 8 to 256; 0 for any other d."""
    if d < HEAD_DIM_MULTIPLE or d > MAX_HEAD_DIM or d % HEAD_DIM_MULTIPLE:
        return 0
    return next(w for w in KERNEL_HEAD_DIMS if w >= d)


def tma_tiles(entry: str, width: int):
    """(query tile, key tile) rows of the TMA kernel of ``entry`` at
    instance width ``width``: :data:`TMA_TILES`, or
    :data:`TMA_TILES_256` past 128 columns."""
    return (TMA_TILES_256 if width > 128 else TMA_TILES)[entry]


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


# ---------------------------------------------------------------------------
# plain PyTorch path (the lax formulation of the JAX package)
# ---------------------------------------------------------------------------

def flash_block_update(q, k_blk, v_blk, q_pos, k_pos, m, l, o,
                       causal: bool, kv_len=None):
    """One online-softmax accumulation step against a K/V block.

    q [B,Tq,H,D]; k_blk/v_blk [B,Tk,H,D]; q_pos [Tq]; k_pos [Tk];
    m/l [B,H,Tq] f32; o [B,Tq,H,D] f32. ``kv_len`` masks keys at
    positions >= kv_len: an int for the whole batch, a ``[B]`` tensor
    per sequence, or a ``[B, Tq]`` tensor per query. Returns updated
    (m, l, o); the caller normalizes o by l at the end.
    """
    scale = q.shape[-1] ** -0.5
    # f32 scores/stats regardless of the operand dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_blk.float()) * scale
    mask = None
    if causal:
        mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
    if kv_len is not None:
        kv = torch.as_tensor(kv_len, device=k_pos.device)
        if kv.ndim == 0:
            kmask = (k_pos < kv)[None, None, None, :]
        elif kv.ndim == 1:          # [B] per-sequence cache lengths
            kmask = (k_pos[None, :] < kv[:, None])[:, None, None, :]
        else:                       # [B,Tq] per-query lengths
            kmask = (k_pos[None, None, :] < kv[:, :, None])[:, None]
        mask = kmask if mask is None else mask & kmask
    if mask is not None:
        scores = scores.masked_fill(~mask, -math.inf)
    blk_max = scores.amax(dim=-1)                             # [B,H,Tq]
    new_m = torch.maximum(m, blk_max)
    # -inf rows (nothing attendable yet) must not NaN
    safe_m = torch.where(torch.isfinite(new_m), new_m,
                         torch.zeros_like(new_m))
    p = torch.exp(scores - safe_m[..., None])                 # [B,H,Tq,Tk]
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    finite_m = torch.isfinite(m)
    correction = torch.where(finite_m, torch.exp(m - safe_m),
                             torch.zeros_like(m))
    new_l = l * correction + p.sum(dim=-1)
    o_corr = o * correction.transpose(1, 2)[..., None]
    new_o = o_corr + torch.einsum(
        "bhqk,bkhd->bqhd", p.to(v_blk.dtype).float(), v_blk.float())
    return new_m, new_l, new_o


def _plain_fwd(q, k, v, causal: bool, block_k: int, kv_len: int):
    """Blocked forward over K tiles. Inputs are padded [B,T,H,D];
    returns (o [B,T,H,D] q.dtype, l [B,H,T] f32, m [B,H,T] f32)."""
    b, t, h, _ = q.shape
    dev = q.device
    q_pos = torch.arange(t, device=dev)
    m = torch.full((b, h, t), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=dev)
    o = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    kv = kv_len if kv_len != t else None
    for j in range(t // block_k):
        blk = slice(j * block_k, (j + 1) * block_k)
        k_pos = torch.arange(blk.start, blk.stop, device=dev)
        m, l, o = flash_block_update(q, k[:, blk], v[:, blk], q_pos,
                                     k_pos, m, l, o, causal, kv)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    out = (o / l_safe.transpose(1, 2)[..., None]).to(q.dtype)
    # canonical residual stats: finite m (masked-out rows -> 0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return out, l, m


def _plain_bwd(q, k, v, o, l, m, do, causal: bool, block_k: int,
               kv_len: int):
    """Blocked backward (the reference's ``_lax_bwd``): recomputes
    ``p = exp(s - m) / l`` per K tile from the saved stats, with
    ``di = rowsum(dO * O)`` in f32; never builds the [B,H,T,T] score
    matrix. Inputs are padded [B,T,H,D]; returns (dq, dk, dv) in the
    input dtype. dV takes p in f32, dK and dQ take dS rounded to the
    input dtype, as the reference does."""
    b, t, h, d = q.shape
    dev = q.device
    scale = d ** -0.5
    q_pos = torch.arange(t, device=dev)
    l_inv = torch.where(l > 0, 1.0 / torch.where(l > 0, l,
                                                 torch.ones_like(l)),
                        torch.zeros_like(l))
    dof = do.float()
    di = torch.einsum("bqhd,bqhd->bhq", dof, o.float())
    qf = q.float()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for j in range(t // block_k):
        blk = slice(j * block_k, (j + 1) * block_k)
        k_pos = torch.arange(blk.start, blk.stop, device=dev)
        k_blk, v_blk = k[:, blk].float(), v[:, blk].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk) * scale
        mask = None
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
        if kv_len != t:
            kmask = (k_pos < kv_len)[None, :]
            mask = kmask if mask is None else mask & kmask
        p = torch.exp(s - m[..., None]) * l_inv[..., None]
        if mask is not None:
            p = torch.where(mask[None, None], p, torch.zeros_like(p))
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, dof))
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, v_blk)
        ds = p * (dp - di[..., None]) * scale
        dq = dq + torch.einsum("bhqk,bkhd->bqhd",
                               ds.to(k.dtype).float(), k_blk)
        dks.append(torch.einsum("bhqk,bqhd->bkhd",
                                ds.to(q.dtype).float(), qf))
    return (dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


def _plain_decode(q, k_cache, v_cache, lengths, block_k: int):
    """Blocked single-query decode. q [B,1,H,D]; caches [B,S,H,D] (S a
    multiple of block_k); lengths [B] int32. Returns [B,1,H,D]."""
    b, s, h, _ = k_cache.shape
    dev = q.device
    q_pos = torch.full((1,), s, dtype=torch.int64, device=dev)
    m = torch.full((b, h, 1), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, 1), dtype=torch.float32, device=dev)
    o = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    for j in range(s // block_k):
        blk = slice(j * block_k, (j + 1) * block_k)
        k_pos = torch.arange(blk.start, blk.stop, device=dev)
        m, l, o = flash_block_update(q, k_cache[:, blk], v_cache[:, blk],
                                     q_pos, k_pos, m, l, o, causal=False,
                                     kv_len=lengths)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    return (o / l_safe.transpose(1, 2)[..., None]).to(q.dtype)


def _plain_paged_attend(q, k_pages, v_pages, block_tables, kv_len):
    """Blocked attention over PAGED K/V (the reference's
    ``_lax_paged_attend``): the decode scan with the contiguous slab
    replaced by a per-step page GATHER, so the block table is data.

    q [B,Tq,H,D]; k_pages/v_pages [P,ps,H,D] (the pool, shared by all
    sequences); block_tables [B,n_blk] int page ids in block order:
    out-of-pool ids (the ``P`` sentinel of unallocated blocks) are
    clamped, and whatever they gather is masked by ``kv_len``; kv_len
    [B] (decode) or [B,Tq] (per query, the speculative verify chunk).
    Each step gathers ``max(1, 256 // ps)`` pages where the reference
    gathers one: the same math, only the f32 sums run in a coarser
    order (8 steps at a 2048-token capacity and 16-token pages instead
    of 128). Returns [B,Tq,H,D] in q.dtype.
    """
    b, tq, h, d = q.shape
    p, ps, _, _ = k_pages.shape
    n_blk = block_tables.shape[1]
    dev = q.device
    per_step = max(1, DEFAULT_DECODE_BLOCK // ps)
    q_pos = torch.arange(tq, device=dev)  # causal=False: unused
    m = torch.full((b, h, tq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=dev)
    o = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    safe = torch.clamp(block_tables.long(), 0, p - 1)
    for j0 in range(0, n_blk, per_step):
        ids = safe[:, j0:j0 + per_step]                   # [B,n]
        n = ids.shape[1]
        k_blk = k_pages[ids].reshape(b, n * ps, h, d)
        v_blk = v_pages[ids].reshape(b, n * ps, h, d)
        k_pos = torch.arange(j0 * ps, (j0 + n) * ps, device=dev)
        m, l, o = flash_block_update(q, k_blk, v_blk, q_pos, k_pos,
                                     m, l, o, causal=False, kv_len=kv_len)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    return (o / l_safe.transpose(1, 2)[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_kernel_operands(entry: str, *tensors: torch.Tensor) -> None:
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError("%s kernel takes float32 or bfloat16, got %s"
                         % (entry, dtype))
    d = tensors[0].shape[-1]
    if not kernel_width(d):
        raise ValueError(
            "%s kernel takes head dims that are multiples of %d from %d "
            "to %d (a bf16 row of TMA is a multiple of 16 bytes; shared "
            "memory caps the tiles at %d columns), got %d"
            % (entry, HEAD_DIM_MULTIPLE, HEAD_DIM_MULTIPLE, MAX_HEAD_DIM,
               MAX_HEAD_DIM, d))
    for x in tensors:
        if not x.is_cuda or x.device != dev or x.dtype != dtype:
            raise ValueError("%s kernel operands must share one CUDA "
                             "device and dtype" % entry)
        if x.stride(-1) != 1:
            raise ValueError("%s kernel needs unit stride on the head "
                             "dim, got strides %r" % (entry, x.stride()))


def tma_layout(shape, strides, element_size: int, data_ptr: int,
               box_rows: int, width: Optional[int] = None):
    """The TMA tensor map of one ``[B, T, H, D]`` operand of the bf16
    Hopper kernels, as ``cuTensorMapEncodeTiled`` takes it (the kernels
    encode exactly these values): a tuple of 12 ints, the dims innermost
    first ``(D, H, T, B)``; the byte strides of H, T and B; the box
    ``(columns, 1, box_rows, 1)``, one chunk of the row's columns for one
    head and sequence; and the swizzle span in bytes, ``min(128, row
    bytes)``, which the kernels' shared-memory descriptors assume. A row
    wider than the span loads as several boxes, one per chunk of
    columns. Rows past T, and a box past any edge, load as zeros.

    ``width`` (default D): the row width of the kernel instance that
    reads the operand, at least D. The box and the swizzle are that
    width's; its columns past D load as zeros (D = 80 on the 128-wide
    instance: two boxes of 64 columns, 48 of the second past the row).

    Returns None when TMA cannot read the operand in place, and it must
    be copied: the head dim not at unit stride, a base address or a
    stride not a multiple of 16 bytes, a stride that is not positive or
    not below 2^40 bytes. A dim of size 1 is never stepped, so its
    stride is replaced by the packed one and cannot break the rule.
    """
    b, t, h, d = shape
    sb, st, sh, sd = strides
    if sd != 1 or d * element_size % 16:
        return None
    if b == 1:
        sb = t * h * d
    if t == 1:
        st = h * d
    if h == 1:
        sh = d
    sb, st, sh = sb * element_size, st * element_size, sh * element_size
    if data_ptr % 16 or sb % 16 or st % 16 or sh % 16 or \
            min(sb, st, sh) <= 0 or max(sb, st, sh) >= TMA_STRIDE_LIMIT:
        return None
    width = d if width is None else width
    if width < d:
        raise ValueError("a %d-wide instance cannot read rows of %d"
                         % (width, d))
    swizzle = min(TMA_SWIZZLE_MAX, width * element_size)
    return (d, h, t, b, sh, st, sb, swizzle // element_size, 1, box_rows, 1,
            swizzle)


def _tma_operand(x: torch.Tensor, box_rows: int,
                 width: Optional[int] = None):
    """``x`` and its :func:`tma_layout`; a contiguous copy of ``x`` where
    TMA cannot read it in place."""
    layout = tma_layout(x.shape, x.stride(), x.element_size(),
                        x.data_ptr(), box_rows, width)
    if layout is None:
        x = x.clone(memory_format=torch.contiguous_format)
        layout = tma_layout(x.shape, x.stride(), x.element_size(),
                            x.data_ptr(), box_rows, width)
    return x, layout


def _tma_maps(layouts) -> bytes:
    """The layouts of a launch's operands as one C int64 array (native
    byte order), passed to the C entry as a pointer."""
    flat = sum(layouts, ())
    return struct.pack("=%dq" % len(flat), *flat)


def _tma_operands(entry: str, *xs: torch.Tensor):
    """The bf16 operands q, k, v (and dO) of the TMA kernel of ``entry``,
    each copied where TMA cannot read it in place, and their layouts
    packed for the C entry: q and dO take the query tile's rows, k and v
    the key tile's (:func:`tma_tiles` at the instance width the head dim
    runs on)."""
    width = kernel_width(xs[0].shape[-1])
    rows_q, rows_k = tma_tiles(entry, width)
    rows = (rows_q, rows_k, rows_k, rows_q)
    pairs = [_tma_operand(x, r, width) for x, r in zip(xs, rows)]
    xs, layouts = zip(*pairs)
    return xs, _tma_maps(layouts)


def _fwd_lib() -> ctypes.CDLL:
    lib = _build.library("flash_fwd")
    if lib.veles_flash_fwd.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.veles_flash_fwd.argtypes = (
            [p] * 6 + [i64] * 16 +
            [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_char_p,
             p])
        lib.veles_flash_fwd.restype = ctypes.c_int
        lib.veles_flash_fwd_smem.argtypes = [i64]
        lib.veles_flash_fwd_smem.restype = i64
    return lib


def _decode_lib() -> ctypes.CDLL:
    lib = _build.library("flash_decode")
    if lib.veles_flash_decode.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        tail = [ctypes.c_float, ctypes.c_int, p]
        lib.veles_flash_decode.argtypes = [p] * 6 + [i64] * 15 + tail
        lib.veles_flash_decode.restype = ctypes.c_int
        lib.veles_flash_decode_paged.argtypes = [p] * 7 + [i64] * 18 + tail
        lib.veles_flash_decode_paged.restype = ctypes.c_int
    return lib


def flash_fwd_cuda(q, k, v, causal: bool):
    """K1: the forward kernel on [B,T,H,D] CUDA tensors read in place
    through their strides (no transpose, no padding copy; bf16 through
    TMA tensor maps). Returns (o [B,T,H,D] contiguous, l [B,H,T] f32,
    m [B,H,T] f32)."""
    _check_kernel_operands("flash_fwd", q, k, v)
    maps = None
    if q.dtype == torch.bfloat16:
        (q, k, v), maps = _tma_operands("flash_fwd", q, k, v)
    b, t, h, d = q.shape
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    l = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    lib = _fwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.veles_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            l.data_ptr(), m.data_ptr(), b, t, h, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], int(bool(causal)), d ** -0.5,
            _DTYPE_CODES[q.dtype], maps, stream)
    _build.check(lib, "flash_fwd", rc)
    launches.count(LAUNCHES, "flash_fwd")
    return o, l, m


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.library("flash_bwd")
    if lib.veles_flash_bwd_dkv.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        tail = [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_char_p, p]
        lib.veles_flash_bwd_dkv.argtypes = [p] * 9 + [i64] * 22 + tail
        lib.veles_flash_bwd_dkv.restype = ctypes.c_int
        lib.veles_flash_bwd_dq.argtypes = [p] * 8 + [i64] * 19 + tail
        lib.veles_flash_bwd_dq.restype = ctypes.c_int
        for entry in ("dkv", "dq"):
            smem = getattr(lib, "veles_flash_bwd_%s_smem" % entry)
            smem.argtypes = [i64]
            smem.restype = i64
    return lib


def hopper_smem_bytes(entry: str, d: int) -> int:
    """Dynamic shared memory of the bf16 TMA kernel of ``entry`` (a key
    of :data:`TMA_TILES`) at head dim ``d`` (its instance's width's), in
    bytes (ptxas reports only static shared memory)."""
    if entry not in TMA_TILES:
        raise ValueError("no TMA kernel for %r" % entry)
    lib = _fwd_lib() if entry == "flash_fwd" else _bwd_lib()
    return getattr(lib, "veles_%s_smem" % entry)(d)


def _bwd_operands(entry, q, k, v, do, l, m, di):
    """The checked kernel operands q, k, v, dO of K2/K3 and, at bf16,
    their TMA layouts packed for the C entry (None at f32)."""
    _check_kernel_operands(entry, q, k, v, do)
    b, t, h, _ = q.shape
    if k.shape != q.shape or v.shape != q.shape or do.shape != q.shape:
        raise ValueError("%s kernel needs q, k, v, dO of one [B, T, H, D] "
                         "shape" % entry)
    for x in (l, m, di):
        if x.dtype != torch.float32 or x.device != q.device or \
                tuple(x.shape) != (b, h, t) or not x.is_contiguous():
            raise ValueError("%s kernel needs contiguous f32 l, m, di "
                             "[B, H, T] on the operands' device" % entry)
    if q.dtype != torch.bfloat16:
        return q, k, v, do, None
    (q, k, v, do), maps = _tma_operands(entry, q, k, v, do)
    return q, k, v, do, maps


def flash_bwd_dkv_cuda(q, k, v, do, l, m, di, causal: bool):
    """K2: dK and dV from q, k, v, dO [B,T,H,D] CUDA tensors (read in
    place through their strides; bf16 through TMA tensor maps) and the
    f32 stats l, m, di [B,H,T]. Returns (dk, dv), [B,T,H,D] contiguous
    in the input dtype."""
    q, k, v, do, maps = _bwd_operands("flash_bwd_dkv", q, k, v, do, l, m,
                                      di)
    b, t, h, d = q.shape
    dk = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.veles_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            l.data_ptr(), m.data_ptr(), di.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, t, h, d,
            *(st for x in (q, k, v, do, dk, dv) for st in x.stride()[:3]),
            int(bool(causal)), d ** -0.5, _DTYPE_CODES[q.dtype], maps,
            stream)
    _build.check(lib, "flash_bwd_dkv", rc)
    launches.count(LAUNCHES, "flash_bwd_dkv")
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, do, l, m, di, causal: bool):
    """K3: dQ from the same operands as :func:`flash_bwd_dkv_cuda` (bf16
    read through TMA tensor maps). Returns dq, [B,T,H,D] contiguous in
    the input dtype."""
    q, k, v, do, maps = _bwd_operands("flash_bwd_dq", q, k, v, do, l, m,
                                      di)
    b, t, h, d = q.shape
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.veles_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            l.data_ptr(), m.data_ptr(), di.data_ptr(), dq.data_ptr(),
            b, t, h, d,
            *(st for x in (q, k, v, do, dq) for st in x.stride()[:3]),
            int(bool(causal)), d ** -0.5, _DTYPE_CODES[q.dtype], maps,
            stream)
    _build.check(lib, "flash_bwd_dq", rc)
    launches.count(LAUNCHES, "flash_bwd_dq")
    return dq


def decode_chunks(capacity: int) -> int:
    """Blocks per (head, sequence) of the decode kernels at a cache
    capacity (S, or n_blk * page size): ``ceil(capacity /
    DECODE_CHUNK)``. The grid and the workspace follow from it and from
    B, H and D alone, never from the lengths."""
    return -(-capacity // DECODE_CHUNK)


def kernel_workspace(name: str, b: int, h: int, d: int,
                     capacity: int = 0, t: int = 0) -> int:
    """Device bytes kernel ``name`` allocates that its plain version
    does not (the memory plan adds them where the plain version stands
    in): K4/K5's f32 split partials ``part`` ``[B, H, chunks, W + 2]``
    (``capacity`` = S, or n_blk x page size; W the instance width head
    dim ``d`` runs on, or d itself where no instance takes it), K2/K3's
    ``di = rowsum(dO * O)`` ``[B, H, T]`` f32. K1 adds nothing: its
    ``o``, ``l`` and ``m`` are the plain version's outputs too."""
    if name in ("flash_decode", "flash_decode_paged"):
        width = kernel_width(d) or d
        return b * h * decode_chunks(capacity) * (width + 2) * 4
    if name == "flash_bwd":
        return b * h * t * 4
    return 0


def _decode_operand(x: torch.Tensor) -> torch.Tensor:
    """A cache operand of the decode kernels, which read it 16 bytes at
    a time: ``x`` itself where its base and its strides are multiples of
    16 bytes, else a contiguous copy."""
    es = x.element_size()
    if x.data_ptr() % 16 or any(st * es % 16 for st in x.stride()[:3]):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _check_decode_ints(entry, device, named):
    for name, x, shape in named:
        if x.device != device or x.dtype != torch.int32 or \
                tuple(x.shape) != shape:
            raise ValueError("%s kernel needs int32 %s %r on the cache's "
                             "device" % (entry, name, shape))


def flash_decode_cuda(q, k_cache, v_cache, lengths):
    """K4: the split-key decode kernel. q [B,H,D], caches [B,S,H,D] CUDA
    tensors (unit head-dim stride; a cache with a base or a stride off
    16 bytes is copied); lengths [B] int32 on the same device. One C
    call launches two device kernels (the chunks of :data:`DECODE_CHUNK`
    keys, then their merge) on the current stream, with no host
    synchronisation; the grid and the f32 workspace depend on the shapes
    only, so the call can be captured in a CUDA graph with the lengths
    as data. Returns [B,H,D] contiguous."""
    _check_kernel_operands("flash_decode", q, k_cache, v_cache)
    b, s, h, d = k_cache.shape
    if v_cache.shape != k_cache.shape or tuple(q.shape) != (b, h, d) or \
            not 0 < s < 2 ** 31:
        raise ValueError("flash_decode kernel needs q [B, H, D] and caches "
                         "[B, S, H, D] with 0 < S < 2^31, got %r, %r, %r"
                         % (tuple(q.shape), tuple(k_cache.shape),
                            tuple(v_cache.shape)))
    _check_decode_ints("flash_decode", q.device, [("lengths", lengths,
                                                   (b,))])
    lengths = lengths.contiguous()
    lib = _decode_lib()
    k_cache, v_cache = _decode_operand(k_cache), _decode_operand(v_cache)
    o = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    part = torch.empty((b, h, decode_chunks(s), kernel_width(d) + 2),
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.veles_flash_decode(
            k_cache.data_ptr(), v_cache.data_ptr(), q.data_ptr(),
            lengths.data_ptr(), o.data_ptr(), part.data_ptr(), b, s, h, d,
            *k_cache.stride()[:3], *v_cache.stride()[:3], *q.stride()[:2],
            *o.stride()[:2], DECODE_CHUNK, d ** -0.5,
            _DTYPE_CODES[q.dtype], stream)
    _build.check(lib, "flash_decode", rc)
    launches.count(LAUNCHES, "flash_decode")
    return o


def flash_decode_paged_cuda(q, k_pages, v_pages, block_tables, lengths):
    """K5: the paged decode kernel (K4's chunks, rows and merge, the rows
    read through a block table, so it equals K4 bitwise on the same
    K/V). q [B,H,D], pools [P,ps,H,D] CUDA tensors (ps a power of two;
    strides as K4's caches); block_tables [B,n_blk] int32 page ids (ids
    outside [0, P) are clamped in the kernel); lengths [B] int32,
    clamped to n_blk * ps. Capture-safe as K4 (tables and lengths are
    data). Returns [B,H,D] contiguous."""
    _check_kernel_operands("flash_decode_paged", q, k_pages, v_pages)
    b, h, d = q.shape
    p, ps = k_pages.shape[:2]
    n_blk = block_tables.shape[1]
    if ps < 1 or ps & (ps - 1):
        raise ValueError("flash_decode_paged kernel needs a power-of-two "
                         "page size, got %d" % ps)
    if v_pages.shape != k_pages.shape or k_pages.shape[2:] != (h, d):
        raise ValueError("flash_decode_paged kernel needs q [B, H, D] and "
                         "pools [P, ps, H, D], got %r, %r, %r"
                         % (tuple(q.shape), tuple(k_pages.shape),
                            tuple(v_pages.shape)))
    _check_decode_ints("flash_decode_paged", q.device,
                       [("block_tables", block_tables, (b, n_blk)),
                        ("lengths", lengths, (b,))])
    if n_blk < 1 or p < 1 or n_blk * ps >= 2 ** 31:
        raise ValueError("flash_decode_paged kernel takes a non-empty "
                         "table over a non-empty pool, n_blk * ps below "
                         "2^31, got %d entries of %d over %d pages"
                         % (n_blk, ps, p))
    block_tables = block_tables.contiguous()
    lengths = lengths.contiguous()
    lib = _decode_lib()
    k_pages, v_pages = _decode_operand(k_pages), _decode_operand(v_pages)
    o = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    part = torch.empty((b, h, decode_chunks(n_blk * ps),
                        kernel_width(d) + 2),
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.veles_flash_decode_paged(
            k_pages.data_ptr(), v_pages.data_ptr(), q.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), o.data_ptr(),
            part.data_ptr(), b, p, ps.bit_length() - 1, n_blk, h, d,
            *k_pages.stride()[:3], *v_pages.stride()[:3], *q.stride()[:2],
            block_tables.stride(0), *o.stride()[:2], DECODE_CHUNK,
            d ** -0.5, _DTYPE_CODES[q.dtype], stream)
    _build.check(lib, "flash_decode_paged", rc)
    launches.count(LAUNCHES, "flash_decode_paged")
    return o


# ---------------------------------------------------------------------------
# the differentiable core (the reference's custom_vjp)
# ---------------------------------------------------------------------------

def _core_fwd(q, k, v, causal, block_k, kv_len, impl):
    if impl == "cuda":
        return flash_fwd_cuda(q, k, v, causal)
    return _plain_fwd(q, k, v, causal, block_k, kv_len)


def _core_bwd(q, k, v, o, l, m, do, causal, block_k, kv_len, impl):
    # autograd may hand over an expanded (zero-stride) gradient, e.g.
    # the backward of ``out.sum()``; the kernels read rows in place
    do = do.to(q.dtype).contiguous()
    if impl == "plain":
        launches.note_workspace("flash_bwd", kernel_workspace(
            "flash_bwd", q.shape[0], q.shape[2], q.shape[3],
            t=q.shape[1]))
        return _plain_bwd(q, k, v, o, l, m, do, causal, block_k, kv_len)
    # di = rowsum(dO * O), outside the kernels as in the reference
    di = torch.einsum("bqhd,bqhd->bhq", do.float(),
                      o.float()).contiguous()
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, l, m, di, causal)
    dq = flash_bwd_dq_cuda(q, k, v, do, l, m, di, causal)
    return dq, dk, dv


class _FlashCore(torch.autograd.Function):
    """o, l, m = attention(q, k, v) with the blocked backward. Saves
    only ``q, k, v, o, l, m`` (the reference's residuals); l and m are
    not differentiable. q, k, v may be strided views (of the fused QKV
    projection): their gradients reach the base through autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_k, kv_len, impl):
        o, l, m = _core_fwd(q, k, v, causal, block_k, kv_len, impl)
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.spec = (causal, block_k, kv_len, impl)
        ctx.mark_non_differentiable(l, m)
        return o, l, m

    @staticmethod
    def backward(ctx, do, _dl, _dm):
        q, k, v, o, l, m = ctx.saved_tensors
        dq, dk, dv = _core_bwd(q, k, v, o, l, m, do, *ctx.spec)
        return dq, dk, dv, None, None, None, None


# ---------------------------------------------------------------------------
# public entries
# ---------------------------------------------------------------------------

def flash_attention_fwd(q, k, v, causal: bool = False,
                        block_q: Optional[int] = None,
                        block_k: Optional[int] = None,
                        impl: Optional[str] = None):
    """Blocked online-softmax attention with its residuals.

    q/k/v ``[B, T, H, D]`` (self-attention: equal shapes). Returns
    ``(o [B,T,H,D] q.dtype, l [B,H,T] f32, m [B,H,T] f32)``; ``l`` is
    the unnormalized row sum and ``m`` the row max (0 for a row with
    nothing to attend). ``impl``: "cuda" (the K1 kernel forward, K2
    and K3 backward), "plain", or None = "cuda" for CUDA tensors, else
    "plain". The plain path pads T to ``lcm(block_q, block_k)`` and
    masks the pad keys, as the JAX package does (the pad's gradient is
    sliced off by autograd); the kernels mask the ragged tail
    themselves. ``o`` is differentiable when grad mode is on and an
    input requires grad; otherwise (``torch.inference_mode()``, the
    serving path) nothing is saved for a backward.
    """
    if q.shape != k.shape or q.shape != v.shape or q.ndim != 4:
        raise ValueError("flash_attention is self-attention shaped: "
                         "q/k/v must match [B, T, H, D], got %r/%r/%r"
                         % (tuple(q.shape), tuple(k.shape),
                            tuple(v.shape)))
    impl = _build.resolve_impl(impl, q.device, "flash_attention")
    t = q.shape[1]
    bk, t_pad = t, t
    if impl == "plain":
        bq = min(block_q or DEFAULT_BLOCK, _round_up(t, 8))
        bk = min(block_k or DEFAULT_BLOCK, _round_up(t, 8))
        t_pad = _round_up(t, int(np.lcm(bq, bk)))
    if t_pad != t:
        pad = (0, 0, 0, 0, 0, t_pad - t)
        q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
    args = (q, k, v, bool(causal), bk, t, impl)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        o, l, m = _FlashCore.apply(*args)
    else:
        o, l, m = _core_fwd(*args)
    if t_pad != t:
        return o[:, :t], l[..., :t], m[..., :t]
    return o, l, m


def flash_attention(q, k, v, causal: bool = False,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    impl: Optional[str] = None):
    """:func:`flash_attention_fwd` without the residuals: returns
    ``[B, T, H, D]`` in q.dtype."""
    return flash_attention_fwd(q, k, v, causal, block_q, block_k, impl)[0]


def flash_decode(q, k_cache, v_cache, lengths,
                 block_k: Optional[int] = None,
                 impl: Optional[str] = None):
    """One autoregressive decode step: a single new query per sequence
    attending over its KV cache.

    q ``[B, H, D]``; k_cache/v_cache ``[B, S, H, D]`` slabs;
    ``lengths`` ``[B]`` int32 — valid cache entries per sequence,
    INCLUDING the current token's K/V. Entries at positions >=
    lengths[b] are masked (lengths clamp to S); a sequence with length
    0 returns zeros. Returns ``[B, H, D]`` in q.dtype. ``impl`` as in
    :func:`flash_attention_fwd` ("cuda" runs the K4 kernel).
    """
    if q.ndim != 3:
        raise ValueError("flash_decode q is [B, H, D] (one query per "
                         "sequence), got shape %r" % (tuple(q.shape),))
    if k_cache.shape != v_cache.shape or k_cache.ndim != 4:
        raise ValueError("flash_decode caches are [B, S, H, D], got "
                         "%r/%r" % (tuple(k_cache.shape),
                                    tuple(v_cache.shape)))
    impl = _build.resolve_impl(impl, q.device, "flash_decode")
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=q.device)
    if impl == "cuda":
        return flash_decode_cuda(q, k_cache, v_cache, lengths)
    s = k_cache.shape[1]
    launches.note_workspace("flash_decode", kernel_workspace(
        "flash_decode", q.shape[0], q.shape[1], q.shape[2], capacity=s))
    bk = min(block_k or DEFAULT_DECODE_BLOCK, _round_up(s, 8))
    s_pad = _round_up(s, bk)
    if s_pad != s:
        pad = (0, 0, 0, 0, 0, s_pad - s)
        k_cache, v_cache = F.pad(k_cache, pad), F.pad(v_cache, pad)
    lengths = torch.clamp(lengths, max=s)
    return _plain_decode(q[:, None], k_cache, v_cache, lengths, bk)[:, 0]


def _check_paged(entry, q, k_pages, v_pages, block_tables, q_ndim):
    if q.ndim != q_ndim:
        raise ValueError("%s q is [B, %sH, D], got shape %r"
                         % (entry, "" if q_ndim == 3 else "K1, ",
                            tuple(q.shape)))
    if k_pages.shape != v_pages.shape or k_pages.ndim != 4:
        raise ValueError("%s pages are [P, page_size, H, D], got %r/%r"
                         % (entry, tuple(k_pages.shape),
                            tuple(v_pages.shape)))
    if block_tables.ndim != 2 or block_tables.shape[0] != q.shape[0]:
        raise ValueError("%s block_tables is [B, n_blocks], got %r"
                         % (entry, tuple(block_tables.shape)))


def flash_decode_paged(q, k_pages, v_pages, block_tables, lengths,
                       impl: Optional[str] = None):
    """One autoregressive decode step over PAGED K/V: the paged-
    attention read path. Each sequence's cache is the ordered page list
    ``block_tables[b]`` into the shared ``[P, page_size, H, D]`` pool;
    the table is data, so join, retire and copy-on-write change no
    shape.

    q ``[B, H, D]``; ``lengths`` ``[B]`` int32 valid entries per
    sequence INCLUDING the current token's K/V (clamped to
    ``n_blocks * page_size``); table entries at or past the sequence's
    last block may be the ``P`` sentinel (clamped on gather, masked by
    length). Returns ``[B, H, D]`` in q.dtype. ``impl`` as in
    :func:`flash_decode` ("cuda" runs the K5 kernel).
    """
    _check_paged("flash_decode_paged", q, k_pages, v_pages, block_tables, 3)
    impl = _build.resolve_impl(impl, q.device, "flash_decode_paged")
    n_blk, ps = block_tables.shape[1], k_pages.shape[1]
    lengths = torch.clamp(torch.as_tensor(lengths, dtype=torch.int32,
                                          device=q.device), max=n_blk * ps)
    if impl == "cuda":
        return flash_decode_paged_cuda(
            q, k_pages, v_pages,
            torch.as_tensor(block_tables, dtype=torch.int32,
                            device=q.device), lengths)
    launches.note_workspace("flash_decode_paged", kernel_workspace(
        "flash_decode_paged", q.shape[0], q.shape[1], q.shape[2],
        capacity=n_blk * ps))
    return _plain_paged_attend(q[:, None], k_pages, v_pages,
                               torch.as_tensor(block_tables,
                                               device=q.device),
                               lengths)[:, 0]


def flash_verify_paged(q, k_pages, v_pages, block_tables, kv_len):
    """Speculative-verify attention: a K+1-token query CHUNK per
    sequence over paged K/V, causality expressed as per-query lengths
    (``kv_len[b, i]`` = prefix visible to chunk query i, its own K/V
    included).

    q ``[B, K1, H, D]``; kv_len ``[B, K1]`` int32. Returns
    ``[B, K1, H, D]``. The plain blocked path on every device: the
    JAX package has no kernel for it either ("always the lax blocked
    path": verify runs once per accepted run of tokens, off the
    per-token critical path), so this is the reference's own design,
    not a fallback.
    """
    _check_paged("flash_verify_paged", q, k_pages, v_pages, block_tables, 4)
    n_blk, ps = block_tables.shape[1], k_pages.shape[1]
    kv_len = torch.clamp(torch.as_tensor(kv_len, dtype=torch.int32,
                                         device=q.device), max=n_blk * ps)
    return _plain_paged_attend(q, k_pages, v_pages,
                               torch.as_tensor(block_tables,
                                               device=q.device), kv_len)
