"""Ring attention: exact attention over a sequence sharded across the
ranks of a mesh axis, K/V blocks rotating one hop at a time.

Port of ``veles_tpu/parallel/ring_attention.py``. Each rank holds one
sequence chunk of Q, K and V ``[B, T/n, H, D]``; at each of the ring's
``n`` hops it attends its Q chunk to the K/V chunk it holds, then
passes that chunk to its left neighbour (``ppermute``), so every rank
sees every chunk once and the traffic is neighbour to neighbour.

The reference applies the blocked online-softmax update per hop. Here
each hop is one call of the port's flash core, so on CUDA tensors it is
the K1 kernel (``ops/csrc/flash_fwd.cu``) and on CPU tensors the plain
blocked path. Chunks are equal, so every hop is self-attention shaped:

- the hop of the rank's own chunk runs causal (when ``causal``);
- chunks before it run non-causal;
- chunks after it are fully masked and skipped (the reference's masked
  update leaves ``(m, l, o)`` unchanged there).

The hops' ``(o, l, m)`` merge in f32. The backward runs the ring again:
each hop calls the flash core's backward (K2 for dK/dV, K3 for dQ) with
the merged, global ``l`` and ``m`` and ``Di = rowsum(dO * O)`` of the
global output, and each chunk's dK/dV accumulate in f32 as they travel
with it, one hop more bringing them home to its owner.

Rounding. A hop's ``o`` comes back normalized in the input dtype, where
the reference keeps an unnormalized f32 accumulator: in bf16 that adds
one rounding of at most 2^-8 of a hop's output to each merged row, so
the ring's bf16 output is within 2^-8 of ``max |o|`` (plus the final
cast's 2^-8) of an f32-accumulated ring; at f32 the difference is f32
rounding. The hops' dQ, dK and dV come back in the input dtype and are
summed in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from veles_tpu_torch.ops import _build
from veles_tpu_torch.ops.flash_attention import (DEFAULT_BLOCK, _core_bwd,
                                                 _round_up,
                                                 flash_attention_fwd)
from veles_tpu_torch.parallel import collectives


def attention_reference(q, k, v, causal: bool = False):
    """Dense oracle: softmax(q k^T / sqrt(d)) v. Shapes [B, T, H, D];
    scores and softmax in f32 even for bf16 inputs."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=q.device).tril(tk - tq)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def hop_bwd(q, k, v, o, l, m, do, causal, block_k, impl):
    """One hop's (dq, dk, dv) through the flash core's backward with
    external (global) ``l`` and ``m``; the plain path pads T to its
    tile as ``flash_attention_fwd`` does."""
    t = q.shape[1]
    bk, t_pad = t, t
    if impl == "plain":
        bk = min(block_k or DEFAULT_BLOCK, _round_up(t, 8))
        t_pad = _round_up(t, bk)
    if t_pad != t:
        pad = (0, 0, 0, 0, 0, t_pad - t)
        q, k, v, o, do = (F.pad(x, pad) for x in (q, k, v, o, do))
        l, m = F.pad(l, (0, t_pad - t)), F.pad(m, (0, t_pad - t))
    dq, dk, dv = _core_bwd(q, k, v, o, l.contiguous(), m.contiguous(), do,
                           causal, bk, t, impl)
    return dq[:, :t], dk[:, :t], dv[:, :t]


def merge_hop(acc, l_acc, m_acc, o_h, l_h, m_h):
    """Fold one hop's ``(o, l, m)`` (o normalized, in the input dtype;
    l, m f32 ``[B, H, T]``) into the f32 running ``(acc, l, m)``, acc
    unnormalized ``[B, T, H, D]``; -inf in ``m_acc`` marks a row with
    nothing yet. Returns the new ``(acc, l, m)``."""
    new_m = torch.maximum(m_acc, m_h)
    c_acc = torch.where(torch.isfinite(m_acc), torch.exp(m_acc - new_m),
                        torch.zeros_like(m_acc))
    c_h = torch.exp(m_h - new_m) * l_h
    acc = (acc * c_acc.transpose(1, 2)[..., None] +
           o_h.float() * c_h.transpose(1, 2)[..., None])
    return acc, l_acc * c_acc + c_h, new_m


def merged_output(acc, l_acc, m_acc, dtype):
    """(o in ``dtype``, l, m) of the merged hops: o normalized by l,
    and m finite (0 for a row with nothing to attend), as the flash
    core returns them."""
    l_safe = torch.where(l_acc > 0, l_acc, torch.ones_like(l_acc))
    o = (acc / l_safe.transpose(1, 2)[..., None]).to(dtype)
    m = torch.where(torch.isfinite(m_acc), m_acc, torch.zeros_like(m_acc))
    return o, l_acc, m


def _hops(axis, causal):
    """(step, chunk, hop causal or None when skipped) for this rank."""
    n, i = axis.size, axis.index
    for step in range(n):
        j = (i + step) % n
        if not causal or j < i:
            yield step, j, False
        elif j == i:
            yield step, j, True
        else:
            yield step, j, None


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis, causal, impl, block_k):
        n, i = axis.size, axis.index
        left, right = (i - 1) % n, (i + 1) % n
        b, t, h, _ = q.shape
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        l_acc = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
        m_acc = torch.full((b, h, t), float("-inf"), dtype=torch.float32,
                           device=q.device)
        kb, vb = k, v
        for step, _, hop_causal in _hops(axis, causal):
            if hop_causal is not None:
                acc, l_acc, m_acc = merge_hop(
                    acc, l_acc, m_acc, *flash_attention_fwd(
                        q, kb, vb, hop_causal, block_k=block_k, impl=impl))
            if step + 1 < n:
                kb = collectives.exchange(kb, axis, left, right)
                vb = collectives.exchange(vb, axis, left, right)
        o, l_acc, m_acc = merged_output(acc, l_acc, m_acc, q.dtype)
        ctx.save_for_backward(q, k, v, o, l_acc, m_acc)
        ctx.spec = (axis, causal, impl, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors
        axis, causal, impl, block_k = ctx.spec
        n, i = axis.size, axis.index
        left, right = (i - 1) % n, (i + 1) % n
        do = do.to(q.dtype).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dvb = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        for step, _, hop_causal in _hops(axis, causal):
            if hop_causal is not None:
                dq_h, dk_h, dv_h = hop_bwd(q, kb, vb, o, l, m, do,
                                           hop_causal, block_k, impl)
                dq += dq_h.float()
                dkb += dk_h.float()
                dvb += dv_h.float()
            if step + 1 < n:
                kb = collectives.exchange(kb, axis, left, right)
                vb = collectives.exchange(vb, axis, left, right)
            # the gradients travel with their chunk, and one hop more
            # takes them home: after n hops rank i holds chunk i's
            dkb = collectives.exchange(dkb, axis, left, right)
            dvb = collectives.exchange(dvb, axis, left, right)
        return (dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None,
                None, None, None)


def ring_attention_local(q, k, v, axis=None, causal: bool = False,
                         impl: Optional[str] = None,
                         block_k: Optional[int] = None):
    """The per-rank ring: q/k/v are this rank's sequence chunks
    ``[B, T/n, H, D]`` over the mesh axis ``axis`` (a ``Mesh.axis``;
    chunk i on the axis's index i). With ``axis=None`` or an axis of
    one rank it is single-chunk flash attention. ``impl`` as
    ``flash_attention``'s (None: the kernels on CUDA tensors).
    Differentiable; returns the chunk's output in q.dtype."""
    impl = _build.resolve_impl(impl, q.device, "ring_attention")
    if axis is None or axis.size == 1:
        return flash_attention_fwd(q, k, v, causal, block_k=block_k,
                                   impl=impl)[0]
    if q.shape != k.shape or q.shape != v.shape or q.ndim != 4:
        raise ValueError("ring attention is self-attention shaped: q/k/v "
                         "must match [B, T/n, H, D]")
    return _Ring.apply(q, k, v, axis, bool(causal), impl, block_k)


def ring_attention_sharded(q, k, v, mesh, axis: str = "seq",
                           causal: bool = False,
                           impl: Optional[str] = None):
    """q/k/v are the GLOBAL ``[B, T, H, D]`` tensors, the same on every
    rank; the sequence is sharded over the mesh axis ``axis``, the ring
    runs across it, and every rank gets the global output back (an
    invariant all-gather of the chunks: differentiate it once, as one
    device would)."""
    ax = mesh.axis(axis)
    q, k, v = (collectives.shard(torch.as_tensor(x).to(mesh.device), ax, 1)
               for x in (q, k, v))
    out = ring_attention_local(q, k, v, ax, causal, impl)
    return collectives.all_gather_invariant(out, ax, 1)
