"""Convolution in the reference's layout: NHWC activations, HWIO
weights.

Port of ``conv_raw`` and ``conv_s2d_raw`` from ``veles_tpu/nn/conv.py``
(the ``Conv`` unit classes wait for the ``nn/`` units, ROADMAP.md
queue 1 item 5). The product itself is ``torch.nn.functional.conv2d``
(cuDNN on the card), as the reference leaves it to XLA: the NHWC
tensor enters as its NCHW view, which is channels-last in memory, and
the weights are cast and laid out channels-last in one copy, so cuDNN
reads both without a further transpose and its output comes back as a
contiguous NHWC tensor.
Autograd flows through the views, so the weight gradient lands in the
HWIO layout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, strides, padding, groups: int = 1):
    """NHWC ``x`` and HWIO ``w``, both in the compute dtype, through
    cuDNN; ``padding`` is the lax form: "VALID", "SAME" or ((top,
    bottom), (left, right)). Returns NHWC in the compute dtype."""
    kh, kw = w.shape[0], w.shape[1]
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            padding = ((0, 0), (0, 0))
        elif padding.upper() == "SAME":
            padding = (_same_pads(x.shape[1], kh, strides[0]),
                       _same_pads(x.shape[2], kw, strides[1]))
        else:
            raise ValueError("conv padding must be VALID, SAME or pairs, "
                             "got %r" % (padding,))
    (pt, pb), (pl, pr) = padding
    xc = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        xc = F.pad(xc, (pl, pr, pt, pb))
        pad = (0, 0)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(xc, wc, None, stride=tuple(strides), padding=pad,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def conv_raw(x, weights, bias, strides, padding, compute_dtype,
             out_dtype: Optional[torch.dtype] = None,
             groups: Optional[int] = None):
    """Linear convolution: operands cast to the compute dtype, result
    cast to ``out_dtype`` (default: the weights' dtype), bias added in
    that dtype. Grouped convolutions: HWIO weights with I = C/groups;
    ``groups=None`` infers the count from the shapes, a given count
    that the shapes contradict raises."""
    if x.shape[-1] % weights.shape[2]:
        raise ValueError(
            "conv: input channels %d not a multiple of the weights' "
            "per-group channels %d" % (x.shape[-1], weights.shape[2]))
    inferred = x.shape[-1] // weights.shape[2]
    if groups is None:
        groups = inferred
    elif groups != inferred:
        raise ValueError(
            "conv: expected %d group(s) but shapes imply %d "
            "(input C=%d, weights I=%d)" %
            (groups, inferred, x.shape[-1], weights.shape[2]))
    out_dtype = out_dtype or weights.dtype
    y = _conv(x.to(compute_dtype), weights.to(compute_dtype), strides,
              padding, groups).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y


def conv_s2d_raw(x, weights, bias, strides, padding, compute_dtype,
                 out_dtype: Optional[torch.dtype] = None):
    """:func:`conv_raw` rewritten through space-to-depth for strided
    few-channel stems (AlexNet conv1): each s x s input patch folds into
    channels and the kernel is zero-padded to a multiple of s and
    re-indexed, giving a stride-1 conv on s*s*C channels with identical
    math. Needs a square stride s > 1 and symmetric padding pairs; the
    reference's choice (for the TPU's 128-wide contraction), kept so the
    op sequence is the reference's."""
    s = strides[0]
    if s != strides[1] or s <= 1:
        raise ValueError("conv_s2d needs a square stride > 1, got %r"
                         % (tuple(strides),))
    (ph, _), (pw, _) = padding
    b_, h_, w_, c = x.shape
    kh, kw, _, n_out = weights.shape
    out_h = (h_ + 2 * ph - kh) // s + 1
    out_w = (w_ + 2 * pw - kw) // s + 1
    kc_h = -(-kh // s)
    kc_w = -(-kw // s)
    pr_h = s * (out_h + kc_h - 1) - h_ - ph
    pr_w = s * (out_w + kc_w - 1) - w_ - pw
    if pr_h < 0 or pr_w < 0:
        # the input reaches past the last window's cells: the rewrite
        # would need a crop, so take the plain conv (as the reference)
        return conv_raw(x, weights, bias, strides, padding,
                        compute_dtype, out_dtype)

    xp = F.pad(x.to(compute_dtype), (0, 0, pw, pr_w, ph, pr_h))
    hc = xp.shape[1] // s
    wc = xp.shape[2] // s
    xp = xp.reshape(b_, hc, s, wc, s, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b_, hc, wc, s * s * c)
    wp = F.pad(weights.to(compute_dtype),
               (0, 0, 0, 0, 0, kc_w * s - kw, 0, kc_h * s - kh))
    wp = wp.reshape(kc_h, s, kc_w, s, c, n_out).permute(
        0, 2, 1, 3, 4, 5).reshape(kc_h, kc_w, s * s * c, n_out)
    out_dtype = out_dtype or weights.dtype
    y = _conv(xp, wp, (1, 1), "VALID").to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y
