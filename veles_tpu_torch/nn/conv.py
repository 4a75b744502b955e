"""Convolution in the reference's layout: NHWC activations, HWIO
weights, and the convolutional forward units.

Port of ``veles_tpu/nn/conv.py``: ``conv_raw``, ``conv_s2d_raw`` and
the units ``Conv``, ``ConvTanh``, ``ConvRELU`` and ``ConvSigmoid``
(with ``as_nhwc`` and ``normalize_padding``). The product itself is
``torch.nn.functional.conv2d`` (cuDNN on the card), as the reference
leaves it to XLA: the NHWC tensor enters as its NCHW view, which is
channels-last in memory, and the weights are cast and laid out
channels-last in one copy, so cuDNN reads both without a further
transpose and its output comes back as a contiguous NHWC tensor.
Autograd flows through the views, so the weight gradient lands in the
HWIO layout. A unit works its output shape out by arithmetic
(:func:`conv_output_hw`), where the reference traces the function.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.activation import ACTIVATIONS
from veles_tpu_torch.nn.filling import fill_weights


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


def _conv_forward(act: str, strides, padding, groups, x, weights, bias,
                  compute_dtype):
    return ACTIVATIONS[act](
        conv_raw(x, weights, bias, strides, padding, compute_dtype,
                 groups=groups))


def as_nhwc(x):
    """[B,H,W] -> [B,H,W,1]; NHWC passes through."""
    return x.reshape(tuple(x.shape) + (1,)) if x.ndim == 3 else x


def normalize_padding(padding):
    """User padding forms -> the lax form: int, (px, py),
    ((py, py), (px, px)) or SAME/VALID strings."""
    if isinstance(padding, int):
        padding = ((padding, padding), (padding, padding))
    elif isinstance(padding, (tuple, list)) and \
            isinstance(padding[0], int):
        # (px, py) user convention -> ((py, py), (px, px)): conv dims
        # are (H, W) and kx/px are the W (x) direction.
        px, py = padding
        padding = ((py, py), (px, px))
    elif isinstance(padding, str):
        return padding.upper()
    return tuple(tuple(p) for p in padding)


def conv_output_hw(h: int, w: int, ky: int, kx: int, strides,
                   padding) -> Tuple[int, int]:
    """The output (H, W) of :func:`conv_raw` on an [*, h, w, *] input
    with a ky x kx kernel, ``strides`` (sh, sw) and lax-form
    ``padding``."""
    if isinstance(padding, str):
        if padding == "SAME":
            return -(-h // strides[0]), -(-w // strides[1])
        padding = ((0, 0), (0, 0))
    (pt, pb), (pl, pr) = padding
    return ((h + pt + pb - ky) // strides[0] + 1,
            (w + pl + pr - kx) // strides[1] + 1)


class Conv(AcceleratedUnit):
    """2-D convolution: kwargs ``n_kernels``, ``kx``, ``ky``,
    ``sliding`` (strides ``(sx, sy)``), ``padding`` (int, ``(px, py)``,
    or SAME/VALID), ``n_groups``. The user surface follows the x, y
    convention; H, W ordering is internal (``strides_hw``)."""

    ACTIVATION = "linear"
    EXPORT_UUID = "veles.tpu.conv"
    MAPPING = "conv"
    MAPPING_GROUP = "layer"

    def export_spec(self):
        """(props, arrays) of the layer: HWIO weights as stored; padding
        SAME/VALID or [[ph, ph], [pw, pw]]."""
        padding = self.padding if isinstance(self.padding, str) else \
            [list(p) for p in self.padding]
        props = {"activation": self.ACTIVATION,
                 "strides_hw": list(self.strides_hw),
                 "padding": padding,
                 "include_bias": bool(self.include_bias),
                 "n_kernels": self.n_kernels,
                 "n_groups": self.n_groups,
                 "ky": self.ky, "kx": self.kx}
        arrays = {"weights": self.weights.map_read()}
        if self.include_bias:
            arrays["bias"] = self.bias.map_read()
        return props, arrays

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.n_kernels: int = kwargs.pop("n_kernels")
        #: caffe-style channel groups; weights hold C/groups input
        #: channels per filter
        self.n_groups: int = kwargs.pop("n_groups", 1)
        self.kx: int = kwargs.pop("kx")
        self.ky: int = kwargs.pop("ky", None) or self.kx
        self.sliding: Tuple[int, int] = tuple(
            np.atleast_1d(kwargs.pop("sliding", (1, 1))))
        if len(self.sliding) == 1:
            self.sliding = (self.sliding[0], self.sliding[0])
        self.strides_hw = (self.sliding[1], self.sliding[0])
        self.padding = normalize_padding(kwargs.pop("padding", "VALID"))
        self.weights_stddev = kwargs.pop("weights_stddev", None)
        self.weights_filling = kwargs.pop("weights_filling", "uniform")
        self.include_bias = kwargs.pop("include_bias", True)
        prng_stream = kwargs.pop("prng_stream", "default")
        super().__init__(workflow, **kwargs)
        self.input: Optional[Array] = None
        self.output = Array()
        self.weights = Array()
        self.bias = Array()
        self.rand = prng.get(prng_stream)
        self.demand("input")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.input:
            return True
        in_shape = self.input.shape
        channels = 1 if len(in_shape) == 3 else in_shape[-1]
        if channels % self.n_groups or self.n_kernels % self.n_groups:
            raise ValueError(
                "conv n_groups=%d must divide channels (%d) and "
                "n_kernels (%d)" % (self.n_groups, channels,
                                    self.n_kernels))
        w_shape = (self.ky, self.kx, channels // self.n_groups,
                   self.n_kernels)
        dtype = self.device.precision_dtype
        if not self.weights or self.weights.shape != w_shape:
            fan_in = self.ky * self.kx * channels // self.n_groups
            self.init_array("weights", data=fill_weights(
                self.rand, w_shape, self.weights_filling,
                self.weights_stddev, fan_in=fan_in,
                fan_out=self.n_kernels).astype(dtype))
            self.init_array("bias",
                            data=np.zeros(self.n_kernels, dtype=dtype))
        else:
            self.init_array("weights")
            self.init_array("bias")
        self._forward_ = self.jit(_conv_forward,
                                  static_argnums=(0, 1, 2, 3, 7))
        out_h, out_w = conv_output_hw(in_shape[1], in_shape[2], self.ky,
                                      self.kx, self.strides_hw,
                                      self.padding)
        if out_h < 1 or out_w < 1:
            raise ValueError("conv %s: a %dx%d kernel leaves no output on "
                             "a %s input" % (self.name, self.ky, self.kx,
                                             in_shape))
        self.init_array("output",
                        shape=(in_shape[0], out_h, out_w, self.n_kernels),
                        dtype=dtype)
        return None

    def run(self) -> None:
        self.output.devmem = self._forward_(
            self.ACTIVATION, self.strides_hw, self.padding,
            self.n_groups, as_nhwc(self.input.devmem),
            self.weights.devmem,
            self.bias.devmem if self.include_bias else None,
            self.device.compute_dtype)


class ConvTanh(Conv):
    ACTIVATION = "tanh"
    MAPPING = "conv_tanh"


class ConvRELU(Conv):
    ACTIVATION = "relu"
    MAPPING = "conv_relu"


class ConvSigmoid(Conv):
    ACTIVATION = "sigmoid"
    MAPPING = "conv_sigmoid"
