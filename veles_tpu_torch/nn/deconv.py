"""Deconvolution (transposed convolution) and depooling units: the
decoder half of a convolutional autoencoder.

Port of ``veles_tpu/nn/deconv.py``. The reference's ``deconv_raw`` is
``jax.lax.conv_transpose`` with the kernel not flipped: a stride-1
correlation of the HWIO kernel (I the deconv's own input channels) over
the input with ``strides - 1`` zeros inserted between its pixels and
padded by ``lax``'s transposed-convolution rules (SAME and VALID name
the forward conv's padding and may pad unevenly; explicit pairs are the
transposed conv's own). The port computes exactly that: the zero
insertion, one ``F.pad`` (negative pads crop), then the port's
stride-1 correlation (:func:`veles_tpu_torch.nn.conv._conv`, cuDNN on
the card). ``torch.nn.functional.conv_transpose2d`` flips the kernel,
reads padding as ``k - 1 - p`` on both sides and takes no uneven pair,
so it is not used. Depooling is the zero-insertion upsample (each input
pixel at the top-left of its window); its backward twin is the strided
slice of the anchors.
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
from veles_tpu_torch.nn.conv import _conv, as_nhwc, normalize_padding
from veles_tpu_torch.nn.filling import fill_weights
from veles_tpu_torch.nn.gd_conv import GDConv, _gd_conv_step


def _transpose_pads(k: int, s: int, padding) -> Tuple[int, int]:
    """(before, after) padding of one spatial dim of the dilated input,
    ``jax.lax.conv_transpose``'s ``_conv_transpose_padding`` for the
    string modes; an explicit pair is used as it is."""
    if padding == "SAME":
        total = k + s - 2
        before = k - 1 if s > k - 1 else -(-total // 2)
    elif padding == "VALID":
        total = k + s - 2 + max(k - s, 0)
        before = k - 1
    else:
        return tuple(padding)
    return before, total - before


def _pads(ky: int, kx: int, strides, padding):
    if isinstance(padding, str):
        if padding not in ("SAME", "VALID"):
            raise ValueError("deconv padding must be SAME, VALID or pairs, "
                             "got %r" % (padding,))
        padding = (padding, padding)
    return (_transpose_pads(ky, strides[0], padding[0]),
            _transpose_pads(kx, strides[1], padding[1]))


def deconv_output_hw(h: int, w: int, ky: int, kx: int, strides,
                     padding) -> Tuple[int, int]:
    """The output (H, W) of :func:`deconv_raw` on an [*, h, w, *] input
    with a ky x kx kernel, ``strides`` (sh, sw) and lax-form
    ``padding``."""
    (pt, pb), (pl, pr) = _pads(ky, kx, strides, padding)
    return ((h - 1) * strides[0] + 1 + pt + pb - ky + 1,
            (w - 1) * strides[1] + 1 + pl + pr - kx + 1)


def _dilate(x, sh: int, sw: int):
    """NHWC ``x`` with ``s - 1`` zeros between neighbouring pixels."""
    if sh == 1 and sw == 1:
        return x
    h, w = x.shape[1], x.shape[2]
    return depool_raw(x, sh, sw)[:, :(h - 1) * sh + 1, :(w - 1) * sw + 1]


def deconv_raw(x, weights, bias, strides, padding, compute_dtype,
               out_dtype: Optional[torch.dtype] = None):
    """Transposed convolution: NHWC ``x``, HWIO ``weights`` (I and O the
    deconv's own input and output channels), operands in the compute
    dtype, the result in ``out_dtype`` (default: the weights' dtype) with
    the bias added in that dtype."""
    ky, kx = weights.shape[0], weights.shape[1]
    (pt, pb), (pl, pr) = _pads(ky, kx, strides, padding)
    xd = _dilate(x.to(compute_dtype), strides[0], strides[1])
    xd = F.pad(xd, (0, 0, pl, pr, pt, pb))
    out_dtype = out_dtype or weights.dtype
    y = _conv(xd, weights.to(compute_dtype), (1, 1),
              ((0, 0), (0, 0))).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y


def _deconv_forward(act: str, strides, padding, x, weights, bias,
                    compute_dtype):
    return ACTIVATIONS[act](
        deconv_raw(x, weights, bias, strides, padding, compute_dtype))


def depool_raw(x, ky: int, kx: int):
    """Zero-insertion upsample by (ky, kx): each input pixel lands at
    the top-left of its window (the adjoint of non-overlapping
    pooling)."""
    b, h, w, c = x.shape
    out = x.new_zeros((b, h, ky, w, kx, c))
    out[:, :, 0, :, 0, :] = x
    return out.reshape(b, h * ky, w * kx, c)


def _depool_bwd(err, ky: int, kx: int):
    """Adjoint of zero-insertion: strided slice of the anchors."""
    return err[:, ::ky, ::kx, :].contiguous()


def _sliding(kwargs) -> Tuple[int, int]:
    sliding = tuple(int(s) for s in np.atleast_1d(
        kwargs.pop("sliding", (1, 1))))
    return (sliding[0], sliding[0]) if len(sliding) == 1 else sliding


class Deconv(AcceleratedUnit):
    """Transposed 2-D convolution: kwargs ``n_kernels`` (output
    channels), ``kx``/``ky``, ``sliding`` (the upsampling factor),
    ``padding`` (SAME/VALID, an int or ``(px, py)``)."""

    ACTIVATION = "linear"
    EXPORT_UUID = "veles.tpu.deconv"
    MAPPING = "deconv"
    MAPPING_GROUP = "layer"

    def export_spec(self):
        """(props, arrays) of the layer. Weights are HWIO as stored (I =
        the deconv's input channels); padding is SAME/VALID or [[ph,
        ph], [pw, pw]] with ``jax.lax.conv_transpose`` semantics (kernel
        not flipped, zero-insertion upsample by ``strides_hw``)."""
        padding = self.padding if isinstance(self.padding, str) else \
            [list(p) for p in self.padding]
        props = {"activation": self.ACTIVATION,
                 "strides_hw": list(self.strides_hw),
                 "padding": padding,
                 "include_bias": bool(self.include_bias),
                 "n_kernels": self.n_kernels,
                 "ky": self.ky, "kx": self.kx}
        arrays = {"weights": self.weights.map_read()}
        if self.include_bias:
            arrays["bias"] = self.bias.map_read()
        return props, arrays

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.n_kernels: int = kwargs.pop("n_kernels")
        self.kx: int = kwargs.pop("kx")
        self.ky: int = kwargs.pop("ky", None) or self.kx
        self.sliding = _sliding(kwargs)
        self.strides_hw = (self.sliding[1], self.sliding[0])
        self.padding = normalize_padding(kwargs.pop("padding", "SAME"))
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
        w_shape = (self.ky, self.kx, channels, self.n_kernels)
        dtype = self.device.precision_dtype
        if not self.weights or self.weights.shape != w_shape:
            fan_in = self.ky * self.kx * channels
            self.init_array("weights", data=fill_weights(
                self.rand, w_shape, self.weights_filling,
                self.weights_stddev, fan_in=fan_in,
                fan_out=self.n_kernels).astype(dtype))
            self.init_array("bias",
                            data=np.zeros(self.n_kernels, dtype=dtype))
        else:
            self.init_array("weights")
            self.init_array("bias")
        self._forward_ = self.jit(_deconv_forward,
                                  static_argnums=(0, 1, 2, 6))
        out_h, out_w = deconv_output_hw(in_shape[1], in_shape[2], self.ky,
                                        self.kx, self.strides_hw,
                                        self.padding)
        if out_h < 1 or out_w < 1:
            raise ValueError("deconv %s: a %dx%d kernel leaves no output "
                             "on a %s input" % (self.name, self.ky,
                                                self.kx, in_shape))
        self.init_array("output",
                        shape=(in_shape[0], out_h, out_w, self.n_kernels),
                        dtype=dtype)
        return None

    def run(self) -> None:
        self.output.devmem = self._forward_(
            self.ACTIVATION, self.strides_hw, self.padding,
            as_nhwc(self.input.devmem), self.weights.devmem,
            self.bias.devmem if self.include_bias else None,
            self.device.compute_dtype)


class DeconvTanh(Deconv):
    ACTIVATION = "tanh"
    MAPPING = "deconv_tanh"


class DeconvRELU(Deconv):
    ACTIVATION = "relu"
    MAPPING = "deconv_relu"


class DeconvSigmoid(Deconv):
    ACTIVATION = "sigmoid"
    MAPPING = "deconv_sigmoid"


def _gd_deconv_step(*args):
    return _gd_conv_step(*args, linear=deconv_raw)


class GDDeconv(GDConv):
    """Backward twin of :class:`Deconv`: :class:`GDConv`'s step through
    :func:`deconv_raw` (autograd from the pre-update weights, the
    reference's ``jax.vjp``; the bias gradient the delta's sum over
    batch and pixels; the in-place SGD update). Built by
    :func:`veles_tpu_torch.nn.gd.gd_for`."""

    STEP = staticmethod(_gd_deconv_step)

    def __init__(self, workflow, **kwargs: Any) -> None:
        kwargs["sliding"] = _sliding(kwargs)
        kwargs["padding"] = normalize_padding(kwargs.pop("padding", "SAME"))
        super().__init__(workflow, **kwargs)


class GDDeconvTanh(GDDeconv):
    ACTIVATION = "tanh"


class GDDeconvRELU(GDDeconv):
    ACTIVATION = "relu"


class GDDeconvSigmoid(GDDeconv):
    ACTIVATION = "sigmoid"


_GD_DECONV_BY_ACTIVATION = {
    "linear": GDDeconv,
    "tanh": GDDeconvTanh,
    "relu": GDDeconvRELU,
    "sigmoid": GDDeconvSigmoid,
}


class Depooling(AcceleratedUnit):
    """Zero-insertion upsample (kwargs ``kx``/``ky``); pairs with a
    matching pooling in the encoder."""

    EXPORT_UUID = "veles.tpu.depooling"
    MAPPING = "depooling"
    MAPPING_GROUP = "layer"

    def export_spec(self):
        """(props, arrays) of the layer."""
        return {"ky": self.ky, "kx": self.kx}, {}

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.kx: int = kwargs.pop("kx")
        self.ky: int = kwargs.pop("ky", None) or self.kx
        super().__init__(workflow, **kwargs)
        self.input: Optional[Array] = None
        self.output = Array()
        self.demand("input")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.input:
            return True
        in_shape = self.input.shape
        x_shape = in_shape if len(in_shape) == 4 else in_shape + (1,)
        b, h, w, c = x_shape
        self.init_array("output",
                        shape=(b, h * self.ky, w * self.kx, c),
                        dtype=self.device.precision_dtype)
        self._fwd_ = self.jit(depool_raw, static_argnums=(1, 2))
        return None

    def run(self) -> None:
        self.output.devmem = self._fwd_(
            as_nhwc(self.input.devmem), self.ky, self.kx)


class GDDepooling(AcceleratedUnit):
    """Backward twin of :class:`Depooling`: the adjoint of the zero
    insertion, a strided slice."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.kx: int = kwargs.pop("kx")
        self.ky: int = kwargs.pop("ky", None) or self.kx
        kwargs.setdefault("view_group", "TRAINER")
        super().__init__(workflow, **kwargs)
        self.input: Optional[Array] = None
        self.err_output: Optional[Array] = None
        self.err_input = Array()
        self.demand("input", "err_output")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.input or not self.err_output:
            return True
        self.init_array("err_input", shape=self.input.shape,
                        dtype=self.device.precision_dtype)
        self._bwd_ = self.jit(_depool_bwd, static_argnums=(1, 2))
        return None

    def run(self) -> None:
        err = self._bwd_(as_nhwc(self.err_output.devmem), self.ky,
                         self.kx)
        if tuple(err.shape) != tuple(self.input.shape):
            err = err.reshape(self.input.shape)
        self.err_input.devmem = err
