"""Gradient-descent units for conv layers.

Port of ``veles_tpu/nn/gd_conv.py``. The reference takes ``jax.vjp`` of
the same linear ``conv_raw`` the forward unit runs; the port takes
autograd through the port's ``conv_raw`` (cuDNN's transposed and
weight-gradient convolutions on the card): err_input and the HWIO
weight gradient in one backward, from the pre-update weights, then the
in-place SGD update of :func:`veles_tpu_torch.nn.gd.sgd_update`.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from veles_tpu_torch.nn.activation import DERIVATIVES
from veles_tpu_torch.nn.conv import as_nhwc, conv_raw
from veles_tpu_torch.nn.gd import GradientDescent, sgd_update


def _gd_conv_step(act: str, need_err_input: bool, include_bias: bool,
                  strides, padding, weights, bias, vel_w, vel_b,
                  x, y, err_output, lr, lr_bias, weight_decay, momentum,
                  compute_dtype, linear=conv_raw):
    """``linear`` is the forward's linear op, ``conv_raw`` or another
    of its signature (``nn/deconv.py``'s ``deconv_raw``)."""
    d = err_output * DERIVATIVES[act](y)
    with torch.enable_grad():
        xr = x.detach().requires_grad_(need_err_input)
        wr = weights.detach().requires_grad_()
        out = linear(xr, wr, None, strides, padding, compute_dtype)
        leaves = (xr, wr) if need_err_input else (wr,)
        grads = torch.autograd.grad(out, leaves, d)
    err_input = grads[0].contiguous() if need_err_input else None
    sgd_update(weights, bias, vel_w, vel_b, grads[-1],
               d.sum(dim=(0, 1, 2)) if include_bias else None, lr,
               lr_bias, weight_decay, momentum)
    return err_input


class GDConv(GradientDescent):
    """Backward twin of :class:`veles_tpu_torch.nn.conv.Conv`; built by
    :func:`veles_tpu_torch.nn.gd.gd_for`, which wires the input, output,
    weights and bias links and copies the geometry."""

    ACTIVATION = "linear"
    #: the step function (a subclass of another linear op swaps it)
    STEP = staticmethod(_gd_conv_step)

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.sliding = tuple(kwargs.pop("sliding", (1, 1)))
        self.strides_hw = (self.sliding[1], self.sliding[0])
        self.padding = kwargs.pop("padding", "VALID")
        super().__init__(workflow, **kwargs)

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        self._step_ = self.jit(
            self.STEP, static_argnums=(0, 1, 2, 3, 4, 16),
            donate_argnums=(5, 6, 7, 8))
        return None

    def run(self) -> None:
        params = self._step_args()
        err_input = self._step_(
            self.ACTIVATION, self.need_err_input, self.include_bias,
            self.strides_hw, self.padding, *params,
            as_nhwc(self.input.devmem), self.output.devmem,
            self.err_output.devmem,
            float(self.learning_rate), float(self.learning_rate_bias),
            float(self.weight_decay), float(self.momentum),
            self.device.compute_dtype)
        self._updated(params)
        if self.need_err_input:
            if tuple(err_input.shape) != tuple(self.input.shape):
                err_input = err_input.reshape(self.input.shape)
            self.err_input.devmem = err_input


class GDConvTanh(GDConv):
    ACTIVATION = "tanh"


class GDConvRELU(GDConv):
    ACTIVATION = "relu"


class GDConvSigmoid(GDConv):
    ACTIVATION = "sigmoid"
