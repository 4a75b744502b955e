"""Gradient-descent units for the all2all family, and ``gd_for``.

Port of ``veles_tpu/nn/gd.py``. Each backward unit computes err_input
for the layer before it and applies the SGD update with momentum and
weight decay to the weights it shares with its forward twin (the same
:class:`~veles_tpu_torch.memory.Array` objects, by ``link_attrs``).
The step is one plain function: the derivative from the layer's
output, err_input from the pre-update weights, the weight and bias
gradients (operands in the compute dtype, sums in f32, as the forward's
:func:`~veles_tpu_torch.nn.all2all.dot`), then ``v = momentum v - lr
(g + wd w)``, ``w += v`` written in place on the shared tensors under
``torch.no_grad()``, where the reference donates the buffers to its
jit function.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn import all2all
from veles_tpu_torch.nn.activation import DERIVATIVES
from veles_tpu_torch.nn.all2all import dot


def sgd_update(weights, bias, vel_w, vel_b, grad_w, grad_b, lr, lr_bias,
               weight_decay, momentum) -> None:
    """``v = momentum v - lr (g + wd w)``, ``w += v`` in place (no decay
    on the bias; ``grad_b`` None leaves the bias and its velocity
    alone)."""
    with torch.no_grad():
        grad_w = grad_w + weight_decay * weights
        vel_w.copy_(momentum * vel_w - lr * grad_w)
        weights.add_(vel_w)
        if grad_b is not None:
            vel_b.copy_(momentum * vel_b - lr_bias * grad_b)
            bias.add_(vel_b)


def _gd_step(act: str, need_err_input: bool, include_bias: bool,
             weights, bias, vel_w, vel_b, x, y, err_output,
             lr, lr_bias, weight_decay, momentum, compute_dtype):
    d = err_output * DERIVATIVES[act](y)
    x2 = x.reshape(x.shape[0], -1)
    err_input = None
    if need_err_input:
        # the pre-update weights, as in the reference's backward pass
        err_input = dot(d, weights.T, compute_dtype,
                        weights.dtype).reshape(x.shape)
    grad_w = dot(x2.T, d, compute_dtype, weights.dtype)
    sgd_update(weights, bias, vel_w, vel_b, grad_w,
               d.sum(dim=0) if include_bias else None, lr, lr_bias,
               weight_decay, momentum)
    return err_input


class GradientDescent(AcceleratedUnit):
    """SGD backward unit for a linear all2all layer."""

    ACTIVATION = "linear"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.learning_rate: float = kwargs.pop("learning_rate", 0.01)
        lr_bias = kwargs.pop("learning_rate_bias", None)
        self.learning_rate_bias: float = self.learning_rate \
            if lr_bias is None else lr_bias
        self.weight_decay: float = kwargs.pop("weight_decay", 0.0)
        self.momentum: float = kwargs.pop("momentum", 0.0)
        self.need_err_input: bool = kwargs.pop("need_err_input", True)
        self.include_bias: bool = kwargs.pop("include_bias", True)
        kwargs.setdefault("view_group", "TRAINER")
        super().__init__(workflow, **kwargs)
        # job pieces are the whole parameter state, replaced on apply
        self.job_data_is_param_state = True
        self.input: Optional[Array] = None
        self.output: Optional[Array] = None
        self.err_output: Optional[Array] = None
        self.weights: Optional[Array] = None
        self.bias: Optional[Array] = None
        self.err_input = Array()
        self.velocity_weights = Array()
        self.velocity_bias = Array()
        self.demand("input", "output", "err_output", "weights", "bias")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.weights or not self.err_output:
            return True
        dtype = self.device.precision_dtype
        self.init_array("velocity_weights",
                        shape=self.weights.shape, dtype=dtype)
        self.init_array("velocity_bias",
                        shape=self.bias.shape if self.bias else (1,),
                        dtype=dtype)
        if self.need_err_input:
            self.init_array("err_input", shape=self.input.shape,
                            dtype=dtype)
        self._step_ = self.jit(
            _gd_step, static_argnums=(0, 1, 2, 14),
            donate_argnums=(3, 4, 5, 6))
        return None

    def _step_args(self):
        return (self.weights.devmem, self.bias.devmem,
                self.velocity_weights.devmem, self.velocity_bias.devmem)

    def _updated(self, params) -> None:
        """Mark the parameters written in place as the device's
        (their host copies are stale until ``map_read``)."""
        for arr, t in zip((self.weights, self.bias, self.velocity_weights,
                           self.velocity_bias), params):
            arr.devmem = t

    def run(self) -> None:
        params = self._step_args()
        err_input = self._step_(
            self.ACTIVATION, self.need_err_input, self.include_bias,
            *params, self.input.devmem, self.output.devmem,
            self.err_output.devmem,
            float(self.learning_rate), float(self.learning_rate_bias),
            float(self.weight_decay), float(self.momentum),
            self.device.compute_dtype)
        self._updated(params)
        if self.need_err_input:
            self.err_input.devmem = err_input

    # -- distributed (async data parallelism over the job channel) ---------
    # Each job trains one minibatch on the worker's copy of the
    # parameters; the worker ships its parameters back and the
    # coordinator adopts them. Velocities travel too, so one worker
    # reproduces the standalone trajectory exactly.
    def _param_state(self):
        return {"weights": np.array(self.weights.map_read()),
                "bias": np.array(self.bias.map_read()),
                "velocity_weights": np.array(
                    self.velocity_weights.map_read()),
                "velocity_bias": np.array(self.velocity_bias.map_read())}

    def _apply_param_state(self, data) -> None:
        for attr in ("weights", "bias", "velocity_weights",
                     "velocity_bias"):
            arr = getattr(self, attr)
            arr.reset(data[attr])
            if self.device is not None:
                arr.initialize(self.device)

    def generate_data_for_slave(self, slave=None):
        return self._param_state()

    def apply_data_from_master(self, data) -> None:
        self._apply_param_state(data)

    def generate_data_for_master(self):
        return self._param_state()

    def apply_data_from_slave(self, data, slave=None) -> None:
        self._apply_param_state(data)


class GDTanh(GradientDescent):
    ACTIVATION = "tanh"


class GDRELU(GradientDescent):
    ACTIVATION = "relu"


class GDSigmoid(GradientDescent):
    ACTIVATION = "sigmoid"


class GDSoftmax(GradientDescent):
    """Backward unit for All2AllSoftmax: the evaluator already emitted
    the fused softmax + cross-entropy gradient, so the derivative is
    the identity."""
    ACTIVATION = "softmax"


_GD_BY_ACTIVATION = {
    "linear": GradientDescent,
    "tanh": GDTanh,
    "relu": GDRELU,
    "sigmoid": GDSigmoid,
    "softmax": GDSoftmax,
}


def gd_for(forward, workflow, **kwargs):
    """Construct the matching backward unit for a forward layer unit
    (all2all, conv, pooling, dropout, LRN, deconv, depooling, LSTM) and
    wire the standard links. Parameterless backward units receive only
    the relevant kwargs."""
    from veles_tpu_torch.nn import conv as conv_mod
    from veles_tpu_torch.nn import deconv as deconv_mod
    from veles_tpu_torch.nn import dropout as drop_mod
    from veles_tpu_torch.nn import gd_conv, gd_pooling
    from veles_tpu_torch.nn import pooling as pool_mod
    from veles_tpu_torch.nn.lrn import GDLRNormalizer, LRNormalizerForward
    from veles_tpu_torch.nn.rnn import GDLSTM, LSTM

    name = kwargs.pop("name", None)
    if isinstance(forward, conv_mod.Conv):
        cls = {"linear": gd_conv.GDConv, "tanh": gd_conv.GDConvTanh,
               "relu": gd_conv.GDConvRELU,
               "sigmoid": gd_conv.GDConvSigmoid}[forward.ACTIVATION]
        kwargs.setdefault("include_bias", forward.include_bias)
        unit = cls(workflow, sliding=forward.sliding,
                   padding=forward.padding, name=name, **kwargs)
        unit.link_attrs(forward, "input", "output", "weights", "bias")
    elif isinstance(forward, pool_mod.Pooling):
        cls = gd_pooling.GDMaxPooling if forward.KIND == "max" \
            else gd_pooling.GDAvgPooling
        unit = cls(workflow, kx=forward.kx, ky=forward.ky,
                   sliding=forward.sliding, name=name)
        unit.link_attrs(forward, "input")
    elif isinstance(forward, drop_mod.Dropout):
        unit = drop_mod.GDDropout(workflow, name=name)
        unit.link_attrs(forward, "mask")
    elif isinstance(forward, LRNormalizerForward):
        unit = GDLRNormalizer(workflow, k=forward.k, n=forward.n,
                              alpha=forward.alpha, beta=forward.beta,
                              name=name)
        unit.link_attrs(forward, "input")
    elif isinstance(forward, all2all.All2All):
        cls = _GD_BY_ACTIVATION[forward.ACTIVATION]
        kwargs.setdefault("include_bias", forward.include_bias)
        unit = cls(workflow, name=name, **kwargs)
        unit.link_attrs(forward, "input", "output", "weights", "bias")
    elif isinstance(forward, deconv_mod.Deconv):
        try:
            cls = deconv_mod._GD_DECONV_BY_ACTIVATION[forward.ACTIVATION]
        except KeyError:
            raise TypeError(
                "no GDDeconv variant for activation %r" %
                forward.ACTIVATION) from None
        kwargs.setdefault("include_bias", forward.include_bias)
        unit = cls(workflow, sliding=forward.sliding,
                   padding=forward.padding, name=name, **kwargs)
        unit.link_attrs(forward, "input", "output", "weights", "bias")
    elif isinstance(forward, deconv_mod.Depooling):
        unit = deconv_mod.GDDepooling(workflow, kx=forward.kx,
                                      ky=forward.ky, name=name)
        unit.link_attrs(forward, "input")
    elif isinstance(forward, LSTM):
        unit = GDLSTM(workflow, name=name, **kwargs)
        unit.link_attrs(forward, "input", "weights_x", "weights_h",
                        "bias")
    else:
        raise TypeError("no backward unit known for %r" % (forward,))
    return unit
