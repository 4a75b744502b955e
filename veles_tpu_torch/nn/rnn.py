"""Recurrent units: the LSTM forward and its gradient-descent twin.

Port of ``veles_tpu/nn/rnn.py``. The reference runs the time recursion
as one ``lax.scan`` and its backward as ``jax.vjp`` through it; the
port projects the input once for all steps (``x @ wx + b``, one
product), then runs the recursion as a Python loop over T with one
``h @ wh`` a step, and takes autograd back through the same loop. Gates
are ordered i, f, g, o. Everything runs at the input's dtype, as the
reference's does (no compute dtype).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.filling import fill_weights


def lstm_scan(x, wx, wh, b, h0=None, c0=None):
    """x [B, T, F] -> (outputs [B, T, H], h_last, c_last); gates ordered
    i, f, g, o; ``h0``/``c0`` default to zeros."""
    batch, steps = x.shape[0], x.shape[1]
    hidden = wh.shape[0]
    xproj = torch.einsum("btf,fg->btg", x, wx) + b      # [B, T, 4H]
    h = x.new_zeros((batch, hidden)) if h0 is None else h0
    c = x.new_zeros((batch, hidden)) if c0 is None else c0
    outs = []
    for t in range(steps):
        gates = xproj[:, t] + h @ wh                     # [B, 4H]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1), h, c


def _lstm_forward(x, wx, wh, b):
    return lstm_scan(x, wx, wh, b)[0]


def _lstm_gd_step(need_err_input: bool, wx, wh, b, vwx, vwh, vb,
                  x, err_output, lr, weight_decay, momentum):
    """Autograd through the recursion, then the momentum update of the
    three arrays in place (weight decay on ``wx`` and ``wh`` only).
    Returns err_input (None unless ``need_err_input``)."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(need_err_input)
        leaves = [p.detach().requires_grad_() for p in (wx, wh, b)]
        out = _lstm_forward(xr, *leaves)
        grads = torch.autograd.grad(
            out, ([xr] if need_err_input else []) + leaves, err_output)
    gwx, gwh, gb = grads[-3:]
    with torch.no_grad():
        vwx.copy_(momentum * vwx - lr * (gwx + weight_decay * wx))
        vwh.copy_(momentum * vwh - lr * (gwh + weight_decay * wh))
        vb.copy_(momentum * vb - lr * gb)
        wx.add_(vwx)
        wh.add_(vwh)
        b.add_(vb)
    return grads[0].contiguous() if need_err_input else None


class LSTM(AcceleratedUnit):
    """LSTM layer unit: input [B, T, F] -> output [B, T, H].

    kwargs: ``hidden`` (H), ``weights_filling``/``weights_stddev``,
    ``forget_bias`` (init of the forget-gate bias, default 1.0).
    """

    EXPORT_UUID = "veles.tpu.lstm"
    MAPPING = "lstm"
    MAPPING_GROUP = "layer"

    def export_spec(self):
        """(props, arrays) of the layer."""
        return ({"hidden": self.hidden},
                {"weights_x": self.weights_x.map_read(),
                 "weights_h": self.weights_h.map_read(),
                 "bias": self.bias.map_read()})

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.hidden: int = kwargs.pop("hidden")
        self.weights_stddev = kwargs.pop("weights_stddev", None)
        self.weights_filling = kwargs.pop("weights_filling", "uniform")
        self.forget_bias: float = kwargs.pop("forget_bias", 1.0)
        prng_stream = kwargs.pop("prng_stream", "default")
        super().__init__(workflow, **kwargs)
        self.input: Optional[Array] = None
        self.output = Array()
        self.weights_x = Array()   # [F, 4H]
        self.weights_h = Array()   # [H, 4H]
        self.bias = Array()        # [4H]
        self.rand = prng.get(prng_stream)
        self.demand("input")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.input:
            return True
        if len(self.input.shape) != 3:
            raise ValueError("LSTM input must be [B, T, F], got %s" %
                             (self.input.shape,))
        batch, t, features = self.input.shape
        h = self.hidden
        dtype = self.device.precision_dtype
        if not self.weights_x or self.weights_x.shape != (features, 4 * h):
            self.init_array("weights_x", data=fill_weights(
                self.rand, (features, 4 * h), self.weights_filling,
                self.weights_stddev).astype(dtype))
            self.init_array("weights_h", data=fill_weights(
                self.rand, (h, 4 * h), self.weights_filling,
                self.weights_stddev).astype(dtype))
            bias = np.zeros(4 * h, dtype=dtype)
            bias[h:2 * h] = self.forget_bias  # forget gate slice
            self.init_array("bias", data=bias)
        else:
            for attr in ("weights_x", "weights_h", "bias"):
                self.init_array(attr)
        self.init_array("output", shape=(batch, t, h), dtype=dtype)
        self._fwd_ = self.jit(_lstm_forward)
        return None

    def run(self) -> None:
        self.output.devmem = self._fwd_(
            self.input.devmem, self.weights_x.devmem,
            self.weights_h.devmem, self.bias.devmem)


class GDLSTM(AcceleratedUnit):
    """Backward twin of :class:`LSTM`: autograd through the recursion
    and SGD with momentum on the weight Arrays it shares with the
    forward unit (``link_attrs``)."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.learning_rate: float = kwargs.pop("learning_rate", 0.01)
        self.weight_decay: float = kwargs.pop("weight_decay", 0.0)
        self.momentum: float = kwargs.pop("momentum", 0.0)
        self.need_err_input: bool = kwargs.pop("need_err_input", True)
        kwargs.setdefault("view_group", "TRAINER")
        super().__init__(workflow, **kwargs)
        self.input: Optional[Array] = None
        self.err_output: Optional[Array] = None
        self.weights_x: Optional[Array] = None
        self.weights_h: Optional[Array] = None
        self.bias: Optional[Array] = None
        self.err_input = Array()
        self.velocity_wx = Array()
        self.velocity_wh = Array()
        self.velocity_b = Array()
        self.demand("input", "err_output", "weights_x", "weights_h",
                    "bias")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.weights_x or not self.err_output:
            return True
        dtype = self.device.precision_dtype
        self.init_array("velocity_wx", shape=self.weights_x.shape,
                        dtype=dtype)
        self.init_array("velocity_wh", shape=self.weights_h.shape,
                        dtype=dtype)
        self.init_array("velocity_b", shape=self.bias.shape, dtype=dtype)
        if self.need_err_input:
            self.init_array("err_input", shape=self.input.shape,
                            dtype=dtype)
        self._step_ = self.jit(_lstm_gd_step, static_argnums=(0,),
                               donate_argnums=(1, 2, 3, 4, 5, 6))
        return None

    def run(self) -> None:
        params = (self.weights_x, self.weights_h, self.bias,
                  self.velocity_wx, self.velocity_wh, self.velocity_b)
        tensors = tuple(arr.devmem for arr in params)
        err_input = self._step_(
            self.need_err_input, *tensors, self.input.devmem,
            self.err_output.devmem, float(self.learning_rate),
            float(self.weight_decay), float(self.momentum))
        # written in place: mark the device copies current
        for arr, t in zip(params, tensors):
            arr.devmem = t
        if self.need_err_input:
            self.err_input.devmem = err_input
