"""Backward units for pooling layers.

Port of ``veles_tpu/nn/gd_pooling.py``: autograd through the same
``pool_raw`` the forward ran (the reference takes ``jax.vjp``). The max
pool sends each window's error to the window's first maximum in
row-major order, the reference's select-and-scatter rule; the average
spreads it evenly. No parameters: the unit turns err_output into
err_input.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.conv import as_nhwc
from veles_tpu_torch.nn.pooling import pool_raw


def _gd_pool_step(kind: str, ky: int, kx: int, strides, x, err_output):
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        y = pool_raw(kind, ky, kx, strides, xr)
        (dx,) = torch.autograd.grad(y, xr, err_output.reshape(y.shape))
    return dx.contiguous()


class GDPooling(AcceleratedUnit):
    """Built by :func:`veles_tpu_torch.nn.gd.gd_for`; demands ``input``
    and ``err_output``, produces ``err_input``."""

    KIND = "max"
    hide_from_registry = True

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.kx: int = kwargs.pop("kx")
        self.ky: int = kwargs.pop("ky", None) or self.kx
        self.sliding = tuple(kwargs.pop("sliding", (self.kx, self.ky)))
        self.strides_hw = (self.sliding[1], self.sliding[0])
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
        self._step_ = self.jit(_gd_pool_step, static_argnums=(0, 1, 2, 3))
        self.init_array("err_input", shape=self.input.shape,
                        dtype=self.device.precision_dtype)
        return None

    def run(self) -> None:
        err_input = self._step_(
            self.KIND, self.ky, self.kx, self.strides_hw,
            as_nhwc(self.input.devmem), self.err_output.devmem)
        if tuple(err_input.shape) != tuple(self.input.shape):
            err_input = err_input.reshape(self.input.shape)
        self.err_input.devmem = err_input


class GDMaxPooling(GDPooling):
    KIND = "max"
    hide_from_registry = False


class GDAvgPooling(GDPooling):
    KIND = "avg"
    hide_from_registry = False
