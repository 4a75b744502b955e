"""Pooling (max / average) over NHWC windows, VALID, and its units.

Port of ``veles_tpu/nn/pooling.py``: ``pool_raw`` and the units
``Pooling``, ``MaxPooling`` and ``AvgPooling``. The windows run
through ``torch.nn.functional.max_pool2d`` / ``avg_pool2d`` on the
NCHW view of the NHWC tensor (channels-last in memory). The max pool's
backward routes each window's cotangent to the window's first maximum
in row-major order, which is the reference's select-and-scatter
derivative, ties included (``nn/gd_pooling.py`` takes it). The
reference's ``VELES_POOL_DILATED`` variant (an argmax-gather backward
kept for TPU experiments) is not ported.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch.nn.functional as F

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.conv import as_nhwc


def pool_raw(kind: str, ky: int, kx: int, strides, x):
    """``kind`` "max", or anything else for the average, as the
    reference; x NHWC."""
    xc = x.permute(0, 3, 1, 2)
    if kind == "max":
        y = F.max_pool2d(xc, (ky, kx), tuple(strides))
    else:
        y = F.avg_pool2d(xc, (ky, kx), tuple(strides))
    return y.permute(0, 2, 3, 1)


class Pooling(AcceleratedUnit):
    """kwargs: ``kx``, ``ky`` (window), ``sliding`` ``(sx, sy)``
    (default = the window, i.e. non-overlapping)."""

    KIND = "max"
    EXPORT_UUID = "veles.tpu.pooling"
    hide_from_registry = True

    def export_spec(self):
        """(props, arrays) of the layer."""
        return {"kind": self.KIND, "ky": self.ky, "kx": self.kx,
                "strides_hw": list(self.strides_hw)}, {}

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.kx: int = kwargs.pop("kx")
        self.ky: int = kwargs.pop("ky", None) or self.kx
        sliding = kwargs.pop("sliding", None)
        self.sliding: Tuple[int, int] = tuple(np.atleast_1d(
            sliding)) if sliding is not None else (self.kx, self.ky)
        if len(self.sliding) == 1:
            self.sliding = (self.sliding[0], self.sliding[0])
        self.strides_hw = (self.sliding[1], self.sliding[0])
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
        self._pool_ = self.jit(pool_raw, static_argnums=(0, 1, 2, 3))
        in_shape = self.input.shape
        x_shape = in_shape if len(in_shape) == 4 else in_shape + (1,)
        b, h, w, c = x_shape
        out_h = (h - self.ky) // self.strides_hw[0] + 1
        out_w = (w - self.kx) // self.strides_hw[1] + 1
        self.init_array("output", shape=(b, out_h, out_w, c),
                        dtype=self.device.precision_dtype)
        return None

    def run(self) -> None:
        self.output.devmem = self._pool_(
            self.KIND, self.ky, self.kx, self.strides_hw,
            as_nhwc(self.input.devmem))


class MaxPooling(Pooling):
    KIND = "max"
    MAPPING = "max_pooling"
    MAPPING_GROUP = "layer"
    hide_from_registry = False


class AvgPooling(Pooling):
    KIND = "avg"
    MAPPING = "avg_pooling"
    MAPPING_GROUP = "layer"
    hide_from_registry = False
