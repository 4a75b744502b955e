"""MeanDispNormalizer: the ``(x - mean) * rdisp`` input unit.

Port of ``veles_tpu/mean_disp_normalizer.py``: normalizes each
minibatch against per-feature mean and reciprocal dispersion arrays
(the AlexNet pipeline's input stage), one elementwise expression on
the unit's device, the result in the device's precision dtype.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array, torch_dtype


def _normalize(x: torch.Tensor, mean: torch.Tensor, rdisp: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    return ((x - mean) * rdisp).to(dtype)


class MeanDispNormalizer(AcceleratedUnit):
    """Demands ``input``, ``mean``, ``rdisp`` (link_attrs from the
    loader or set directly as Arrays)."""

    EXPORT_UUID = "veles.tpu.mean_disp"

    def export_spec(self):
        """(props, arrays) for a package export."""
        return {}, {"mean": np.asarray(self.mean.map_read()),
                    "rdisp": np.asarray(self.rdisp.map_read())}

    def __init__(self, workflow, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.input: Optional[Array] = None
        self.mean: Optional[Array] = None
        self.rdisp: Optional[Array] = None
        self.output = Array()
        self.demand("input", "mean", "rdisp")

    @classmethod
    def from_dataset(cls, workflow, dataset: np.ndarray, **kwargs):
        """Compute mean/rdisp over a dataset ``[N, ...]`` up front."""
        unit = cls(workflow, **kwargs)
        mean = dataset.mean(axis=0)
        disp = dataset.max(axis=0) - dataset.min(axis=0)
        with np.errstate(divide="ignore"):
            rdisp = np.where(disp > 0, 1.0 / np.where(disp > 0, disp, 1),
                             1.0)
        unit.mean = Array(data=mean.astype(np.float32))
        unit.rdisp = Array(data=rdisp.astype(np.float32))
        return unit

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.input:
            return True
        for name in ("mean", "rdisp"):
            arr = getattr(self, name)
            if isinstance(arr, Array) and arr.device_ is None:
                arr.initialize(self.device)
        if self.mean.shape != self.input.shape[1:]:
            raise ValueError("mean shape %s != sample shape %s" %
                             (self.mean.shape, self.input.shape[1:]))
        self.init_array("output", shape=self.input.shape,
                        dtype=self.device.precision_dtype)
        self._norm_ = self.jit(_normalize, static_argnums=(3,))
        return None

    def run(self) -> None:
        self.output.devmem = self._norm_(
            self.input.devmem, self.mean.devmem, self.rdisp.devmem,
            torch_dtype(self.device.precision_dtype))
