"""InputJoiner: concatenation of several input Arrays along the
feature axis, on the device.

Port of ``veles_tpu/input_joiner.py``: one ``torch.cat`` over the
inputs flattened per sample, in the device's precision dtype. Inputs
link as ``input_0 .. input_{n-1}`` attributes.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array, torch_dtype


def _join(dtype: torch.dtype, *inputs: torch.Tensor) -> torch.Tensor:
    flat = [x.reshape(x.shape[0], -1).to(dtype) for x in inputs]
    return torch.cat(flat, dim=1)


class InputJoiner(AcceleratedUnit):
    """kwargs: ``num_inputs``. Set ``input_0``...``input_{n-1}`` via
    link_attrs; output is ``[batch, sum(flat features)]``."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.num_inputs: int = kwargs.pop("num_inputs", 2)
        super().__init__(workflow, **kwargs)
        self.output = Array()
        for i in range(self.num_inputs):
            setattr(self, "input_%d" % i, None)
        self.demand(*("input_%d" % i for i in range(self.num_inputs)))

    @property
    def inputs(self) -> List[Array]:
        return [getattr(self, "input_%d" % i)
                for i in range(self.num_inputs)]

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not all(self.inputs):
            return True  # upstream outputs not allocated yet
        batches = {arr.shape[0] for arr in self.inputs}
        if len(batches) != 1:
            raise ValueError("InputJoiner: batch sizes differ: %s" %
                             batches)
        features = sum(int(np.prod(arr.shape[1:])) for arr in self.inputs)
        self.init_array("output", shape=(batches.pop(), features),
                        dtype=self.device.precision_dtype)
        self._join_ = self.jit(_join, static_argnums=(0,))
        return None

    def run(self) -> None:
        self.output.devmem = self._join_(
            torch_dtype(self.device.precision_dtype),
            *(arr.devmem for arr in self.inputs))
