"""Dropout forward and backward units.

Port of ``veles_tpu/nn/dropout.py``. On a TRAIN minibatch the forward
draws one uniform fill of the input's shape from the unit's ``prng``
stream (K8 on the card, the same Philox in plain PyTorch on the CPU,
bitwise equal), keeps the elements where ``fill < keep`` and scales
them by ``1/keep``; the mask is kept for the backward unit. Outside
TRAIN minibatches the output is the input. The reference draws
``jax.random.bernoulli``: the masks differ from its masks, as the
fused trainer's do (ROADMAP.md queue 3, deliberate divergences); at
ratio 0 both are the identity.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.memory import Array


def _dropout_apply(x, fill, keep_prob):
    mask = (fill < keep_prob).to(x.dtype) / keep_prob
    return x * mask, mask


def _mask_mul(err_output, mask):
    return err_output * mask


class Dropout(AcceleratedUnit):
    """kwargs: ``dropout_ratio`` (probability of zeroing)."""

    EXPORT_UUID = "veles.tpu.dropout"
    MAPPING = "dropout"
    MAPPING_GROUP = "layer"

    def export_spec(self):
        """Identity at inference; exported so an inference graph
        mirrors the training graph one to one."""
        return {"dropout_ratio": self.dropout_ratio}, {}

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.dropout_ratio: float = kwargs.pop("dropout_ratio", 0.5)
        prng_stream = kwargs.pop("prng_stream", "dropout")
        super().__init__(workflow, **kwargs)
        self.input: Optional[Array] = None
        self.output = Array()
        self.mask = Array()
        self.minibatch_class: Optional[int] = None  # link from loader
        self.rand = prng.get(prng_stream)
        self.demand("input", "minibatch_class")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.input:
            return True
        self._apply_ = self.jit(_dropout_apply)
        self.init_array("output", shape=self.input.shape,
                        dtype=self.device.precision_dtype)
        return None

    def run(self) -> None:
        if self.minibatch_class == TRAIN:
            x = self.input.devmem
            fill = self.rand.uniform(tuple(x.shape), dtype=torch.float32,
                                     device=x.device)
            out, mask = self._apply_(x, fill, 1.0 - self.dropout_ratio)
            self.output.devmem = out
            self.mask.devmem = mask
        else:
            self.output.devmem = self.input.devmem


class GDDropout(AcceleratedUnit):
    """err_input = err_output * the saved mask. Runs on TRAIN
    minibatches only (gd_skip gates it), so the mask is always the
    current minibatch's."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        kwargs.setdefault("view_group", "TRAINER")
        super().__init__(workflow, **kwargs)
        self.err_output: Optional[Array] = None
        self.mask: Optional[Array] = None
        self.err_input = Array()
        self.demand("err_output", "mask")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.err_output:
            return True
        self._mul_ = self.jit(_mask_mul)
        # allocated, so units linking ("err_output", "err_input") see a
        # shaped Array at their initialize
        self.init_array("err_input", shape=self.err_output.shape,
                        dtype=self.device.precision_dtype)
        return None

    def run(self) -> None:
        self.err_input.devmem = self._mul_(
            self.err_output.devmem, self.mask.devmem)
