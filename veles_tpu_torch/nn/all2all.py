"""Fully-connected (all-to-all) forward units.

Port of ``veles_tpu/nn/all2all.py``: ``output = act(reshape(x) @ W +
b)`` with the weights stored ``[in, out]`` and the input flattened in
its NHWC order. The product takes both operands rounded to the compute
dtype and accumulates and returns in the weights' dtype, as the
reference's ``jnp.dot(..., preferred_element_type=weights.dtype)``
(:func:`dot`). The softmax layer also keeps the per-sample argmax.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.activation import ACTIVATIONS


def dot(a: torch.Tensor, b: torch.Tensor, compute_dtype: torch.dtype,
        out_dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` of the operands rounded to ``compute_dtype``, summed
    and returned in ``out_dtype`` (bf16 operands, f32 accumulation and
    result: the reference's ``preferred_element_type``)."""
    a = a.to(compute_dtype)
    b = b.to(compute_dtype)
    if compute_dtype != out_dtype:
        a, b = a.to(out_dtype), b.to(out_dtype)
    return a @ b


def _forward(act: str, x, weights, bias, compute_dtype):
    y = dot(x.reshape(x.shape[0], -1), weights, compute_dtype,
            weights.dtype)
    if bias is not None:
        y = y + bias
    return ACTIVATIONS[act](y)


def _forward_softmax_argmax(x, weights, bias, compute_dtype):
    probs = _forward("softmax", x, weights, bias, compute_dtype)
    return probs, probs.argmax(dim=-1).to(torch.int32)


class All2All(AcceleratedUnit):
    """y = act(x @ W + b). Linear activation by default."""

    ACTIVATION = "linear"
    EXPORT_UUID = "veles.tpu.all2all"
    MAPPING = "all2all"
    MAPPING_GROUP = "layer"

    def export_spec(self):
        """(props, arrays) of the layer, the reference's layout."""
        props = {"activation": self.ACTIVATION,
                 "include_bias": bool(self.include_bias),
                 "output_size": self.neurons_number}
        arrays = {"weights": self.weights.map_read()}
        if self.include_bias:
            arrays["bias"] = self.bias.map_read()
        return props, arrays

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.output_sample_shape: Tuple[int, ...] = tuple(
            np.atleast_1d(kwargs.pop("output_sample_shape")))
        self.weights_stddev: Optional[float] = kwargs.pop(
            "weights_stddev", None)
        self.weights_filling: str = kwargs.pop("weights_filling", "uniform")
        self.include_bias: bool = kwargs.pop("include_bias", True)
        prng_stream = kwargs.pop("prng_stream", "default")
        super().__init__(workflow, **kwargs)
        self.input: Optional[Array] = None
        self.output = Array()
        self.weights = Array()
        self.bias = Array()
        self.rand = prng.get(prng_stream)
        self.demand("input")

    @property
    def neurons_number(self) -> int:
        return int(np.prod(self.output_sample_shape))

    def fill_weights(self, shape: Tuple[int, int]) -> np.ndarray:
        from veles_tpu_torch.nn.filling import fill_weights
        return fill_weights(self.rand, shape, self.weights_filling,
                            self.weights_stddev)

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.input:
            return True  # upstream output not allocated yet: requeue
        batch = self.input.shape[0]
        in_size = int(np.prod(self.input.shape[1:]))
        dtype = self.device.precision_dtype
        if not self.weights or self.weights.shape != (in_size,
                                                      self.neurons_number):
            self.init_array(
                "weights",
                data=self.fill_weights((in_size, self.neurons_number))
                .astype(dtype))
            self.init_array(
                "bias", data=np.zeros(self.neurons_number, dtype=dtype))
        else:
            self.init_array("weights")
            self.init_array("bias")
        self.init_array("output", shape=(batch, self.neurons_number),
                        dtype=dtype)
        self._forward_ = self.jit(_forward, static_argnums=(0, 4))
        return None

    def run(self) -> None:
        self.output.devmem = self._forward_(
            self.ACTIVATION, self.input.devmem, self.weights.devmem,
            self.bias.devmem if self.include_bias else None,
            self.device.compute_dtype)


class All2AllTanh(All2All):
    """Scaled-tanh FC layer."""
    ACTIVATION = "tanh"
    MAPPING = "all2all_tanh"


class All2AllRELU(All2All):
    """ReLU FC layer."""
    ACTIVATION = "relu"
    MAPPING = "all2all_relu"


class All2AllSigmoid(All2All):
    """Sigmoid FC layer."""
    ACTIVATION = "sigmoid"
    MAPPING = "all2all_sigmoid"


class All2AllSoftmax(All2All):
    """Softmax output layer: ``output`` holds the class probabilities,
    ``max_idx`` the per-sample argmax."""

    ACTIVATION = "softmax"
    MAPPING = "softmax"

    def __init__(self, workflow, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.max_idx = Array()

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        self.init_array("max_idx", shape=(self.output.shape[0],),
                        dtype=np.int32)
        self._forward_sm_ = self.jit(_forward_softmax_argmax,
                                     static_argnums=(3,))
        return None

    def run(self) -> None:
        probs, idx = self._forward_sm_(
            self.input.devmem, self.weights.devmem,
            self.bias.devmem if self.include_bias else None,
            self.device.compute_dtype)
        self.output.devmem = probs
        self.max_idx.devmem = idx
