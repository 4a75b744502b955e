"""Activation registry: name -> function, and name -> derivative.

Port of ``veles_tpu/nn/activation.py``. ``ACTIVATIONS`` holds the
forward functions (the fused trainer and the forward units call them);
``DERIVATIVES`` holds each one's derivative written in terms of the
layer's *output* y, not its input, as the reference's gradient-descent
units take it (no pre-activation is kept for the backward pass). The
softmax entry's derivative is the identity: the softmax evaluator
already emits the fused softmax + cross-entropy gradient.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _linear(x):
    return x


def _linear_deriv(y):
    return torch.ones_like(y)


def _tanh(x):
    # Scaled tanh (LeCun 1.7159 * tanh(2/3 x)), the reference's form.
    return 1.7159 * torch.tanh(0.6666 * x)


def _tanh_deriv(y):
    # d/dx [a tanh(bx)] = ab (1 - tanh^2) = b/a (a^2 - y^2)
    return (y * y - 1.7159 ** 2) * (-0.6666 / 1.7159)


def _sigmoid_deriv(y):
    return y * (1.0 - y)


def _relu(x):
    # torch.relu's derivative at exactly 0 is 0, as jax.nn.relu's.
    return torch.relu(x)


def _relu_deriv(y):
    return (y > 0).to(y.dtype)


def _softmax(x):
    return torch.softmax(x, dim=-1)


ACTIVATIONS: Dict[str, Callable] = {
    "linear": _linear,
    "tanh": _tanh,
    "sigmoid": torch.sigmoid,
    "relu": _relu,
    "softmax": _softmax,
}

DERIVATIVES: Dict[str, Callable] = {
    "linear": _linear_deriv,
    "tanh": _tanh_deriv,
    "sigmoid": _sigmoid_deriv,
    "relu": _relu_deriv,
    # softmax: gradient fused into the evaluator's err_output
    "softmax": _linear_deriv,
}
