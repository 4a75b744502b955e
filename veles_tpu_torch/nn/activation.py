"""Activation registry: name -> function.

Port of ``veles_tpu/nn/activation.py`` trimmed to ``ACTIVATIONS`` (the
output-space derivatives serve the unit graph, a later slice; the
fused trainer differentiates through autograd).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _linear(x):
    return x


def _tanh(x):
    # Scaled tanh (LeCun 1.7159 * tanh(2/3 x)), the reference's form.
    return 1.7159 * torch.tanh(0.6666 * x)


def _relu(x):
    # torch.relu's derivative at exactly 0 is 0, as jax.nn.relu's.
    return torch.relu(x)


def _softmax(x):
    return torch.softmax(x, dim=-1)


ACTIVATIONS: Dict[str, Callable] = {
    "linear": _linear,
    "tanh": _tanh,
    "sigmoid": torch.sigmoid,
    "relu": _relu,
    "softmax": _softmax,
}
