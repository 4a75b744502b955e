"""CIFAR-class conv workflow (caffe-style geometry).

Port of ``veles_tpu/models/cifar.py``: a conv stack with pooling and
ReLU on :class:`veles_tpu_torch.models.standard.StandardWorkflow`,
trained on the synthetic color images (32 x 32 x 3, 10 classes).
"""

from __future__ import annotations

from typing import Any

from veles_tpu_torch.loader.datasets import SyntheticColorImagesLoader
from veles_tpu_torch.models.standard import StandardWorkflow

CIFAR_LAYERS = [
    {"type": "conv_relu", "n_kernels": 32, "kx": 5, "padding": 2},
    {"type": "max_pooling", "kx": 3, "sliding": (2, 2)},
    {"type": "conv_relu", "n_kernels": 32, "kx": 5, "padding": 2},
    {"type": "avg_pooling", "kx": 3, "sliding": (2, 2)},
    {"type": "conv_relu", "n_kernels": 64, "kx": 5, "padding": 2},
    {"type": "avg_pooling", "kx": 3, "sliding": (2, 2)},
    {"type": "all2all_relu", "output_sample_shape": 64},
    {"type": "softmax", "output_sample_shape": 10},
]


class CifarWorkflow(StandardWorkflow):
    def __init__(self, workflow=None, **kwargs: Any) -> None:
        kwargs.setdefault("layers", CIFAR_LAYERS)
        kwargs.setdefault("loader_cls", SyntheticColorImagesLoader)
        kwargs.setdefault("learning_rate", 0.05)
        kwargs.setdefault("momentum", 0.9)
        kwargs.setdefault("max_epochs", 10)
        super().__init__(workflow, **kwargs)


def run(load, main):
    from veles_tpu_torch.config import get, root
    load(CifarWorkflow, **(get(root.cifar) or {}))
    main()
