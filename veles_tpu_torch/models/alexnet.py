"""AlexNet through the unit graph.

Port of ``veles_tpu/models/alexnet.py``: the classic caffe geometry (no
grouped convolutions) as a layer list for
:class:`veles_tpu_torch.models.standard.StandardWorkflow`, trained on
synthetic color images at the real shapes and FLOPs.
"""

from __future__ import annotations

from typing import Any, List

from veles_tpu_torch.loader.datasets import SyntheticColorImagesLoader
from veles_tpu_torch.models.standard import StandardWorkflow


def alexnet_layers(n_classes: int = 1000,
                   dropout: float = 0.5) -> List[dict]:
    return [
        {"type": "conv_relu", "n_kernels": 96, "kx": 11,
         "sliding": (4, 4), "padding": 2},
        {"type": "lrn"},
        {"type": "max_pooling", "kx": 3, "sliding": (2, 2)},
        {"type": "conv_relu", "n_kernels": 256, "kx": 5, "padding": 2},
        {"type": "lrn"},
        {"type": "max_pooling", "kx": 3, "sliding": (2, 2)},
        {"type": "conv_relu", "n_kernels": 384, "kx": 3, "padding": 1},
        {"type": "conv_relu", "n_kernels": 384, "kx": 3, "padding": 1},
        {"type": "conv_relu", "n_kernels": 256, "kx": 3, "padding": 1},
        {"type": "max_pooling", "kx": 3, "sliding": (2, 2)},
        {"type": "all2all_relu", "output_sample_shape": 4096},
        {"type": "dropout", "dropout_ratio": dropout},
        {"type": "all2all_relu", "output_sample_shape": 4096},
        {"type": "dropout", "dropout_ratio": dropout},
        {"type": "softmax", "output_sample_shape": n_classes},
    ]


class AlexNetWorkflow(StandardWorkflow):
    """AlexNet on 224x224x3 synthetic color images (the shapes and
    FLOPs of the ImageNet model)."""

    def __init__(self, workflow=None, n_classes: int = 1000,
                 image_size: int = 224, **kwargs: Any) -> None:
        kwargs.setdefault("layers", alexnet_layers(n_classes))
        kwargs.setdefault("loader_cls", SyntheticColorImagesLoader)
        loader_kwargs = kwargs.setdefault("loader_kwargs", {})
        loader_kwargs.setdefault("image_size", image_size)
        loader_kwargs.setdefault("minibatch_size", 128)
        kwargs.setdefault("learning_rate", 0.01)
        kwargs.setdefault("momentum", 0.9)
        kwargs.setdefault("weight_decay", 5e-4)
        super().__init__(workflow, **kwargs)


def run(load, main):
    from veles_tpu_torch.config import get, root
    load(AlexNetWorkflow, **(get(root.alexnet) or {}))
    main()
