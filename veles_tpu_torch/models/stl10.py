"""STL-10-class conv workflow (96 x 96 x 3, 10 classes).

Port of ``veles_tpu/models/stl10.py``: a conv stack with a stride-2
stem, pooling, one FC layer with dropout and a softmax on
:class:`veles_tpu_torch.models.standard.StandardWorkflow`, trained on
the synthetic color images at STL resolution.
"""

from __future__ import annotations

from typing import Any

from veles_tpu_torch.loader.datasets import SyntheticColorImagesLoader
from veles_tpu_torch.models.standard import StandardWorkflow

STL10_LAYERS = [
    {"type": "conv_relu", "n_kernels": 32, "kx": 5, "padding": 2,
     "sliding": (2, 2)},
    {"type": "max_pooling", "kx": 3, "sliding": (2, 2)},
    {"type": "conv_relu", "n_kernels": 64, "kx": 5, "padding": 2},
    {"type": "max_pooling", "kx": 3, "sliding": (2, 2)},
    {"type": "conv_relu", "n_kernels": 128, "kx": 3, "padding": 1},
    {"type": "avg_pooling", "kx": 3, "sliding": (2, 2)},
    {"type": "all2all_relu", "output_sample_shape": 128},
    {"type": "dropout", "dropout_ratio": 0.5},
    {"type": "softmax", "output_sample_shape": 10},
]


class Stl10Workflow(StandardWorkflow):
    def __init__(self, workflow=None, **kwargs: Any) -> None:
        lk = dict(kwargs.pop("loader_kwargs", None) or {})
        lk.setdefault("image_size", 96)
        lk.setdefault("minibatch_size", 50)
        kwargs["loader_kwargs"] = lk
        kwargs.setdefault("layers", STL10_LAYERS)
        kwargs.setdefault("loader_cls", SyntheticColorImagesLoader)
        kwargs.setdefault("learning_rate", 0.02)
        kwargs.setdefault("momentum", 0.9)
        kwargs.setdefault("max_epochs", 10)
        super().__init__(workflow, **kwargs)


def run(load, main):
    from veles_tpu_torch.config import get, root
    load(Stl10Workflow, **(get(root.stl10) or {}))
    main()
