"""LeNet-5-style conv workflow for MNIST-class data.

Port of ``veles_tpu/models/lenet.py``: conv 6@5x5 -> max pool 2 ->
conv 16@5x5 -> max pool 2 -> fc 120 -> fc 84 -> softmax 10 on
:class:`veles_tpu_torch.models.standard.StandardWorkflow`.
"""

from __future__ import annotations

from typing import Any

from veles_tpu_torch.models.standard import StandardWorkflow

LENET_LAYERS = [
    {"type": "conv_tanh", "n_kernels": 6, "kx": 5, "padding": 2},
    {"type": "max_pooling", "kx": 2},
    {"type": "conv_tanh", "n_kernels": 16, "kx": 5},
    {"type": "max_pooling", "kx": 2},
    {"type": "all2all_tanh", "output_sample_shape": 120},
    {"type": "all2all_tanh", "output_sample_shape": 84},
    {"type": "softmax", "output_sample_shape": 10},
]


class LenetWorkflow(StandardWorkflow):
    def __init__(self, workflow=None, **kwargs: Any) -> None:
        kwargs.setdefault("layers", LENET_LAYERS)
        kwargs.setdefault("learning_rate", 0.02)
        kwargs.setdefault("momentum", 0.9)
        kwargs.setdefault("max_epochs", 10)
        super().__init__(workflow, **kwargs)


def run(load, main):
    from veles_tpu_torch.config import get, root
    load(LenetWorkflow, **(get(root.lenet) or {}))
    main()
