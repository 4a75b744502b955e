"""MNIST fully-connected workflow: 784 -> 100 -> 10 softmax.

Port of ``veles_tpu/models/mnist.py``, built on
:class:`veles_tpu_torch.models.standard.StandardWorkflow` over the
synthetic digits (or a local ``mnist.npz``, ``loader/datasets.py``).
"""

from __future__ import annotations

from typing import Any, Sequence

from veles_tpu_torch.models.standard import StandardWorkflow


class MnistWorkflow(StandardWorkflow):
    """The MNIST FC rung of the config ladder."""

    def __init__(self, workflow=None, layers: Sequence[int] = (100, 10),
                 **kwargs: Any) -> None:
        specs = [{"type": "all2all_tanh", "output_sample_shape": n}
                 for n in layers[:-1]]
        specs.append({"type": "softmax",
                      "output_sample_shape": layers[-1]})
        kwargs.setdefault("learning_rate", 0.1)
        kwargs.setdefault("momentum", 0.9)
        kwargs.setdefault("max_epochs", 10)
        kwargs.setdefault("fail_iterations", 25)
        super().__init__(workflow, layers=specs, **kwargs)


def run(load, main):
    """CLI entry convention (``run(load, main)``); kwargs come from the
    ``root.mnist`` config subtree."""
    from veles_tpu_torch.config import get, root
    load(MnistWorkflow, **(get(root.mnist) or {}))
    main()
