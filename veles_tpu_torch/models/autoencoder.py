"""Autoencoder workflows: the MNIST-shaped 784 -> bottleneck -> 784
fully-connected one and the convolutional one (a conv encoder and a
deconv decoder), both trained on the MSE of the reconstruction.

Port of ``veles_tpu/models/autoencoder.py``, built on
:class:`veles_tpu_torch.models.standard.StandardWorkflow` with the MSE
evaluator and decision pair; the target is the input minibatch (linked
to ``loader.minibatch_data``), or the loader's ``minibatch_targets``
where it serves one (``FullBatchImageLoaderMSE``).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from veles_tpu_torch.models.standard import StandardWorkflow
from veles_tpu_torch.nn import DecisionMSE, EvaluatorMSE


class MSEReconstructionMixin:
    """Evaluator/decision pair for reconstruction training: the target
    is the loader's ``minibatch_targets`` when it serves one, else the
    input minibatch itself; improvement is judged on per-sample RMSE."""

    def _build_evaluator_decision(self, max_epochs, fail_iterations):
        self.evaluator = EvaluatorMSE(self)
        self.evaluator.link_attrs(self.forwards[-1], "output")
        target_attr = ("minibatch_targets"
                       if getattr(self.loader, "minibatch_targets", None)
                       is not None else "minibatch_data")
        self.evaluator.link_attrs(self.loader,
                                  ("target", target_attr),
                                  ("batch_size", "minibatch_size"))
        self.evaluator.link_from(self.forwards[-1])

        self.decision = DecisionMSE(self, max_epochs=max_epochs,
                                    fail_iterations=fail_iterations)
        self.decision.link_attrs(
            self.loader, "minibatch_class", "minibatch_size",
            "last_minibatch", "epoch_number", "class_lengths")
        self.decision.link_attrs(self.evaluator, "sum_rmse")
        self.decision.link_from(self.evaluator)


class AutoencoderWorkflow(MSEReconstructionMixin, StandardWorkflow):
    """kwargs: ``layers``, the hidden sizes, e.g. ``(100,)``; the output
    layer (input-sized, linear) is appended from the loader's image
    side (``loader_kwargs["image_size"]``, 28 by default)."""

    def __init__(self, workflow=None, layers: Sequence[int] = (100,),
                 **kwargs: Any) -> None:
        lk = dict(kwargs.get("loader_kwargs") or {})
        kwargs["loader_kwargs"] = lk
        specs = [{"type": "all2all_tanh", "output_sample_shape": n}
                 for n in layers]
        side = lk.get("image_size", 28)
        # a small-stddev reconstruction head: the output starts near
        # zero, the data's own scale
        specs.append({"type": "all2all",
                      "output_sample_shape": int(np.prod((side, side))),
                      "weights_filling": "gaussian",
                      "weights_stddev": 0.01})
        kwargs.setdefault("learning_rate", 0.005)
        kwargs.setdefault("momentum", 0.9)
        kwargs.setdefault("max_epochs", 25)
        super().__init__(workflow, layers=specs, **kwargs)


class ConvAutoencoderWorkflow(MSEReconstructionMixin, StandardWorkflow):
    """Convolutional autoencoder: a conv encoder and a deconv/depooling
    decoder, trained on the MSE of the reconstruction.

    kwargs: ``layers``, a full layer-spec list whose last layer
    reconstructs the input shape (default: a stride-2 conv encoder and
    a stride-2 deconv decoder for 28 x 28 grayscale). The default
    learning rate is the reference's conservative 3e-4: a deconv sums
    overlapping kernel contributions, so its gradients are much larger
    than a fully-connected layer's.
    """

    def __init__(self, workflow=None, layers=None, **kwargs: Any) -> None:
        if layers is None:
            layers = [
                {"type": "conv_relu", "n_kernels": 8, "kx": 3,
                 "padding": 1, "sliding": (2, 2)},      # 28 -> 14
                {"type": "deconv", "n_kernels": 1, "kx": 3,
                 "sliding": (2, 2), "weights_filling": "gaussian",
                 "weights_stddev": 0.02},               # 14 -> 28
            ]
        kwargs.setdefault("learning_rate", 3e-4)
        kwargs.setdefault("momentum", 0.9)
        kwargs.setdefault("max_epochs", 25)
        super().__init__(workflow, layers=layers, **kwargs)


def run(load, main):
    """CLI entry convention (``run(load, main)``); kwargs come from the
    ``root.autoencoder`` config subtree."""
    from veles_tpu_torch.config import get, root
    load(AutoencoderWorkflow, **(get(root.autoencoder) or {}))
    main()
