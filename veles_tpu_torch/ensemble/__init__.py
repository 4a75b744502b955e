"""Ensemble training and evaluation.

Port of ``veles_tpu/ensemble/``: :class:`EnsembleTrainerWorkflow`
trains N model instances in-process, each on its own random subset of
the TRAIN set (one job per member over the job channel), and ships back
each member's metrics and its trained params as fused specs;
:class:`EnsembleTesterWorkflow` combines the members by averaging their
softmax outputs on the device.
"""

from veles_tpu_torch.ensemble.workflows import (  # noqa: F401
    EnsembleTester, EnsembleTesterWorkflow, EnsembleTrainer,
    EnsembleTrainerWorkflow)
