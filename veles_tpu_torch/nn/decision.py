"""Decision unit: epoch bookkeeping and the stop criterion.

Port of ``veles_tpu/nn/decision.py``: ``DecisionGD`` accumulates the
evaluator's per-minibatch counters into per-class epoch statistics,
tracks the best validation error, decides when training is complete
(``max_epochs`` reached, or no improvement for ``fail_iterations``
epochs), and drives the gates that skip the backward pass outside
TRAIN (``gd.gate_skip = decision.gd_skip``, ``end_point.gate_block =
~decision.complete``). ``DecisionMSE`` judges on the mean per-sample
RMSE instead. Host-side control logic only.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from veles_tpu_torch.loader.base import CLASS_NAME, TRAIN, VALID
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.units import Unit
from veles_tpu_torch.workflow import IResultProvider, NoMoreJobs


class DecisionGD(Unit, IResultProvider):
    """Accumulates evaluator counters; flips ``complete`` when done.

    Demands (link from loader): ``minibatch_class``, ``minibatch_size``,
    ``last_minibatch``, ``epoch_number``, ``class_lengths``;
    (link from evaluator): ``n_err``.
    """

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.max_epochs: Optional[int] = kwargs.pop("max_epochs", None)
        self.fail_iterations: int = kwargs.pop("fail_iterations", 100)
        kwargs.setdefault("view_group", "TRAINER")
        super().__init__(workflow, **kwargs)
        self.complete = Bool(False, name="decision_complete")
        self.improved = Bool(False, name="decision_improved")
        self.gd_skip = Bool(False, name="gd_skip")
        # linked from loader
        self.minibatch_class: Optional[int] = None
        self.minibatch_size: Optional[int] = None
        self.last_minibatch: Optional[Bool] = None
        self.epoch_number: Optional[int] = None
        self.class_lengths: Optional[List[int]] = None
        # linked from evaluator
        self.n_err: Optional[int] = None
        # optional link: per-minibatch confusion, accumulated over the
        # VALID class into last_epoch_confusion (what plotters render)
        self.confusion_matrix = None
        self.epoch_confusion = None
        self.last_epoch_confusion = None
        self.demand("minibatch_class", "minibatch_size", "last_minibatch",
                    "epoch_number", "class_lengths", "n_err")

        self.epoch_n_err = [0, 0, 0]
        self.epoch_samples = [0, 0, 0]
        self.epoch_errors: Dict[int, List[float]] = {0: [], 1: [], 2: []}
        self.min_validation_error = np.inf
        self.min_validation_epoch = -1
        self.min_train_error = np.inf
        self._epochs_without_improvement = 0

    def initialize(self, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(**kwargs)
        if retry:
            return retry
        # No VALID class → improvement is judged on TRAIN error.
        self._improve_class = VALID if self.class_lengths[VALID] else TRAIN
        return None

    # -- metric hooks (overridden by DecisionMSE) --------------------------
    def _minibatch_metric(self) -> float:
        """The evaluator counter to accumulate for this minibatch."""
        return int(self.n_err)

    def _format_error(self, value: float) -> str:
        """How this decision's metric prints in log messages."""
        return "%.2f%%" % value

    def _class_error(self, klass: int, served: int) -> float:
        """Epoch error from the accumulated metric."""
        error_pt = 100.0 * self.epoch_n_err[klass] / served
        self.info("epoch %d %s: %.2f%% errors (%d/%d)",
                  self.epoch_number, CLASS_NAME[klass], error_pt,
                  self.epoch_n_err[klass], served)
        return error_pt

    def run(self) -> None:
        klass = self.minibatch_class
        self.epoch_n_err[klass] += self._minibatch_metric()
        self.epoch_samples[klass] += int(self.minibatch_size)
        if klass == VALID and self.confusion_matrix is not None:
            mat = np.asarray(self.confusion_matrix)
            self.epoch_confusion = mat.copy() \
                if self.epoch_confusion is None \
                else self.epoch_confusion + mat
        if bool(self.last_minibatch):
            if klass == VALID and self.epoch_confusion is not None:
                self.last_epoch_confusion = self.epoch_confusion
                self.epoch_confusion = None
            self._finish_class(klass)
        # Skip the backward pass outside TRAIN and once complete.
        self.gd_skip <<= (self.minibatch_class != TRAIN) or bool(
            self.complete)

    def _finish_class(self, klass: int) -> None:
        served = max(self.epoch_samples[klass], 1)
        error_pt = self._class_error(klass, served)
        self.epoch_errors[klass].append(error_pt)
        self.epoch_n_err[klass] = 0
        self.epoch_samples[klass] = 0
        if klass == TRAIN:
            self.min_train_error = min(self.min_train_error, error_pt)
        if klass == self._improve_class:
            if error_pt < self.min_validation_error:
                self.min_validation_error = error_pt
                self.min_validation_epoch = self.epoch_number
                self.improved <<= True
                self._epochs_without_improvement = 0
            else:
                self.improved <<= False
                self._epochs_without_improvement += 1
            done = self._epochs_without_improvement >= self.fail_iterations
            # VALID is served before TRAIN within an epoch, so at the
            # VALID boundary of epoch N exactly N TRAIN passes have run;
            # when improvement is judged on TRAIN (no VALID class) it is
            # N+1. Count completed TRAIN passes, not epoch numbers.
            trains_done = self.epoch_number + (
                1 if self._improve_class == TRAIN else 0)
            if self.max_epochs is not None and \
                    trains_done >= self.max_epochs:
                done = True
            if done and not bool(self.complete):
                self.info(
                    "training complete at epoch %d: best %s error "
                    "%s (epoch %d)", self.epoch_number,
                    CLASS_NAME[self._improve_class],
                    self._format_error(self.min_validation_error),
                    self.min_validation_epoch)
            self.complete <<= done

    # -- distributed -------------------------------------------------------
    @property
    def job_stream_complete(self) -> bool:
        """Surfaced through ``Workflow.job_stream_complete`` so the
        pipelined coordinator can discard updates of jobs that were
        still in flight when training completion latched."""
        return bool(self.complete)

    def generate_data_for_slave(self, slave=None):
        """Completion ends the job stream
        (reference: NoMoreJobs, veles/workflow.py:500-502)."""
        if bool(self.complete):
            raise NoMoreJobs()
        return None

    def generate_data_for_master(self):
        # Non-None so the coordinator-side apply hook below fires
        # (None pieces are skipped by Workflow.apply_data_from_slave).
        return {"minibatch_done": True}

    def apply_data_from_slave(self, data, slave=None) -> None:
        """Re-run the accumulation on the coordinator with the loader/
        evaluator pieces (applied just before this in dependency order)
        feeding the linked attributes."""
        self.run()

    def get_metric_names(self):
        return {"min_validation_error_pt", "min_validation_epoch",
                "min_train_error_pt", "epochs"}

    def get_metric_values(self):
        return {"min_validation_error_pt": float(
                    self.min_validation_error),
                "min_validation_epoch": self.min_validation_epoch,
                "min_train_error_pt": float(self.min_train_error)
                if np.isfinite(self.min_train_error) else None,
                "epochs": self.epoch_number}


class DecisionMSE(DecisionGD):
    """Decision for regression/autoencoder workflows: improvement is
    judged on mean per-sample RMSE instead of classification error
    Demands
    ``sum_rmse`` from EvaluatorMSE instead of ``n_err``."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.sum_rmse: Optional[float] = None
        self._demanded.discard("n_err")
        self.demand("sum_rmse")
        self.epoch_n_err = [0.0, 0.0, 0.0]  # accumulates rmse sums

    def _minibatch_metric(self) -> float:
        return float(self.sum_rmse)

    def _class_error(self, klass: int, served: int) -> float:
        rmse = self.epoch_n_err[klass] / served
        self.info("epoch %d %s: rmse %.4f (%d samples)",
                  self.epoch_number, CLASS_NAME[klass], rmse, served)
        return rmse

    def _format_error(self, value: float) -> str:
        return "rmse %.4f" % value

    def get_metric_names(self):
        return {"min_validation_rmse", "min_validation_epoch",
                "min_train_rmse", "epochs"}

    def get_metric_values(self):
        return {"min_validation_rmse": float(self.min_validation_error),
                "min_validation_epoch": self.min_validation_epoch,
                "min_train_rmse": float(self.min_train_error)
                if np.isfinite(self.min_train_error) else None,
                "epochs": self.epoch_number}
