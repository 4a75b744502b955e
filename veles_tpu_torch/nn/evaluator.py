"""Evaluators: the model's output and the ground truth -> err_output and
the minibatch's counters.

Port of ``veles_tpu/nn/evaluator.py``. One plain function computes
err_output, the error count, the loss, the confusion matrix and the
largest error in one pass over the minibatch, masking the rows past the
short tail's ``size`` (and labels of -1); the ``1/batch_size`` gradient
scale is folded into err_output, so the gradient-descent units apply
the learning rate directly. The counters go to the host once per
minibatch, as the reference reads them: packed into one int32 tensor
(the f32 scalars by their bits) and copied in one device-to-host
transfer, not one per scalar.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.workflow import IResultProvider


def _softmax_eval(probs, labels, size, n_classes):
    batch = probs.shape[0]
    rows = torch.arange(batch, device=probs.device)
    valid = (rows < size) & (labels >= 0)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    onehot = (torch.arange(n_classes, device=probs.device)[None, :] ==
              safe[:, None]).to(probs.dtype)
    scale = valid.to(probs.dtype) / max(size, 1)
    err = (probs - onehot) * scale[:, None]
    pred = probs.argmax(dim=-1)
    wrong = valid & (pred != safe)
    n_err = wrong.sum().to(torch.int32)
    p_true = probs.gather(1, safe[:, None])[:, 0]
    loss = -(torch.log(torch.clamp(p_true, min=1e-30)) *
             valid.to(probs.dtype)).sum()
    confusion = torch.zeros((n_classes, n_classes), dtype=torch.int32,
                            device=probs.device)
    confusion.index_put_((safe, pred), valid.to(torch.int32),
                         accumulate=True)
    max_err = err.abs().max()
    return err, n_err, loss, confusion, max_err


def _mse_eval(output, target, size):
    batch = output.shape[0]
    valid = (torch.arange(batch, device=output.device) < size).to(
        output.dtype)
    mask = valid.reshape((batch,) + (1,) * (output.ndim - 1))
    # autoencoder targets link the raw minibatch ([B, H, W]) against a
    # flat FC output ([B, H*W]): the same size, laid out as the output
    diff = (output - target.reshape(output.shape).to(output.dtype)) * mask
    err = diff / max(size, 1)
    sum_sq = (diff * diff).sum()
    # per-sample RMSE summed over the minibatch
    per_sample = torch.sqrt((diff * diff).reshape(batch, -1).sum(dim=1))
    return err, sum_sq, per_sample.sum(), diff.abs().max()


def to_host(ints, floats):
    """One device-to-host copy of int32 tensors and f32 scalars: the
    floats travel as their bits. Returns (host int32 array, host f32
    array)."""
    bits = [f.to(torch.float32).reshape(1).view(torch.int32)
            for f in floats]
    packed = torch.cat([t.to(torch.int32).reshape(-1) for t in ints] +
                       bits).cpu().numpy()
    n_float = len(floats)
    return packed[:packed.size - n_float], \
        packed[packed.size - n_float:].view(np.float32)


class EvaluatorBase(AcceleratedUnit):
    """Common plumbing: demands the model's output and the minibatch's
    size from the loader, owns the err_output buffer."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs: Any) -> None:
        kwargs.setdefault("view_group", "EVALUATOR")
        super().__init__(workflow, **kwargs)
        self.output: Optional[Array] = None
        self.err_output = Array()
        self.batch_size: Optional[int] = None  # link from minibatch_size
        self.demand("output", "batch_size")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.output:
            return True
        self.init_array("err_output", shape=self.output.shape,
                        dtype=self.device.precision_dtype)
        return None


class EvaluatorSoftmax(EvaluatorBase, IResultProvider):
    """Cross-entropy evaluator for a softmax output layer.

    Produces ``err_output = (p - onehot)/batch`` (masked) and the
    minibatch's counters ``n_err``, ``loss``, ``confusion_matrix`` and
    ``max_err_output_sum``.
    """

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.compute_confusion = kwargs.pop("compute_confusion", True)
        super().__init__(workflow, **kwargs)
        self.labels: Optional[Array] = None
        self.n_err = 0
        self.loss = 0.0
        self.confusion_matrix: Optional[np.ndarray] = None
        self.max_err_output_sum = 0.0
        self.demand("labels")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        self._eval_ = self.jit(_softmax_eval, static_argnums=(3,))
        return None

    def run(self) -> None:
        n_classes = self.output.shape[-1]
        err, n_err, loss, confusion, max_err = self._eval_(
            self.output.devmem, self.labels.devmem,
            int(self.batch_size), n_classes)
        self.err_output.devmem = err
        # the minibatch's one host read: n_err, the confusion matrix
        # (when kept) and the two f32 scalars, in one copy
        ints = [n_err] + ([confusion] if self.compute_confusion else [])
        host_ints, host_floats = to_host(ints, [loss, max_err])
        self.n_err = int(host_ints[0])
        self.loss = float(host_floats[0])
        self.max_err_output_sum = float(host_floats[1])
        if self.compute_confusion:
            self.confusion_matrix = host_ints[1:].reshape(n_classes,
                                                          n_classes)

    def get_metric_names(self):
        return {"n_err", "loss"}

    def get_metric_values(self):
        return {"n_err": self.n_err, "loss": self.loss}

    # -- distributed: counters flow worker -> coordinator ------------------
    def generate_data_for_master(self):
        return {"n_err": self.n_err, "loss": self.loss,
                "max_err_output_sum": self.max_err_output_sum}

    def apply_data_from_slave(self, data, slave=None) -> None:
        self.n_err = data["n_err"]
        self.loss = data["loss"]
        self.max_err_output_sum = data["max_err_output_sum"]


class EvaluatorMSE(EvaluatorBase, IResultProvider):
    """Mean-squared-error evaluator for regression / autoencoder
    tails."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.target: Optional[Array] = None
        self.sum_sq = 0.0
        self.sum_rmse = 0.0
        self.max_diff = 0.0
        self.demand("target")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        self._eval_ = self.jit(_mse_eval)
        return None

    def run(self) -> None:
        err, sum_sq, sum_rmse, max_diff = self._eval_(
            self.output.devmem, self.target.devmem, int(self.batch_size))
        self.err_output.devmem = err
        _, host = to_host([], [sum_sq, sum_rmse, max_diff])
        self.sum_sq = float(host[0])
        self.sum_rmse = float(host[1])
        self.max_diff = float(host[2])

    # -- distributed: ship the counters DecisionMSE accumulates ------------
    def generate_data_for_master(self):
        return {"sum_sq": self.sum_sq, "sum_rmse": self.sum_rmse,
                "max_diff": self.max_diff}

    def apply_data_from_slave(self, data, slave=None) -> None:
        self.sum_sq = data["sum_sq"]
        self.sum_rmse = data["sum_rmse"]
        self.max_diff = data["max_diff"]

    def get_metric_names(self):
        return {"mse", "rmse_sum"}

    def get_metric_values(self):
        return {"mse": self.sum_sq, "rmse_sum": self.sum_rmse}
