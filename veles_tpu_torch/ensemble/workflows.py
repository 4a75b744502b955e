"""Ensemble trainer and tester workflows.

Port of ``veles_tpu/ensemble/workflows.py``. The trainer's member
seeds come from the ``"ensemble"`` random stream, drawn as the
reference draws them; the tester is an AcceleratedUnit that runs the
members' fused forwards (``parallel.fused._apply``) at f32 on the
device it is initialized with.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.plumbing import Repeater
from veles_tpu_torch.units import Unit
from veles_tpu_torch.workflow import IResultProvider, NoMoreJobs, Workflow


class EnsembleTrainer(Unit, IResultProvider):
    """Trains ``size`` model instances; each instance = one job.

    kwargs: ``model_factory(instance_index, seed, train_ratio) ->
    trained-workflow`` — constructs AND trains one member, returning the
    workflow; ``size``; ``train_ratio`` (subset fraction per member).
    """

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.model_factory: Callable = kwargs.pop("model_factory")
        self.size: int = kwargs.pop("size", 5)
        self.train_ratio: float = kwargs.pop("train_ratio", 0.8)
        super().__init__(workflow, **kwargs)
        self.results: List[Optional[Dict[str, Any]]] = [None] * self.size
        self.complete = Bool(False, name="ensemble_complete")
        self.rand = prng.get("ensemble")
        self._seeds = [int(self.rand.randint(0, 2 ** 31 - 1))
                       for _ in range(self.size)]

    def _train_one(self, index: int) -> Dict[str, Any]:
        from veles_tpu_torch.parallel.fused import fuse_forwards
        seed = self._seeds[index]
        wf = self.model_factory(index, seed, self.train_ratio)
        specs, params = fuse_forwards(wf.forwards)
        return {
            "index": index,
            "seed": seed,
            "train_ratio": self.train_ratio,
            "metrics": wf.gather_results(),
            "specs": specs,
            "params": params,
        }

    def run(self) -> None:
        if self.is_slave:
            self._result_ = self._train_one(self._job_["index"])
            return
        for i in range(self.size):
            if self.results[i] is None:
                self.results[i] = self._train_one(i)
                self.info("ensemble member %d/%d: %s", i + 1, self.size,
                          self.results[i]["metrics"])
        self.complete <<= True

    # -- distributed: a job is a model index -------------------------------
    def init_unpickled(self) -> None:
        super().init_unpickled()
        self._outstanding_: Dict[Any, List[int]] = {}
        self._job_ = None
        self._result_ = None

    def generate_data_for_slave(self, slave=None):
        if bool(self.complete):
            raise NoMoreJobs()
        todo = [i for i in range(self.size)
                if self.results[i] is None and
                not any(i in v for v in self._outstanding_.values())]
        if not todo:
            self.has_data_for_slave = False
            return False
        idx = todo[0]
        self._outstanding_.setdefault(slave, []).append(idx)
        self.has_data_for_slave = len(todo) > 1
        return {"index": idx, "seed": self._seeds[idx],
                "train_ratio": self.train_ratio}

    def apply_data_from_master(self, data) -> None:
        self._job_ = data
        self._seeds[data["index"]] = data["seed"]

    def generate_data_for_master(self):
        return self._result_

    def apply_data_from_slave(self, data, slave=None) -> None:
        idx = data["index"]
        self.results[idx] = data
        if slave in self._outstanding_ and \
                idx in self._outstanding_[slave]:
            self._outstanding_[slave].remove(idx)
        if all(r is not None for r in self.results):
            self.complete <<= True
        # Stay "ready" when complete so generate can raise NoMoreJobs.
        self.has_data_for_slave = bool(self.complete) or any(
            self.results[i] is None and
            not any(i in v for v in self._outstanding_.values())
            for i in range(self.size))

    def retract_data_for_slave(self, slave=None) -> None:
        """Take back the member index recorded by an aborted
        generate_data_for_slave call: newest outstanding entry only —
        older entries belong to jobs genuinely in flight."""
        outstanding = self._outstanding_.get(slave)
        if outstanding:
            outstanding.pop()
            if not outstanding:
                del self._outstanding_[slave]
            self.has_data_for_slave = True

    def requeue_one_for_slave(self, slave=None) -> None:
        """Relay retract: value-keyed bookkeeping cannot tell WHICH
        member index died downstream, and popping a guessed entry
        could strand the dead one as outstanding-forever. Requeue the
        slave's whole outstanding set (drop_slave discipline) —
        applies are idempotent (results keyed by index), so an alive
        duplicate recomputes harmlessly while the dead index becomes
        issuable again."""
        self.drop_slave(slave)

    def drop_slave(self, slave=None) -> None:
        dropped = self._outstanding_.pop(slave, [])
        if dropped:
            self.has_data_for_slave = True
            self.warning("worker %r dropped; members %s requeued",
                         slave, dropped)

    def get_metric_names(self):
        return {"members"}

    def get_metric_values(self):
        return {"members": [r["metrics"] if r else None
                            for r in self.results]}


class EnsembleTrainerWorkflow(Workflow):
    """Repeater -> EnsembleTrainer -> EndPoint."""

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        trainer_kwargs = {k: kwargs.pop(k) for k in
                          ("model_factory", "size", "train_ratio")
                          if k in kwargs}
        super().__init__(workflow, **kwargs)
        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)
        self.trainer = EnsembleTrainer(self, **trainer_kwargs)
        self.trainer.link_from(self.repeater)
        self.repeater.link_from(self.trainer)
        self.repeater.gate_block = self.trainer.complete
        self.end_point.link_from(self.trainer)
        self.end_point.gate_block = ~self.trainer.complete
        self._slave_rewired = False

    def initialize(self, device=None, **kwargs: Any) -> None:
        if self.is_slave and not self._slave_rewired:
            _ = self.checksum
            self.repeater.unlink_from(self.trainer)
            self.end_point.gate_block <<= False
            self._slave_rewired = True
        super().initialize(device=device, **kwargs)

    @property
    def members(self):
        return self.trainer.results


class EnsembleTester(AcceleratedUnit, IResultProvider):
    """Combines trained members by averaging their softmax outputs on
    the device.

    kwargs: ``members`` (the trainer's results: ``specs`` and
    ``params`` each). Demands ``data`` (rows or images) and
    ``labels``."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.members: List[Dict[str, Any]] = kwargs.pop("members")
        super().__init__(workflow, **kwargs)
        self.n_err: Optional[int] = None
        self.error_pt: Optional[float] = None
        self.complete = Bool(False, name="ensemble_test_complete")
        self.demand("data", "labels")

    def run(self) -> None:
        from veles_tpu_torch.parallel.fused import _apply
        dev = self.device.torch_device
        x = torch.from_numpy(np.asarray(self.data, dtype=np.float32)).to(
            dev)
        labels = np.asarray(self.labels)
        total = None
        with torch.no_grad():
            for member in self.members:
                params = [{k: torch.from_numpy(
                    np.asarray(v, dtype=np.float32)).to(dev)
                    for k, v in p.items()} for p in member["params"]]
                logits = _apply(tuple(member["specs"]), False, params, x,
                                0, torch.float32)
                probs = torch.softmax(logits, dim=-1)
                total = probs if total is None else total + probs
            pred = total.argmax(dim=-1).cpu().numpy()
        self.n_err = int((pred != labels).sum())
        self.error_pt = 100.0 * self.n_err / max(len(labels), 1)
        self.info("ensemble of %d: %.2f%% errors (%d/%d)",
                  len(self.members), self.error_pt, self.n_err,
                  len(labels))
        self.complete <<= True

    def get_metric_names(self):
        return {"ensemble_error_pt", "ensemble_n_err"}

    def get_metric_values(self):
        return {"ensemble_error_pt": self.error_pt,
                "ensemble_n_err": self.n_err}


class EnsembleTesterWorkflow(Workflow):
    """start -> tester -> end (single pass)."""

    def __init__(self, workflow=None, **kwargs: Any) -> None:
        tester_kwargs = {k: kwargs.pop(k) for k in ("members",)
                         if k in kwargs}
        super().__init__(workflow, **kwargs)
        self.tester = EnsembleTester(self, **tester_kwargs)
        self.tester.link_from(self.start_point)
        self.end_point.link_from(self.tester)
