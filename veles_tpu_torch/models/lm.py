"""The transformer language model as a unit-graph workflow.

Port of ``veles_tpu/models/lm.py``. :class:`TransformerTrainer`
(``models/transformer.py``) stays the training surface; this module
gives the LM the control plane of the classifiers:

- :class:`TransformerUnit`, the graph unit owning a
  ``TransformerTrainer``: TRAIN minibatches step it, VALID and TEST
  minibatches score the current params without updating;
- :class:`DecisionLM`, the epoch bookkeeping judged on mean
  validation loss;
- :class:`TransformerWorkflow`, the Repeater cycle with an lr policy,
  snapshots (the trainer's params and Adam moments pickled as numpy)
  and the job methods of a coordinator's workers;
- :func:`run`, the command-line rung.

On a CUDA device the trainer replays one captured train step
(``graphs.StepGraph``), which reads the trainer's tensors by address. A restore
therefore copies the snapshot's values into those tensors
(``TransformerTrainer.load_state``) and never rebinds them, where the
reference assigns new arrays.

``mesh=`` (a ``parallel.mesh.Mesh`` over a joined process group) trains
the LM SPMD on every rank of it, as ``TransformerTrainer(mesh=)`` does;
the workflow runs on each rank with the mesh's device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from veles_tpu_torch.accelerated_units import (AcceleratedUnit,
                                               AcceleratedWorkflow)
from veles_tpu_torch.loader.base import CLASS_NAME, TRAIN
from veles_tpu_torch.loader.text import SyntheticTextLoader
from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerTrainer, _tree_map)
from veles_tpu_torch.nn.decision import DecisionGD
from veles_tpu_torch.parallel.mesh import check_mesh
from veles_tpu_torch.plumbing import Repeater


class DecisionLM(DecisionGD):
    """Decision judged on the mean per-window LM loss (cross-entropy,
    nats). Demands ``sum_loss`` from the transformer unit instead of
    ``n_err``; ``min_validation_error`` holds the best mean loss."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.sum_loss: Optional[float] = None
        self._demanded.discard("n_err")
        self.demand("sum_loss")
        self.epoch_n_err = [0.0, 0.0, 0.0]  # accumulates loss sums

    def _minibatch_metric(self) -> float:
        return float(self.sum_loss)

    def _class_error(self, klass: int, served: int) -> float:
        loss = self.epoch_n_err[klass] / served
        self.info("epoch %d %s: loss %.4f (ppl %.2f, %d windows)",
                  self.epoch_number, CLASS_NAME[klass], loss,
                  float(np.exp(min(loss, 30.0))), served)
        return loss

    def _format_error(self, value: float) -> str:
        return "loss %.4f" % value

    def get_metric_names(self):
        return {"min_validation_loss", "min_validation_epoch",
                "min_train_loss", "epochs"}

    def get_metric_values(self):
        return {"min_validation_loss": float(self.min_validation_error),
                "min_validation_epoch": self.min_validation_epoch,
                "min_train_loss": float(self.min_train_error)
                if np.isfinite(self.min_train_error) else None,
                "epochs": self.epoch_number}


class TransformerUnit(AcceleratedUnit):
    """Graph unit owning the transformer trainer.

    Demands ``input`` (minibatch_data ``[mbs, T+1]`` int32),
    ``minibatch_class``, ``minibatch_size``. Provides ``sum_loss``
    (loss x windows, what :class:`DecisionLM` accumulates) and
    ``loss``. The LR scheduler drives ``learning_rate`` as it drives a
    GD unit's; each TRAIN run pushes it into the trainer."""

    def __init__(self, workflow, config: TransformerConfig,
                 mesh=None, learning_rate: float = 3e-4,
                 seed: int = 0, **kwargs: Any) -> None:
        check_mesh(mesh)
        kwargs.setdefault("view_group", "TRAINER")
        super().__init__(workflow, **kwargs)
        # job pieces are whole trainer state with replacement semantics
        self.job_data_is_param_state = True
        self.config = config
        self.mesh = mesh
        self.learning_rate = learning_rate
        self.seed = seed
        self.input = None
        self.minibatch_class: Optional[int] = None
        self.minibatch_size: Optional[int] = None
        self.sum_loss = 0.0
        self.loss = np.inf
        self._saved_state: Optional[Dict[str, Any]] = None
        self.demand("input", "minibatch_class", "minibatch_size")

    def init_unpickled(self) -> None:
        super().init_unpickled()
        self._trainer_: Optional[TransformerTrainer] = None

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if self.input is None:
            return True
        if self._trainer_ is None:
            self._trainer_ = TransformerTrainer(
                self.config, device=self.device.torch_device,
                learning_rate=self.learning_rate, seed=self.seed,
                mesh=self.mesh)
            if self._saved_state is not None:
                self._load_state(self._saved_state)
                self._saved_state = None
        return None

    # -- state (snapshots and jobs) ----------------------------------------
    def _host_state(self) -> Dict[str, Any]:
        """The trainer's params and Adam m, v as numpy trees (copies),
        with the step count and the learning rate."""
        t = self._trainer_

        def host(x):
            return x.detach().to("cpu", copy=True).numpy()

        state = {"params": _tree_map(host, t.params),
                 "opt_m": _tree_map(host, t.opt_m),
                 "opt_v": _tree_map(host, t.opt_v)}
        state["step_count"] = t._step_count
        state["learning_rate"] = float(self.learning_rate)
        return state

    def _load_state(self, state: Dict[str, Any]) -> None:
        """Copy ``state`` into the trainer's own tensors (the captured
        step reads them by address)."""
        self._trainer_.load_state(state["params"], state["opt_m"],
                                  state["opt_v"],
                                  step=int(state["step_count"]))

    def __getstate__(self) -> Dict[str, Any]:
        state = super().__getstate__()
        # process groups do not pickle: a restored unit takes its mesh
        # anew (each rank's state holds its own shards)
        state["mesh"] = None
        if self._trainer_ is not None:
            state["_saved_state"] = self._host_state()
        return state

    # -- the work ----------------------------------------------------------
    def run(self) -> None:
        size = int(self.minibatch_size)
        tokens = self.input.devmem[:size]
        trainer = self._trainer_
        if self.minibatch_class == TRAIN:
            trainer.learning_rate = float(self.learning_rate)
            self.loss = float(trainer.step(tokens)["loss"])
        else:
            self.loss = float(trainer.eval_loss(tokens))
        self.sum_loss = self.loss * size

    # -- coordinator job farming -------------------------------------------
    # The coordinator ships current params with each job; the worker
    # trains on its index slice and ships the updated params back.
    def generate_data_for_slave(self, slave=None):
        return self._host_state()

    def apply_data_from_master(self, data) -> None:
        if self._trainer_ is not None:
            self._load_state(data)

    def generate_data_for_master(self):
        state = self._host_state()
        state["sum_loss"] = self.sum_loss
        state["loss"] = self.loss
        return state

    def apply_data_from_slave(self, data, slave=None) -> None:
        if self._trainer_ is not None:
            self._load_state(data)
        self.sum_loss = data["sum_loss"]
        self.loss = data["loss"]


class TransformerWorkflow(AcceleratedWorkflow):
    """LM training workflow: Repeater -> TokenWindowLoader ->
    TransformerUnit -> DecisionLM cycle, with an lr policy, snapshots
    and worker-mode rewiring."""

    def __init__(self, workflow=None,
                 config: Optional[TransformerConfig] = None,
                 loader_cls=None,
                 loader_kwargs: Optional[Dict[str, Any]] = None,
                 learning_rate: float = 3e-4,
                 max_epochs: Optional[int] = 10,
                 fail_iterations: int = 25,
                 lr_policy=None,
                 mesh=None,
                 seed: int = 0,
                 snapshot_dir: Optional[str] = None,
                 snapshot_prefix: Optional[str] = None,
                 **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        if config is None:
            config = TransformerConfig(vocab=64, embed=64, heads=2,
                                       layers=2, seq_len=32)
        self.config = config
        if loader_cls is None:
            loader_cls = SyntheticTextLoader

        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        lk = dict(loader_kwargs or {})
        lk.setdefault("minibatch_size", 16)
        lk.setdefault("seq_len", config.seq_len)
        if loader_cls is SyntheticTextLoader:
            lk.setdefault("vocab", config.vocab)
        self.loader = loader_cls(self, **lk)
        self.loader.link_from(self.repeater)

        self.trainer_unit = TransformerUnit(
            self, config=config, mesh=mesh, learning_rate=learning_rate,
            seed=seed)
        self.trainer_unit.link_attrs(
            self.loader, ("input", "minibatch_data"),
            "minibatch_class", "minibatch_size")
        self.trainer_unit.link_from(self.loader)
        self.forwards: List[Any] = [self.trainer_unit]

        self.decision = DecisionLM(self, max_epochs=max_epochs,
                                   fail_iterations=fail_iterations)
        self.decision.link_attrs(
            self.loader, "minibatch_class", "minibatch_size",
            "last_minibatch", "epoch_number", "class_lengths")
        self.decision.link_attrs(self.trainer_unit, "sum_loss")
        self.decision.link_from(self.trainer_unit)

        # The cycle tail runs decision -> [lr scheduler] ->
        # [snapshotter] -> repeater, so the epoch-boundary services
        # finish before the next cycle's trainer run can observe their
        # mutations (lr) or state (snapshots).
        tail = self.decision
        self.lr_scheduler = None
        if lr_policy is not None:
            from veles_tpu_torch.nn.lr_policy import LRScheduler
            self.lr_scheduler = LRScheduler(self, policy=lr_policy)
            self.lr_scheduler.gds = [self.trainer_unit]
            self.lr_scheduler.link_attrs(self.decision, "epoch_number")
            self.lr_scheduler.link_attrs(self.loader,
                                         "minibatches_served")
            self.lr_scheduler.link_from(tail)
            self.lr_scheduler.gate_skip = ~self.loader.epoch_ended
            tail = self.lr_scheduler

        self.snapshotter = None
        if snapshot_dir:
            from veles_tpu_torch.snapshotter import Snapshotter
            self.snapshotter = Snapshotter(
                self, directory=snapshot_dir,
                prefix=snapshot_prefix or type(self).__name__.lower())
            self.snapshotter.link_from(tail)
            self.snapshotter.gate_skip = ~(self.loader.epoch_ended &
                                           self.decision.improved)
            tail = self.snapshotter

        self._cycle_tail = tail
        self.repeater.link_from(tail)
        self.repeater.gate_block = self.decision.complete
        # a barrier over the decision and the service tail, so the last
        # epoch's lr and snapshot work completes before the run ends
        self.end_point.link_from(self.decision)
        if tail is not self.decision:
            self.end_point.link_from(tail)
        self.end_point.gate_block = ~self.decision.complete
        self._slave_rewired = False

    def initialize(self, device=None, **kwargs: Any) -> None:
        """Worker mode runs ONE pass per job (the rewiring of
        StandardWorkflow)."""
        if self.is_slave and not self._slave_rewired:
            _ = self.checksum
            self.repeater.unlink_from(self._cycle_tail)
            self.end_point.gate_block <<= False
            self._slave_rewired = True
        super().initialize(device=device, **kwargs)

    def resume_overrides(self, **kwargs: Any) -> None:
        """Config overrides onto a snapshot-restored workflow (the part
        of StandardWorkflow.resume_overrides that applies to the LM)."""
        unknown = []
        for key, value in kwargs.items():
            if key == "max_epochs":
                self.decision.max_epochs = value
                self.decision.complete <<= False
            elif key == "fail_iterations":
                self.decision.fail_iterations = value
                self.decision.complete <<= False
            elif key == "learning_rate":
                self.trainer_unit.learning_rate = value
                if self.lr_scheduler is not None:
                    self.lr_scheduler.rebase(value)
            elif key == "lr_policy":
                from veles_tpu_torch.nn.lr_policy import make_policy
                if self.lr_scheduler is not None:
                    self.lr_scheduler.policy = make_policy(value)
                else:
                    self.warning(
                        "resume cannot ADD an lr scheduler to a graph "
                        "built without one; lr_policy ignored")
            else:
                unknown.append(key)
        if unknown:
            raise TypeError("resume_overrides got unexpected kwargs %s"
                            % sorted(unknown))


def run(load, main):
    """CLI entry convention; kwargs come from the ``root.lm`` config
    subtree."""
    from veles_tpu_torch.config import get, root
    load(TransformerWorkflow, **(get(root.lm) or {}))
    main()
