"""StandardWorkflow: a classifier's unit graph from a layer list.

Port of ``veles_tpu/models/standard.py``. A layer-spec list describes
the forward stack; the workflow builds the classic graph from it:
``Repeater`` -> loader -> forward units -> ``EvaluatorSoftmax`` ->
``DecisionGD`` -> gradient-descent units (``gd_for``) -> ``Repeater``,
with the gates that skip the backward pass outside TRAIN and end the
run when the decision completes, and an optional ``LRScheduler``.

Layer spec: a dict with ``type`` plus the unit's kwargs, e.g.::

    {"type": "conv_relu", "n_kernels": 32, "kx": 5, "padding": 2}
    {"type": "max_pooling", "kx": 2}
    {"type": "dropout", "dropout_ratio": 0.5}
    {"type": "all2all_tanh", "output_sample_shape": 120}
    {"type": "softmax", "output_sample_shape": 10}

:func:`load_params` and :func:`params_of` carry a workflow's weights
in and out in the reference's layouts.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
# importing veles_tpu_torch.nn populates the "layer" unit registry
from veles_tpu_torch.nn import (LSTM, All2All, Conv, DecisionGD, Deconv,
                                Dropout, EvaluatorSoftmax, gd_for)
from veles_tpu_torch.nn.lr_policy import LRScheduler, make_policy
from veles_tpu_torch.plumbing import Repeater
from veles_tpu_torch.units import UnitRegistry


def layer_types():
    """The live spec-name -> unit-class map, populated by each layer
    unit's ``MAPPING``/``MAPPING_GROUP = "layer"`` declaration.
    Importing veles_tpu_torch.nn above registered the standard set; a
    user plugin extends it by defining a class."""
    return UnitRegistry.mapped.get("layer", {})


# layer types that carry trainable parameters (get lr/wd/momentum); an
# LSTM's twin keeps its own defaults, as in the reference
_PARAMETRIC = (All2All, Conv, Deconv)


class StandardWorkflow(AcceleratedWorkflow):
    """Classifier training workflow from a declarative layer list."""

    def __init__(self, workflow=None,
                 layers: Sequence[Dict[str, Any]] = (),
                 loader_cls=None,
                 loader_kwargs: Optional[Dict[str, Any]] = None,
                 learning_rate: float = 0.1,
                 weight_decay: float = 0.0,
                 momentum: float = 0.9,
                 max_epochs: Optional[int] = 10,
                 fail_iterations: int = 25,
                 lr_policy=None,
                 plotters: bool = False,
                 snapshot_dir: Optional[str] = None,
                 snapshot_prefix: Optional[str] = None,
                 **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        if loader_cls is None:
            from veles_tpu_torch.loader.datasets import SyntheticDigitsLoader
            loader_cls = SyntheticDigitsLoader

        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        lk = dict(loader_kwargs or {})
        lk.setdefault("minibatch_size", 100)
        self.loader = loader_cls(self, **lk)
        self.loader.link_from(self.repeater)

        self.forwards: List[Any] = []
        self._build_forwards(layers)

        self._build_evaluator_decision(max_epochs, fail_iterations)

        self._build_backwards(learning_rate, weight_decay, momentum)

        self.lr_scheduler = None
        if lr_policy is not None:
            self.lr_scheduler = LRScheduler(self, policy=lr_policy)
            self.lr_scheduler.gds = self.gds
            self.lr_scheduler.link_attrs(self.decision, "epoch_number")
            self.lr_scheduler.link_attrs(self.loader,
                                         "minibatches_served")
            # After the whole backward chain (not parallel with it):
            # the gds of the boundary minibatch must finish reading
            # their lr before the scheduler mutates it.
            self.lr_scheduler.link_from(self.gds[-1])
            # adjust only at epoch boundaries
            self.lr_scheduler.gate_skip = ~self.loader.epoch_ended

        self.repeater.link_from(self.gds[-1])
        # Block the cycle once training completes — without this, a
        # pool thread can race extra forward passes past the end gate.
        self.repeater.gate_block = self.decision.complete
        # end_point is a barrier over BOTH the decision and the end of
        # the backward chain, so it can only open after the whole pass —
        # and in worker mode (single pass per job) it opens right then.
        self.end_point.link_from(self.decision)
        self.end_point.link_from(self.gds[-1])
        self.end_point.gate_block = ~self.decision.complete
        self._slave_rewired = False

        self.plotters: List[Any] = []
        if plotters:
            from veles_tpu_torch.plotting import (AccumulatingPlotter,
                                                  MatrixPlotter)
            # both read host values the decision already holds
            err_plot = AccumulatingPlotter(
                self, plot_name="validation_error")
            err_plot.link_attrs(self.decision,
                                ("input", "min_validation_error"))
            err_plot.gate_skip = ~self.loader.epoch_ended
            # the decision accumulates per-minibatch confusions over
            # the whole VALID class — plotting the evaluator's own
            # matrix would show only the LAST minibatch of the epoch
            self.decision.link_attrs(self.evaluator, "confusion_matrix")
            conf_plot = MatrixPlotter(self, plot_name="confusion")
            conf_plot.link_attrs(self.decision,
                                 ("input", "last_epoch_confusion"))
            conf_plot.gate_skip = ~self.loader.epoch_ended
            # One chain, decision -> plotters -> backward: the next
            # minibatch (behind the repeater) cannot start, and clear
            # loader.epoch_ended, before they read their gate, and the
            # end point cannot stop the graph under the last epoch's
            # plots. The reference runs them beside the chain, where
            # either race drops plots; a chain also hands no extra
            # branch to the thread pool each minibatch.
            self.gds[0].unlink_from(self.decision)
            err_plot.link_from(self.decision)
            conf_plot.link_from(err_plot)
            self.gds[0].link_from(conf_plot)
            self.plotters = [err_plot, conf_plot]

        self.snapshotter = None
        if snapshot_dir:
            from veles_tpu_torch.snapshotter import attach_snapshotter
            self.snapshotter = attach_snapshotter(
                self, directory=snapshot_dir,
                prefix=snapshot_prefix or type(self).__name__.lower())

    def resume_overrides(self, **kwargs: Any) -> None:
        """Apply config overrides onto a snapshot-restored workflow
        (reference: resumed runs re-read the config tree). Extending
        ``max_epochs`` past the snapshot's horizon clears ``complete``
        so training actually continues."""
        unknown = []
        for key, value in kwargs.items():
            if key == "max_epochs":
                self.decision.max_epochs = value
                self.decision.complete <<= False
            elif key == "fail_iterations":
                self.decision.fail_iterations = value
                self.decision.complete <<= False
            elif key in ("learning_rate", "weight_decay", "momentum"):
                for gd in self.gds:
                    if hasattr(gd, key):
                        setattr(gd, key, value)
                        if key == "learning_rate":
                            gd.learning_rate_bias = value
                if key == "learning_rate" and \
                        self.lr_scheduler is not None:
                    # the scheduler's persisted bases would clobber the
                    # override at its next apply — re-base them
                    self.lr_scheduler.rebase(value)
            elif key == "lr_policy":
                if self.lr_scheduler is not None:
                    self.lr_scheduler.policy = make_policy(value)
                else:
                    self.warning(
                        "resume cannot ADD an lr scheduler to a graph "
                        "built without one; lr_policy ignored")
            elif key in ("layers", "loader_kwargs", "snapshot_dir",
                         "snapshot_prefix"):
                self.warning("resume cannot change %r — the restored "
                             "graph keeps its construction-time value",
                             key)
            else:
                unknown.append(key)
        if unknown:
            raise TypeError("resume_overrides got unexpected kwargs %s"
                            % sorted(unknown))

    def prepare_single_pass(self) -> None:
        """--dry-run exec: one full pass through the graph, then stop
        (same rewiring as worker mode)."""
        if not self._slave_rewired:
            _ = self.checksum
            self.repeater.unlink_from(self.gds[-1])
            self.end_point.gate_block <<= False
            self._slave_rewired = True

    def initialize(self, device=None, **kwargs: Any) -> None:
        """Worker mode runs ONE pass per job: the cycle-closing edge is
        removed and the end gate opened (reference: slave-mode gating,
        docs/source/manualrst_veles_distributed_training.rst)."""
        if self.is_slave and not self._slave_rewired:
            _ = self.checksum  # pin the pre-rewire pairing identity
            self.repeater.unlink_from(self.gds[-1])
            self.end_point.gate_block <<= False
            self._slave_rewired = True
        super().initialize(device=device, **kwargs)

    # -- construction ------------------------------------------------------
    def _build_evaluator_decision(self, max_epochs, fail_iterations):
        """Classifier default: softmax evaluator + n_err decision.
        AutoencoderWorkflow overrides with the MSE pair."""
        self.evaluator = EvaluatorSoftmax(self)
        self.evaluator.link_attrs(self.forwards[-1], "output")
        self.evaluator.link_attrs(self.loader,
                                  ("labels", "minibatch_labels"),
                                  ("batch_size", "minibatch_size"))
        self.evaluator.link_from(self.forwards[-1])

        self.decision = DecisionGD(self, max_epochs=max_epochs,
                                   fail_iterations=fail_iterations)
        self.decision.link_attrs(
            self.loader, "minibatch_class", "minibatch_size",
            "last_minibatch", "epoch_number", "class_lengths")
        self.decision.link_attrs(self.evaluator, "n_err")
        self.decision.link_from(self.evaluator)

    def _build_forwards(self, layers: Sequence[Dict[str, Any]]) -> None:
        src_unit, src_attr = self.loader, "minibatch_data"
        for i, spec in enumerate(layers):
            spec = dict(spec)
            type_name = spec.pop("type")
            try:
                cls = layer_types()[type_name]
            except KeyError:
                raise ValueError(
                    "unknown layer type %r (registered: %s)" %
                    (type_name, sorted(layer_types()))) from None
            unit = cls(self, name="%s%d" % (type_name, i + 1), **spec)
            unit.link_attrs(src_unit, ("input", src_attr))
            if isinstance(unit, Dropout):
                unit.link_attrs(self.loader, "minibatch_class")
            unit.link_from(self.forwards[-1] if self.forwards
                           else self.loader)
            self.forwards.append(unit)
            src_unit, src_attr = unit, "output"

    def _build_backwards(self, learning_rate: float, weight_decay: float,
                         momentum: float) -> None:
        self.gds: List[Any] = []
        err_src = self.evaluator
        for i, fwd in enumerate(reversed(self.forwards)):
            first_layer = i == len(self.forwards) - 1
            kwargs: Dict[str, Any] = {"name": "gd_%s" % fwd.name}
            if isinstance(fwd, _PARAMETRIC):
                kwargs.update(learning_rate=learning_rate,
                              weight_decay=weight_decay,
                              momentum=momentum,
                              need_err_input=not first_layer)
            gd = gd_for(fwd, self, **kwargs)
            if err_src is self.evaluator:
                gd.link_attrs(err_src, "err_output")
            else:
                gd.link_attrs(err_src, ("err_output", "err_input"))
            gd.link_from(self.gds[-1] if self.gds else self.decision)
            gd.gate_skip = self.decision.gd_skip
            self.gds.append(gd)
            err_src = gd


def _param_attrs(unit):
    """The names of a forward unit's parameter Arrays."""
    if isinstance(unit, _PARAMETRIC):
        return ("weights", "bias")
    if isinstance(unit, LSTM):
        return ("weights_x", "weights_h", "bias")
    return ()


def params_of(wf) -> List[Dict[str, np.ndarray]]:
    """The forward units' parameters in order, as host numpy copies in
    the reference's layouts (all2all ``[in, out]``, conv and deconv
    HWIO, bias ``[n]``; an LSTM's ``weights_x [F, 4H]``, ``weights_h
    [H, 4H]`` and ``bias [4H]``): one dict a unit, ``{}`` for one
    without parameters."""
    return [{attr: np.array(getattr(u, attr).map_read())
             for attr in _param_attrs(u)} for u in wf.forwards]


def load_params(wf, params: Sequence[Dict[str, Any]]) -> None:
    """Write ``params`` (one dict per forward unit, as :func:`params_of`
    gives them; a reference workflow's ``map_read()`` of the same
    Arrays have the same layouts) into the workflow's forward units,
    before or after ``initialize``. The gradient-descent units share
    these Arrays, so they train the loaded values."""
    params = list(params)
    if len(params) != len(wf.forwards):
        raise ValueError("%d parameter dicts for %d forward units"
                         % (len(params), len(wf.forwards)))
    for unit, p in zip(wf.forwards, params):
        attrs = _param_attrs(unit)
        if not attrs:
            if p:
                raise ValueError("%s has no parameters, got %s"
                                 % (unit.name, sorted(p)))
            continue
        for attr in attrs:
            arr = getattr(unit, attr)
            old = arr.shape if arr else None
            value = np.ascontiguousarray(
                p[attr], dtype=arr.dtype if arr else np.float32)
            if old and tuple(old) != value.shape:
                raise ValueError("%s.%s: shape %s, got %s"
                                 % (unit.name, attr, tuple(old),
                                    value.shape))
            arr.reset(value)
            if unit.device is not None:
                arr.initialize(unit.device)
