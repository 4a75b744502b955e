"""The dataflow Unit: gated control links, demand attributes, timing.

Port of ``veles_tpu/units.py``. A ``Unit`` is a node in a control-flow
graph. ``link_from`` adds a control edge; a unit runs when all incoming
edges have fired (the barrier gate, ``open_gate``) unless
``ignore_gate``; ``gate_block`` suppresses run and propagation and
``gate_skip`` suppresses run but propagates; ``run_dependent`` fans
successors out onto the workflow's thread pool, the last one through a
per-thread trampoline; ``link_attrs`` creates live attribute pointers;
``demand`` declares attributes that must be set before ``initialize``;
per-unit wall timers feed ``Workflow.print_stats``.

Units never own device kernels: device work belongs to
:class:`veles_tpu_torch.accelerated_units.AcceleratedUnit` subclasses;
the graph itself is host-side Python. A unit marked as a scheduler
tenant (``sched.attach_workflow``) runs each pass as one quantum of the
shared device, and on a CUDA device that quantum ends only once the
pass's device work is done (``veles_tpu_torch.sched``).
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Set

from veles_tpu_torch.config import root
from veles_tpu_torch.distributable import Distributable, TriviallyDistributable
from veles_tpu_torch.mutable import Bool, LinkableAttribute


class UnitRegistry(type):
    """Metaclass recording every Unit subclass for introspection,
    plus grouped name->class mappings (reference: unit_registry.py:51
    UnitRegistry and :178 MappedUnitRegistry).

    A class declaring ``MAPPING = "conv_relu"`` registers itself under
    ``mapped[<MAPPING_GROUP>]["conv_relu"]``; the group comes from the
    (inheritable) ``MAPPING_GROUP`` attribute — "layer" for NN forward
    units (consumed by StandardWorkflow's spec reader), "loader" for
    loaders (consumed by config-driven loader construction), "unit"
    otherwise.
    """

    units: Set[type] = set()
    mapped: Dict[str, Dict[str, type]] = {}

    def __init__(cls, name, bases, namespace):
        super().__init__(name, bases, namespace)
        if not namespace.get("hide_from_registry", False):
            UnitRegistry.units.add(cls)
        mapping = namespace.get("MAPPING")
        if mapping:
            group = getattr(cls, "MAPPING_GROUP", "unit")
            UnitRegistry.mapped.setdefault(group, {})[mapping] = cls


class IUnit:
    """The minimal unit interface: initialize() then run()
    (reference: veles/units.py:59-77)."""

    def initialize(self, **kwargs: Any) -> Optional[bool]:
        """Prepare to run. Return True to request re-initialization after
        other units (used when demanded attributes are not yet set)."""

    def run(self) -> None:
        """Do the work for one graph pass."""


class RunAfterStopError(RuntimeError):
    """A unit was triggered after the workflow stopped — miswired control
    flow (reference: veles/units.py:819-845)."""


class DemandError(AttributeError):
    """A demanded attribute was never linked/set before initialize."""


class Unit(Distributable, TriviallyDistributable, metaclass=UnitRegistry):
    """Dataflow node with gated control links."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.name = kwargs.pop("name", None) or type(self).__name__
        self.view_group = kwargs.pop("view_group", None)
        if kwargs:
            # Fail fast on misspelled layer-spec / constructor keys —
            # every legitimate kwarg was popped by a subclass before
            # super() (reference: validate_kwargs, veles/config.py:165).
            raise TypeError(
                "%s got unexpected kwargs %s" %
                (type(self).__name__, sorted(kwargs)))
        super().__init__()
        # Stable identity pairing coordinator and workers: job-data pieces
        # are matched by this id, never by enumeration order. The id is
        # made deterministic (insertion index + class + name) when the
        # unit joins a workflow, so independently constructed coordinator
        # and worker instances of the same workflow code agree on it
        # (enumeration order alone would be fragile).
        self.id = uuid.uuid4().hex
        self._workflow = None
        self.workflow = workflow
        self._demanded: Set[str] = set()
        self.initialized = False
        self.stopped = False

    def init_unpickled(self) -> None:
        super().init_unpickled()
        self._gate_lock_ = threading.RLock()
        self._run_lock_ = threading.RLock()
        self._is_initialized_ = False
        # control edges: src unit -> fired flag
        if not hasattr(self, "_links_from"):
            self._links_from: Dict["Unit", bool] = {}
        if not hasattr(self, "_links_to"):
            self._links_to: List["Unit"] = []
        if not hasattr(self, "gate_block"):
            self.gate_block = Bool(False, name="gate_block")
        if not hasattr(self, "gate_skip"):
            self.gate_skip = Bool(False, name="gate_skip")
        self.ignore_gate = getattr(self, "ignore_gate", False)
        self.total_run_time_ = 0.0
        self.run_count_ = 0

    # -- graph membership --------------------------------------------------
    @property
    def workflow(self):
        return self._workflow

    @workflow.setter
    def workflow(self, value) -> None:
        if self._workflow is not None:
            self._workflow.del_ref(self)
        self._workflow = value
        if value is not None:
            value.add_ref(self)

    @property
    def is_standalone(self) -> bool:
        return self.workflow.is_standalone if self.workflow else True

    @property
    def is_master(self) -> bool:
        return self.workflow.is_master if self.workflow else False

    @property
    def is_slave(self) -> bool:
        return self.workflow.is_slave if self.workflow else False

    # -- linking -----------------------------------------------------------
    def link_from(self, *units: "Unit") -> "Unit":
        """Add control edges ``unit -> self``
        (reference: veles/units.py:554-568). Returns self for chaining."""
        with self._gate_lock_:
            for unit in units:
                if unit not in self._links_from:
                    self._links_from[unit] = False
                if self not in unit._links_to:
                    unit._links_to.append(self)
        return self

    def unlink_from(self, *units: "Unit") -> "Unit":
        with self._gate_lock_:
            for unit in units:
                self._links_from.pop(unit, None)
                if self in unit._links_to:
                    unit._links_to.remove(self)
        return self

    def unlink_all(self) -> None:
        for src in list(self._links_from):
            self.unlink_from(src)
        for dst in list(self._links_to):
            dst.unlink_from(self)

    @property
    def links_from(self) -> Dict["Unit", bool]:
        return self._links_from

    @property
    def links_to(self) -> List["Unit"]:
        return self._links_to

    def link_attrs(self, other: "Unit", *attrs, two_way: bool = False) -> None:
        """Make self's attributes live pointers into ``other``.

        Each item is either a name (same on both sides) or a
        ``(dst_name, src_name)`` pair
        (reference: veles/units.py:638-656)."""
        for attr in attrs:
            if isinstance(attr, tuple):
                dst, src = attr
            else:
                dst = src = attr
            LinkableAttribute(self, dst, (other, src))

    def demand(self, *attrs: str) -> None:
        """Declare attributes that must be set before initialize
        (reference: veles/units.py:682-699)."""
        self._demanded.update(attrs)
        for attr in attrs:
            if not hasattr(self, attr):
                setattr(self, attr, None)

    def verify_demands(self) -> List[str]:
        missing = []
        for attr in self._demanded:
            if getattr(self, attr, None) is None:
                missing.append(attr)
        return missing

    # -- lifecycle ---------------------------------------------------------
    def initialize(self, **kwargs: Any) -> Optional[bool]:
        missing = self.verify_demands()
        if missing:
            return True  # request requeue (reference: partial-init retry)
        self._is_initialized_ = True
        self.initialized = True
        return None

    def run(self) -> None:
        pass

    def _initialize_reproducibly(self, **kwargs: Any) -> Optional[bool]:
        """Run ``initialize`` with RNG-stream replay: the state of every
        RandomGenerator attribute is saved on first initialize and
        replayed on re-initialization (after snapshot restore, requeue,
        or mode switch), so parameter init is identical no matter how
        many times initialize runs (reference: veles/units.py:859-885).
        """
        from veles_tpu_torch.prng import RandomGenerator
        saved = getattr(self, "_saved_rg_states", None) or {}
        current = {}
        for key, value in self.__dict__.items():
            if isinstance(value, RandomGenerator):
                if key not in saved:
                    saved[key] = value.state
                else:
                    current[key] = value.state
                    value.state = saved[key]
        try:
            return self.initialize(**kwargs)
        finally:
            # Streams created *during* initialize (lazy `self.rand =
            # RandomGenerator(...)` patterns) were invisible to the
            # entry scan; baseline them at their seed state so the next
            # re-initialize replays the same init-time consumption.
            for key, value in self.__dict__.items():
                if isinstance(value, RandomGenerator) \
                        and key not in saved and key not in current:
                    saved[key] = value.state_at_seed
            if saved:
                self._saved_rg_states = saved
            for key, state in current.items():
                getattr(self, key).state = state

    def stop(self) -> None:
        """Called on workflow stop for units holding external resources.

        Sets :attr:`stopped`; a later trigger raises
        :class:`RunAfterStopError` (reference: veles/units.py:819-845)
        unless a :class:`veles_tpu_torch.plumbing.FireStarter` resets the flag.
        """
        self.stopped = True

    # -- execution engine --------------------------------------------------
    def open_gate(self, src: Optional["Unit"]) -> bool:
        """Barrier gate: mark ``src``'s edge fired; open when all incoming
        edges have fired, then reset (reference: veles/units.py:524-543)."""
        if self.ignore_gate or src is None or not self._links_from:
            return True
        with self._gate_lock_:
            if src in self._links_from:
                self._links_from[src] = True
            if all(self._links_from.values()):
                for k in self._links_from:
                    self._links_from[k] = False
                return True
            return False

    def _check_gate_and_run(self, src: Optional["Unit"]) -> None:
        """The hot loop body (reference: veles/units.py:782-803).

        Paired with an in-flight counter on the workflow: when it drops
        to zero before the end point ran, the graph is miswired (nothing
        can ever fire again) and the workflow reports a stall instead of
        hanging (the replacement for the original design's deadlock
        watchdogs, SURVEY.md §5)."""
        wf = self.workflow
        try:
            if wf is not None and wf.stopped and not getattr(
                    self, "run_when_stopped", False):
                return
            if getattr(self, "stopped", False) and not getattr(
                    self, "run_when_stopped", False):
                # Unit-level stop: a trigger here means miswired control
                # flow (reference: veles/units.py:819-845).
                if bool(root.common.exceptions.run_after_stop):
                    exc = RunAfterStopError(
                        "%s's run() was triggered after stop() — control "
                        "flow links are miswired (workflow %s)" %
                        (self, wf.name if wf else "?"))
                    if wf is not None:
                        wf.on_unit_failure(self, exc)
                    raise exc
                self.warning(
                    "run() triggered after stop(); set root.common."
                    "exceptions.run_after_stop to raise instead")
                return
            if not self.open_gate(src):
                return
            if bool(self.gate_block):
                return
            if bool(self.gate_skip):
                self.run_dependent()
                return
            with self._run_lock_:
                if wf is not None and wf.stopped and not getattr(
                        self, "run_when_stopped", False):
                    return
                t0 = time.perf_counter()
                try:
                    # data_lock serializes run() against coordinator job
                    # generation/application touching this unit's state
                    # (reference: veles/distributable.py:137-205).
                    with self.data_lock():
                        # A unit marked as a scheduler tenant
                        # (sched.attach_workflow) runs each pass as ONE
                        # quantum of the shared device pool — the unit
                        # graph's natural preemption boundary.
                        tenant = getattr(self, "sched_tenant_", None)
                        if tenant is None:
                            self.run()
                        else:
                            with tenant.quantum():
                                self.run()
                except Exception as exc:
                    if wf is not None:
                        wf.on_unit_failure(self, exc)
                    raise
                dt = time.perf_counter() - t0
                self.total_run_time_ += dt
                self.run_count_ += 1
                if bool(root.common.trace.run):
                    self.debug("ran in %.3f ms", dt * 1000)
            self.run_dependent()
        finally:
            if wf is not None:
                wf._inflight_dec()

    def run_dependent(self) -> None:
        """Fan out to successors (reference: veles/units.py:485-505).

        All but the last successor are dispatched to the thread pool; the
        last continues on this thread through a per-thread *trampoline*
        queue, so arbitrarily long cyclic chains (training loops of
        thousands of minibatches) execute at O(1) stack depth regardless
        of link declaration order — an inline recursion could
        hit RecursionError when the cycle-closing edge was last-declared.
        """
        wf = self.workflow
        targets = list(self._links_to)
        if not targets:
            return
        if wf is not None:
            for _ in targets:
                wf._inflight_inc()
        pool = wf.thread_pool if wf is not None else None
        if pool is not None:
            for dst in targets[:-1]:
                pool.callInThread(dst._check_gate_and_run, self)
            _trampoline_run(targets[-1], self)
        else:
            for dst in targets:
                _trampoline_run(dst, self)

    # -- misc --------------------------------------------------------------
    @property
    def average_run_time(self) -> float:
        return self.total_run_time_ / max(self.run_count_, 1)

    def __repr__(self) -> str:
        return "<%s %r>" % (type(self).__name__, self.name)


_trampoline_local = threading.local()


@contextmanager
def fresh_trampoline():
    """Run the body with a fresh trampoline frame on this thread.

    A nested ``Workflow.run()`` issued from inside a running unit (the
    ensemble/genetics pattern: a member model trains inside the outer
    graph's step) must drive its own graph to completion NOW — if its
    start point merely enqueued onto the caller's active trampoline
    queue, the nested ``run()`` would wait on its sync event while the
    queue item waits for the nested ``run()`` to return: deadlock.
    """
    saved = getattr(_trampoline_local, "queue", None)
    _trampoline_local.queue = None
    try:
        yield
    finally:
        _trampoline_local.queue = saved


def _trampoline_run(dst: "Unit", src: Optional["Unit"]) -> None:
    """Run ``dst._check_gate_and_run(src)`` through the calling thread's
    trampoline queue: if a trampoline loop is already active on this
    thread, enqueue and return (the active loop will pick it up);
    otherwise become the loop and drain until the queue is empty."""
    queue = getattr(_trampoline_local, "queue", None)
    if queue is not None:
        queue.append((dst, src))
        return
    _trampoline_local.queue = queue = deque(((dst, src),))
    try:
        while queue:
            unit, source = queue.popleft()
            unit._check_gate_and_run(source)
    except BaseException:
        # Balance the in-flight counter for items that will never run.
        while queue:
            unit, _ = queue.popleft()
            if unit.workflow is not None:
                unit.workflow._inflight_dec()
        raise
    finally:
        _trampoline_local.queue = None


class TrivialUnit(Unit):
    """A unit that does nothing — graph filler for tests
    (reference: veles/units.py:916)."""

    def initialize(self, **kwargs):
        return super().initialize(**kwargs)

    def run(self):
        pass


class Container(Unit):
    """A unit that contains other units (base of Workflow)
    (reference: veles/units.py:925)."""

    hide_from_registry = True
