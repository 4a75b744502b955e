"""Pickle discipline and the distributed-unit interface.

Port of ``veles_tpu/distributable.py``: ``Pickleable`` drops attributes
whose names end in ``_`` from pickles and recreates them in
``init_unpickled``; ``Distributable`` adds the data lock with a
deadlock warning; ``IDistributable`` is the coordinator-worker data
interface every unit may implement (generate/apply data for/from
master/slave + ``drop_slave``); ``TriviallyDistributable`` is the no-op
default. The interface carries host-level jobs (minibatch index
ranges, chromosomes, model indices); the job farm that calls it is a
later slice.
"""

from __future__ import annotations

import threading
import warnings
from typing import Any, Dict

from veles_tpu_torch.logger import Logger


class Pickleable(Logger):
    """Base with the trailing-underscore pickle exclusion discipline.

    Attributes named ``foo_`` are transient (devices, locks, compiled
    functions, device tensors) and are dropped on pickle; subclasses recreate
    them in :meth:`init_unpickled`
    (reference: veles/distributable.py:48-133).
    """

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.init_unpickled()

    def init_unpickled(self) -> None:
        """(Re)create transient state; called on construction and after
        unpickling."""
        self._logger_ = None  # recreated lazily by Logger.logger

    def __getstate__(self) -> Dict[str, Any]:
        """Drop transient trailing-underscore attrs — EXCEPT attribute-link
        records ``_linked_<name>_`` which must survive so linked
        attributes stay live after restore (the reference re-installs
        links via ``class_attributes__``, veles/distributable.py:75-119;
        link targets are units inside the same pickle graph, so pickle's
        memo preserves identity)."""
        return {k: v for k, v in self.__dict__.items()
                if not k.endswith("_") or k.endswith("__")
                or k.startswith("_linked_")}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        # Re-install LinkableAttribute descriptors for preserved links —
        # in a fresh process the class may not have them yet.
        from veles_tpu_torch import mutable
        for key in state:
            if key.startswith("_linked_") and key.endswith("_"):
                mutable.install(type(self), key[len("_linked_"):-1])
        self.init_unpickled()


class Distributable(Pickleable):
    """Adds the distributed data lock with deadlock detection.

    ``data_lock_`` serializes job-data generation/application against the
    unit's own run; acquisition waits at most :data:`DEADLOCK_TIME`
    seconds before warning (reference: veles/distributable.py:137-205).
    """

    DEADLOCK_TIME = 60.0

    def __init__(self, **kwargs: Any) -> None:
        self.negotiates_on_connect = False
        #: True for units whose regular job piece is parameter state
        #: with replacement semantics (GD weights, LM trainer state):
        #: the pipelined coordinator may substitute None for such
        #: pieces when the target worker's local params are provably
        #: current (Workflow.generate_data_for_slave include_params)
        self.job_data_is_param_state = False
        super().__init__(**kwargs)

    def init_unpickled(self) -> None:
        super().init_unpickled()
        self.data_lock_ = threading.RLock()
        self.has_data_for_slave_ = threading.Event()
        self.has_data_for_slave_.set()

    @property
    def has_data_for_slave(self) -> bool:
        return self.has_data_for_slave_.is_set()

    @has_data_for_slave.setter
    def has_data_for_slave(self, value: bool) -> None:
        if value:
            self.has_data_for_slave_.set()
        else:
            self.has_data_for_slave_.clear()

    def _acquire_data_lock(self) -> None:
        if not self.data_lock_.acquire(timeout=self.DEADLOCK_TIME):
            warnings.warn(
                "Possible deadlock: %s waited %.0fs for its data lock" %
                (type(self).__name__, self.DEADLOCK_TIME))
            self.data_lock_.acquire()

    def _release_data_lock(self) -> None:
        self.data_lock_.release()

    class _DataLockScope:
        def __init__(self, owner: "Distributable"):
            self.owner = owner

        def __enter__(self):
            self.owner._acquire_data_lock()
            return self

        def __exit__(self, *exc):
            self.owner._release_data_lock()
            return False

    def data_lock(self) -> "_DataLockScope":
        return Distributable._DataLockScope(self)


class IDistributable:
    """The master-slave / coordinator-worker data interface.

    Units override any subset; the workflow calls them in graph order
    (reference: veles/distributable.py:222-281). Semantics:

    - ``generate_data_for_slave(slave)`` (coordinator): produce this
      unit's piece of a job for ``slave``; return ``None`` if the unit
      ships nothing, raise :class:`veles_tpu_torch.workflow.NoMoreJobs` to end
      training, or return ``False`` to postpone the job.
    - ``apply_data_from_master(data)`` (worker): consume the job piece.
    - ``generate_data_for_master()`` (worker): produce the update piece.
    - ``apply_data_from_slave(data, slave)`` (coordinator): merge it.
    - ``drop_slave(slave)`` (coordinator): worker vanished — requeue its
      outstanding work.
    """

    def generate_data_for_master(self):
        return None

    def generate_data_for_slave(self, slave=None):
        return None

    def apply_data_from_master(self, data) -> None:
        pass

    def apply_data_from_slave(self, data, slave=None) -> None:
        pass

    def drop_slave(self, slave=None) -> None:
        pass


class TriviallyDistributable(IDistributable):
    """No-op distributed behavior
    (reference: veles/distributable.py:284-302)."""
