"""Control-flow service units: Start/End points, Repeater, FireStarter.

Port of ``veles_tpu/plumbing.py``: ``Repeater`` (``ignore_gate=True``)
closes the training cycle; ``StartPoint`` seeds the first pass;
``EndPoint.run`` signals workflow completion; ``FireStarter`` resets
the stopped flag of its units.
"""

from __future__ import annotations

from typing import Any

from veles_tpu_torch.units import Unit, TrivialUnit


class Repeater(TrivialUnit):
    """Closes the loop in cyclic workflows.

    ``ignore_gate=True`` lets any single incoming edge re-trigger it, so
    ``repeater.link_from(last_unit)`` forms the training cycle
    (reference: veles/plumbing.py:17-33)."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        kwargs.setdefault("name", "Repeater")
        super().__init__(workflow, **kwargs)
        self.ignore_gate = True

    def init_unpickled(self):
        super().init_unpickled()
        self.ignore_gate = True


class StartPoint(TrivialUnit):
    """The workflow entry unit (reference: veles/plumbing.py:44-60)."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        kwargs.setdefault("name", "Start")
        super().__init__(workflow, **kwargs)


class EndPoint(TrivialUnit):
    """The workflow exit unit; running it finishes the workflow
    (reference: veles/plumbing.py:62-88)."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        kwargs.setdefault("name", "End")
        super().__init__(workflow, **kwargs)
        self.run_when_stopped = True

    def init_unpickled(self):
        super().init_unpickled()
        self.run_when_stopped = True

    def run(self) -> None:
        self.workflow.on_workflow_finished()

    def run_dependent(self) -> None:
        pass  # nothing runs after the end


class FireStarter(Unit):
    """Resets ``stopped`` on its registered units so a stopped workflow
    segment can run again without tripping RunAfterStopError
    (reference: veles/plumbing.py:92-113)."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        units = kwargs.pop("units", ())
        super().__init__(workflow, **kwargs)
        self.units = set(units)
        # Must itself be runnable after stop — that is its whole job.
        self.run_when_stopped = True

    def init_unpickled(self) -> None:
        super().init_unpickled()
        self.run_when_stopped = True

    def run(self) -> None:
        for unit in self.units:
            unit.stopped = False
