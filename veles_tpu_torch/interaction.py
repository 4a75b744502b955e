"""Interaction: a Shell unit that drops into a REPL mid-workflow (port
of ``veles_tpu/interaction.py``).

Reference capability: veles/interaction.py:49 (``Shell`` = embedded
IPython between graph steps) and external/manhole (socket REPL).
Here: prefers IPython when importable, else stdlib
``code.interact``; a ``commands`` list supports scripted/untty use
(tests, batch probes). The namespace exposes the workflow, its units
by name, and numpy.
"""

from __future__ import annotations

import code
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from veles_tpu_torch.units import Unit


class Shell(Unit):
    """kwargs: ``interval`` (run the REPL every Nth trigger, default 1),
    ``commands`` (list of source strings executed instead of an
    interactive session — used when stdin is not a tty)."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.interval: int = kwargs.pop("interval", 1)
        self.commands: Optional[List[str]] = kwargs.pop("commands", None)
        kwargs.setdefault("view_group", "SERVICE")
        super().__init__(workflow, **kwargs)
        self._trigger_count = 0
        self.last_result: Dict[str, Any] = {}

    def namespace(self) -> Dict[str, Any]:
        ns: Dict[str, Any] = {"wf": self.workflow, "np": np,
                              "shell": self}
        for unit in self.workflow.units:
            key = unit.name.replace(" ", "_")
            ns.setdefault(key, unit)
        return ns

    def run(self) -> None:
        self._trigger_count += 1
        if self.interval > 1 and self._trigger_count % self.interval:
            return
        ns = self.namespace()
        if self.commands is not None:
            for src in self.commands:
                exec(compile(src, "<shell>", "exec"), ns)  # noqa: S102
            self.last_result = ns
            return
        if not sys.stdin.isatty():
            self.warning("Shell: stdin is not a tty and no commands "
                         "were given; skipping")
            return
        try:
            from IPython import embed
            embed(user_ns=ns, banner1="veles_tpu_torch shell (wf, np, units)")
        except ImportError:
            code.interact(banner="veles_tpu_torch shell (wf, np, units)",
                          local=ns)
