"""Runtime capture-count guard: prove a hot path does NOT capture again.

Port of ``veles_tpu/analysis/recompile.py``. Where the reference counts
XLA compilations through ``jax.monitoring``, the port counts what stands
for them on the card: CUDA graphs captured by ``graphs.StepGraph``, the
shapes an engine that runs eagerly records in their place (the CPU, or
``cuda_graphs=False``), and kernel library builds, split into fresh
builds (``nvcc`` runs) and libraries found already built
(``ops/_build.py``)::

    from veles_tpu_torch.analysis.recompile import CaptureWatcher

    with CaptureWatcher(max_captures=0) as watcher:
        for _ in range(steps):
            engine.apply(batch)
    # __exit__ raised RecompileError if anything was captured

One listener a source is installed lazily and fans out to every active
watcher, so watchers nest and concurrent use is safe.

* :attr:`~CaptureWatcher.capture_count`: graphs captured plus shapes
  recorded in the region. The steady-state pins bound this number.
* :attr:`~CaptureWatcher.fresh_build_count`: ``nvcc`` runs. A warm
  ``--aot-cache`` start reports zero here.
* :attr:`~CaptureWatcher.cached_build_count`: libraries loaded from a
  build directory without ``nvcc``.
"""

from __future__ import annotations

import threading
from typing import List, Optional

_lock = threading.Lock()
_active: List["CaptureWatcher"] = []
_installed = {"done": False}


class RecompileError(AssertionError):
    """A guarded region captured more times than its bound allows."""


def _on_capture(kind: str) -> None:
    with _lock:
        watchers = list(_active)
    for watcher in watchers:
        watcher._bump(kind, 1)


def _on_build(kind: str, n: int) -> None:
    with _lock:
        watchers = list(_active)
    for watcher in watchers:
        watcher._bump(kind, n)


def _install_listeners() -> None:
    with _lock:
        if _installed["done"]:
            return
        _installed["done"] = True
    from veles_tpu_torch import graphs
    from veles_tpu_torch.ops import _build
    graphs._LISTENERS.append(_on_capture)
    _build._LISTENERS.append(_on_build)


class CaptureWatcher:
    """Context manager counting captures and kernel builds in its
    scope. ``max_captures=None`` observes; an int raises
    :class:`RecompileError` on exit when the captures exceed it.
    ``label`` names the region in the error."""

    def __init__(self, max_captures: Optional[int] = None,
                 label: str = "guarded region") -> None:
        self.max_captures = max_captures
        self.label = label
        self._counts = {"graph": 0, "shape": 0, "fresh": 0, "cached": 0}
        self._count_lock = threading.Lock()
        self._entered = False

    @property
    def graph_count(self) -> int:
        """CUDA graphs captured in scope."""
        return self._counts["graph"]

    @property
    def shape_count(self) -> int:
        """Shapes recorded by engines that run eagerly, in scope."""
        return self._counts["shape"]

    @property
    def capture_count(self) -> int:
        """Graphs captured plus eager shapes recorded: the number a
        steady state pins at zero."""
        return self._counts["graph"] + self._counts["shape"]

    @property
    def fresh_build_count(self) -> int:
        """Kernel libraries built by ``nvcc`` in scope."""
        return self._counts["fresh"]

    @property
    def cached_build_count(self) -> int:
        """Kernel libraries found already built in scope."""
        return self._counts["cached"]

    def _bump(self, kind: str, n: int) -> None:
        with self._count_lock:
            self._counts[kind] += n

    def __enter__(self) -> "CaptureWatcher":
        if self._entered:
            raise RuntimeError("CaptureWatcher is not reentrant; create "
                               "a fresh one")
        self._entered = True
        for key in self._counts:
            self._counts[key] = 0
        _install_listeners()
        with _lock:
            _active.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        with _lock:
            try:
                _active.remove(self)
            except ValueError:
                pass
        self._entered = False
        if exc_type is None and self.max_captures is not None and \
                self.capture_count > self.max_captures:
            raise RecompileError(
                "%s captured %d time(s), bound is %d: a shape or dtype "
                "is drifting between calls (capture churn)"
                % (self.label, self.capture_count, self.max_captures))


def assert_max_captures(n: int, label: str = "guarded region"
                        ) -> CaptureWatcher:
    """Sugar: ``with assert_max_captures(0, "apply"): ...``"""
    return CaptureWatcher(max_captures=n, label=label)
