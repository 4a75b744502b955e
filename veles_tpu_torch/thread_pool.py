"""Service-thread stop/join discipline (port of
``veles_tpu/thread_pool.py:ManagedThreads``; the unit-graph
``ThreadPool`` comes with the unit-graph slice)."""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional


class ManagedThreads:
    """One stop/join discipline for long-lived service threads.

    Owners (the batcher's dispatch loop, the HTTP listener) register
    their threads here: one shared stop event the loops poll, one
    ``join_all`` that the owner's ``stop()`` calls. Threads are
    non-daemon, so a leak is loud, not silent.
    """

    def __init__(self, name: str = "service") -> None:
        self.name = name
        self._threads: List[threading.Thread] = []  # guarded-by: _lock
        self._stop_event = threading.Event()
        self._lock = threading.Lock()

    @property
    def stop_requested(self) -> bool:
        return self._stop_event.is_set()

    def spawn(self, target: Callable, *args: Any,
              name: Optional[str] = None) -> threading.Thread:
        """Start and register a service thread. Raises once stop was
        requested — an owner must not leak threads past its stop()."""
        with self._lock:
            if self._stop_event.is_set():
                raise RuntimeError(
                    "%s threads are stopped; refusing to spawn %s" %
                    (self.name, name or target))
            thread = threading.Thread(
                target=target, args=args,
                name="%s/%s" % (self.name, name or target.__name__))
            self._threads.append(thread)
        thread.start()
        return thread

    def request_stop(self) -> None:
        self._stop_event.set()

    def join_all(self, timeout: float = 5.0) -> List[threading.Thread]:
        """Request stop and join every registered thread; returns the
        (hopefully empty) list of threads still alive at the deadline.
        Safe to call from inside one of the owned threads (it skips
        joining itself)."""
        self._stop_event.set()
        deadline = time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads)
        leaked = []
        for thread in threads:
            if thread is threading.current_thread():
                continue
            thread.join(max(0.0, deadline - time.monotonic()))
            if thread.is_alive():
                leaked.append(thread)
        with self._lock:
            self._threads = [t for t in self._threads if t.is_alive()]
        return leaked
