"""Host-side thread pool driving unit-graph execution, and the
service-thread stop/join discipline.

Port of ``veles_tpu/thread_pool.py``: :class:`ManagedThreads` (one stop
event and one ``join_all`` for long-lived service threads: the
batchers' dispatch loops, the HTTP listener) and :class:`ThreadPool`, a
thin layer over ``concurrent.futures.ThreadPoolExecutor`` with failure
interception, shutdown callbacks and pause/resume. The pool runs the
unit graph's host-side control flow; device work is issued from
whichever thread runs a unit, on that thread's current CUDA stream.
"""

from __future__ import annotations

import atexit
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional


class ManagedThreads:
    """One stop/join discipline for long-lived service threads.

    Owners (the batchers' dispatch loops, the HTTP listener, a unit's
    service threads) register their threads here: one shared stop
    event the loops poll, one ``join_all`` that the owner's ``stop()``
    (and ``Workflow.stop``) calls. Threads are non-daemon by default,
    so a leak is loud, not silent.
    """

    def __init__(self, name: str = "service") -> None:
        self.name = name
        self._threads: List[threading.Thread] = []  # guarded-by: _lock
        self._stop_event = threading.Event()
        self._lock = threading.Lock()

    @property
    def stop_requested(self) -> bool:
        return self._stop_event.is_set()

    def wait_stop(self, timeout: float) -> bool:
        """Sleep that a stop request interrupts; returns stop_requested."""
        return self._stop_event.wait(timeout)

    def spawn(self, target: Callable, *args: Any, name: Optional[str] = None,
              daemon: bool = False,
              on_error: Optional[Callable[[BaseException], None]] = None
              ) -> threading.Thread:
        """Start and register a service thread. Raises once stop was
        requested — an owner must not leak threads past its stop().

        ``on_error`` traps an exception escaping ``target``: without
        it a service thread dies printing to stderr and its owner
        never learns (the checkpoint writer, a relay recv loop); with
        it the owner records the failure and can respawn or surface
        it on the next call."""
        if on_error is not None:
            inner = target

            def target(*a):  # noqa: F811 — deliberate wrap
                try:
                    inner(*a)
                except BaseException as e:  # noqa: BLE001 — thread trap
                    traceback.print_exc()
                    try:
                        on_error(e)
                    except Exception:
                        traceback.print_exc()
            target.__name__ = getattr(inner, "__name__", "service")
        with self._lock:
            if self._stop_event.is_set():
                raise RuntimeError(
                    "%s threads are stopped; refusing to spawn %s" %
                    (self.name, name or target))
            thread = threading.Thread(
                target=target, args=args, daemon=daemon,
                name="%s/%s" % (self.name, name or target.__name__))
            self._threads.append(thread)
        thread.start()
        return thread

    def request_stop(self) -> None:
        self._stop_event.set()

    def reset(self) -> None:
        """Allow spawning again after a completed stop/join cycle."""
        with self._lock:
            if any(t.is_alive() for t in self._threads):
                raise RuntimeError(
                    "%s threads still alive; join before reset" % self.name)
            self._threads = []
            self._stop_event.clear()

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


class ThreadPool:
    """Thread pool with error trapping, pause/resume and shutdown hooks."""

    _instances: List["ThreadPool"] = []

    def __init__(self, minthreads: int = 2, maxthreads: int = 32,
                 name: str = "veles") -> None:
        self.name = name
        self._executor = ThreadPoolExecutor(
            max_workers=maxthreads, thread_name_prefix=name)
        self._on_shutdowns: List[Callable[[], None]] = []
        self._paused = threading.Event()
        self._paused.set()  # set == running
        self._failure_lock = threading.Lock()
        # first error wins; later reads (pool owner surfacing the
        # failure) are lock-free exactly-once-set reads
        self.failure: Optional[
            BaseException] = None          # guarded-by: _failure_lock
        self._on_failure: Optional[Callable[[BaseException], None]] = None
        self._shut_down = False
        ThreadPool._instances.append(self)

    # -- execution ---------------------------------------------------------
    def callInThread(self, func: Callable, *args: Any, **kwargs: Any):
        """Submit ``func`` to the pool; unhandled errors stop the pool
        (reference: thread_pool.errback veles/thread_pool.py:58-67)."""
        def wrapper():
            self._paused.wait()
            try:
                return func(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — pool-level trap
                self._record_failure(e)
                raise
        if self._shut_down:
            raise RuntimeError("ThreadPool %s is shut down" % self.name)
        return self._executor.submit(wrapper)

    def callInThreadWithCallback(self, on_result: Callable, func: Callable,
                                 *args: Any, **kwargs: Any):
        """Run func, then on_result(success, result_or_exception)."""
        def wrapper():
            self._paused.wait()
            try:
                result = func(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001
                self._record_failure(e)
                on_result(False, e)
                return
            on_result(True, result)
        if self._shut_down:
            raise RuntimeError("ThreadPool %s is shut down" % self.name)
        return self._executor.submit(wrapper)

    def _record_failure(self, e: BaseException) -> None:
        with self._failure_lock:
            if self.failure is None:
                self.failure = e
        traceback.print_exc()
        if self._on_failure is not None:
            try:
                self._on_failure(e)
            except Exception:
                traceback.print_exc()

    def set_failure_handler(self, fn: Callable[[BaseException], None]) -> None:
        self._on_failure = fn

    # -- pause / resume (reference: thread_pool pause/resume) --------------
    def pause(self) -> None:
        self._paused.clear()

    def resume(self) -> None:
        self._paused.set()

    @property
    def paused(self) -> bool:
        return not self._paused.is_set()

    # -- shutdown ----------------------------------------------------------
    def register_on_shutdown(self, fn: Callable[[], None]) -> None:
        self._on_shutdowns.append(fn)

    def shutdown(self, wait: bool = True) -> None:
        if self._shut_down:
            return
        self._shut_down = True
        self._paused.set()
        for fn in reversed(self._on_shutdowns):
            try:
                fn()
            except Exception:
                traceback.print_exc()
        self._executor.shutdown(wait=wait)
        if self in ThreadPool._instances:
            ThreadPool._instances.remove(self)

    @staticmethod
    def shutdown_all(wait: bool = False) -> None:
        for pool in list(ThreadPool._instances):
            pool.shutdown(wait=wait)


atexit.register(ThreadPool.shutdown_all)
