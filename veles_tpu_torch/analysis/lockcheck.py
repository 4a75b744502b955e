"""Runtime lock-order validation over the port (the dynamic half of
VC001; port of ``veles_tpu/analysis/lockcheck.py``).

The static pass (:mod:`veles_tpu_torch.analysis.concurrency`) proves
lock-order acyclicity over the call graph it can RESOLVE; this module
closes the gap from the other side: an opt-in instrumented lock layer
records the **real** acquisition-order edge set of a running process —
every pair (A held while B acquired), keyed by the locks' creation
sites — and asserts at teardown that the observed graph is acyclic,
with a captured stack witness for every edge.

Opt-in and STRICTLY zero-cost when off:

- ``VELES_LOCKCHECK=1`` (or any truthy value) makes
  :func:`maybe_install` patch ``threading.Lock`` / ``threading.RLock``
  with recording wrappers. ``threading.Condition()`` and
  ``queue.Queue()`` pick the patch up automatically (they resolve the
  factory through the ``threading`` module globals at call time).
- unset/falsy: :func:`maybe_install` does nothing — ``threading.Lock``
  remains the C factory, no wrapper exists anywhere, overhead is
  exactly zero.

One recorder a process: the real factories are taken from ``_thread``
(never from ``threading``, which another recorder may have patched
already), :func:`install` refuses while ``threading.Lock`` is anything
but the C factory or this module's own wrapper factory, and
:func:`uninstall` restores only a patch of its own. A process that
already runs another package's recorder keeps it untouched; run the
port's in a process of its own (``VELES_LOCKCHECK=1 python -c ...``,
calling :func:`maybe_install` before the port's modules import).

Mechanics:

- every wrapped lock gets a **site** (``file.py:LINE`` of its
  construction, stdlib frames skipped) — the graph node. Two locks
  from the same site (two MicroBatcher instances) share a node: a
  cross-instance inversion through one code path is exactly the ABBA
  risk worth reporting, while same-site nesting is skipped.
- a thread-local stack tracks held wrappers; on acquire, one edge
  (held.site -> new.site) is recorded per distinct held lock, with a
  condensed stack captured the FIRST time the edge appears.
- **same-site re-entry opens a nested scope** (lockdep's nested-
  subclass idea): edges record only from locks held BEFORE the
  outermost same-site acquisition.
- :meth:`Recorder.assert_acyclic` runs a DFS over the edge set and
  raises :class:`LockOrderError` naming the cycle and the witness
  stacks. ``Condition.wait`` is transparent: the wait releases and
  re-acquires through the wrapper (plain Lock) or the inner RLock's
  save/restore (RLock).

Known bound (documented, deliberate): locks created BEFORE
:func:`install` ran (module-level locks of already-imported modules,
stdlib internals) are not wrapped and stay invisible. The static pass
covers module-level locks.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
import traceback
from typing import Any, Dict, List, Optional, Tuple

#: the C factories, from ``_thread``: ``threading.Lock`` may already be
#: another recorder's wrapper factory when this module imports
_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = _thread.RLock

#: environment knob; truthy values enable installation
ENV_VAR = "VELES_LOCKCHECK"

#: stack frames from these file substrings are not lock "sites"
_SKIP_FRAMES = (os.sep + "threading.py", os.sep + "queue.py",
                "lockcheck.py", os.sep + "_weakrefset.py")


class LockOrderError(RuntimeError):
    """The observed acquisition-order graph contains a cycle."""

    def __init__(self, message: str, cycle: List[str],
                 witnesses: List[str]) -> None:
        super().__init__(message)
        self.cycle = cycle
        self.witnesses = witnesses


def _creation_site() -> str:
    frame = sys._getframe(2)
    while frame is not None:
        filename = frame.f_code.co_filename
        if not any(skip in filename for skip in _SKIP_FRAMES):
            return "%s:%d" % (_relpath(filename), frame.f_lineno)
        frame = frame.f_back
    return "<unknown>"


def _relpath(path: str) -> str:
    try:
        rel = os.path.relpath(path)
    except ValueError:  # pragma: no cover - cross-drive windows
        return path
    return path if rel.startswith("..") else rel


def _condensed_stack(limit: int = 8) -> str:
    lines = []
    for entry in traceback.extract_stack()[:-3][-limit:]:
        if any(skip in entry.filename for skip in _SKIP_FRAMES):
            continue
        lines.append("    %s:%d in %s" % (
            _relpath(entry.filename), entry.lineno, entry.name))
    return "\n".join(lines)


class Recorder:
    """One acquisition-order edge set (per process under the global
    install; per fixture in tests)."""

    def __init__(self) -> None:
        self._mutex = _REAL_LOCK()      # NEVER a wrapped lock
        self._local = threading.local()
        #: (site_a, site_b) -> first-seen witness text
        self._edges: Dict[Tuple[str, str], str] = {}
        #: per-thread [count] cells (each thread increments only its
        #: own — an unsynchronized shared int would lose updates)
        self._counters: List[List[int]] = []

    # -- wrapper plumbing ---------------------------------------------------
    def _stack(self) -> List["_LockWrapper"]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
            counter = self._local.counter = [0]
            with self._mutex:
                self._counters.append(counter)
        return stack

    @property
    def acquisitions(self) -> int:
        with self._mutex:
            return sum(cell[0] for cell in self._counters)

    def note_acquired(self, wrapper: "_LockWrapper") -> None:
        stack = self._stack()
        self._local.counter[0] += 1
        # Same-site re-entry opens a NESTED scope (lockdep's nested-
        # subclass idea): when this thread already holds a lock from
        # the acquired lock's own creation site — the unit-graph
        # pattern where a unit's run() drives a nested workflow whose
        # units take the same run-lock/data-lock pair one level down —
        # the instances are strictly nesting-ordered by construction,
        # and recording edges from locks acquired INSIDE the outer
        # scope would self-cycle the site pair on every nested run.
        # Ordering constraints therefore propagate only from locks
        # held BEFORE the outermost same-site acquisition; a genuine
        # cross-site inversion (the lock held before entering the
        # hierarchy) still records.
        limit = len(stack)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i].site == wrapper.site:
                limit = i
                break
        new_edges = []
        for held in stack[:limit]:
            if held.site == wrapper.site:
                continue  # an even-earlier same-site hold: reentrance
            key = (held.site, wrapper.site)
            if key not in self._edges:
                new_edges.append(key)
        if new_edges:
            witness = _condensed_stack()
            with self._mutex:
                for key in new_edges:
                    self._edges.setdefault(
                        key, "  %s -> %s first seen at:\n%s"
                        % (key[0], key[1], witness))
        stack.append(wrapper)

    def note_released(self, wrapper: "_LockWrapper") -> None:
        stack = self._stack()
        # release order is usually LIFO but `acquire/release` pairs
        # can interleave: drop the LAST occurrence
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is wrapper:
                del stack[i]
                return

    # -- lock construction --------------------------------------------------
    def wrap_lock(self, site: Optional[str] = None) -> "_LockWrapper":
        return _LockWrapper(self, _REAL_LOCK(),
                            site or _creation_site())

    def wrap_rlock(self, site: Optional[str] = None) -> "_LockWrapper":
        return _LockWrapper(self, _REAL_RLOCK(),
                            site or _creation_site())

    # -- reading ------------------------------------------------------------
    def edges(self) -> Dict[Tuple[str, str], str]:
        with self._mutex:
            return dict(self._edges)

    def reset(self) -> None:
        with self._mutex:
            self._edges.clear()

    def find_cycle(self) -> Optional[List[str]]:
        """One lock-order cycle as a closed site path, or None."""
        edges = self.edges()
        graph: Dict[str, List[str]] = {}
        for a, b in edges:
            graph.setdefault(a, []).append(b)
            graph.setdefault(b, [])
        # iterative DFS cycle detection with path reconstruction
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {node: WHITE for node in graph}
        parent: Dict[str, Optional[str]] = {}
        for root in graph:
            if color[root] != WHITE:
                continue
            stack: List[Tuple[str, int]] = [(root, 0)]
            color[root] = GRAY
            parent[root] = None
            while stack:
                node, idx = stack[-1]
                succs = graph[node]
                if idx < len(succs):
                    stack[-1] = (node, idx + 1)
                    succ = succs[idx]
                    if color[succ] == GRAY:
                        cycle = [succ]
                        cur: Optional[str] = node
                        while cur is not None and cur != succ:
                            cycle.append(cur)
                            cur = parent.get(cur)
                        cycle.append(succ)
                        cycle.reverse()
                        return cycle
                    if color[succ] == WHITE:
                        color[succ] = GRAY
                        parent[succ] = node
                        stack.append((succ, 0))
                else:
                    color[node] = BLACK
                    stack.pop()
        return None

    def assert_acyclic(self) -> None:
        """Raise :class:`LockOrderError` (cycle + per-edge witness
        stacks) when the observed acquisition order has a cycle."""
        cycle = self.find_cycle()
        if cycle is None:
            return
        edges = self.edges()
        witnesses = []
        for a, b in zip(cycle, cycle[1:]):
            witness = edges.get((a, b))
            if witness is not None:
                witnesses.append(witness)
        raise LockOrderError(
            "lock-order cycle observed at runtime: %s\n%s"
            % (" -> ".join(cycle), "\n".join(witnesses)),
            cycle, witnesses)


class _LockWrapper:
    """Recording proxy over a real lock. Context-manager compatible,
    Condition-compatible (``_release_save``/``_acquire_restore``/
    ``_is_owned`` forward to the inner lock when it has them — the
    held-stack stays consistent across a ``Condition.wait``)."""

    __slots__ = ("_recorder", "_inner", "site")

    def __init__(self, recorder: Recorder, inner: Any,
                 site: str) -> None:
        self._recorder = recorder
        self._inner = inner
        self.site = site

    def acquire(self, *args: Any, **kwargs: Any) -> bool:
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._recorder.note_acquired(self)
        return got

    def release(self) -> None:
        self._inner.release()
        self._recorder.note_released(self)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __getattr__(self, name: str) -> Any:
        # _release_save / _acquire_restore / _is_owned (RLock inner,
        # used by Condition.wait) and anything else forward verbatim
        return getattr(self._inner, name)

    def __repr__(self) -> str:
        return "<lockcheck %r from %s>" % (self._inner, self.site)


# ---------------------------------------------------------------------------
# global installation (the VELES_LOCKCHECK=1 path)
# ---------------------------------------------------------------------------

_installed: Optional[Recorder] = None


def enabled() -> bool:
    value = os.environ.get(ENV_VAR, "").strip().lower()
    return value not in ("", "0", "false", "off", "no")


def installed() -> Optional[Recorder]:
    """The active global recorder, or None when not installed."""
    return _installed


class ForeignRecorderError(RuntimeError):
    """``threading.Lock`` is patched by someone else (another package's
    lock-order recorder): this one does not wrap it."""


def _foreign_patch() -> bool:
    factory = threading.Lock
    return factory is not _REAL_LOCK and \
        getattr(factory, "__module__", None) != __name__


def install() -> Recorder:
    """Patch ``threading.Lock``/``threading.RLock`` with recording
    factories. Idempotent; returns the global recorder. Raises
    :class:`ForeignRecorderError` when another recorder's patch is in
    place (it stays)."""
    global _installed
    if _installed is not None:
        return _installed
    if _foreign_patch():
        raise ForeignRecorderError(
            "threading.Lock is already patched (%r): another lock-order "
            "recorder runs in this process; run this one in a process "
            "of its own" % (threading.Lock,))
    recorder = Recorder()

    def lock_factory() -> _LockWrapper:
        return recorder.wrap_lock()

    def rlock_factory() -> _LockWrapper:
        return recorder.wrap_rlock()

    threading.Lock = lock_factory            # type: ignore[assignment]
    threading.RLock = rlock_factory          # type: ignore[assignment]
    _installed = recorder
    return recorder


def uninstall() -> None:
    """Restore the real factories when the patch in place is this
    module's (wrapped locks already handed out keep working — they
    proxy real locks); another recorder's patch stays."""
    global _installed
    if _installed is None:
        return
    if not _foreign_patch():
        threading.Lock = _REAL_LOCK          # type: ignore[assignment]
        threading.RLock = _REAL_RLOCK        # type: ignore[assignment]
    _installed = None


def maybe_install() -> Optional[Recorder]:
    """Install iff ``VELES_LOCKCHECK`` is truthy; the no-op pass-
    through otherwise (``threading.Lock`` stays the C factory)."""
    if not enabled():
        return None
    return install()
