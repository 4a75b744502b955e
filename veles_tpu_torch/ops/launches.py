"""The kernel wrappers' launch counters and a capture's own tally.

Each wrapper adds one to its module's ``LAUNCHES`` where it launches
its kernel (:func:`count`). While a CUDA graph is captured on a stream
(:func:`capturing`), the wrapper calls made on that stream launch
nothing: they go to the capture's tally, which the graph adds on every
replay (:func:`add`). The stream decides, not the thread: autograd runs
a captured step's backward on a thread of its own, on the capturing
stream. Launches on other streams during the capture (a sibling replica
replaying while a respawned one captures) count as usual.

:func:`observing` reports the launches an eager call makes on its
stream (they count as usual): what an eager dispatch's capture record
(``aot/export.py``) holds in place of a replay's tally.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterator, List, Tuple

import torch

Tally = List[Tuple[Dict[str, int], Dict[str, int]]]

_LOCK = threading.Lock()
#: the tallies of the captures under way, by capturing stream
_TALLIES: Dict[int, Tally] = {}
#: the observers of eager calls under way, by stream
_OBSERVERS: Dict[int, List[Dict[str, int]]] = {}
#: called as ``fn(name, nbytes)`` where a wrapper runs its kernel's
#: plain version: the device bytes the kernel would allocate that the
#: plain version does not (the memory plan adds them)
_WORKSPACE: List[Callable[[str, int], None]] = []


def _stream_key() -> int:
    return torch.cuda.current_stream().cuda_stream


def count(counter: Dict[str, int], name: str) -> None:
    """One launch of ``name``: into the tally of a capture on the
    current stream, else into ``counter``."""
    key = _stream_key() if (_TALLIES or _OBSERVERS) else None
    tally = _TALLIES.get(key) if _TALLIES else None
    with _LOCK:
        if tally is None:
            counter[name] += 1
            for seen in _OBSERVERS.get(key, ()):
                seen[name] = seen.get(name, 0) + 1
            return
        for known, gained in tally:
            if known is counter:
                gained[name] = gained.get(name, 0) + 1
                return
        tally.append((counter, {name: 1}))


def add(tally: Tally) -> None:
    """A replay's launches: the tally of the capture it replays."""
    with _LOCK:
        for counter, gained in tally:
            for name, n in gained.items():
                counter[name] += n


@contextlib.contextmanager
def capturing() -> Iterator[Tally]:
    """The wrapper calls on the current stream go to the yielded tally
    for the block (enter it inside the capture, on its stream). A
    second capture on a stream that is capturing raises."""
    key = _stream_key()
    tally: Tally = []
    with _LOCK:
        if key in _TALLIES:
            raise RuntimeError("a capture is already under way on "
                               "stream %r" % (key,))
        _TALLIES[key] = tally
    try:
        yield tally
    finally:
        with _LOCK:
            del _TALLIES[key]


@contextlib.contextmanager
def observing(device) -> Iterator[Dict[str, int]]:
    """The launches made on the current stream during the block, by
    name, in the yielded dict (they also count as usual). Off a CUDA
    device nothing launches and the dict stays empty."""
    seen: Dict[str, int] = {}
    if torch.device(device).type != "cuda":
        yield seen
        return
    key = _stream_key()
    with _LOCK:
        _OBSERVERS.setdefault(key, []).append(seen)
    try:
        yield seen
    finally:
        with _LOCK:
            _OBSERVERS[key].remove(seen)
            if not _OBSERVERS[key]:
                del _OBSERVERS[key]


def note_workspace(name: str, nbytes: int) -> None:
    """A wrapper took its plain version in place of kernel ``name``,
    whose launch would allocate ``nbytes`` more (``analysis.memplan``
    listens while it plans)."""
    for fn in list(_WORKSPACE):
        fn(name, int(nbytes))


@contextlib.contextmanager
def workspace_listener(fn: Callable[[str, int], None]) -> Iterator[None]:
    """``fn`` hears every :func:`note_workspace` during the block."""
    _WORKSPACE.append(fn)
    try:
        yield
    finally:
        _WORKSPACE.remove(fn)
