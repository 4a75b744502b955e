"""The kernel wrappers' launch counters and a capture's own tally.

Each wrapper adds one to its module's ``LAUNCHES`` where it launches
its kernel (:func:`count`). While a CUDA graph is captured on a stream
(:func:`capturing`), the wrapper calls made on that stream launch
nothing: they go to the capture's tally, which the graph adds on every
replay (:func:`add`). The stream decides, not the thread: autograd runs
a captured step's backward on a thread of its own, on the capturing
stream. Launches on other streams during the capture (a sibling replica
replaying while a respawned one captures) count as usual.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Tuple

import torch

Tally = List[Tuple[Dict[str, int], Dict[str, int]]]

_LOCK = threading.Lock()
#: the tallies of the captures under way, by capturing stream
_TALLIES: Dict[int, Tally] = {}


def _stream_key() -> int:
    return torch.cuda.current_stream().cuda_stream


def count(counter: Dict[str, int], name: str) -> None:
    """One launch of ``name``: into the tally of a capture on the
    current stream, else into ``counter``."""
    tally = _TALLIES.get(_stream_key()) if _TALLIES else None
    with _LOCK:
        if tally is None:
            counter[name] += 1
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
