"""Captured CUDA graphs: one dispatch per step.

The reference compiles a decode round, a train step or a bucket's
forward into one XLA executable and dispatches it once. On the card the
counterpart is a captured CUDA graph: :class:`StepGraph` records one
call of a step function and replays it with a single launch.

The step reads its inputs from tensors that keep their addresses: the
caller rewrites them in place (``copy_``) between replays and never
rebinds them. Its outputs live in the graph's memory pool, and every
replay overwrites them; graphs that share a pool reuse each other's
freed scratch, so read or copy a replay's outputs before the next
replay of any graph of that pool. A pool all of whose graphs were
dropped takes no further capture: :class:`GraphPool` opens a fresh one
then.

The kernel wrappers count their launches on the host, once per Python
call. A capture makes those calls but launches nothing, and a replay
launches without a call. So the calls made on the capturing stream
(the step's backward too, which autograd runs on a thread of its own)
go to the graph's own tally (``ops.launches.capturing``), which every
replay adds to the counters (``ops.flash_attention``, ``ops.lrn``,
``ops.rng``); launches on other streams during the capture count as
usual, and the warm-up calls before the capture launch for real and
stay counted. The counts stay true.

Captures take turns (``_CAPTURE_LOCK``), each on a stream of its own:
entering ``torch.cuda.graph`` synchronises the device, runs a
collection and empties the allocator's cache, none of which may happen
while another thread's capture is under way. Replays and eager work on
other threads go on beside a capture.

Each capture, and each new shape an engine that runs eagerly records in
its place (:func:`note_shape`), is reported to the listeners
(``analysis.recompile.CaptureWatcher`` counts them over a region).

Python's cyclic garbage collector pauses while a capture is under way.
A collection may run on any allocation, and one that frees a dead
cycle holding an earlier graph (an engine or trainer dropped with its
threads) destroys that graph on the capturing thread, which
invalidates the capture; the cycle is collected after it instead.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import weakref
from typing import Any, Callable, Iterator, Optional, Sequence

import torch

from veles_tpu_torch.ops import launches

#: called as ``fn(kind)``, kind "graph" for a capture and "shape" for a
#: shape an eager engine recorded
_LISTENERS: list = []

#: held by the capture under way in this process
_CAPTURE_LOCK = threading.Lock()
#: captures under way in this process, and whether the collector ran
#: before the first of them began (``_collector_paused``)
_PAUSE_LOCK = threading.Lock()
_PAUSE = {"captures": 0, "was_enabled": False}


@contextlib.contextmanager
def _collector_paused() -> Iterator[None]:
    """The cyclic garbage collector off for the block; captures on
    several threads nest, and the last to end restores it."""
    with _PAUSE_LOCK:
        if _PAUSE["captures"] == 0:
            _PAUSE["was_enabled"] = gc.isenabled()
            gc.disable()
        _PAUSE["captures"] += 1
    try:
        yield
    finally:
        with _PAUSE_LOCK:
            _PAUSE["captures"] -= 1
            if _PAUSE["captures"] == 0 and _PAUSE["was_enabled"]:
                gc.enable()


def _notify(kind: str) -> None:
    for fn in list(_LISTENERS):
        fn(kind)


def note_shape() -> None:
    """An engine that runs eagerly served a shape it had not served:
    the counterpart of a capture where nothing is captured."""
    _notify("shape")


def use_graphs(cuda_graphs: Optional[bool], device: torch.device) -> bool:
    """An entry point's ``cuda_graphs`` argument resolved: None means
    graphs on a CUDA device and none elsewhere; True on another device
    raises ``ValueError``; False runs the step eagerly."""
    if cuda_graphs is None:
        return device.type == "cuda"
    if cuda_graphs and device.type != "cuda":
        raise ValueError("cuda_graphs=True needs a CUDA device, got %s"
                         % device)
    return bool(cuda_graphs)


class GraphPool:
    """The memory pool that the graphs of one engine or trainer share
    (``StepGraph(pool=)``), opened at the first capture. A pool whose
    graphs were all dropped (a trainer drops its loader step's graphs
    when the dataset is uploaded anew) refuses another capture, so a
    capture while none of the graphs it served lives opens a fresh
    pool."""

    def __init__(self) -> None:
        self._handle = None
        self._graphs: "weakref.WeakSet[StepGraph]" = weakref.WeakSet()

    def handle(self, graph: "StepGraph") -> Any:
        """The pool handle for ``graph``'s capture."""
        if not self._graphs:
            self._handle = torch.cuda.graph_pool_handle()
        self._graphs.add(graph)
        return self._handle


class StepGraph:
    """One call of ``fn(*inputs)`` captured into a CUDA graph.

    ``inputs``: the static input tensors ``fn`` reads (:meth:`replay`
    copies new values into them). ``keep``: tensors ``fn`` updates in
    place (a step count, parameters) whose values the warm-up calls must
    not advance: they are saved before the warm-up and copied back
    after it. ``pool``: the :class:`GraphPool` of the engine or trainer
    whose graphs share one (default: a pool of the graph's own). A
    capture that fails raises.
    """

    #: eager calls on a side stream before the capture: they build the
    #: kernels, create cuBLAS's handles and workspaces and let autograd
    #: set up, none of which a capture may do
    WARMUP = 2

    def __init__(self, fn: Callable[..., Any],
                 inputs: Sequence[torch.Tensor] = (),
                 keep: Sequence[torch.Tensor] = (),
                 pool: Optional[GraphPool] = None) -> None:
        self.inputs = tuple(inputs)
        self.pool = (GraphPool() if pool is None else pool).handle(self)
        with torch.no_grad():
            saved = [t.detach().clone() for t in keep]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, value in zip(keep, saved):
                t.copy_(value)
        del saved
        self.graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, _collector_paused(), \
                torch.cuda.graph(self.graph, pool=self.pool,
                                 stream=torch.cuda.Stream(),
                                 capture_error_mode="thread_local"), \
                launches.capturing() as self._launches:
            self.outputs = fn(*self.inputs)
        _notify("graph")

    def tally(self) -> dict:
        """The launches of one replay, by counter name."""
        out: dict = {}
        for _, gained in self._launches:
            for name, n in gained.items():
                out[name] = out.get(name, 0) + n
        return out

    def replay(self, *values: torch.Tensor) -> Any:
        """Copy ``values`` (as many as leading static inputs) into the
        static inputs, replay, count the launches; returns the static
        outputs."""
        for static, value in zip(self.inputs, values):
            static.copy_(value)
        self.graph.replay()
        launches.add(self._launches)
        return self.outputs
