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
replay of any graph of that pool.

The kernel wrappers count their launches on the host, once per Python
call. A capture makes those calls but launches nothing, and a replay
launches without a call. So the graph takes back what each counter
(``ops.flash_attention``, ``ops.lrn``, ``ops.rng``) gained during the
capture and adds it on every replay; the warm-up calls before the
capture launch for real and stay counted. The counts stay true.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from veles_tpu_torch.ops import flash_attention, lrn, rng

_COUNTERS = (flash_attention.LAUNCHES, lrn.LAUNCHES, rng.LAUNCHES)


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


class StepGraph:
    """One call of ``fn(*inputs)`` captured into a CUDA graph.

    ``inputs``: the static input tensors ``fn`` reads (:meth:`replay`
    copies new values into them). ``keep``: tensors ``fn`` updates in
    place (a step count, parameters) whose values the warm-up calls must
    not advance: they are saved before the warm-up and copied back
    after it. ``pool``: a ``torch.cuda.graph_pool_handle()`` shared by
    the graphs of one engine or trainer. A capture that fails raises.
    """

    #: eager calls on a side stream before the capture: they build the
    #: kernels, create cuBLAS's handles and workspaces and let autograd
    #: set up, none of which a capture may do
    WARMUP = 2

    def __init__(self, fn: Callable[..., Any],
                 inputs: Sequence[torch.Tensor] = (),
                 keep: Sequence[torch.Tensor] = (),
                 pool: Any = None) -> None:
        self.inputs = tuple(inputs)
        self.pool = pool if pool is not None else \
            torch.cuda.graph_pool_handle()
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
        before = [dict(counter) for counter in _COUNTERS]
        with torch.cuda.graph(self.graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            self.outputs = fn(*self.inputs)
        self._launches = []
        for counter, old in zip(_COUNTERS, before):
            self._launches.append({name: n - old[name]
                                   for name, n in counter.items()
                                   if n != old[name]})
            counter.update(old)

    def replay(self, *values: torch.Tensor) -> Any:
        """Copy ``values`` (as many as leading static inputs) into the
        static inputs, replay, count the launches; returns the static
        outputs."""
        for static, value in zip(self.inputs, values):
            static.copy_(value)
        self.graph.replay()
        for counter, gained in zip(_COUNTERS, self._launches):
            for name, n in gained.items():
                counter[name] += n
        return self.outputs
