"""REST inference serving: RESTfulAPI unit + RestfulLoader pair (port
of ``veles_tpu/restful_api.py``).

Reference capability: veles/restful_api.py:54-217 (Twisted HTTP unit
answering POST with the model's output for the posted input) paired
with veles/loader/restful.py.

The HTTP front (``POST /apply`` -> ``{"output": ...}``, plus
``/healthz`` and ``/metrics``) is
:class:`veles_tpu_torch.serve.server.ServeServer` at ``path``. Two
backends:

- **engine mode** (``RESTfulAPI(wf, engine=InferenceEngine...)`` or
  :meth:`RESTfulAPI.for_workflow`): requests go through a dynamic
  micro-batcher into the engine's bucketed forward (captured per bucket
  on the card) — the serving hot path; no unit-graph loop involved.
- **loader-graph mode** (link ``output`` from the last forward and set
  ``loader``): each POST enqueues its samples into the
  :class:`RestfulLoader` with a ticket; the graph loop serves the
  minibatch through the forwards; ``run()`` (linked after the last
  forward) pulls the output to the host once a minibatch, pops the
  tickets and completes the HTTP responses. The port's QueueLoader
  keeps a fed batch as one queue item and serves its rows in order, so
  the FIFO ticket attribution holds.

Endpoint: ``POST /apply`` body ``{"input": [[...], ...]}`` ->
``{"output": [[...], ...]}`` — the same either way.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Deque, List, Optional, Tuple

import numpy as np

from veles_tpu_torch.loader.interactive import QueueLoader
from veles_tpu_torch.units import Unit


class RestfulLoader(QueueLoader):
    """QueueLoader that tracks (ticket, n_samples) per request so the
    API unit can route outputs back to the right HTTP response."""

    MAPPING = "restful"

    def __init__(self, workflow, **kwargs: Any) -> None:
        kwargs.setdefault("feed_timeout", None)
        super().__init__(workflow, **kwargs)

    def init_unpickled(self) -> None:
        super().init_unpickled()
        from collections import deque
        self._tickets_: Deque[Tuple[Any, int]] = deque()
        self._served_tickets_: List[Tuple[Any, int]] = []

    def feed_request(self, ticket: Any, batch: np.ndarray) -> None:
        self._tickets_.append((ticket, len(batch)))
        self.feed(batch)

    def serve_next_minibatch(self, slave_id) -> None:
        super().serve_next_minibatch(slave_id)
        # attribute the served rows to requests, in FIFO order
        remaining = self.minibatch_size
        self._served_tickets_ = []
        while remaining > 0 and self._tickets_:
            ticket, n = self._tickets_.popleft()
            take = min(n, remaining)
            self._served_tickets_.append((ticket, take))
            if take < n:  # request split across minibatches
                self._tickets_.appendleft((ticket, n - take))
            remaining -= take


class RESTfulAPI(Unit):
    """HTTP front over the serve/ subsystem.

    Loader-graph mode: link after the last forward with
    ``link_attrs(forward, 'output')`` and link the loader instance.
    Engine mode: pass ``engine=`` (an
    :class:`~veles_tpu_torch.serve.engine.InferenceEngine`); no graph links
    needed and ``run()`` is a no-op.

    kwargs: ``host``/``port`` (default 127.0.0.1:0 = ephemeral),
    ``path`` (default /apply), ``engine``, ``max_batch``,
    ``max_delay_ms``, ``max_queue_rows`` (engine mode batching knobs).
    """

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.host: str = kwargs.pop("host", "127.0.0.1")
        self.port: int = kwargs.pop("port", 0)
        self.path: str = kwargs.pop("path", "/apply")
        # trailing underscore: runtime-only (device weights, captured
        # graphs and locks must not ride a workflow pickle; rebuild
        # with for_workflow after a snapshot restore)
        self.engine_ = kwargs.pop("engine", None)
        self.max_batch: int = kwargs.pop("max_batch", 64)
        self.max_delay_ms: float = kwargs.pop("max_delay_ms", 2.0)
        self.max_queue_rows: int = kwargs.pop("max_queue_rows", 1024)
        kwargs.setdefault("view_group", "SERVICE")
        super().__init__(workflow, **kwargs)
        self.output = None            # linked: last forward's output
        self.loader: Optional[RestfulLoader] = None
        if self.engine_ is None:
            self.demand("output", "loader")

    @classmethod
    def for_workflow(cls, workflow, **kwargs: Any) -> "RESTfulAPI":
        """Engine-backed API over a trained StandardWorkflow: the
        engine's forward (loader normalizer included) on the device the
        workflow was initialized on (the card when it has none) — the
        graph loop is not involved in serving at all."""
        from veles_tpu_torch.serve.engine import InferenceEngine
        if "engine" not in kwargs:
            device = getattr(workflow, "device", None)
            kwargs["engine"] = InferenceEngine.from_workflow(
                workflow, device=getattr(device, "torch_device", None))
        return cls(workflow, **kwargs)

    def init_unpickled(self) -> None:
        super().init_unpickled()
        # preserve a constructor-passed engine; after a snapshot
        # restore it is gone (device state) — rebuild via
        # for_workflow
        self.engine_ = getattr(self, "engine_", None)
        self._server_ = None
        self._registry_ = None
        self._ticket_counter_ = 0
        self._responses_: dict = {}
        self._responses_lock_ = threading.Lock()

    def initialize(self, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(**kwargs)
        if retry:
            return retry
        if self._server_ is None:
            self._start_server()
        return None

    @property
    def endpoint(self):
        return self._server_.endpoint

    @property
    def url(self) -> str:
        return "http://%s:%d%s" % (*self.endpoint, self.path)

    @property
    def metrics(self):
        """The default model's ServeMetrics (observability surface)."""
        return self._registry_.get(None).metrics

    def _start_server(self) -> None:
        from veles_tpu_torch.serve.registry import ModelRegistry
        from veles_tpu_torch.serve.server import ServeServer
        self._registry_ = ModelRegistry()
        if self.engine_ is not None:
            self._registry_.add(
                "default", self.engine_, max_batch=self.max_batch,
                max_delay_ms=self.max_delay_ms,
                max_queue_rows=self.max_queue_rows)
        else:
            self._registry_.add_callable("default", self.submit)
        self._server_ = ServeServer(
            self._registry_, host=self.host, port=self.port,
            path=self.path, timeout=30.0)
        self.info("REST API serving on %s (%s-backed)", self.url,
                  "engine" if self.engine_ is not None else "graph")

    # -- loader-graph request plumbing --------------------------------------
    def submit(self, batch: np.ndarray, timeout: float = 30.0) \
            -> np.ndarray:
        """Called on HTTP threads: enqueue + wait for the graph loop."""
        with self._responses_lock_:
            self._ticket_counter_ += 1
            ticket = self._ticket_counter_
            self._responses_[ticket] = queue.Queue(maxsize=1)
        self.loader.feed_request(ticket, batch)
        try:
            chunks = []
            expected = len(batch)
            got = 0
            while got < expected:
                chunk = self._responses_[ticket].get(timeout=timeout)
                chunks.append(chunk)
                got += len(chunk)
            return np.concatenate(chunks, axis=0)
        except queue.Empty:
            raise TimeoutError
        finally:
            with self._responses_lock_:
                self._responses_.pop(ticket, None)

    def run(self) -> None:
        """Graph loop: route this minibatch's output rows to tickets.
        (Engine mode: nothing to do — serving bypasses the graph.)"""
        if self.engine_ is not None:
            return
        # the one host read of this minibatch's forward output
        out = self.output
        if hasattr(out, "map_read"):
            out = out.map_read()
        if hasattr(out, "detach"):
            out = out.detach().float().cpu().numpy()
        out = np.asarray(out)
        offset = 0
        for ticket, n in self.loader._served_tickets_:
            rows = out[offset:offset + n]
            offset += n
            q = self._responses_.get(ticket)
            if q is not None:
                q.put(np.array(rows))
        self.loader._served_tickets_ = []

    def stop(self) -> None:
        if self._server_ is not None:
            # legacy-path drains are the graph loop's business; the
            # engine path drains its batcher
            self._server_.stop(drain=self.engine_ is not None,
                               timeout=10.0)
            self._server_ = None
            self._registry_ = None
        super().stop()
