"""Interactive and streaming loaders: feed a running workflow from user
code or a socket.

Port of ``veles_tpu/loader/interactive.py``. ``QueueLoader`` serves
what ``feed()`` enqueues as TEST minibatches and blocks in ``run()``
until data or ``close()`` arrives; ``InteractiveLoader`` is the handle
user code feeds; ``StreamLoader`` listens on a TCP socket for
length-prefixed pickled arrays (an empty frame closes the stream), and
``send_stream`` is its client. One ``feed()`` enqueues its rows as one
item, so the rows of one fed batch (one frame) are served together,
never split by the short wait for a minibatch's further rows; and a
close frame takes effect once every connection accepted before its own
is read to its end, so data sent before a close is served before it.
Every
service thread (the accept loop, one receiver a connection) belongs to
a :class:`veles_tpu_torch.thread_pool.ManagedThreads`: ``stop()``
requests the stop, closes the listener and joins them, and
``Workflow.stop`` sweeps any unit's ``_service_threads_`` as a
backstop.
"""

from __future__ import annotations

import pickle
import queue
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, List, Optional

import numpy as np

from veles_tpu_torch.loader.base import TEST, Loader
from veles_tpu_torch.thread_pool import ManagedThreads


class QueueLoader(Loader):
    """Serves whatever ``feed()`` enqueues; ``run`` blocks until data
    or ``close()`` arrives. class_lengths is a virtual TEST stream."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.sample_shape = tuple(kwargs.pop("sample_shape"))
        self.feed_timeout: Optional[float] = kwargs.pop(
            "feed_timeout", None)
        super().__init__(workflow, **kwargs)
        self.complete = False

    def init_unpickled(self) -> None:
        super().init_unpickled()
        self._queue_ = queue.Queue()
        # rows of a fed batch not served yet
        self._rows_: "deque[np.ndarray]" = deque()
        self._service_threads_ = ManagedThreads(
            name=getattr(self, "name", "queue-loader"))

    def feed(self, sample: np.ndarray) -> None:
        """Enqueue one sample (or a batch: leading dim). A batch is one
        item of the queue, so its rows are served together."""
        arr = np.asarray(sample, dtype=np.float32)
        if arr.shape == self.sample_shape:
            arr = arr[None]
        if arr.shape[1:] != self.sample_shape:
            raise ValueError("fed sample shape %s != %s" %
                             (arr.shape[1:], self.sample_shape))
        if len(arr):
            self._queue_.put(arr)

    def close(self) -> None:
        """No more data: the workflow's gate will see train_ended."""
        self._queue_.put(None)

    # -- Loader interface ----------------------------------------------------
    def load_data(self) -> None:
        # Virtual: one TEST "class" whose length is unknown; report one
        # minibatch worth so geometry works, and loop until close().
        # (minibatch_size_requested, not max_minibatch_size: the latter
        # is derived FROM class_lengths and would still read 1 here.)
        self.class_lengths[TEST] = max(1, self.minibatch_size_requested)

    def create_minibatch_data(self) -> None:
        shape = (self.max_minibatch_size,) + self.sample_shape
        self.minibatch_data.reset(np.zeros(shape, dtype=np.float32))

    def fill_minibatch(self) -> None:
        pass  # filled in serve_next_minibatch

    def initialize(self, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(**kwargs)
        if retry:
            return retry
        if self._service_threads_.stop_requested:
            # re-initialize after a stop(): arm the stop/join
            # discipline again so serving (and, in subclasses,
            # spawning) works
            self._service_threads_.reset()
        return None

    def _next_row(self, first: bool):
        """Dequeue one sample, polling in short slices so that
        ``stop()`` interrupts a blocked serve (the one stop discipline
        shared with ManagedThreads owners). Rows left of a fed batch
        come first. Raises ``queue.Empty`` on the feed timeout; returns
        None for a stop-interrupted wait or a ``close()``."""
        if self._rows_:
            return self._rows_.popleft()
        timeout = self.feed_timeout if first else 0.05
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.stopped and \
                not self._service_threads_.stop_requested:
            if deadline is None:
                slice_ = 0.25
            else:
                slice_ = min(0.25, deadline - time.monotonic())
                if slice_ <= 0:
                    raise queue.Empty
            try:
                item = self._queue_.get(timeout=slice_)
            except queue.Empty:
                continue
            if item is None:
                return None
            self._rows_.extend(item)
            return self._rows_.popleft()
        return None  # stopped: serve what we have (possibly nothing)

    def serve_next_minibatch(self, slave_id) -> None:
        data = self.minibatch_data.map_invalidate()
        data[:] = 0
        count = 0
        while count < self.max_minibatch_size and not self.complete:
            try:
                row = self._next_row(first=count == 0)
            except queue.Empty:
                if count == 0 and self.feed_timeout is not None:
                    self.complete = True
                break
            if row is None:
                if self.stopped or self._service_threads_.stop_requested:
                    break
                self.complete = True
                break
            data[count] = row
            count += 1
        self.minibatch_class = TEST
        self.minibatch_size = count
        self.minibatch_offset = count
        self.last_minibatch <<= self.complete
        self.epoch_ended <<= self.complete
        self.train_ended <<= self.complete
        self.normalize_minibatch()

    def stop(self) -> None:
        super().stop()
        leaked = self._service_threads_.join_all()
        if leaked:
            self.warning("leaked service threads after stop: %s",
                         [t.name for t in leaked])


class InteractiveLoader(QueueLoader):
    """The reference's IPython-feed loader equivalent: user code holds
    a handle and calls ``loader.feed(x)`` / ``loader.close()``."""

    MAPPING = "interactive"


class StreamLoader(QueueLoader):
    """TCP-fed loader (ZeroMQLoader capability): listens on a socket;
    each frame is a length-prefixed pickled ndarray. An empty frame
    closes the stream. ``endpoint`` property reports (host, port)."""

    MAPPING = "stream"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.bind_host: str = kwargs.pop("bind_host", "127.0.0.1")
        self.bind_port: int = kwargs.pop("bind_port", 0)
        super().__init__(workflow, **kwargs)

    def init_unpickled(self) -> None:
        super().init_unpickled()
        self._server_ = None
        # one event a connection accepted so far, set once it is read
        # to its end
        self._received_: List[threading.Event] = []

    def initialize(self, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(**kwargs)
        if retry:
            return retry
        self._server_ = socket.create_server(
            (self.bind_host, self.bind_port))
        self._server_.settimeout(1.0)
        self._service_threads_.spawn(self._accept_loop, name="accept")
        self.info("stream loader listening on %s:%d", *self.endpoint)
        return None

    @property
    def endpoint(self):
        return self._server_.getsockname()[:2]

    def _accept_loop(self) -> None:
        while not self.complete and \
                not self._service_threads_.stop_requested:
            try:
                conn, _ = self._server_.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            earlier = list(self._received_)
            done = threading.Event()
            self._received_.append(done)
            try:
                self._service_threads_.spawn(self._recv_loop, conn, done,
                                             earlier, name="recv")
            except RuntimeError:  # stop raced the accept
                conn.close()
                return

    def _recv_loop(self, conn: socket.socket, done: threading.Event,
                   earlier: List[threading.Event]) -> None:
        """Feed the frames of one connection. A close frame waits for
        the connections accepted before this one to be read to their
        ends, so data sent before a close is served before it."""
        try:
            with conn:
                conn.settimeout(0.5)
                while True:
                    header = self._recv_exact(conn, 4)
                    if header is None:
                        return
                    (length,) = struct.unpack("!I", header)
                    if length == 0:
                        for event in earlier:
                            while not event.wait(0.1):
                                if self._service_threads_.stop_requested:
                                    return
                        self.close()
                        return
                    payload = self._recv_exact(conn, length)
                    if payload is None:
                        return
                    self.feed(pickle.loads(payload))
        except Exception as e:  # noqa: BLE001 - network feeder thread
            self.warning("stream feeder error: %s", e)
        finally:
            done.set()

    def _recv_exact(self, conn: socket.socket, n: int):
        buf = b""
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except socket.timeout:
                if self._service_threads_.stop_requested:
                    return None
                continue
            if not chunk:
                return None
            buf += chunk
        return buf

    def stop(self) -> None:
        self.complete = True
        self._service_threads_.request_stop()
        if self._server_ is not None:
            try:
                self._server_.close()
            except OSError:
                pass
        super().stop()


def send_stream(endpoint, sample: Optional[np.ndarray]) -> None:
    """Client helper: send one sample (or batch) to a StreamLoader;
    ``None`` sends the close frame."""
    with socket.create_connection(endpoint) as conn:
        if sample is None:
            conn.sendall(struct.pack("!I", 0))
            return
        payload = pickle.dumps(np.asarray(sample, dtype=np.float32),
                               protocol=4)
        conn.sendall(struct.pack("!I", len(payload)) + payload)
