"""Plotting service: plotter units publish data specs; a separate
renderer process draws them with matplotlib (port of
``veles_tpu/plotting.py``).

Reference capability: veles/plotter.py:48-177 + graphics_server.py /
graphics_client.py — Plotter units pickle themselves to a ZeroMQ
publisher and a dedicated matplotlib process renders (Qt/Tk/WebAgg/
PDF), with multicast so any machine can watch. Here:

- Plotter units emit plain **data-spec dicts** (kind + series), not
  pickled unit objects — nothing about rendering lives in the training
  process. A spec holds host values only: a plotter turns a tensor or
  an ``Array`` it is linked to into numpy on the graph's thread, and
  :meth:`GraphicsServer.publish` refuses a spec that still holds a
  tensor (pickling one would carry its storage, a CUDA one included,
  into the renderer).
- Transport is the port's length-prefixed-pickle Connection
  (veles_tpu_torch.distributed.protocol) over TCP; the renderer is
  ``python -m veles_tpu_torch.plotting --endpoint H:P --out DIR``
  running matplotlib Agg -> PNG files, or appending the specs to
  ``DIR/plots.jsonl`` where matplotlib is missing. The renderer starts
  no CUDA context.
- An in-process "inline" sink renders without a child process (tests,
  notebooks).
"""

from __future__ import annotations

import os
import queue
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from veles_tpu_torch.thread_pool import ManagedThreads
from veles_tpu_torch.units import Unit

#: sender-queue shutdown sentinel (close() enqueues it; the sender
#: drains pending specs first, then emits the shutdown frames)
_CLOSE = object()
#: how long a GraphicsServer waits for its spawned renderer to connect
#: while the child lives (the reference waits 10 s, which a loaded host
#: has exceeded)
RENDERER_START_S = 120.0

# ---------------------------------------------------------------------------
# plotter units
# ---------------------------------------------------------------------------


def _host(value: Any) -> np.ndarray:
    """numpy of an ``Array``, a tensor or an array-like."""
    if hasattr(value, "map_read"):
        value = value.map_read()
    if hasattr(value, "detach"):
        value = value.detach()
        if str(value.dtype) == "torch.bfloat16":
            value = value.float()
        value = value.cpu().numpy()
    return np.asarray(value)


def _refuse_tensors(spec: Any) -> None:
    """Raise TypeError when a spec holds a tensor (dict values, and the
    first element of each list: spec lists are homogeneous)."""
    if type(spec).__module__.split(".")[0] == "torch":
        raise TypeError("plot specs hold host values only, got a %s"
                        % type(spec).__name__)
    if isinstance(spec, dict):
        for value in spec.values():
            _refuse_tensors(value)
    elif isinstance(spec, (list, tuple)) and spec:
        _refuse_tensors(spec[0])


class Plotter(Unit):
    """Base: ``run`` builds a data spec and hands it to the workflow's
    graphics sink (set by GraphicsServer.attach, else a no-op)."""

    KIND = "none"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.plot_name: str = kwargs.pop("plot_name",
                                         kwargs.get("name", "plot"))
        kwargs.setdefault("view_group", "PLOTTER")
        super().__init__(workflow, **kwargs)

    def redraw_data(self) -> Dict[str, Any]:
        raise NotImplementedError

    @property
    def graphics(self):
        return getattr(self.workflow, "graphics_sink_", None)

    def run(self) -> None:
        sink = self.graphics
        if sink is None:
            return
        if getattr(self, "input", "absent") is None:
            return  # linked source has produced nothing yet
        spec = self.redraw_data()
        spec.setdefault("kind", self.KIND)
        spec.setdefault("name", self.plot_name)
        sink.publish(spec)


class AccumulatingPlotter(Plotter):
    """Scalar-vs-time curve (the reference's error/loss curves). Link
    ``input`` to any attribute holding a number; each run appends."""

    KIND = "curve"

    def __init__(self, workflow, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.input: Any = None
        self.values: List[float] = []

    def redraw_data(self) -> Dict[str, Any]:
        value = self.input() if callable(self.input) else self.input
        self.values.append(float(_host(value)))
        return {"y": list(self.values)}


class MatrixPlotter(Plotter):
    """2-D matrix heatmap (confusion matrices). ``input`` holds the
    matrix (ndarray or Array)."""

    KIND = "matrix"

    def __init__(self, workflow, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.input: Any = None

    def redraw_data(self) -> Dict[str, Any]:
        mat = _host(self.input)
        return {"matrix": mat.tolist()}


class Histogram(Plotter):
    """Value histogram of an Array/ndarray attribute."""

    KIND = "histogram"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.n_bins: int = kwargs.pop("n_bins", 20)
        super().__init__(workflow, **kwargs)
        self.input: Any = None

    def redraw_data(self) -> Dict[str, Any]:
        values = _host(self.input)
        counts, edges = np.histogram(values.ravel(),
                                     bins=self.n_bins)
        return {"counts": counts.tolist(), "edges": edges.tolist()}


class ImagePlotter(Plotter):
    """Renders an image batch sample (e.g. first kernels / samples)."""

    KIND = "image"

    def __init__(self, workflow, **kwargs: Any) -> None:
        super().__init__(workflow, **kwargs)
        self.input: Any = None

    def redraw_data(self) -> Dict[str, Any]:
        img = _host(self.input)
        img = img.astype(np.float32)
        if img.ndim >= 3:
            img = img[0]
        return {"image": img.tolist()}


class MultiHistogram(Plotter):
    """One histogram per row-group (the reference's per-layer weight
    histograms): ``inputs`` is a list of Arrays."""

    KIND = "multi_histogram"

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.n_bins: int = kwargs.pop("n_bins", 20)
        super().__init__(workflow, **kwargs)
        self.inputs: List[Any] = []

    def redraw_data(self) -> Dict[str, Any]:
        hists = []
        for arr in self.inputs:
            counts, edges = np.histogram(_host(arr).ravel(),
                                         bins=self.n_bins)
            hists.append({"counts": counts.tolist(),
                          "edges": edges.tolist()})
        return {"histograms": hists}


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------


class InlineSink:
    """Renders in-process (tests/notebooks); collects specs too."""

    def __init__(self, out_dir: Optional[str] = None) -> None:
        self.out_dir = out_dir
        self.specs: List[Dict[str, Any]] = []

    def publish(self, spec: Dict[str, Any]) -> None:
        _refuse_tensors(spec)
        self.specs.append(spec)
        if self.out_dir:
            render_spec(spec, self.out_dir)

    def close(self) -> None:
        pass


class GraphicsServer:
    """Spawns the renderer child and exposes ``publish`` to plotters.

    >>> server = GraphicsServer(out_dir="plots/")
    >>> server.attach(workflow)   # sets workflow.graphics_sink_
    ...
    >>> server.close()
    """

    def __init__(self, out_dir: str = "plots",
                 spawn_process: bool = True,
                 broadcast: Optional[str] = None) -> None:
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self._listener = socket.create_server(("127.0.0.1", 0))
        self._conn = None
        self._dead = False  # set when a spawned renderer dies
        self._lock = threading.Lock()
        self._child: Optional[subprocess.Popen] = None
        # All socket sends (renderer child + broadcast subscribers)
        # happen on a dedicated sender thread fed by this bounded
        # queue: publish() on the training thread only ever does a
        # non-blocking put and DROPS on would-block — a stalled
        # watcher can cost plots, never training time (the
        # reference's epgm pub/sub had the same drop semantics).
        self._send_queue: "queue.Queue" = queue.Queue(maxsize=256)
        self.dropped_specs = 0
        self._threads = ManagedThreads(name="graphics")
        self._sender_started = False
        # Any-machine plot watching (the reference broadcast plots
        # over epgm multicast, veles/graphics_server.py:100-109; here
        # a TCP fan-out): subscribers connect to ``broadcast``
        # ("host:port", e.g. "0.0.0.0:5001") and receive every spec —
        # `python -m veles_tpu_torch.plotting --endpoint h:p --out dir` on
        # any box is a live subscriber.
        self._subscribers: list = []             # guarded-by: _lock
        self._bcast_listener = None
        self._bcast_thread = None
        self._bcast_closed = False               # guarded-by: _lock
        if broadcast:
            from veles_tpu_torch.distributed.protocol import parse_address
            self._bcast_listener = socket.create_server(
                parse_address(broadcast, default_port=5001))
            # On the graphics ManagedThreads: close() closes the
            # listener (unblocking accept) and joins — no daemon leak.
            self._bcast_thread = self._threads.spawn(
                self._accept_subscribers, name="bcast-accept")
        if spawn_process:
            endpoint = "%s:%d" % self._listener.getsockname()[:2]
            self._child = subprocess.Popen(
                [sys.executable, "-m", "veles_tpu_torch.plotting",
                 "--endpoint", endpoint, "--out",
                 os.path.abspath(out_dir)],
                cwd=os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))))
            try:
                conn = self._accept_renderer()
            except BaseException:
                self.close()   # the listeners and the broadcast thread
                raise
            from veles_tpu_torch.distributed.protocol import Connection
            self._conn = Connection(conn)
        if self._conn is not None or self._bcast_listener is not None:
            self._threads.spawn(self._sender_loop, name="sender")
            self._sender_started = True

    def _accept_renderer(self) -> socket.socket:
        """The spawned renderer's connection. Waits while the child
        lives, up to RENDERER_START_S (its interpreter and imports can
        take seconds on a busy host), and raises at once if it exits."""
        deadline = time.monotonic() + RENDERER_START_S
        self._listener.settimeout(0.25)
        while True:
            try:
                conn, _ = self._listener.accept()
                conn.settimeout(None)
                return conn
            except socket.timeout:
                rc = self._child.poll()
                if rc is not None:
                    raise RuntimeError(
                        "the renderer exited (rc %d) before it connected"
                        % rc) from None
                if time.monotonic() > deadline:
                    self._child.kill()
                    self._child.wait()
                    raise TimeoutError(
                        "the renderer did not connect in %.0f s"
                        % RENDERER_START_S) from None

    def attach(self, workflow) -> None:
        # trailing underscore: excluded from workflow pickling (the
        # sink holds sockets/locks; snapshots must not carry it)
        workflow.graphics_sink_ = self

    @property
    def broadcast_endpoint(self):
        """(host, port) subscribers connect to, or None."""
        if self._bcast_listener is None:
            return None
        return self._bcast_listener.getsockname()[:2]

    def _accept_subscribers(self) -> None:
        from veles_tpu_torch.distributed.protocol import Connection
        while True:
            try:
                sock, _ = self._bcast_listener.accept()
            except OSError:
                return  # listener closed
            # a stalled subscriber must never block the training
            # thread's publish(): bounded sends, dropped on timeout
            sock.settimeout(5.0)
            with self._lock:
                if self._bcast_closed:
                    # accepted in the shutdown window: don't strand a
                    # watcher waiting on a stream that will never come
                    sock.close()
                    return
                self._subscribers.append(Connection(sock))

    def _send_one(self, spec) -> None:
        """Sender thread: fan out one spec. The subscriber list is
        snapshotted under the lock, but the (blocking, up to the 5 s
        socket timeout) sends happen OUTSIDE it — close() and
        _accept_subscribers never contend on a stalled watcher (VC004
        gates the discipline). A
        timeout mid-frame corrupts the length-prefixed stream, so a
        stalled subscriber is dropped, not retried."""
        with self._lock:
            subs = list(self._subscribers)
        dead = []
        for sub in subs:
            try:
                sub.send(spec)
            except OSError:
                dead.append(sub)
        if dead:
            with self._lock:
                self._subscribers = [s for s in self._subscribers
                                     if s not in dead]
            for sub in dead:
                try:
                    sub.close()
                except OSError:
                    pass
        conn = self._conn
        if conn is not None:
            try:
                conn.send(spec)
            except OSError:
                self._dead = True
                self._conn = None

    def _sender_loop(self) -> None:
        while True:
            try:
                spec = self._send_queue.get(timeout=0.2)
            except queue.Empty:
                if self._threads.stop_requested:
                    return
                continue
            if spec is _CLOSE:
                self._send_one(None)  # shutdown frame, child + subs
                return
            self._send_one(spec)

    def publish(self, spec: Dict[str, Any]) -> None:
        """Training-thread side: never blocks on a socket. Specs are
        handed to the sender thread (dropped, counted, when its queue
        is full); inline mode renders synchronously as before. Raises
        TypeError on a spec that holds a tensor."""
        _refuse_tensors(spec)
        if self._sender_started:
            try:
                self._send_queue.put_nowait(spec)
            except queue.Full:
                self.dropped_specs += 1
        if self._conn is None and not self._dead:
            render_spec(spec, self.out_dir)  # inline mode

    def close(self) -> None:
        with self._lock:
            self._bcast_closed = True
        if self._bcast_listener is not None:
            # Before the join — and shutdown() first: only a shutdown
            # actually wakes a thread parked in accept() (a bare
            # close() does not on Linux).
            try:
                self._bcast_listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._bcast_listener.close()
        if self._sender_started:
            try:  # drains queued specs FIFO, then emits the shutdown
                self._send_queue.put(_CLOSE, timeout=5.0)
            except queue.Full:
                pass  # sender is stuck; join below forces stop
        if self._sender_started or self._bcast_thread is not None:
            leaked = self._threads.join_all(timeout=15.0)
            if leaked:
                sys.stderr.write("graphics threads leaked: %s\n"
                                 % [t.name for t in leaked])
        with self._lock:
            conn, self._conn = self._conn, None
            subs, self._subscribers = self._subscribers, []
        for sub in subs:
            try:
                sub.close()
            except OSError:
                pass
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        self._listener.close()
        if self._child is not None:
            try:
                self._child.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self._child.kill()
                self._child.wait(timeout=5)


# ---------------------------------------------------------------------------
# renderer (child process body)
# ---------------------------------------------------------------------------


def render_spec(spec: Dict[str, Any], out_dir: str) -> Optional[str]:
    """Draw one spec to ``<out_dir>/<name>.png``; returns the path.
    Falls back to a JSONL sink when matplotlib is unavailable."""
    name = str(spec.get("name", "plot")).replace(os.sep, "_")
    try:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
    except ImportError:
        import json
        path = os.path.join(out_dir, "plots.jsonl")
        with open(path, "a") as fout:
            fout.write(json.dumps(spec) + "\n")
        return path

    fig, ax = plt.subplots(figsize=(6, 4))
    kind = spec.get("kind")
    if kind == "curve":
        ax.plot(spec["y"], marker="o", markersize=3)
        ax.set_xlabel("step")
    elif kind == "matrix":
        im = ax.imshow(np.asarray(spec["matrix"]), cmap="viridis")
        fig.colorbar(im, ax=ax)
    elif kind == "histogram":
        edges = np.asarray(spec["edges"])
        ax.bar(edges[:-1], spec["counts"],
               width=np.diff(edges), align="edge")
    elif kind == "image":
        img = np.asarray(spec["image"])
        ax.imshow(img.squeeze(), cmap="gray" if img.ndim == 2 or
                  img.shape[-1] == 1 else None)
        ax.axis("off")
    elif kind == "multi_histogram":
        for i, h in enumerate(spec["histograms"]):
            edges = np.asarray(h["edges"])
            ax.bar(edges[:-1], h["counts"], width=np.diff(edges),
                   align="edge", alpha=0.5, label="series %d" % i)
        ax.legend()
    else:
        ax.text(0.5, 0.5, "unknown plot kind %r" % kind,
                ha="center", va="center")
    ax.set_title(name)
    path = os.path.join(out_dir, "%s.png" % name)
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def _client_main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(prog="veles_tpu_torch.plotting")
    parser.add_argument("--endpoint", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    from veles_tpu_torch.distributed.protocol import Connection, parse_address
    host, port = parse_address(args.endpoint, default_port=5001)
    os.makedirs(args.out, exist_ok=True)

    sock = socket.create_connection((host, port))
    conn = Connection(sock)
    while True:
        try:
            spec = conn.recv()
        except (OSError, EOFError):
            return 0
        if spec is None:
            return 0
        try:
            render_spec(spec, args.out)
        except Exception as e:  # noqa: BLE001 - keep renderer alive
            print("render error: %s" % e, file=sys.stderr)


if __name__ == "__main__":
    sys.exit(_client_main())
