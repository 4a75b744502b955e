"""Relay tier: a sub-coordinator that aggregates N downstream workers
into ONE upstream connection, so fan-in at the root coordinator scales
with the number of relays, not the number of workers.

Port of ``veles_tpu/distributed/relay.py``.

Topology (hierarchical parameter server, Li et al., OSDI '14 §5)::

    root Coordinator
      ├── Relay ── worker, worker, ... (N downstream)
      ├── Relay ── worker, worker, ...
      └── worker                         (plain workers still fine)

The relay speaks the ordinary worker protocol upstream (HELLO with
``relay: True`` and a ``credits`` window sized for its whole subtree)
and the ordinary coordinator protocol downstream — downstream workers
are UNMODIFIED ``Worker`` clients. It never runs jobs itself and needs
no workflow: the upstream handshake reuses the first downstream
worker's checksum, and the root's welcome tells it which data keys are
parameter state (``param_units``).

Three mechanisms deliver the fan-in win:

* **Update coalescing** — at most one un-acked upstream send is in
  flight; downstream updates arriving meanwhile accumulate and flush
  as a single ``update_multi`` batch on the next ack. Parameter
  payloads are stripped from every entry except the last one that has
  them: updates carry full replacement state, so the composition of a
  batch IS its last state ("sum of deltas composes"). Per-job control
  pieces (loader bookkeeping, decision stats) stay intact, preserving
  the root's exactly-once accounting per job id.
* **Param caching** — the relay keeps the latest parameter state it
  has seen (from upstream job payloads or downstream updates) and
  injects it into the next job of any downstream worker whose params
  are stale, exactly mirroring the root's per-worker staleness logic
  one level down. A fresh downstream joiner therefore still gets a
  full-param bootstrap even though the root only bootstraps the relay.
* **Upstream re-encoding** — downstream links run uncompressed (the
  relay is co-located with its workers); the upstream link negotiates
  the root's codec (``distributed/compress.py``) and the relay
  re-encodes the composed update, so the root's fan-in bytes get the
  full int8/bf16 saving.

Failure handling: a downstream death sends ``retract`` upstream with
the dead worker's in-flight job ids — the root requeues each through
the exactly-once machinery (``requeued_jobs``). A relay death is a
plain worker death at the root: everything in flight requeues. Loss of
the upstream drops all downstream connections; their reconnect loops
re-handshake, which lazily redials the upstream — self-healing without
bookkeeping.

CLI: ``python -m veles_tpu_torch.distributed.relay ROOT_ADDR:PORT
[-l LISTEN] [--credits N]``.
"""

from __future__ import annotations

import socket
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from veles_tpu_torch.distributed import compress
from veles_tpu_torch.distributed.protocol import (Connection, machine_id,
                                            parse_address)
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.obs import metrics as obs_metrics
from veles_tpu_torch.obs.trace import TRACER, TraceContext, make_span
from veles_tpu_torch.thread_pool import ManagedThreads


class _Downstream:
    """Per-downstream-worker relay state."""

    __slots__ = ("wid", "conn", "stale", "jobs")

    def __init__(self, wid: str, conn: Connection) -> None:
        self.wid = wid
        self.conn = conn
        #: needs the cached params injected into its next job
        self.stale = True
        #: upstream job ids in flight on this worker
        self.jobs: set = set()


class Relay(Logger):
    """One relay process/thread-group: listen downstream, multiplex
    upstream."""

    def __init__(self, upstream: str, listen: str = "127.0.0.1:0",
                 credits: int = 32,
                 encodings: Optional[Tuple[str, ...]] = None,
                 fault_plan=None) -> None:
        super().__init__()
        #: scripted chaos (distributed/faults.py): ``drop-upstream@J``
        #: hard-closes the upstream connection after J relayed jobs —
        #: the self-healing claim (downstream reconnects lazily
        #: redial) under a deterministic schedule instead of luck
        if fault_plan is None:
            from veles_tpu_torch.distributed import faults
            fault_plan = faults.FaultPlan.from_env()
        self._fault_plan = fault_plan
        self.upstream_addr = parse_address(upstream)
        self.credits = max(1, int(credits))
        self.encodings = tuple(compress.SUPPORTED if encodings is None
                               else encodings)
        self._lock = threading.RLock()
        #: serializes the lazy upstream dial: N downstream workers
        #: handshake at once and exactly ONE may dial the root (two
        #: would register two relay identities and, worse, race two
        #: recv loops onto whichever connection wins self._up)
        self._dial = threading.Lock()
        self._threads = ManagedThreads(name="relay")
        self._downstream: Dict[str, _Downstream] = {}  # guarded-by: _lock
        self._wid_seq = 0                            # guarded-by: _lock
        #: downstream wids awaiting a job/wait reply, FIFO
        self._waiters: deque = deque()               # guarded-by: _lock
        #: completed downstream updates awaiting the upstream flush
        self._pending: List[Dict[str, Any]] = []     # guarded-by: _lock
        self._unacked = 0                            # guarded-by: _lock
        self._params_cache: Dict[Any, Any] = {}      # guarded-by: _lock
        self._param_units: Tuple = ()                # guarded-by: _lock
        self._checksum: Optional[str] = None         # guarded-by: _lock
        self._initial_data: Any = None               # guarded-by: _lock
        self._up: Optional[Connection] = None        # guarded-by: _lock
        self._up_encoding = "none"                   # guarded-by: _lock
        self._up_enc: Optional[compress.Encoder] = None  # guarded-by: _lock
        self._up_dec: Optional[compress.Decoder] = None
        #: tracing negotiated with the root (offered at the upstream
        #: HELLO like encodings); passed through to downstream
        #: welcomes so workers know whether to ship spans
        self._up_tracing = False                     # guarded-by: _lock
        #: job id -> the relay-hop span dict, attached to that job's
        #: update entry so the root stitches coordinator→relay→worker
        self._relay_spans: Dict[Any, Dict[str, Any]] = {}  # guarded-by: _lock
        #: the relay's own obs registry, forwarded with each upstream
        #: flush (farm-wide aggregation under this relay's worker id)
        self.obs = obs_metrics.MetricsRegistry()
        self.obs.register("relay", self._relay_samples)
        self.done = threading.Event()   # upstream said training is over
        self._closing = False
        self._accepting = True
        self.jobs_relayed = 0                        # guarded-by: _lock
        self.updates_relayed = 0                     # guarded-by: _lock
        # update/update_multi frames up
        self.upstream_sends = 0                      # guarded-by: _lock
        self.retracted = 0                           # guarded-by: _lock
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind(parse_address(listen))
        self._listener.listen(64)
        self.address = "%s:%d" % self._listener.getsockname()

    def _relay_samples(self):
        with self._lock:
            values = (("downstream_workers", len(self._downstream),
                       "gauge"),
                      ("jobs_relayed_total", self.jobs_relayed,
                       "counter"),
                      ("updates_relayed_total", self.updates_relayed,
                       "counter"),
                      ("upstream_sends_total", self.upstream_sends,
                       "counter"),
                      ("retracted_total", self.retracted, "counter"))
        return [obs_metrics.Sample("veles_relay_%s" % name, kind, v)
                for name, v, kind in values]

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._threads.spawn(self._accept_loop, name="accept")
        self.info("relay listening on %s (upstream %s:%d)",
                  self.address, *self.upstream_addr)

    def stop(self, grace: float = 5.0) -> None:
        self._closing = True
        self._accepting = False
        # Grace: downstream workers that were computing when the root
        # declared done still need their update-ack/"done"/bye
        # round-trips — cutting their connections here would send them
        # into a reconnect loop against a dead farm.
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline:
            with self._lock:
                if not self._downstream:
                    break
            time.sleep(0.05)
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            downstream = list(self._downstream.values())
            up = self._up
        for ds in downstream:
            ds.conn.close()
        if up is not None:
            up.close()
        leaked = self._threads.join_all(timeout=max(grace, 5.0))
        if leaked:
            self.warning("relay leaked threads after stop: %s",
                         [t.name for t in leaked])

    # -- downstream --------------------------------------------------------
    def _accept_loop(self) -> None:
        while self._accepting:
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return
            try:
                self._threads.spawn(self._serve_downstream, sock, addr,
                                    name="downstream-%s:%s" % addr[:2])
            except RuntimeError:
                sock.close()
                return

    def _serve_downstream(self, sock: socket.socket, addr) -> None:
        conn = Connection(sock)
        ds: Optional[_Downstream] = None
        try:
            hello = conn.recv(timeout=30.0)
            if hello.get("type") != "handshake":
                conn.send({"type": "reject", "reason": "bad handshake"})
                return
            try:
                self._ensure_upstream(hello)
            except (ConnectionError, OSError, RuntimeError) as e:
                # RuntimeError: a handshake raced stop() and the
                # upstream-loop spawn was refused — reject, don't leak
                conn.send({"type": "reject",
                           "reason": "relay upstream unavailable: %s"
                                     % (e,)})
                return
            with self._lock:
                checksum = self._checksum
                initial_data = self._initial_data
                up_tracing = self._up_tracing
                param_units = list(self._param_units)
            if hello.get("checksum") != checksum:
                conn.send({"type": "reject",
                           "reason": "workflow checksum mismatch"})
                return
            with self._lock:
                self._wid_seq += 1
                wid = "d%04d" % self._wid_seq
                ds = _Downstream(wid, conn)
                self._downstream[wid] = ds
            conn.send({"type": "welcome", "id": wid,
                       "initial_data": initial_data,
                       # downstream links run uncompressed: the codec
                       # win is the upstream fan-in, which this relay
                       # re-encodes itself
                       "encoding": "none",
                       # tracing passes through: downstream workers
                       # ship spans only when the ROOT negotiated it
                       "tracing": up_tracing and
                       bool(hello.get("tracing")),
                       "param_units": param_units})
            self.info("downstream worker %s joined from %s", wid, addr)
            self._downstream_loop(ds)
        except (ConnectionError, OSError, EOFError) as e:
            if not self._closing:
                self.warning("downstream %s lost: %s",
                             ds.wid if ds else addr, e)
        finally:
            if ds is not None:
                self._drop_downstream(ds)

    def _downstream_loop(self, ds: _Downstream) -> None:
        while True:
            msg = ds.conn.recv()
            mtype = msg.get("type")
            if mtype == "job_request":
                with self._lock:
                    done = self.done.is_set()
                    lost = self._up is None
                    if not done and not lost:
                        self._waiters.append(ds.wid)
                        up = self._up
                if done:
                    ds.conn.send({"type": "done"})
                elif lost:
                    # upstream merely LOST (reset in progress), not
                    # training-complete: answering "done" would make
                    # this worker exit cleanly mid-run. Drop the
                    # connection instead — the worker's reconnect
                    # loop re-handshakes, which lazily redials the
                    # root (the self-healing path).
                    raise ConnectionError("relay upstream lost")
                else:
                    # forward 1:1 — the root parks excess requests in
                    # its credit machinery and answers as slots free
                    up.send({"type": "job_request"})
            elif mtype == "update":
                self._handle_downstream_update(ds, msg)
            elif mtype == "bye":
                self.info("downstream worker %s left", ds.wid)
                return
            else:
                raise ConnectionError("unknown message %r" % mtype)

    def _handle_downstream_update(self, ds: _Downstream,
                                  msg: Dict) -> None:
        job_id = msg.get("job_id")
        data = msg.get("data")
        with self._lock:
            ds.jobs.discard(job_id)
            if self._cache_params(data):
                for other in self._downstream.values():
                    other.stale = other is not ds
            entry = {"job_id": job_id, "data": data, "peer": ds.wid}
            # stitchables ride the entry: the worker's compute spans
            # + this relay's forward span, and the worker's registry
            spans = list(msg.get("spans") or ())
            relay_span = self._relay_spans.pop(job_id, None)
            if relay_span is not None:
                spans.append(relay_span)
            if spans:
                entry["spans"] = spans
            if msg.get("metrics") is not None:
                entry["metrics"] = msg["metrics"]
            self._pending.append(entry)
            self.updates_relayed += 1
        # ack immediately: the relay now owns delivery (or retract —
        # and a relay death requeues everything at the root anyway)
        ds.conn.send({"type": "update_ack", "job_id": job_id})
        self._flush_upstream()

    def _cache_params(self, data: Any) -> bool:  # holds: _lock
        """Remember the latest parameter pieces; True when any were
        present. Caller holds the lock."""
        if not isinstance(data, dict):
            return False
        cached = False
        for key in self._param_units:
            piece = data.get(key)
            if piece is not None:
                self._params_cache[key] = piece
                cached = True
        return cached

    def _drop_downstream(self, ds: _Downstream) -> None:
        with self._lock:
            if self._downstream.pop(ds.wid, None) is None:
                return
            jobs = sorted(ds.jobs)
            ds.jobs.clear()
            for job_id in jobs:  # their traces die with the retract
                self._relay_spans.pop(job_id, None)
            up = self._up
        ds.conn.close()
        if jobs and up is not None:
            try:
                up.send({"type": "retract", "job_ids": jobs})
                with self._lock:
                    self.retracted += len(jobs)
                self.info("downstream %s died: retracted %d job(s) "
                          "upstream", ds.wid, len(jobs))
            except (ConnectionError, OSError):
                pass  # upstream gone too: root requeues at our drop

    # -- upstream ----------------------------------------------------------
    def _ensure_upstream(self, hello: Dict) -> None:
        """Lazy upstream dial on the first downstream handshake: the
        relay has no workflow of its own, so it borrows the first
        worker's identity (checksum/power) and caches the welcome for
        everyone else. Subsequent calls are no-ops."""
        with self._dial:
            # The dial DELIBERATELY blocks under this lock: exactly
            # one downstream handshake may perform the upstream
            # connect+HELLO round-trip, and every peer handshake must
            # wait for its outcome anyway (two dialers would register
            # two relay identities at the root). The lock serializes
            # nothing else.
            self._dial_upstream(hello)  # noqa: VC004

    def _dial_upstream(self, hello: Dict) -> None:
        with self._lock:
            if self._up is not None:
                return
        sock = socket.create_connection(self.upstream_addr,
                                        timeout=30.0)
        sock.settimeout(None)
        up = Connection(sock)
        up.send({
            "type": "handshake",
            "checksum": hello.get("checksum"),
            "power": hello.get("power", 1.0),
            "mid": machine_id(),
            "relay": True,
            "credits": self.credits,
            "encodings": list(self.encodings),
            "tracing": TRACER.enabled,
            "metrics": self.obs.as_wire(),
        })
        welcome = up.recv(timeout=60.0)
        if welcome.get("type") != "welcome":
            up.close()
            raise ConnectionError(
                "relay rejected upstream: %s" %
                welcome.get("reason", welcome))
        encoding = welcome.get("encoding", "none")
        negotiated = encoding if encoding in self.encodings else "none"
        with self._lock:
            self._up = up
            self._up_tracing = TRACER.enabled and \
                bool(welcome.get("tracing"))
            self._checksum = hello.get("checksum")
            self._initial_data = welcome.get("initial_data")
            self._param_units = tuple(welcome.get("param_units") or ())
            self._up_encoding = negotiated
            self._up_enc = compress.Encoder(negotiated,
                                            keyframe="quant")
            self._up_dec = compress.Decoder(negotiated)
        self._threads.spawn(self._upstream_loop, up, name="upstream")
        self.info("relay joined root as %s (encoding=%s, credits=%d)",
                  welcome.get("id"), negotiated, self.credits)

    def _upstream_loop(self, up: Connection) -> None:
        try:
            while True:
                msg = up.recv()
                mtype = msg.get("type")
                if mtype == "job":
                    self._route_job(msg)
                elif mtype == "wait":
                    self._route_wait(msg)
                elif mtype == "update_ack":
                    with self._lock:
                        self._unacked = 0
                    self._flush_upstream()
                elif mtype == "done":
                    self._handle_done()
                    return
                else:
                    raise ConnectionError("unknown message %r" % mtype)
        except (ConnectionError, OSError, EOFError) as e:
            if not self._closing:
                self.warning("upstream lost (%s): dropping downstream "
                             "workers for reconnect", e)
            self._reset_upstream()

    def _route_job(self, msg: Dict) -> None:
        data = msg.get("data")
        job_id = msg.get("job_id")
        recv_t0 = time.monotonic()
        with self._lock:
            up_tracing = self._up_tracing
            up_encoding = self._up_encoding
            up_dec = self._up_dec
        ctx = TraceContext.from_wire(msg.get("trace")) \
            if up_tracing else None
        if up_encoding != "none" and data is not None:
            data = up_dec.decode(data)  # single upstream thread
        with self._lock:
            has_params = self._cache_params(data)
            if has_params:
                # the cache just advanced to the master's latest:
                # everyone is stale relative to it until resynced
                for ds in self._downstream.values():
                    ds.stale = True
            target: Optional[_Downstream] = None
            while self._waiters:
                wid = self._waiters.popleft()
                target = self._downstream.get(wid)
                if target is not None:
                    break
            if target is None:
                up = self._up
            else:
                if has_params:
                    target.stale = False
                elif target.stale and isinstance(data, dict) and \
                        self._params_cache:
                    # stale downstream worker, param-less job: inject
                    # the cached latest params — the relay-local
                    # mirror of the root's bootstrap/resync logic
                    data = dict(data)
                    data.update(self._params_cache)
                    target.stale = False
                target.jobs.add(job_id)
                self.jobs_relayed += 1
            relayed = self.jobs_relayed
        if self._fault_plan is not None and \
                self._fault_plan.relay_drop_due(relayed):
            self.warning("fault injection: dropping upstream after "
                         "%d relayed jobs", relayed)
            with self._lock:
                up_conn = self._up
            if up_conn is not None:
                up_conn.close()  # recv loop resets; lazy redial heals
        if target is None:
            # the requester died while its job was in transit and no
            # other worker is waiting: hand the job straight back
            try:
                up.send({"type": "retract", "job_ids": [job_id]})
                with self._lock:
                    self.retracted += 1
            except (ConnectionError, OSError):
                pass
            return
        if ctx is not None:
            # the relay-hop span: received upstream -> handed
            # downstream; attached to this job's update entry so the
            # root stitches all three hops under one trace id
            span = make_span("relay_forward", "farm", ctx, recv_t0,
                             time.monotonic(), job_id=job_id,
                             downstream=target.wid)
            with self._lock:
                self._relay_spans[job_id] = span
        fwd = {"type": "job", "job_id": job_id, "data": data}
        if ctx is not None:
            fwd["trace"] = msg.get("trace")
        try:
            target.conn.send(fwd)
        except (ConnectionError, OSError):
            pass  # its handler thread sees the broken pipe and drops

    def _route_wait(self, msg: Dict) -> None:
        with self._lock:
            target = None
            while self._waiters:
                wid = self._waiters.popleft()
                target = self._downstream.get(wid)
                if target is not None:
                    break
        if target is not None:
            try:
                target.conn.send(msg)
            except (ConnectionError, OSError):
                pass

    def _flush_upstream(self) -> None:
        """Coalescing flush: at most one un-acked batch in flight;
        whatever accumulated behind it goes up as ONE update_multi on
        the next ack. Under light load every update flushes alone
        (k=1, no added latency); under fan-in pressure the batch size
        self-paces to the root's ack rate — that is exactly the
        byte-aggregation the tier exists for."""
        with self._lock:
            if self._unacked or not self._pending or self._up is None:
                return
            entries = self._pending
            self._pending = []
            self._unacked = 1
            updates = self._compose(entries)
            up = self._up
            probe = self._up_encoding == "none"
        try:
            up.send({"type": "update_multi", "updates": updates,
                     "metrics": self.obs.as_wire()},
                    probe=probe)
            with self._lock:
                self.upstream_sends += 1
        except (ConnectionError, OSError):
            pass  # upstream loop notices and resets

    def _compose(self, entries: List[Dict]) -> List[Dict]:  # holds: _lock
        """Strip param payloads from all but the last param-bearing
        entry, then re-encode that one for the upstream codec. Caller
        holds the lock (encoder state is guarded by the _unacked
        gate + this lock)."""
        last_with_params = -1
        for i, entry in enumerate(entries):
            data = entry.get("data")
            if isinstance(data, dict) and any(
                    data.get(k) is not None for k in self._param_units):
                last_with_params = i
        out: List[Dict] = []
        for i, entry in enumerate(entries):
            data = entry.get("data")
            if isinstance(data, dict) and self._param_units:
                if i != last_with_params:
                    stripped = {
                        key: (None if key in self._param_units
                              else value)
                        for key, value in data.items()}
                    data = stripped
                elif self._up_encoding != "none":
                    data = self._up_enc.encode(data)
            composed = dict(entry)  # keeps spans/metrics/peer intact
            composed["data"] = data
            out.append(composed)
        return out

    def _handle_done(self, drain_timeout: float = 60.0) -> None:
        """Root says training is over. Do NOT tear down yet: other
        downstream workers may still be computing in-flight jobs, and
        their updates must reach the root (which applies or discards
        them — either fate keeps the conservation counters exact; a
        blanket bye here would strand them as requeued minibatches
        that nobody will ever run). So: answer the parked requests
        with "done", let every remaining worker finish its
        update -> request -> done -> bye cycle (the downstream loop
        answers post-done requests directly), then flush whatever
        accumulated and leave cleanly."""
        with self._lock:
            self.done.set()
            waiters = list(self._waiters)
            self._waiters.clear()
        for wid in waiters:
            with self._lock:
                ds = self._downstream.get(wid)
            if ds is not None:
                try:
                    ds.conn.send({"type": "done"})
                except (ConnectionError, OSError):
                    pass
        deadline = time.monotonic() + drain_timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._downstream:
                    break
            time.sleep(0.02)
        # final flush, ignoring the ack gate: acks piled up unread
        # during the drain, and these trailing entries must resolve
        # (as applies or post-completion discards) BEFORE the bye is
        # processed — same connection, ordered
        with self._lock:
            entries = self._pending
            self._pending = []
            updates = self._compose(entries) if entries else []
            up = self._up
            encoding = self._up_encoding
        try:
            if updates:
                up.send({"type": "update_multi", "updates": updates},
                        probe=encoding == "none")
            up.send({"type": "bye"})
        except (ConnectionError, OSError):
            pass
        with self._lock:
            totals = (self.jobs_relayed, self.updates_relayed,
                      self.upstream_sends, self.retracted)
        self.info("relay done: %d jobs relayed, %d updates (%d "
                  "upstream frames), %d retracted", *totals)

    def _reset_upstream(self) -> None:
        """Upstream gone: drop everything downstream; their reconnect
        loops re-handshake, which redials the upstream lazily."""
        with self._lock:
            up, self._up = self._up, None
            downstream = list(self._downstream.values())
            self._waiters.clear()
            self._pending = []
            self._unacked = 0
            self._params_cache = {}
            self._relay_spans.clear()
        if up is not None:
            up.close()
        for ds in downstream:
            ds.conn.close()


def main(argv=None) -> int:
    import argparse
    import logging

    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch.distributed.relay",
        description="Relay tier: aggregate N downstream workers into "
                    "one root-coordinator connection.")
    parser.add_argument("upstream", metavar="ADDR:PORT",
                        help="root coordinator address")
    parser.add_argument("-l", "--listen", default="0.0.0.0:5556",
                        metavar="ADDR:PORT",
                        help="address downstream workers connect to")
    parser.add_argument("--credits", type=int, default=32,
                        help="upstream credit window (size for the "
                             "whole subtree: ~2x downstream workers)")
    args = parser.parse_args(argv)
    relay = Relay(args.upstream, listen=args.listen,
                  credits=args.credits)
    relay.start()
    try:
        relay.done.wait()
    except KeyboardInterrupt:
        pass
    finally:
        relay.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
