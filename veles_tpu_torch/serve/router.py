"""Fleet router: one HTTP front tier over N replica ServeServers.

Port of ``veles_tpu/serve/router.py``; the wire (paths, JSON bodies,
headers, status codes) is the reference's, so a port router fronts a
reference replica and the other way round.

Everything below ``serve/server.py`` is a single failure domain: one
hung device call or one bad weight push takes down all traffic. This
module is the second tier over it: an HTTP front that load-balances
``POST /apply`` and ``POST /generate`` (including streaming) over
replicas using their real health signals, survives replica death
mid-request, and gives the fleet manager (``serve/fleet.py``) the
pause/resume hooks rolling rollouts need.

Routing signals — one ``/healthz`` scrape per replica per poll tick
(the satellite that put the admission signals INTO /healthz exists
for exactly this; no second /metrics fetch per decision):

- ``drain_rate_rows_per_s`` — the replica's dispatch-time EWMA
  service rate (tokens/s on the decode plane);
- ``queue_depth`` — admission-control occupancy;
- ``stuck_for_s`` / the 503 ``{"stuck": true}`` flip — a replica
  whose device call is wedged is routed AROUND, not retried into;
- ``draining`` — a replica mid-rollout (or shutting down) takes no
  new work.

Placement picks the replica with the smallest predicted wait
``(queue_depth + router-side in-flight) / drain_rate`` among routable
replicas; round-robin breaks ties and covers the pre-calibration
window. SESSION AFFINITY for generative traffic: a request carrying a
``session`` body field (or ``X-Session-Id`` header) sticks to the
replica that served the session before while that replica stays
routable — the KV-slab locality story (a follow-up turn re-using a
warm prefix must not hop replicas).

Edge admission re-uses the batchers' shed discipline one tier up: a
deadline-carrying request that provably cannot make its budget given
the FLEET's best predicted wait is refused at the door (503 + a
Retry-After computed from the aggregate drain rate) without burning a
replica round trip; the remaining budget is forwarded to the replica
via ``X-Deadline-Ms`` so the replica-side admission stays exact.

Failover: a replica that dies (connection refused/reset, torn reply)
or answers ``draining`` mid-request gets its in-flight NON-STREAMING
tickets re-admitted on a sibling — exactly once per ticket id (the
router mints ``X-Ticket-Id`` when the client didn't; inference is
idempotent, and the one-retry bound keeps a poison request from
cascading through the fleet). STREAMING clients get a clean
mid-stream error record (``{"error": ..., "replica": ...}`` as the
final ND-JSON line) — a half-streamed sequence cannot be replayed.

Observability across the hop: the router mints/echoes ``X-Trace-Id``
exactly like a replica and FORWARDS it, so one trace id covers
router → replica → engine (a ``route`` span brackets the proxied
exchange); ``GET /metrics?format=prometheus`` aggregates every
replica's registry under ``replica=`` labels next to the router's own
``veles_router_*`` series — one exposition for the whole fleet.
"""

from __future__ import annotations

import http.client
import json
import select
import socket
import threading
import time
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.obs import metrics as obs_metrics
from veles_tpu_torch.obs.trace import TRACER, TraceContext, elapsed_s
from veles_tpu_torch.serve.server import (_TRACE_ID_RE,  # shared
                                          _TrackingHTTPServer)
from veles_tpu_torch.thread_pool import ManagedThreads

#: headers forwarded verbatim to the replica (plus the ones the
#: router computes: X-Deadline-Ms, X-Trace-Id, X-Ticket-Id). X-Shape
#: carries the shape of the port's raw-row ``/apply`` bodies
#: (``application/octet-stream``), which the reference has not.
_FORWARD_HEADERS = ("Content-Type", "X-Priority", "X-Session-Id",
                    "X-Shape")

#: transport-level failures that mean "this replica did not serve the
#: request" — the failover-eligible class (socket.timeout is OSError)
_TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


class NoReplicaAvailable(RuntimeError):
    """No routable replica (all dead/draining/stuck/paused)."""


class _ReplicaConnection(http.client.HTTPConnection):
    """HTTPConnection with TCP_NODELAY: the router writes one small
    POST per request and relays per-token chunks — Nagle + delayed
    ACK turns each into a ~40 ms stall a request."""

    def connect(self) -> None:
        super().connect()
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP,
                                 socket.TCP_NODELAY, 1)
        except OSError:
            pass


def _readable(sock) -> bool:
    """True when ``sock`` has data or an EOF waiting (a zero-timeout
    poll)."""
    try:
        return bool(select.select([sock], [], [], 0)[0])
    except (OSError, ValueError):
        return True


class _ReplicaPool:
    """Keep-alive connection pool, keyed by (host, port): a new TCP
    connect per forwarded request costs syscalls AND correctness of
    the latency story (loopback hides it; a real network does not).
    Connections come back via :meth:`put` only after a clean
    exchange; a replica's entries are dropped wholesale when it
    fails (:meth:`invalidate`) — a respawned replica at the same
    address must never inherit a dead socket."""

    def __init__(self, max_idle_per_replica: int = 32) -> None:
        self._lock = threading.Lock()
        self._idle: Dict[Tuple[str, int],
                         List[Any]] = {}         # guarded-by: _lock
        self._max_idle = int(max_idle_per_replica)

    def get(self, host: str, port: int,
            timeout: float) -> Tuple[Any, bool]:
        """(connection, was_pooled). An idle connection whose socket
        is readable is stale (an idle keep-alive peer sends nothing
        but its FIN or RST): it is closed here and never sent on."""
        key = (host, port)
        while True:
            with self._lock:
                idle = self._idle.get(key)
                conn = idle.pop() if idle else None
            if conn is None:
                return _ReplicaConnection(host, port,
                                          timeout=timeout), False
            if conn.sock is None or _readable(conn.sock):
                conn.close()
                continue
            conn.sock.settimeout(timeout)
            return conn, True

    def put(self, host: str, port: int, conn: Any) -> None:
        key = (host, port)
        with self._lock:
            idle = self._idle.setdefault(key, [])
            if len(idle) < self._max_idle:
                idle.append(conn)
                return
        conn.close()

    def invalidate(self, host: str, port: int) -> None:
        with self._lock:
            idle = self._idle.pop((host, port), [])
        for conn in idle:
            conn.close()

    def close_all(self) -> None:
        with self._lock:
            pools = list(self._idle.values())
            self._idle.clear()
        for idle in pools:
            for conn in idle:
                conn.close()


class RouterMetrics:
    """Router-tier counters + latency distribution (the replica-side
    numbers live in the replicas' own registries; these are the
    routing decisions only)."""

    def __init__(self, window: int = 2048) -> None:
        self._lock = threading.Lock()
        self.requests_total = 0                  # guarded-by: _lock
        self.failovers_total = 0                 # guarded-by: _lock
        self.readmitted_total = 0                # guarded-by: _lock
        self.shed_total = 0                      # guarded-by: _lock
        self.no_replica_total = 0                # guarded-by: _lock
        self.errors_total = 0                    # guarded-by: _lock
        self.stream_errors_total = 0             # guarded-by: _lock
        self.affinity_hits_total = 0             # guarded-by: _lock
        self._routed: Dict[str, int] = {}        # guarded-by: _lock
        self._latencies: deque = deque(maxlen=window)  # guarded-by: _lock

    def observe_routed(self, replica: str) -> None:
        with self._lock:
            self.requests_total += 1
            self._routed[replica] = self._routed.get(replica, 0) + 1

    def observe_latency(self, seconds: float) -> None:
        with self._lock:
            self._latencies.append(seconds)

    def observe(self, counter: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, counter, getattr(self, counter) + n)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            lat = list(self._latencies)
            doc = {
                "requests_total": self.requests_total,
                "failovers_total": self.failovers_total,
                "readmitted_total": self.readmitted_total,
                "shed_total": self.shed_total,
                "no_replica_total": self.no_replica_total,
                "errors_total": self.errors_total,
                "stream_errors_total": self.stream_errors_total,
                "affinity_hits_total": self.affinity_hits_total,
                "routed": dict(self._routed),
            }
        if lat:
            ms = np.asarray(lat) * 1000.0
            p50, p99 = np.percentile(ms, (50, 99))
            doc["latency_ms"] = {"p50": float(p50), "p99": float(p99)}
        else:
            doc["latency_ms"] = {"p50": 0.0, "p99": 0.0}
        return doc

    def samples(self) -> List[obs_metrics.Sample]:
        snap = self.snapshot()
        out = [obs_metrics.Sample("veles_router_%s" % key, "counter",
                                  snap[key])
               for key in ("requests_total", "failovers_total",
                           "readmitted_total", "shed_total",
                           "no_replica_total", "errors_total",
                           "stream_errors_total",
                           "affinity_hits_total")]
        for name, count in sorted(snap["routed"].items()):
            out.append(obs_metrics.Sample(
                "veles_router_routed_total", "counter", count,
                (("replica", name),)))
        for q, key in (("0.5", "p50"), ("0.99", "p99")):
            out.append(obs_metrics.Sample(
                "veles_router_latency_ms", "summary",
                snap["latency_ms"][key], (("quantile", q),)))
        return out


class Replica:
    """One replica's routing state (owned by the Router lock)."""

    __slots__ = ("name", "host", "port", "healthy", "draining",
                 "stuck", "paused", "queue_depth", "drain_rate",
                 "stuck_for_s", "failures", "last_ok", "in_flight",
                 "reason")

    def __init__(self, name: str, host: str, port: int) -> None:
        self.name = name
        self.host = host
        self.port = int(port)
        self.healthy = False      # no scrape yet: unproven, unrouted
        self.draining = False
        self.stuck = False
        self.paused = False       # fleet-manager drain-then-swap hold
        self.queue_depth = 0
        self.drain_rate = 0.0
        self.stuck_for_s = 0.0
        self.failures = 0
        self.last_ok: Optional[float] = None
        self.in_flight = 0        # router-side forwards right now
        self.reason = "unprobed"

    @property
    def routable(self) -> bool:
        return (self.healthy and not self.draining and
                not self.stuck and not self.paused)

    @property
    def address(self) -> str:
        return "%s:%d" % (self.host, self.port)

    def state_doc(self) -> Dict[str, Any]:
        return {
            "address": self.address,
            "healthy": self.healthy,
            "routable": self.routable,
            "draining": self.draining,
            "stuck": self.stuck,
            "paused": self.paused,
            "queue_depth": self.queue_depth,
            "drain_rate_rows_per_s": round(self.drain_rate, 3),
            "stuck_for_s": round(self.stuck_for_s, 3),
            "in_flight": self.in_flight,
            "failures": self.failures,
            "reason": self.reason,
        }


class Router(Logger):
    """Replica table + health scraping + placement (no HTTP of its
    own — :class:`RouterServer` is the front; the fleet manager calls
    the pause/resume/add/remove surface directly)."""

    def __init__(self, health_interval_s: float = 0.25,
                 replica_timeout: float = 30.0,
                 shed_margin: float = 0.7,
                 affinity_capacity: int = 4096,
                 threads: Optional[ManagedThreads] = None) -> None:
        super().__init__()
        self.health_interval_s = float(health_interval_s)
        self.replica_timeout = float(replica_timeout)
        #: edge-admission safety factor — same semantics as the
        #: replica-side MicroBatcher.shed_margin, applied to the
        #: FLEET's best predicted wait
        self.shed_margin = float(shed_margin)
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}  # guarded-by: _lock
        self._names = 0                          # guarded-by: _lock
        self._rr = 0  # round-robin tie-breaker;   guarded-by: _lock
        # session -> replica name                  guarded-by: _lock
        self._affinity: "dict" = {}              # guarded-by: _lock
        self._affinity_order: deque = deque()    # guarded-by: _lock
        self._affinity_capacity = int(affinity_capacity)
        self.metrics = RouterMetrics()
        self._threads = threads if threads is not None else \
            ManagedThreads(name="router")
        self._own_threads = threads is None
        self._threads.spawn(self._health_loop, name="health")

    # -- membership --------------------------------------------------------
    def add_replica(self, address: str,
                    name: Optional[str] = None) -> str:
        """Register ``host:port`` (a ServeServer's endpoint); the
        health loop probes it and starts routing once it answers.
        Re-adding a known address is a no-op (the discovery watcher
        hears every beacon repeatedly)."""
        host, _, port = address.rpartition(":")
        with self._lock:
            for replica in self._replicas.values():
                if replica.host == (host or "127.0.0.1") and \
                        replica.port == int(port):
                    return replica.name
            if name is None:
                name = "r%d" % self._names
            self._names += 1
            self._replicas[name] = Replica(
                name, host or "127.0.0.1", int(port))
        self.info("replica %s added at %s", name, address)
        self.scrape(name)  # route immediately if it is already up
        return name

    def remove_replica(self, name: str) -> None:
        with self._lock:
            self._replicas.pop(name, None)
            for session in [s for s, r in self._affinity.items()
                            if r == name]:
                del self._affinity[session]

    def replica_names(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    def routable_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values()
                       if r.routable)

    def states(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {name: replica.state_doc()
                    for name, replica in self._replicas.items()}

    # -- fleet-manager surface ---------------------------------------------
    def pause(self, name: str) -> None:
        """Stop routing NEW work to ``name`` (drain-then-swap: the
        replica finishes what it holds; the fleet manager swaps once
        its queue empties)."""
        with self._lock:
            if name in self._replicas:
                self._replicas[name].paused = True

    def resume(self, name: str) -> None:
        with self._lock:
            if name in self._replicas:
                self._replicas[name].paused = False

    # -- health ------------------------------------------------------------
    def _health_loop(self) -> None:
        while not self._threads.wait_stop(self.health_interval_s):
            for name in self.replica_names():
                self.scrape(name)

    def scrape(self, name: str) -> Optional[Dict[str, Any]]:
        """One synchronous ``/healthz`` probe of ``name``; updates the
        routing state and returns the signal document (None when the
        replica is unreachable or unknown)."""
        with self._lock:
            replica = self._replicas.get(name)
        if replica is None:
            return None
        timeout = max(min(self.health_interval_s * 4, 2.0), 0.5)
        conn = http.client.HTTPConnection(replica.host, replica.port,
                                          timeout=timeout)
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            doc = json.loads(resp.read() or b"{}")
        except _TRANSPORT_ERRORS + (ValueError,):
            self._mark_down(name, "unreachable")
            return None
        finally:
            conn.close()
        status = doc.get("status")
        with self._lock:
            replica = self._replicas.get(name)
            if replica is None:
                return None
            was_routable = replica.routable
            replica.healthy = True
            replica.failures = 0
            replica.last_ok = time.monotonic()
            replica.draining = status == "draining"
            replica.stuck = bool(doc.get("stuck"))
            replica.queue_depth = int(doc.get("queue_depth") or 0)
            replica.drain_rate = float(
                doc.get("drain_rate_rows_per_s") or 0.0)
            replica.stuck_for_s = float(doc.get("stuck_for_s") or 0.0)
            replica.reason = status or "ok"
            now_routable = replica.routable
        if now_routable and not was_routable:
            self.info("replica %s back in rotation", name)
        return doc

    def _mark_down(self, name: str, reason: str) -> None:
        with self._lock:
            replica = self._replicas.get(name)
            if replica is None:
                return
            was = replica.healthy
            replica.healthy = False
            replica.failures += 1
            replica.reason = reason
            # a dead replica's sessions re-pin on their next request
            for session in [s for s, r in self._affinity.items()
                            if r == name]:
                del self._affinity[session]
        if was:
            self.warning("replica %s out of rotation (%s)",
                         name, reason)

    def note_transport_failure(self, name: str) -> None:
        """A forward to ``name`` failed at the transport level: take
        it out of rotation NOW (the next health tick re-probes; a
        respawned replica at the same address recovers)."""
        self._mark_down(name, "transport failure")

    # -- placement ---------------------------------------------------------
    def _pin(self, session: str, name: str) -> None:  # holds: _lock
        # bounded: the oldest pin falls off (its next request re-pins)
        if session not in self._affinity and \
                len(self._affinity_order) >= self._affinity_capacity:
            while self._affinity_order:
                old = self._affinity_order.popleft()
                if old in self._affinity:
                    del self._affinity[old]
                    break
        if session not in self._affinity:
            self._affinity_order.append(session)
        self._affinity[session] = name

    def pick(self, rows: int = 1, session: Optional[str] = None,
             exclude: Tuple[str, ...] = ()) -> Replica:
        """The replica for one request: session pin if still
        routable, else smallest predicted wait
        ``(queue_depth + in-flight) / drain_rate`` (round-robin while
        uncalibrated / tied). Increments the replica's in-flight
        count — pair with :meth:`done`."""
        with self._lock:
            candidates = [r for r in self._replicas.values()
                          if r.routable and r.name not in exclude]
            if not candidates:
                raise NoReplicaAvailable(
                    "no routable replica (%d registered)"
                    % len(self._replicas))
            chosen = None
            if session is not None:
                pinned = self._affinity.get(session)
                if pinned is not None:
                    chosen = next((r for r in candidates
                                   if r.name == pinned), None)
                    if chosen is not None:
                        self.metrics.observe("affinity_hits_total")
            if chosen is None:
                def wait(r: Replica) -> float:
                    backlog = r.queue_depth + r.in_flight * max(rows, 1)
                    if r.drain_rate > 0:
                        return backlog / r.drain_rate
                    return backlog * 1e-3  # uncalibrated: spread flat
                # PRIMARY key: the router-side in-flight count — it
                # is LIVE, while the scraped queue depth is up to a
                # health tick stale; ranking on the stale number
                # first herds every request of a tick onto whichever
                # replica looked idle last scrape (convoys, p99
                # blowup). The scraped ETA breaks in-flight ties,
                # and a TRUE rotating round-robin breaks full ties
                # (anything hash-based can degenerate to one replica
                # forever when hashes collide mod N).
                self._rr += 1
                rr = self._rr
                index = min(
                    range(len(candidates)),
                    key=lambda i: (candidates[i].in_flight,
                                   wait(candidates[i]),
                                   (i - rr) % len(candidates)))
                chosen = candidates[index]
                if session is not None:
                    self._pin(session, chosen.name)
            chosen.in_flight += 1
            return chosen

    def done(self, replica: Replica) -> None:
        with self._lock:
            replica.in_flight = max(0, replica.in_flight - 1)

    def fleet_eta_s(self, rows: int = 1) -> Optional[float]:
        """The fleet's best predicted time-to-service for a request
        arriving NOW (None while no replica has calibrated a drain
        rate) — the edge-admission model."""
        with self._lock:
            etas = [(r.queue_depth + rows) / r.drain_rate
                    for r in self._replicas.values()
                    if r.routable and r.drain_rate > 0]
        return min(etas) if etas else None

    # -- discovery ---------------------------------------------------------
    def watch_beacons(self, checksum: Optional[str] = None,
                      port: Optional[int] = None,
                      interval_s: float = 1.0) -> None:
        """Background UDP listener for ``role=replica`` beacons
        (``discovery.Announcer(role="replica")``): every announced
        serve address joins the table — the zero-config replica-
        discovery plane for autoscaled/external replicas."""
        from veles_tpu_torch.distributed.discovery import \
            discover_replicas

        def loop() -> None:
            while not self._threads.stop_requested:
                for address in discover_replicas(
                        timeout=interval_s, port=port,
                        checksum=checksum):
                    try:
                        self.add_replica(address)
                    except Exception:  # noqa: BLE001 — one junk
                        # beacon (unauthenticated UDP) must not kill
                        # the watcher for the router's lifetime
                        self.warning("ignoring malformed replica "
                                     "beacon %r", address)

        self._threads.spawn(loop, name="beacon-watch")

    # -- lifecycle ---------------------------------------------------------
    def stop(self) -> None:
        if self._own_threads:
            self._threads.request_stop()
            self._threads.join_all(timeout=10)


class RouterServer(Logger):
    """The HTTP front of a :class:`Router` — same endpoint surface as
    a replica (``POST /apply[/m]``, ``POST /generate[/m]`` incl.
    streaming, ``GET /healthz``, ``GET /metrics``,
    ``GET /debug/trace``), so clients and load tests cannot tell the
    tiers apart, plus failover/affinity/edge-shed on the way through.
    """

    def __init__(self, router: Optional[Router] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 replica_timeout: float = 30.0,
                 default_deadline_ms: Optional[float] = None,
                 health_interval_s: float = 0.25) -> None:
        super().__init__()
        self.router = router if router is not None else Router(
            health_interval_s=health_interval_s,
            replica_timeout=replica_timeout)
        self.replica_timeout = float(replica_timeout)
        self.default_deadline_ms = default_deadline_ms
        self.metrics = self.router.metrics
        #: ticket ids already re-admitted once (bounded): the
        #: exactly-once failover discipline
        self._readmit_lock = threading.Lock()
        self._readmitted: set = set()         # guarded-by: _readmit_lock
        self._readmit_order: deque = deque(   # guarded-by: _readmit_lock
            maxlen=4096)
        self._pool = _ReplicaPool()
        self._httpd = _TrackingHTTPServer((host, port),
                                          self._make_handler())
        self._threads = ManagedThreads(name="router-http")
        self._threads.spawn(self._httpd.serve_forever, name="listener")

    # -- addresses ---------------------------------------------------------
    @property
    def endpoint(self):
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        return "http://%s:%d" % self.endpoint

    # -- re-admission bookkeeping ------------------------------------------
    def _may_readmit(self, ticket_id: str) -> bool:
        """True exactly once per ticket id (second failure of the
        same ticket answers 502 instead of hopping forever)."""
        with self._readmit_lock:
            if ticket_id in self._readmitted:
                return False
            if len(self._readmit_order) == self._readmit_order.maxlen:
                oldest = self._readmit_order[0]
                self._readmitted.discard(oldest)
            self._readmit_order.append(ticket_id)
            self._readmitted.add(ticket_id)
            return True

    # -- replica I/O -------------------------------------------------------
    def _forward_once(self, replica: Replica, path: str, body: bytes,
                      headers: Dict[str, str], timeout: float
                      ) -> Tuple[int, bytes, Dict[str, str]]:
        """One pooled keep-alive exchange with a replica. The pool
        hands out only connections whose socket shows no close from
        the peer (:meth:`_ReplicaPool.get`), so a failure here is the
        replica's (death, blackhole) and propagates to the failover.

        The reference instead retries a pooled connection that failed
        within 0.1 s on a fresh socket to the same replica, taking it
        for stale. A replica killed mid-request fails as fast, so that
        retry can land on the dying replica's listener in its shutdown
        window and come back ``503 draining`` (a failover without the
        re-admission), and on a loaded host a stale exchange can
        outlast the clock and spend the ticket's one re-admission (a
        deliberate divergence)."""
        conn, _ = self._pool.get(replica.host, replica.port, timeout)
        try:
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        except _TRANSPORT_ERRORS:
            conn.close()
            self._pool.invalidate(replica.host, replica.port)
            raise
        if resp.will_close:
            conn.close()
        else:
            self._pool.put(replica.host, replica.port, conn)
        return resp.status, data, dict(resp.getheaders())

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # small replies + relayed per-token chunks: Nagle +
            # delayed ACK would add ~40 ms stalls per exchange
            disable_nagle_algorithm = True

            def log_message(self, *args) -> None:
                pass

            _trace_ctx: Optional[TraceContext] = None

            def _reply(self, code: int, doc: Any,
                       headers: Optional[Dict[str, str]] = None,
                       content_type: str = "application/json"
                       ) -> None:
                body = doc if isinstance(doc, bytes) else (
                    doc.encode() if isinstance(doc, str)
                    else json.dumps(doc).encode())
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                if self._trace_ctx is not None:
                    self.send_header("X-Trace-Id",
                                     self._trace_ctx.trace_id)
                for key, value in (headers or {}).items():
                    self.send_header(key, value)
                self.end_headers()
                self.wfile.write(body)

            def _read_body(self) -> bytes:
                try:
                    length = int(self.headers.get("Content-Length")
                                 or 0)
                except ValueError:
                    length = 0
                return self.rfile.read(length) if length > 0 else b""

            # -- request classification -----------------------------------
            def _request_meta(self, raw: bytes, generate: bool):
                """(deadline_ms, session, stream, doc) for one
                request: headers first, body fields when present.
                /apply bodies are only parsed when the header signals
                are absent AND the body mentions the fields (bulk row
                payloads must not pay a JSON parse at the router AND
                the replica)."""
                deadline = self.headers.get("X-Deadline-Ms")
                deadline = float(deadline) if deadline else None
                session = self.headers.get("X-Session-Id")
                stream = False
                doc = None
                need_parse = generate or (
                    (deadline is None and b'"deadline_ms"' in raw) or
                    (session is None and b'"session"' in raw))
                if need_parse:
                    try:
                        doc = json.loads(raw)
                    except ValueError:
                        doc = None
                if isinstance(doc, dict):
                    if deadline is None and \
                            doc.get("deadline_ms") is not None:
                        deadline = float(doc["deadline_ms"])
                    if session is None and doc.get("session"):
                        session = str(doc["session"])
                    stream = bool(doc.get("stream", False))
                if deadline is None:
                    deadline = server.default_deadline_ms
                if deadline is not None and deadline <= 0:
                    raise ValueError("deadline_ms must be > 0")
                return deadline, session, stream, doc

            def _forward_headers(self, ticket_id: str,
                                 deadline_abs: Optional[float]
                                 ) -> Dict[str, str]:
                headers = {"X-Ticket-Id": ticket_id}
                for key in _FORWARD_HEADERS:
                    value = self.headers.get(key)
                    if value:
                        headers[key] = value
                headers.setdefault("Content-Type", "application/json")
                if deadline_abs is not None:
                    # the REMAINING budget crosses the hop, so the
                    # replica's deadline clock matches the client's
                    remaining_ms = (deadline_abs -
                                    time.monotonic()) * 1000.0
                    headers["X-Deadline-Ms"] = "%.3f" % max(
                        remaining_ms, 0.001)
                if self._trace_ctx is not None:
                    headers["X-Trace-Id"] = self._trace_ctx.trace_id
                return headers

            # -- POST ------------------------------------------------------
            def do_POST(self) -> None:
                self._trace_ctx = None
                url = urlparse(self.path)
                if "chunked" in (self.headers.get(
                        "Transfer-Encoding") or "").lower():
                    self.close_connection = True
                    self._reply(411, {"error": "chunked request "
                                      "bodies unsupported; send "
                                      "Content-Length"})
                    return
                if TRACER.enabled:
                    supplied = self.headers.get("X-Trace-Id")
                    if supplied and not _TRACE_ID_RE.match(supplied):
                        supplied = None
                    self._trace_ctx = TraceContext(supplied) \
                        if supplied else TraceContext.new()
                t0 = time.monotonic()
                try:
                    self._route(url)
                finally:
                    if self._trace_ctx is not None:
                        TRACER.add("route", "router", self._trace_ctx,
                                   t0, time.monotonic(),
                                   path=url.path)
                    server.metrics.observe_latency(elapsed_s(t0))

            def _route(self, url) -> None:
                raw = self._read_body()
                generate = url.path == "/generate" or \
                    url.path.startswith("/generate/")
                if not generate and url.path != "/apply" and \
                        not url.path.startswith("/apply/"):
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    deadline_ms, session, stream, _ = \
                        self._request_meta(raw, generate)
                except (ValueError, TypeError) as e:
                    # float([50]) is a TypeError: junk deadline_ms of
                    # ANY shape answers the documented 400, never a
                    # torn connection
                    self._reply(400, {"error": "bad request: %s" % e})
                    return
                now = time.monotonic()
                deadline_abs = now + deadline_ms / 1000.0 \
                    if deadline_ms is not None else None
                # edge shed: the batchers' admission discipline against
                # the FLEET's best predicted wait — a doomed request
                # must not burn a replica round trip
                eta = server.router.fleet_eta_s()
                if deadline_abs is not None and eta is not None and \
                        eta >= server.router.shed_margin * \
                        (deadline_abs - now):
                    server.metrics.observe("shed_total")
                    import math
                    self._reply(503, {"error": "shed: fleet cannot "
                                      "meet deadline (eta %.1f ms)"
                                      % (eta * 1000.0)},
                                headers={"Retry-After": str(max(
                                    1, math.ceil(eta)))})
                    return
                ticket_id = self.headers.get("X-Ticket-Id") or \
                    uuid.uuid4().hex
                if stream:
                    self._route_stream(url.path, raw, ticket_id,
                                       session, deadline_abs)
                else:
                    self._route_once_or_failover(
                        url.path, raw, ticket_id, session,
                        deadline_abs)

            def _route_once_or_failover(self, path: str, raw: bytes,
                                        ticket_id: str,
                                        session: Optional[str],
                                        deadline_abs: Optional[float]
                                        ) -> None:
                """Non-streaming forward with exactly-once
                re-admission: a transport failure (or a draining
                reply) re-admits the ticket on a sibling ONCE."""
                tried: List[str] = []
                while True:
                    try:
                        replica = server.router.pick(
                            session=session, exclude=tuple(tried))
                    except NoReplicaAvailable:
                        server.metrics.observe("no_replica_total")
                        self._reply(503, {"error": "no healthy "
                                          "replica"},
                                    headers={"Retry-After": "1"})
                        return
                    timeout = server.replica_timeout
                    if deadline_abs is not None:
                        timeout = min(timeout, max(
                            deadline_abs - time.monotonic(), 0.05)
                            + 1.0)
                    try:
                        try:
                            status, data, headers = \
                                server._forward_once(
                                    replica, path, raw,
                                    self._forward_headers(
                                        ticket_id, deadline_abs),
                                    timeout)
                        finally:
                            server.router.done(replica)
                    except _TRANSPORT_ERRORS:
                        server.router.note_transport_failure(
                            replica.name)
                        server.metrics.observe("failovers_total")
                        tried.append(replica.name)
                        if not server._may_readmit(ticket_id):
                            server.metrics.observe("errors_total")
                            self._reply(502, {
                                "error": "replica %s failed and the "
                                "ticket was already re-admitted "
                                "once" % replica.name,
                                "ticket": ticket_id})
                            return
                        server.metrics.observe("readmitted_total")
                        server.info(
                            "re-admitting ticket %s on a sibling "
                            "(replica %s failed mid-request)",
                            ticket_id, replica.name)
                        continue
                    if status == 503 and b'"draining"' in data:
                        # mid-rollout race: the replica began draining
                        # after the pick — a sibling serves it now
                        tried.append(replica.name)
                        server.metrics.observe("failovers_total")
                        continue
                    server.metrics.observe_routed(replica.name)
                    fwd = {"X-Replica": replica.name,
                           "X-Ticket-Id": ticket_id}
                    if "Retry-After" in headers:
                        fwd["Retry-After"] = headers["Retry-After"]
                    self._reply(status, data, headers=fwd)
                    return

            def _route_stream(self, path: str, raw: bytes,
                              ticket_id: str,
                              session: Optional[str],
                              deadline_abs: Optional[float]) -> None:
                """Streaming /generate: relay the replica's chunked
                ND-JSON records one by one. A replica that dies
                mid-stream yields a clean final error record — a
                half-streamed sequence is NOT re-admitted."""
                try:
                    replica = server.router.pick(session=session)
                except NoReplicaAvailable:
                    server.metrics.observe("no_replica_total")
                    self._reply(503, {"error": "no healthy replica"},
                                headers={"Retry-After": "1"})
                    return
                # a dedicated NODELAY connection per stream (never
                # pooled back: a mid-stream abort leaves it dirty)
                conn = _ReplicaConnection(
                    replica.host, replica.port,
                    timeout=server.replica_timeout)
                try:
                    try:
                        conn.request(
                            "POST", path, body=raw,
                            headers=self._forward_headers(
                                ticket_id, deadline_abs))
                        resp = conn.getresponse()
                    except _TRANSPORT_ERRORS:
                        server.router.note_transport_failure(
                            replica.name)
                        server.metrics.observe("failovers_total")
                        # nothing streamed yet: a plain error is
                        # still honest (client may safely retry)
                        self._reply(502, {"error": "replica %s died "
                                          "before streaming"
                                          % replica.name})
                        return
                    if resp.status != 200:
                        data = resp.read()
                        self._reply(resp.status, data,
                                    headers={"X-Replica":
                                             replica.name})
                        return
                    server.metrics.observe_routed(replica.name)
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.send_header("X-Replica", replica.name)
                    if self._trace_ctx is not None:
                        self.send_header("X-Trace-Id",
                                         self._trace_ctx.trace_id)
                    self.end_headers()

                    def chunk(data: bytes) -> bool:
                        try:
                            self.wfile.write(b"%x\r\n" % len(data) +
                                             data + b"\r\n")
                            self.wfile.flush()
                            return True
                        except OSError:
                            self.close_connection = True
                            return False

                    alive = True
                    closed_clean = False
                    try:
                        while True:
                            line = resp.readline()
                            if not line:
                                break
                            if not alive:
                                continue  # drain: client went away
                            alive = chunk(line)
                            if b'"done"' in line or \
                                    b'"error"' in line:
                                closed_clean = True
                    except _TRANSPORT_ERRORS:
                        pass  # handled below as an unclean close
                    if not closed_clean:
                        # the replica died mid-stream: the client
                        # gets a CLEAN final error record, and the
                        # router takes the replica out of rotation
                        server.router.note_transport_failure(
                            replica.name)
                        server._pool.invalidate(replica.host,
                                                replica.port)
                        server.metrics.observe("stream_errors_total")
                        if alive:
                            alive = chunk((json.dumps(
                                {"error": "replica died mid-stream",
                                 "replica": replica.name,
                                 "ticket": ticket_id}) +
                                "\n").encode())
                    if alive:
                        try:
                            self.wfile.write(b"0\r\n\r\n")
                        except OSError:
                            self.close_connection = True
                finally:
                    server.router.done(replica)
                    conn.close()

            # -- GET -------------------------------------------------------
            def do_GET(self) -> None:
                self._trace_ctx = None
                url = urlparse(self.path)
                if url.path == "/healthz":
                    states = server.router.states()
                    routable = sum(1 for s in states.values()
                                   if s["routable"])
                    code = 200 if routable else 503
                    self._reply(code, {
                        "status": "ok" if routable else "no-replicas",
                        "role": "router",
                        "replicas": len(states),
                        "routable": routable,
                        "replica_states": states})
                    return
                if url.path == "/metrics":
                    self._do_metrics(url)
                    return
                if url.path == "/debug/trace":
                    trace_id = parse_qs(url.query).get(
                        "trace", [None])[0]
                    self._reply(200, TRACER.export_json(trace_id))
                    return
                self._reply(404, {"error": "not found"})

            def _do_metrics(self, url) -> None:
                fmt = parse_qs(url.query).get("format", [""])[0]
                accept = self.headers.get("Accept", "")
                replica_docs = server.fetch_replica_metrics()
                if fmt == "prometheus" or (not fmt and
                                           "text/plain" in accept):
                    samples = server.metrics.samples()
                    for name, doc in sorted(replica_docs.items()):
                        samples.extend(
                            _replica_samples(name, doc))
                    samples.extend(
                        obs_metrics.REGISTRY.samples())
                    self._reply(
                        200, obs_metrics.render(samples),
                        content_type="text/plain; version=0.0.4")
                    return
                self._reply(200, {
                    "_router": {
                        **server.metrics.snapshot(),
                        "replica_states": server.router.states(),
                    },
                    "replicas": replica_docs,
                })

        return Handler

    # -- fleet-wide metrics ------------------------------------------------
    def fetch_replica_metrics(self) -> Dict[str, Dict[str, Any]]:
        """Every HEALTHY replica's ``/metrics`` JSON document, by
        replica name (unreachable replicas are skipped — the scrape
        must not hang the exposition)."""
        out: Dict[str, Dict[str, Any]] = {}
        for name, state in self.router.states().items():
            if not state["healthy"]:
                continue
            host, _, port = state["address"].rpartition(":")
            conn = http.client.HTTPConnection(host, int(port),
                                              timeout=2.0)
            try:
                conn.request("GET", "/metrics")
                resp = conn.getresponse()
                doc = json.loads(resp.read() or b"{}")
                if isinstance(doc, dict):
                    out[name] = doc
            except _TRANSPORT_ERRORS + (ValueError,):
                continue
            finally:
                conn.close()
        return out

    # -- lifecycle ---------------------------------------------------------
    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._threads.join_all(timeout=10)
        self._pool.close_all()
        self.router.stop()


def _replica_samples(replica: str,
                     doc: Dict[str, Any]) -> List[obs_metrics.Sample]:
    """One replica's ``/metrics`` JSON → samples with a ``replica=``
    label appended, through the SAME converters the replica's own
    Prometheus form uses (``veles_serve_*`` / ``veles_gen_*`` series
    stay byte-identical in shape; only the label is new). Keys that
    are not model snapshots (``_scheduler``/``_slowest``/``_obs``)
    are skipped — they are per-process documents, not per-model."""
    out: List[obs_metrics.Sample] = []
    label = ("replica", replica)
    for model, snap in sorted(doc.items()):
        if model.startswith("_") or not isinstance(snap, dict):
            continue
        try:
            if "tokens_per_sec" in snap:
                samples = obs_metrics.gen_samples(model, snap)
            elif "qps" in snap:
                samples = obs_metrics.serve_samples(model, snap)
            else:
                continue
        except KeyError:
            continue  # foreign/older snapshot shape: skip, not crash
        for sample in samples:
            sample.labels += (label,)
        out.extend(samples)
    return out
