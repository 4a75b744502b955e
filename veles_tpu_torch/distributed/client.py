"""Worker: connect, request jobs, run them, ship updates.

Port of ``veles_tpu/distributed/client.py``; the per-job step hook
is the port's ``obs/profile.py`` (``on_step``).

Reference: veles/client.py — reconnecting FSM (:177-195), job_received
-> do_job on the thread pool (:278-318), ``--slave-death-probability``
fault injection (:303-307), bounded reconnect attempts (:488-511),
periodic computing-power re-upload.

The default loop is a double-buffered pipelined FSM in the style of
parameter-server request pipelining (Li et al., OSDI '14): job N+1 is
requested the moment job N starts computing, updates are shipped
without blocking on ``update_ack`` (acks are consumed opportunistically
from the receive stream), and the per-connection message ORDER the
coordinator's trajectory guarantee depends on is preserved — request
N+1 travels before update N, never the other way around, and updates
leave in job order. ``pipeline=False`` restores the strict
stop-and-wait loop (the pre-pipelining baseline, used by
``bench_distributed.py``'s baseline arm and the bit-identical
trajectory test).
"""

from __future__ import annotations

import socket
import time
from collections import deque
from typing import Any, Iterable, Optional

from veles_tpu_torch.distributed import compress, faults
from veles_tpu_torch.distributed.protocol import (Connection, machine_id,
                                            parse_address)
from veles_tpu_torch.logger import Logger, log_context
from veles_tpu_torch.obs import metrics as obs_metrics
from veles_tpu_torch.obs import profile as obs_profile
from veles_tpu_torch.obs.trace import TRACER, TraceContext, make_span


class WorkerDeath(Exception):
    """Injected fault (reference: --slave-death-probability)."""


class Worker(Logger):
    """Worker loop around an initialized workflow."""

    def __init__(self, workflow, address: str,
                 death_probability: float = 0.0,
                 reconnect_attempts: int = 5,
                 reconnect_delay: float = 0.5,
                 reconnect_cap: float = faults.BACKOFF_CAP,
                 pipeline: bool = True,
                 wire_version: int = 2,
                 encodings: Optional[Iterable[str]] = None,
                 die_after: Optional[int] = None,
                 fault_plan: Optional["faults.FaultPlan"] = None,
                 fault_index: Optional[int] = None,
                 tracing: bool = True,
                 metrics_every: int = 8) -> None:
        super().__init__()
        self.workflow = workflow
        self.address = parse_address(address)
        self.death_probability = death_probability
        self.reconnect_attempts = reconnect_attempts
        #: base of the jittered exponential reconnect backoff
        #: (attempt 1 ≈ delay, doubling to ``reconnect_cap``). The old
        #: linear delay*attempt retried a dead coordinator every few
        #: hundred ms forever-ish; a restarting farm now sees a calm,
        #: de-synchronized rejoin herd.
        self.reconnect_delay = reconnect_delay
        self.reconnect_cap = reconnect_cap
        #: lifetime successful-reconnect count, shipped in HELLO so
        #: the coordinator's worker_states() can report flapping links
        self.reconnects = 0
        self.pipeline = pipeline
        self.wire_version = wire_version
        #: encodings advertised at HELLO; the coordinator picks its
        #: preferred one from this list (or "none"). Pass () to
        #: emulate a pre-codec worker.
        self.encodings = tuple(compress.SUPPORTED if encodings is None
                               else encodings)
        #: negotiated per connection (welcome reply)
        self.encoding = "none"
        self._enc: Optional[compress.Encoder] = None
        self._dec: Optional[compress.Decoder] = None
        #: deterministic fault injection for elastic tests/bench: die
        #: (once) after this many completed jobs
        self.die_after = die_after
        #: scripted chaos (distributed/faults.py): the plan's events
        #: for ``fault_index`` fire at job boundaries. Falls back to
        #: the VELES_FAULTS env plan so spawned worker processes can
        #: be scripted without argv plumbing.
        if fault_plan is None:
            fault_plan = faults.FaultPlan.from_env()
        if fault_index is None:
            # spawned worker processes get their plan index via env
            # (spawn.py numbers slots; argv plumbing stays untouched)
            import os as _os
            env_index = _os.environ.get("VELES_FAULT_INDEX")
            if env_index is not None:
                fault_index = int(env_index)
        self.fault_index = fault_index
        self._faults = (fault_plan.for_worker(fault_index)
                        if fault_plan is not None else None)
        self.jobs_done = 0
        self.acks_seen = 0
        self.wid: Optional[str] = None
        #: trace propagation offered at HELLO (negotiated DOWN when
        #: the coordinator doesn't speak it — like encodings, so old
        #: peers interop without ever seeing a trace key). Pass
        #: tracing=False to emulate a pre-tracing worker.
        self.tracing = bool(tracing) and TRACER.enabled
        self.tracing_on = False   # the negotiated result
        #: this worker's own obs registry — shipped with updates every
        #: ``metrics_every`` jobs (and once at HELLO) so the
        #: coordinator aggregates the whole farm on one /metrics
        self.registry = obs_metrics.MetricsRegistry()
        self.metrics_every = max(1, int(metrics_every))
        # Client-side idle accounting: fraction of wall time NOT spent
        # computing jobs — the honest per-worker dead-time measure
        # even behind a relay tier, where the root's view covers only
        # its direct peers. The clock starts at the FIRST job receipt:
        # connect/handshake/bootstrap ramp is a fixed cost, not
        # steady-state starvation.
        self.busy_seconds = 0.0
        self._run_started: Optional[float] = None
        self._first_job_at: Optional[float] = None
        self._finished_at: Optional[float] = None
        # Fault injection must be random PER PROCESS: a framework-keyed
        # stream replays identically after a respawn under a fixed -r
        # seed, so a worker fated to die on its first job would die on
        # that job on every respawn, forever (observed: blacklist
        # exhaustion in the soak test). Chaos is not reproducible state.
        import random as _random
        self._rand = _random.Random()

    # -- connection --------------------------------------------------------
    def _connect(self) -> Connection:
        sock = socket.create_connection(self.address, timeout=30.0)
        sock.settimeout(None)
        conn = Connection(sock, wire_version=self.wire_version)
        # the worker's own wire accounting joins its registry; the
        # registry snapshot rides HELLO (and updates) upstream
        self.registry.register(
            "wire", lambda: obs_metrics.wire_samples(
                conn.stats.as_dict(), (("role", "worker"),)))
        conn.send({
            "type": "handshake",
            "checksum": self.workflow.checksum,
            "power": self.workflow.computing_power,
            "mid": machine_id(),
            "pid": __import__("os").getpid(),
            "encodings": list(self.encodings),
            "reconnects": self.reconnects,
            "tracing": self.tracing,
            "metrics": self.registry.as_wire(),
        })
        welcome = conn.recv(timeout=60.0)
        if welcome.get("type") != "welcome":
            raise ConnectionError(
                "rejected by coordinator: %s" %
                welcome.get("reason", welcome))
        self.wid = welcome["id"]
        # tracing negotiated like encodings: ON only when both ends
        # offered it — a legacy coordinator's welcome carries no
        # "tracing" key and this worker ships no spans/trace keys
        self.tracing_on = self.tracing and \
            bool(welcome.get("tracing"))
        #: the peer speaks obs at all (ships us nothing, but accepts
        #: registry snapshots with updates) — key PRESENCE, not value:
        #: a new coordinator answers "tracing" even when negotiating
        #: this worker's tracing down
        self._obs_peer = "tracing" in welcome
        # Per-connection codec state: a reconnect starts from fresh
        # keyframes on both sides. Updates use quantized keyframes
        # (error feedback absorbs the first frame's rounding), job
        # params decode against the coordinator's f32-keyframe stream.
        encoding = welcome.get("encoding", "none")
        self.encoding = encoding if encoding in self.encodings else "none"
        self._enc = compress.Encoder(self.encoding, keyframe="quant")
        self._dec = compress.Decoder(self.encoding)
        initial = welcome.get("initial_data")
        if initial:
            self.workflow.apply_initial_data_from_master(initial)
        self.info("joined as %s", self.wid)
        return conn

    # -- the job loop ------------------------------------------------------
    @property
    def idle_frac(self) -> float:
        """Fraction of wall time not spent computing jobs, measured
        from the first job receipt to the farm's "done" (the clock
        freezes when the worker finishes, so reading this after
        teardown does not count shutdown time as idle)."""
        started = self._first_job_at or self._run_started
        if started is None:
            return 0.0
        end = self._finished_at or time.perf_counter()
        total = end - started
        if total <= 0:
            return 0.0
        return min(max(1.0 - self.busy_seconds / total, 0.0), 1.0)

    def run(self) -> int:
        """Work until the coordinator says done; returns jobs done."""
        attempts = 0
        if self._run_started is None:
            self._run_started = time.perf_counter()
        while True:
            reconnecting = attempts > 0
            connected = False
            try:
                # Count the in-progress reconnect BEFORE the HELLO so
                # the coordinator's worker_states() sees it; a failed
                # attempt is rolled back by the handler below.
                if reconnecting:
                    self.reconnects += 1
                conn = self._connect()
                connected = True
                attempts = 0
                work = self._work_pipelined if self.pipeline else \
                    self._work
                finished = work(conn)
                if finished:
                    return self.jobs_done
            except WorkerDeath:
                if self._finished_at is None:
                    self._finished_at = time.perf_counter()
                self.warning("injected worker death after %d jobs",
                             self.jobs_done)
                raise
            except (ConnectionError, OSError, EOFError) as e:
                if reconnecting and not connected:
                    self.reconnects -= 1  # counted attempt never landed
                attempts += 1
                if attempts > self.reconnect_attempts:
                    self.warning("giving up after %d reconnects (%s)",
                                 attempts - 1, e)
                    raise
                delay = faults.jittered_backoff(
                    attempts, base=self.reconnect_delay,
                    cap=self.reconnect_cap, rand=self._rand.random)
                self.info("reconnecting (%d/%d) in %.2fs after %s",
                          attempts, self.reconnect_attempts, delay, e)
                time.sleep(delay)

    def _maybe_die(self, conn: Connection) -> None:
        if self._faults is not None:
            # scripted events: may raise WorkerDeath / ConnectionError
            # or arm a one-shot wire fault on the connection
            self._faults.at_job(self.jobs_done, conn)
        if self.die_after is not None and \
                self.jobs_done >= self.die_after:
            self.die_after = None  # die once, not on every respawn
            self._finished_at = time.perf_counter()  # freeze idle clock
            conn.close()
            raise WorkerDeath()
        if self.death_probability and \
                self._rand.random() < self.death_probability:
            self._finished_at = time.perf_counter()
            conn.close()
            raise WorkerDeath()

    def _work(self, conn: Connection) -> bool:
        """Strict stop-and-wait loop (pipeline=False): one job in
        flight, blocks on every ``update_ack`` — two round-trips of
        dead time per job, kept as the comparison baseline."""
        while True:
            conn.send({"type": "job_request"})
            msg = conn.recv()
            mtype = msg.get("type")
            if mtype == "done":
                conn.send({"type": "bye"})
                conn.close()
                self._finished_at = time.perf_counter()
                self.info("done: %d jobs", self.jobs_done)
                return True
            if mtype == "wait":
                time.sleep(msg.get("delay", 0.1))
                continue
            if mtype != "job":
                raise ConnectionError("unexpected message %r" % mtype)
            if self._first_job_at is None:
                self._first_job_at = time.perf_counter()
            self._maybe_die(conn)
            msg["data"] = self._decode_job(msg["data"])
            conn.send(self._job_payload(msg),
                      probe=self.encoding == "none")
            ack = conn.recv()
            if ack.get("type") != "update_ack":
                raise ConnectionError("expected update_ack, got %r" % ack)
            self.acks_seen += 1
            self.jobs_done += 1

    def _work_pipelined(self, conn: Connection) -> bool:
        """Double-buffered FSM: while job N computes, the request for
        job N+1 is already at the coordinator, so its reply is sitting
        in the socket buffer by the time update N ships — the worker
        never waits a round-trip between jobs. Acks are consumed
        opportunistically whenever the receive stream yields one."""
        pending_requests = 0   # job_requests whose job/wait/done reply
        #                        has not been received yet
        jobs: deque = deque()  # received, not yet computed (≤ 1 deep)
        wait_delay: Optional[float] = None
        while True:
            if jobs:
                job = jobs.popleft()
                if pending_requests == 0:
                    # double-buffer: request the NEXT job before this
                    # one starts computing
                    conn.send({"type": "job_request"})
                    pending_requests += 1
                self._maybe_die(conn)
                conn.send(self._job_payload(job),
                          probe=self.encoding == "none")
                self.jobs_done += 1
                continue
            if wait_delay is not None:
                time.sleep(wait_delay)
                wait_delay = None
            if pending_requests == 0:
                conn.send({"type": "job_request"})
                pending_requests += 1
            msg = conn.recv()
            mtype = msg.get("type")
            if mtype == "job":
                pending_requests -= 1
                if self._first_job_at is None:
                    self._first_job_at = time.perf_counter()
                # decode at RECEIVE time: delta mirrors must advance
                # in wire order, not compute order
                msg["data"] = self._decode_job(msg["data"])
                jobs.append(msg)
            elif mtype == "wait":
                pending_requests -= 1
                wait_delay = msg.get("delay", 0.1)
            elif mtype == "update_ack":
                self.acks_seen += 1
            elif mtype == "done":
                conn.send({"type": "bye"})
                conn.close()
                self._finished_at = time.perf_counter()
                self.info("done: %d jobs", self.jobs_done)
                return True
            else:
                raise ConnectionError("unexpected message %r" % mtype)

    def _job_payload(self, msg: dict) -> dict:
        """Run one (already decoded) job and build its update
        message: the compute span rides along when tracing was
        negotiated (the coordinator stitches coordinator → relay →
        worker timelines from it), and this worker's obs registry
        snapshot rides every ``metrics_every``-th update so the
        coordinator's /metrics covers the whole farm. Log lines
        emitted while the job computes carry the job/trace ids
        (``logger.log_context`` — off by default, costs nothing)."""
        job_id = msg.get("job_id")
        ctx = TraceContext.from_wire(msg.get("trace")) \
            if self.tracing_on else None
        t0 = time.monotonic()
        with log_context(job=job_id, wid=self.wid,
                         trace=ctx.trace_id if ctx else None):
            update = self._do_job(msg["data"])
        t1 = time.monotonic()
        out = {"type": "update", "job_id": job_id,
               "data": self._encode_update(update)}
        if ctx is not None:
            # shipped, not ingested locally: the span's ONE home is
            # the coordinator's buffer (exactly-once conservation —
            # in-process loopback farms share this process's tracer,
            # and a local copy would double every compute span)
            out["spans"] = [make_span("job_compute", "farm", ctx,
                                      t0, t1, wid=self.wid,
                                      job_id=job_id)]
        if self._obs_peer and \
                (self.jobs_done + 1) % self.metrics_every == 0:
            out["metrics"] = self.registry.as_wire()
        return out

    def _decode_job(self, data: Any) -> Any:
        if self.encoding != "none" and data is not None:
            return self._dec.decode(data)
        return data

    def _encode_update(self, update: Any) -> Any:
        if self.encoding != "none" and update is not None:
            return self._enc.encode(update)
        return update

    def _do_job(self, data: Any):
        result = {}

        def callback(update):
            result["update"] = update

        t0 = time.perf_counter()
        try:
            self.workflow.do_job(data, None, callback)
        finally:
            self.busy_seconds += time.perf_counter() - t0
            obs_profile.on_step()  # --profile-steps on the farm plane
        if "update" not in result:
            raise RuntimeError(
                "workflow run finished without producing an update "
                "(end_point never ran — check worker-mode gating)")
        return result["update"]


def run_worker(workflow, address: str,
               death_probability: float = 0.0,
               fault_plan: Optional["faults.FaultPlan"] = None) -> int:
    """CLI -m entry."""
    worker = Worker(workflow, address,
                    death_probability=death_probability,
                    fault_plan=fault_plan)
    return worker.run()
