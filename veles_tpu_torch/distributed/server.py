"""Coordinator: elastic job farming with failure handling.

Port of ``veles_tpu/distributed/server.py``; farm checkpoints go
through the port's ``AsyncCheckpointer`` (``veles_tpu_torch.checkpoint``).

Reference: veles/server.py — per-slave FSM (:230-254), handshake with
checksum match (:478-529), job scheduling with backpressure (:596-611),
hanged-slave blacklist (:383-395), adaptive job timeout = mean+3σ of
the worker's history (:619-635), respawn hooks (:637-655), pause/resume
(:734-745). All of that is host-control logic and carries over almost
verbatim — minus the Twisted reactor (plain threads) and minus any
gradient traffic (that rides the mesh collectives).

Job pump: handler threads never generate jobs — they enqueue the
requesting worker and go straight back to receiving (updates keep
applying while generation runs). A single producer thread drains the
request queue, generates each job OUTSIDE the coordinator lock, and
replies directly. Workflow data safety comes from the per-unit
data_locks, not a coordinator-wide lock.

Pipelined issue (parameter-server request pipelining, Li et al.,
OSDI '14): each worker may hold up to ``max_outstanding`` jobs
(default 2) identified by per-job ids, so the pipelined client's
request for job N+1 is served while job N computes. Two mechanisms
keep the single-worker trajectory BIT-IDENTICAL to stop-and-wait
despite generation running ahead of application:

* **param staleness tracking** — job payloads carry parameter state
  (the GD/LM units ship params both ways with replacement semantics),
  and a job generated before the worker's previous update lands would
  carry stale params that clobber the worker's own newer state. The
  coordinator therefore skips the param pieces
  (``generate_data_for_slave(include_params=False)``) unless some
  OTHER worker's update was applied since this worker last synced —
  a worker's local params are always at least as new as what the
  master could send it, until a foreign update lands.
* **post-completion discard** — with jobs in flight, one extra job can
  be computed after the decision unit latches completion; its update
  is discarded (``Workflow.job_stream_complete``), never applied, so
  the final weights equal the stop-and-wait run's. Its minibatch is
  requeued by the normal drop path when the worker leaves.
"""

from __future__ import annotations

import math
import queue
import socket
import threading
import time
from typing import Any, Dict, Optional

from veles_tpu_torch.distributed import compress
from veles_tpu_torch.distributed.protocol import Connection, parse_address
from veles_tpu_torch.logger import Logger, log_context
from veles_tpu_torch.obs import metrics as obs_metrics
from veles_tpu_torch.obs.trace import TRACER, TraceContext
from veles_tpu_torch.thread_pool import ManagedThreads
from veles_tpu_torch.workflow import NoMoreJobs


class WorkerState(Logger):
    """Per-worker bookkeeping (reference: SlaveDescription,
    veles/server.py:172-191)."""

    def __init__(self, wid: str, conn: Connection, power: float,
                 mid: str, credits: int = 2,
                 encoding: str = "none", reconnects: int = 0) -> None:
        super().__init__()
        self.wid = wid
        self.conn = conn
        self.power = power
        self.mid = mid
        #: the worker's lifetime reconnect count as of its HELLO — a
        #: flapping-link / coordinator-restart health signal
        self.reconnects = reconnects
        self.state = "WAIT"           # WAIT -> WORK -> GETTING_JOB ...
        #: job id -> issue timestamp, one entry per in-flight job
        #: (≤ credits); insertion order IS issue order
        self.in_flight: Dict[int, float] = {}
        self.jobs_done = 0
        self.paused = False
        self.dropped = False
        #: per-worker credit window: the coordinator default, or the
        #: worker's HELLO override (a relay fronting N downstream
        #: workers asks for N x the per-worker window)
        self.credits = credits
        #: job_requests that arrived while the credit window was full;
        #: parked here (a COUNT — a relay can park many) and
        #: re-enqueued one per resolved job — so max_outstanding=1
        #: with a pipelined client IS stop-and-wait issue (no
        #: sleep/poll), not a degraded mode
        self.deferred_request = 0
        #: the next job must carry parameter state: set at join (fresh
        #: or respawned workers have no/stale local params) and
        #: whenever ANOTHER worker's update is applied
        self.param_stale = True
        #: negotiated update/param encoding + per-direction codec
        #: state (job params: f32 keyframes so a joiner's bootstrap is
        #: exact; update decode mirrors the worker's encoder)
        self.encoding = encoding
        self.enc = compress.Encoder(encoding, keyframe="f32")
        self.dec = compress.Decoder(encoding)
        #: True once a job carrying parameter state was issued — a
        #: joiner's updates must never apply before its full-param
        #: bootstrap went out (tracked by ``stale_applies``)
        self.bootstrapped = False
        self.is_relay = False
        #: trace propagation negotiated at HELLO (like encoding): job
        #: frames to this worker carry a trace context, its updates
        #: carry compute spans the coordinator stitches
        self.tracing = False
        #: job id -> (TraceContext, monotonic issue time) for the
        #: coordinator-side "job" span + cross-process stitching
        self.job_ctx: Dict[int, Any] = {}
        #: obs-registry sample count last absorbed from this worker
        self.obs_samples = 0
        # Adaptive-timeout statistics as running sums — O(1) per
        # completed job, O(1) per watchdog tick (the old list +
        # statistics.mean/pstdev recomputation was O(jobs) per tick
        # per worker, with the import re-executed each time).
        self.dur_n = 0
        self.dur_sum = 0.0
        self.dur_sumsq = 0.0
        # Idle accounting for worker_states(): a worker is idle while
        # it has no job in flight.
        self.connected_at = time.time()
        self.idle_accum = 0.0
        self.idle_since: Optional[float] = self.connected_at

    def note_issue(self, job_id: int, now: float) -> None:
        if not self.in_flight and self.idle_since is not None:
            self.idle_accum += now - self.idle_since
            self.idle_since = None
        self.in_flight[job_id] = now
        self.state = "WORK"

    def note_resolved(self, job_id: int, now: float) -> Optional[float]:
        """Remove ``job_id`` from the in-flight set; returns its
        duration (None when unknown) and folds it into the running
        timeout statistics."""
        issued = self.in_flight.pop(job_id, None)
        if not self.in_flight:
            self.idle_since = now
            self.state = "WAIT"
        if issued is None:
            return None
        took = now - issued
        self.dur_n += 1
        self.dur_sum += took
        self.dur_sumsq += took * took
        return took

    def note_retracted(self, job_id: int, now: float) -> bool:
        """Remove a retracted job from the in-flight set WITHOUT
        folding its duration into the timeout statistics (a retract
        means the downstream worker died, not that the job took this
        long). Returns whether the id was in flight."""
        known = self.in_flight.pop(job_id, None) is not None
        if not self.in_flight:
            self.idle_since = now
            self.state = "WAIT"
        return known

    @property
    def adaptive_timeout(self) -> Optional[float]:
        """mean + 3 sigma of this worker's job history from running
        sums (reference: veles/server.py:619-635)."""
        if self.dur_n < 2:
            return None
        mean = self.dur_sum / self.dur_n
        var = max(self.dur_sumsq / self.dur_n - mean * mean, 0.0)
        return mean + 3 * math.sqrt(var)

    def oldest_issue(self) -> Optional[float]:
        return min(self.in_flight.values()) if self.in_flight else None

    def idle_fraction(self, now: float) -> float:
        idle = self.idle_accum
        if self.idle_since is not None:
            idle += now - self.idle_since
        total = now - self.connected_at
        if total <= 0:
            return 0.0
        return min(max(idle / total, 0.0), 1.0)


class Coordinator(Logger):
    """Accepts workers, pumps jobs, applies updates, handles failures."""

    def __init__(self, workflow, address: str = "127.0.0.1:0",
                 job_timeout: float = 60.0,
                 blacklist_after: int = 3,
                 max_outstanding: int = 2,
                 wire_version: int = 2,
                 param_skip: bool = True,
                 encoding: str = "none",
                 announce: bool = False,
                 announce_port: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 16,
                 checkpoint_keep: int = 3,
                 checkpoint_prefix: str = "farm",
                 fault_plan=None,
                 tracing: bool = True) -> None:
        super().__init__()
        self.workflow = workflow
        self.job_timeout = job_timeout
        self.blacklist_after = blacklist_after
        self.max_outstanding = max(1, int(max_outstanding))
        self.wire_version = wire_version
        #: preferred update/param encoding (none | bf16 | int8);
        #: negotiated DOWN to "none" per connection when a worker's
        #: HELLO does not offer it, so old workers interop
        if encoding not in compress.SUPPORTED:
            raise ValueError("unknown encoding %r" % (encoding,))
        self.encoding = encoding
        self.announce = announce
        self.announce_port = announce_port
        self._announcer = None
        #: skip param-state job pieces for workers whose local params
        #: are provably current (see module docstring). False restores
        #: the pre-pipelining payloads (every job carries params).
        self.param_skip = param_skip
        self.workers: Dict[str, WorkerState] = {}  # guarded-by: _lock
        # machine id -> failures
        self.blacklist: Dict[str, int] = {}        # guarded-by: _lock
        self._lock = threading.RLock()
        self._wid_seq = 0                          # guarded-by: _lock
        self._job_seq = 0                          # guarded-by: _lock
        #: bumped on every applied update; the producer compares it
        #: across a job's generation window to decide whether the
        #: params it snapshotted are still current at issue time
        self._applied_seq = 0                      # guarded-by: _lock
        #: workers awaiting a job; drained by the producer thread.
        #: Bounded naturally by the worker count times the credit
        #: window — the backpressure.
        self._requests: "queue.Queue" = queue.Queue()
        self._drained = False  # producer hit NoMoreJobs; guarded-by: _lock
        self.total_updates = 0  # applied updates;         guarded-by: _lock
        # arrived after completion latched
        self.discarded_updates = 0                       # guarded-by: _lock
        self.jobs_issued = 0                             # guarded-by: _lock
        # in flight at drop/retract, requeued
        self.requeued_jobs = 0                           # guarded-by: _lock
        #: updates applied from a worker whose full-param bootstrap
        #: job had not been issued yet — MUST stay 0 (a joiner's first
        #: applied update follows its bootstrap by construction; this
        #: counter is the elastic-membership tripwire)
        self.stale_applies = 0                     # guarded-by: _lock
        self.done = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(parse_address(address))
        self._listener.listen(64)
        self.address = "%s:%d" % self._listener.getsockname()
        self._threads = ManagedThreads(name="coordinator")
        self._accepting = True
        self._closing = False
        # departed workers' sums
        self._wire_closed: Dict[str, int] = {}     # guarded-by: _lock
        # wid -> final idle_frac
        self._idle_closed: Dict[str, float] = {}   # guarded-by: _lock
        # -- crash-safe farm checkpointing:
        # at every `checkpoint_every`-applied-updates dispatch-window
        # edge the producer thread captures the master workflow
        # (protocol-5 pickle: params become crc-checked shards) and an
        # AsyncCheckpointer commits it off-thread. `resume_farm()`
        # restores the newest commit; a killed farm loses at most one
        # checkpoint interval, never its previous good checkpoint.
        self.checkpoint_every = max(1, int(checkpoint_every))
        self._ckpt = None
        self._ckpt_due = False
        self._ckpt_last_applied = 0
        if checkpoint_dir:
            from veles_tpu_torch.checkpoint import AsyncCheckpointer
            self._ckpt = AsyncCheckpointer(
                checkpoint_dir, prefix=checkpoint_prefix,
                keep=checkpoint_keep, threads=self._threads)
        #: serializes update application against checkpoint capture so
        #: a snapshot never sees a torn mid-apply state (applies were
        #: already serialized per-unit by data_locks; this adds the
        #: whole-workflow consistency edge the capture needs)
        self._apply_lock = threading.Lock()
        #: scripted chaos (distributed/faults.py): kill-coordinator@U
        #: crash-stops this process after U applied updates
        self._fault_plan = fault_plan
        if fault_plan is not None and self._ckpt is not None:
            # hang-save@G: the kill-mid-save window for the SIGKILL
            # harness (shards durable, manifest commit withheld)
            fault_plan.arm_checkpoint_store(self._ckpt.store)
        #: True after a fault-injected (or explicit) kill(): `run()`
        #: returned because the coordinator CRASHED, not finished
        self.killed = False
        #: trace propagation offered to workers at HELLO (negotiated
        #: per connection, like encoding)
        self.tracing = bool(tracing) and TRACER.enabled
        #: the farm's obs registry: coordinator-side collectors plus
        #: every worker's absorbed registry (worker= label) — ONE
        #: /metrics for the whole farm (web_status renders it)
        self.obs = obs_metrics.MetricsRegistry()
        self.obs.register("wire", lambda: obs_metrics.wire_samples(
            self.wire_stats(), (("role", "coordinator"),)))
        self.obs.register("farm", self._farm_samples)
        self.obs.register("ckpt", lambda: obs_metrics.
                          checkpoint_samples(self.checkpoint_stats()))

    def _farm_samples(self):
        with self._lock:
            values = (("workers", len(self.workers), "gauge"),
                      ("jobs_issued_total", self.jobs_issued,
                       "counter"),
                      ("updates_applied_total", self.total_updates,
                       "counter"),
                      ("updates_discarded_total",
                       self.discarded_updates, "counter"),
                      ("jobs_requeued_total", self.requeued_jobs,
                       "counter"))
        return [obs_metrics.Sample("veles_farm_%s" % name, kind, v)
                for name, v, kind in values]

    def metrics_snapshot(self):
        """Farm-wide JSON metrics (own collectors + absorbed worker
        registries) — what the launcher status doc publishes."""
        return self.obs.snapshot()

    def metrics_wire(self):
        return self.obs.as_wire()

    # -- lifecycle ---------------------------------------------------------
    def worker_states(self):
        """{worker id: state summary} for status reporting (the payload
        the reference's master posted to web_status), including the
        pipelining health signals: in-flight depth, idle fraction and
        wire throughput."""
        now = time.time()
        out = {}
        with self._lock:
            for wid, w in list(self.workers.items()):
                stats = w.conn.stats
                uptime = max(now - w.connected_at, 1e-9)
                out[wid] = {
                    "state": w.state, "power": w.power,
                    "jobs_done": w.jobs_done, "paused": w.paused,
                    "in_flight": len(w.in_flight),
                    "credits": w.credits,
                    "idle_frac": w.idle_fraction(now),
                    "wire_mb_in": stats.bytes_in / 1e6,
                    "wire_mb_out": stats.bytes_out / 1e6,
                    "wire_mb_per_sec":
                        (stats.bytes_in + stats.bytes_out) / 1e6 / uptime,
                    # delta-path health: the negotiated encoding and
                    # the realized update compression (logical f32
                    # bytes / wire bytes of this worker's update
                    # params; 1.0 at encoding "none")
                    "encoding": w.encoding,
                    "update_ratio":
                        (w.dec.raw_bytes / w.dec.wire_bytes)
                        if w.dec.wire_bytes else 1.0,
                    "bootstrapped": w.bootstrapped,
                    "is_relay": w.is_relay,
                    "reconnects": w.reconnects,
                    # obs plane: negotiated trace propagation + the
                    # size of this worker's last forwarded registry
                    # (the samples themselves live in self.obs under
                    # a worker= label)
                    "tracing": w.tracing,
                    "obs_samples": w.obs_samples,
                }
        return out

    def wire_stats(self) -> Dict[str, int]:
        """Aggregate wire accounting over live AND departed workers,
        including the codec's update-payload accounting
        (``update_raw_bytes`` = logical float32 size of received
        update params, ``update_wire_bytes`` = what they cost on the
        wire; equal at encoding "none")."""
        with self._lock:
            totals = dict(self._wire_closed)
            workers = list(self.workers.values())
        for worker in workers:
            for key, value in worker.conn.stats.as_dict().items():
                if key == "compression_ratio":
                    continue
                totals[key] = totals.get(key, 0) + value
            totals["update_raw_bytes"] = \
                totals.get("update_raw_bytes", 0) + worker.dec.raw_bytes
            totals["update_wire_bytes"] = \
                totals.get("update_wire_bytes", 0) + worker.dec.wire_bytes
        return totals

    def idle_fractions(self) -> Dict[str, float]:
        """Per-worker lifetime idle fraction, covering live AND
        departed workers — safe to read after ``run()`` returns even
        though workers race their ``bye`` against the caller
        (``bench_distributed.py`` averages this)."""
        now = time.time()
        with self._lock:
            out = dict(self._idle_closed)
            for wid, w in self.workers.items():
                out[wid] = w.idle_fraction(now)
        return out

    def _accumulate_wire(self, worker: "WorkerState") -> None:  # holds: _lock
        for key, value in worker.conn.stats.as_dict().items():
            if key == "compression_ratio":
                continue
            self._wire_closed[key] = self._wire_closed.get(key, 0) + value
        self._wire_closed["update_raw_bytes"] = \
            self._wire_closed.get("update_raw_bytes", 0) + \
            worker.dec.raw_bytes
        self._wire_closed["update_wire_bytes"] = \
            self._wire_closed.get("update_wire_bytes", 0) + \
            worker.dec.wire_bytes

    def start(self) -> None:
        for name, target in (("accept", self._accept_loop),
                             ("watchdog", self._watchdog_loop),
                             ("producer", self._producer_loop)):
            self._threads.spawn(target, name=name)
        if self.announce:
            from veles_tpu_torch.distributed.discovery import Announcer
            self._announcer = Announcer(
                self.address, self.workflow.checksum,
                port=self.announce_port, threads=self._threads)
            self._announcer.start()
        self.info("coordinator listening on %s", self.address)

    def run(self, timeout: Optional[float] = None) -> bool:
        """Block until training completes (all jobs consumed and final
        updates applied)."""
        finished = self.done.wait(timeout)
        return finished

    def stop(self, grace: float = 5.0) -> None:
        # Clean shutdown commits what the async writer still holds —
        # the farm's durable state must not be older than its last
        # dispatch edge just because the operator stopped it politely.
        self.flush_checkpoints(timeout=max(grace, 10.0))
        self._accepting = False
        self._closing = True
        if self._announcer is not None:
            self._announcer.stop()
        try:
            # shutdown() actually WAKES a thread blocked in accept()
            # (a bare close() does not on Linux — the old daemon
            # accept thread silently outlived every coordinator)
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        # Grace: handlers keep answering "done" after completion, so
        # idle workers polling at wait-interval learn training is over
        # and leave cleanly instead of hitting a hard close.
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline:
            with self._lock:
                if not self.workers:
                    break
            time.sleep(0.05)
        with self._lock:
            for worker in list(self.workers.values()):
                worker.conn.close()
        self.done.set()
        # Join the service threads: the closed listener/conns unblock
        # accept() and recv(), done/closing end the watchdog/producer.
        leaked = self._threads.join_all(timeout=max(grace, 5.0))
        if leaked:
            self.warning("coordinator leaked threads after stop: %s",
                         [t.name for t in leaked])

    # -- accept / per-worker handler ---------------------------------------
    def _accept_loop(self) -> None:
        while self._accepting:
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return
            try:
                self._threads.spawn(self._serve_worker, sock, addr,
                                    name="worker-%s:%s" % addr[:2])
            except RuntimeError:
                # accepted in the shutdown window (stop already
                # requested): refuse the connection instead of leaking
                # a handler thread past join_all
                sock.close()
                return

    def _serve_worker(self, sock: socket.socket, addr) -> None:
        conn = Connection(sock, wire_version=self.wire_version)
        worker: Optional[WorkerState] = None
        try:
            hello = conn.recv(timeout=30.0)
            if hello.get("type") != "handshake":
                conn.send({"type": "reject", "reason": "bad handshake"})
                return
            if hello["checksum"] != self.workflow.checksum:
                self.warning("worker %s checksum mismatch", addr)
                conn.send({"type": "reject",
                           "reason": "workflow checksum mismatch"})
                return
            mid = hello.get("mid", "?")
            with self._lock:
                blacklisted = self.blacklist.get(mid, 0) >= \
                    self.blacklist_after
                empty = not self.workers
            if blacklisted:
                # Forgive when the farm is EMPTY: the blacklist exists
                # to prefer healthy machines, and with no workers left
                # there is nothing to prefer — rejecting the last
                # machine forever is a livelock (seen in the respawn
                # soak: 3 first-job deaths on one host, every respawn
                # rejected, coordinator waits for workers that can
                # never come back).
                if empty:
                    self.warning("machine %s is blacklisted but the "
                                 "farm is empty; forgiving", mid)
                    with self._lock:
                        self.blacklist.pop(mid, None)
                else:
                    conn.send({"type": "reject",
                               "reason": "blacklisted"})
                    return
            encoding = compress.negotiate(self.encoding,
                                          hello.get("encodings"))
            try:
                asked = int(hello.get("credits") or 0)
            except (TypeError, ValueError):
                asked = 0
            # HELLO may ask for a wider credit window (a relay fronts
            # N workers); plain workers get the coordinator default
            credits = max(1, min(asked, 4096)) if asked > 0 \
                else self.max_outstanding
            with self._lock:
                self._wid_seq += 1
                wid = "w%04d" % self._wid_seq
                worker = WorkerState(wid, conn, hello.get("power", 1.0),
                                     mid, credits=credits,
                                     encoding=encoding,
                                     reconnects=int(
                                         hello.get("reconnects") or 0))
                worker.is_relay = bool(hello.get("relay"))
                # tracing negotiated like encoding: on only when both
                # ends offered it (legacy HELLOs carry no key)
                worker.tracing = self.tracing and \
                    bool(hello.get("tracing"))
                self.workers[wid] = worker
            # HELLO forwards the worker's obs registry: absorb it
            # (worker= label) so /metrics covers the farm from breath 1
            worker.obs_samples = self.obs.absorb(
                wid, hello.get("metrics"), {"worker": wid})
            initial = self.workflow.generate_initial_data_for_slave(wid)
            conn.send({"type": "welcome", "id": wid,
                       "initial_data": initial,
                       "encoding": encoding,
                       "tracing": worker.tracing,
                       "param_units": self._param_unit_ids()})
            self.info(
                "worker %s joined from %s (power=%.2f, encoding=%s, "
                "credits=%d%s)", wid, addr, worker.power, encoding,
                credits, ", relay" if worker.is_relay else "")
            self._worker_loop(worker)
        except (ConnectionError, OSError, EOFError) as e:
            self.warning("worker %s connection lost: %s",
                         worker.wid if worker else addr, e)
        finally:
            if worker is not None:
                self._drop(worker)

    def _worker_loop(self, worker: WorkerState) -> None:
        # Runs until the worker says bye or the connection drops — NOT
        # until done: late pollers must still receive their "done".
        while True:
            msg = worker.conn.recv()
            mtype = msg.get("type")
            if mtype == "job_request":
                self._handle_job_request(worker)
            elif mtype == "update":
                self._handle_update(worker, msg)
            elif mtype == "update_multi":
                self._handle_update_multi(worker, msg)
            elif mtype == "retract":
                self._handle_retract(worker, msg)
            elif mtype == "bye":
                self.info("worker %s left", worker.wid)
                worker.dropped = True  # clean exit: nothing pending
                return
            else:
                raise ConnectionError("unknown message %r" % mtype)

    def _param_unit_ids(self):
        """Top-level keys of job/update data dicts that hold parameter
        state (replacement semantics) — handed to relays at welcome so
        they can aggregate: in a batch of coalesced updates, only the
        last param payload matters (deltas compose under replacement).
        Receivers already tolerate these pieces being None."""
        ids = getattr(self.workflow, "param_state_unit_ids", None)
        if ids is None:
            return []
        return list(ids)

    # -- job pump ----------------------------------------------------------
    def _send_safe(self, worker: WorkerState, msg: Dict,
                   probe: bool = True) -> None:
        """Reply from the producer thread; a broken pipe is the
        handler thread's problem (its recv fails and drops the
        worker). The Connection's send lock keeps this write from
        interleaving with the handler thread's replies."""
        try:
            worker.conn.send(msg, probe=probe)
        except (ConnectionError, OSError):
            pass

    def _producer_loop(self) -> None:
        """Fulfil queued job requests one at a time. ONE generator
        thread — the loader's offset advance is inherently
        sequential — but handler threads never block on it: they
        enqueue the worker and return to receiving, so updates,
        handshakes and drops proceed during generation. Workflow
        mutation safety against concurrent update applies comes from
        the per-unit data_locks."""
        # Runs until stop(), NOT until done: requests queued in the
        # same instant training completes must still be answered
        # "done", or those workers hang in recv and die reconnecting.
        while not self._closing:
            if self._ckpt_due:
                # Dispatch-window edge: no generation is mid-flight in
                # this thread and the apply lock holds updates off, so
                # the capture sees a consistent master state. Workers
                # keep computing their in-flight jobs throughout; only
                # the next job issue waits for the capture memcpy (the
                # disk write runs on the checkpoint writer).
                self._checkpoint_now()
            try:
                worker = self._requests.get(timeout=0.2)
            except queue.Empty:
                continue
            with self._lock:
                if worker.dropped or worker.wid not in self.workers:
                    continue
                drained = self._drained
                credit = len(worker.in_flight) < worker.credits
                include_params = worker.param_stale or not self.param_skip
                seq_at_gen = self._applied_seq
                if not drained and not self.done.is_set() and not credit:
                    # Credit window full: PARK the request — it is
                    # re-enqueued the moment one of this worker's
                    # in-flight jobs resolves. No reply goes out, so
                    # max_outstanding=1 under a pipelined client
                    # reproduces stop-and-wait issue exactly (job N+1
                    # generated only after update N applied) instead
                    # of a sleep/poll loop.
                    worker.deferred_request += 1
                    continue
            if drained or self.done.is_set():
                self._send_safe(worker, {"type": "done"})
                self._maybe_finish()
                continue
            try:
                data = self.workflow.generate_data_for_slave(
                    worker.wid, include_params=include_params)
            except NoMoreJobs:
                with self._lock:
                    self._drained = True
                # Units that recorded a piece before a later unit
                # raised have already retracted it inside
                # generate_data_for_slave — a blanket drop_slave here
                # would also requeue this worker's OTHER in-flight
                # jobs and double-apply their minibatches.
                self._send_safe(worker, {"type": "done"})
                self._maybe_finish()
                continue
            if data is False:
                self._send_safe(worker, {"type": "wait", "delay": 0.1})
                continue
            with self._lock:
                # Linearize against _drop: either we mark in-flight
                # first (a later _drop sees the in_flight entry and
                # requeues), or _drop popped the worker first and we
                # requeue here — without this, a death timed against
                # generation strands the freshly recorded minibatch
                # (generation runs OUTSIDE this lock).
                alive = (not worker.dropped and
                         worker.wid in self.workers)
                if alive:
                    self._job_seq += 1
                    job_id = self._job_seq
                    worker.note_issue(job_id, time.time())
                    self.jobs_issued += 1
                    if worker.tracing:
                        # one trace per job: the context rides the
                        # job frame; the worker's (and any relay's)
                        # spans stitch under it at resolve time
                        worker.job_ctx[job_id] = (
                            TraceContext.new(), time.monotonic())
                    if include_params:
                        # full-param job issued: the joiner-bootstrap
                        # guarantee for stale_applies tracking
                        worker.bootstrapped = True
                    if include_params and self._applied_seq == seq_at_gen:
                        # Only mark the worker current if NO update
                        # was applied while its params were being
                        # snapshotted (generation runs outside this
                        # lock): a foreign update landing in that
                        # window set param_stale=True for params this
                        # job does NOT carry — clobbering it to False
                        # here would leave the worker stale-but-
                        # trusted until the next foreign apply.
                        worker.param_stale = False
            if not alive:
                self.workflow.drop_slave(worker.wid)
                continue
            if worker.encoding != "none":
                # per-worker encoder state lives here safely: ONE
                # producer thread does all job encoding. Quantized
                # payloads ship raw (probe=False) — they are
                # incompressible residual streams by construction.
                data = worker.enc.encode(data)
            job_msg = {"type": "job", "job_id": job_id, "data": data}
            ctx_entry = worker.job_ctx.get(job_id)
            if ctx_entry is not None:
                job_msg["trace"] = ctx_entry[0].to_wire()
            self._send_safe(worker, job_msg,
                            probe=worker.encoding == "none")

    def _handle_job_request(self, worker: WorkerState) -> None:
        if worker.paused:
            worker.conn.send({"type": "wait", "delay": 0.5})
            return
        with self._lock:
            drained = self._drained
        if drained:
            # answer late pollers directly — no producer round-trip
            worker.conn.send({"type": "done"})
            self._maybe_finish()
            return
        if not worker.in_flight:
            worker.state = "GETTING_JOB"
        self._requests.put(worker)

    def _handle_update(self, worker: WorkerState, msg: Dict) -> None:
        job_id = self._resolve_update(worker, msg.get("job_id"),
                                      msg.get("data"),
                                      legacy_oldest=True,
                                      spans=msg.get("spans"),
                                      metrics=msg.get("metrics"))
        worker.conn.send({"type": "update_ack", "job_id": job_id})
        self._maybe_finish()

    def _handle_update_multi(self, worker: WorkerState,
                             msg: Dict) -> None:
        """A relay's coalesced batch: per-job resolution (exactly-once
        accounting is per job id), ONE ack for the whole batch (the
        relay's flush clock). The relay already stripped param
        payloads from all but the last param-bearing entry — deltas
        compose under replacement semantics, so applying the entries
        in arrival order lands on the same final params. Each entry
        carries its downstream worker's spans/registry (``peer`` names
        it relay-locally); the batch carries the relay's own."""
        updates = msg.get("updates") or []
        last_id = None
        for entry in updates:
            peer = entry.get("peer")
            last_id = self._resolve_update(
                worker, entry.get("job_id"), entry.get("data"),
                spans=entry.get("spans"),
                metrics=entry.get("metrics"),
                peer="%s/%s" % (worker.wid, peer) if peer else None)
        if msg.get("metrics") is not None:
            worker.obs_samples = self.obs.absorb(
                worker.wid, msg["metrics"], {"worker": worker.wid})
        worker.conn.send({"type": "update_ack", "job_id": last_id,
                          "count": len(updates)})
        self._maybe_finish()

    def _resolve_update(self, worker: WorkerState, job_id,
                        data, legacy_oldest: bool = False,
                        spans=None, metrics=None, peer=None):
        now = time.time()
        with self._lock:
            if job_id is None and legacy_oldest and worker.in_flight:
                # legacy client without job ids: resolve the oldest
                # in-flight job (updates arrive in issue order)
                job_id = min(worker.in_flight, key=worker.in_flight.get)
            known = job_id is not None and job_id in worker.in_flight
        # Decode BEFORE the discard decision: the delta codec's
        # mirrors must advance on EVERY received update (the worker's
        # encoder advanced when it sent) — skipping a discarded
        # update's decode would desync the next delta.
        if data is not None:
            # encoding "none": an identity walk that only counts the
            # update-payload bytes for wire_stats()/worker_states()
            data = worker.dec.decode(data)
        # Completion check BEFORE applying: with pipelined issue, one
        # job can still be in flight when the decision unit latches
        # completion — applying its update would walk the weights one
        # extra minibatch past the stop-and-wait trajectory. Its
        # minibatch requeues via the normal drop path.
        discard = (not known) or \
            bool(getattr(self.workflow, "job_stream_complete", False))
        # trace stitching: close the coordinator-side "job" span and
        # absorb the peer spans (worker compute, relay forward) that
        # rode the update — one trace id across all three hops
        ctx_entry = worker.job_ctx.pop(job_id, None) \
            if job_id is not None else None
        if ctx_entry is not None:
            ctx, issued_mono = ctx_entry
            TRACER.add("job", "farm", ctx, issued_mono,
                       time.monotonic(), wid=worker.wid,
                       job_id=job_id, discarded=discard)
        if spans:
            TRACER.ingest(spans)
        if metrics is not None:
            # the worker's (or a relay downstream's) obs registry:
            # farm-wide aggregation under a worker label
            key = peer or worker.wid
            n = self.obs.absorb(key, metrics, {"worker": key})
            if peer is None:
                worker.obs_samples = n
        if not discard:
            # apply outside the coordinator lock: per-unit data_locks
            # serialize against the producer's generation; the apply
            # lock additionally fences checkpoint capture so a
            # snapshot never sees a half-applied update
            with log_context(job=job_id, wid=worker.wid,
                             trace=ctx_entry[0].trace_id
                             if ctx_entry else None):
                with self._apply_lock:
                    self.workflow.apply_data_from_slave(
                        data, worker.wid)
        with self._lock:
            worker.note_resolved(job_id, now)
            # A completed job proves the machine works either way:
            # reset its blacklist counter so only machines that NEVER
            # finish anything (true hangs) accumulate strikes —
            # transient deaths under churn/fault-injection must not
            # poison a host that keeps doing real work between them.
            worker.jobs_done += 1
            self.blacklist.pop(worker.mid, None)
            if discard:
                self.discarded_updates += 1
            else:
                if not worker.bootstrapped:
                    self.stale_applies += 1
                self.total_updates += 1
                self._applied_seq += 1
                # Foreign params landed: every OTHER worker's local
                # chain is now stale and must be resynced on its next
                # job issue.
                for other in self.workers.values():
                    if other is not worker:
                        other.param_stale = True
            if worker.deferred_request:
                # a request parked on the full credit window: a slot
                # just freed, put it back in the producer's queue
                worker.deferred_request -= 1
                self._requests.put(worker)
            if not discard and self._ckpt is not None and \
                    self.total_updates - self._ckpt_last_applied >= \
                    self.checkpoint_every:
                self._ckpt_last_applied = self.total_updates
                self._ckpt_due = True  # producer captures at the edge
            applied = self.total_updates
        # The scripted coordinator kill waits for the first committed
        # generation when checkpointing is on: a crash before ANY
        # commit is a cold start — a different scenario than the
        # "never lose more than one checkpoint interval" claim the
        # chaos harness exists to test.
        if self._fault_plan is not None and not discard and \
                (self._ckpt is None or
                 self._ckpt.saves_committed > 0) and \
                self._fault_plan.coordinator_crash_due(applied):
            self.warning("fault injection: killing coordinator after "
                         "%d applied updates", applied)
            if self._fault_plan.sigkill:
                import os
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
            self.kill()
            raise ConnectionError("fault injection: coordinator killed")
        return job_id

    # -- crash-safe checkpointing ------------------------------------------
    def _checkpoint_now(self) -> None:
        """Capture the master workflow at a dispatch-window edge and
        hand it to the async writer. Runs in the producer thread; the
        apply lock fences concurrent update application for the
        duration of the capture (a protocol-5 pickle whose array
        buffers leave as copies — the only synchronous cost)."""
        self._ckpt_due = False
        if self._ckpt is None or self._closing:
            return
        with self._lock:
            meta = {
                "applied": self.total_updates,
                "jobs_issued": self.jobs_issued,
                "discarded": self.discarded_updates,
                "requeued": self.requeued_jobs,
                "active_wids": list(self.workers),
                "address": self.address,
                "checksum": self.workflow.checksum,
            }
        try:
            with self._apply_lock:
                ticket = self._ckpt.save(obj=self.workflow, meta=meta)
            self.debug("farm checkpoint generation %d queued "
                       "(%d applied updates)", ticket.generation,
                       meta["applied"])
        except Exception as e:
            # NEVER let a capture failure out of here: this runs in
            # the producer thread, and an unpicklable workflow
            # attribute (PicklingError/TypeError) escaping would kill
            # job issue for the whole farm. A failed checkpoint is a
            # warning; a hung farm is an outage.
            self.warning("farm checkpoint failed (training "
                         "continues): %s", e)

    def checkpoint_stats(self) -> Optional[Dict]:
        """AsyncCheckpointer counters (None when checkpointing is
        off); ``bench_distributed.py`` derives ckpt_stall_ms_per_step
        from ``stall_seconds`` / applied updates."""
        if self._ckpt is None:
            return None
        stats = self._ckpt.stats()
        stats["checkpoint_every"] = self.checkpoint_every
        return stats

    def flush_checkpoints(self, timeout: float = 30.0) -> bool:
        """Wait for queued checkpoint commits (clean-shutdown path —
        a KILLED coordinator naturally cannot and must not)."""
        if self._ckpt is None:
            return True
        return self._ckpt.wait(timeout=timeout)

    def kill(self) -> None:
        """Crash-stop: drop the listener and every connection NOW — no
        drain, no "done" grace, no checkpoint flush. This is the
        in-process stand-in for SIGKILL that the chaos harness uses;
        the only cleanup is joining our own threads so the harness
        process does not leak them. State is abandoned exactly as a
        real crash would abandon it — resume goes through
        :func:`resume_farm` from the last committed generation."""
        with self._lock:
            if self.killed:
                return
            self.killed = True
        self._accepting = False
        self._closing = True
        if self._announcer is not None:
            self._announcer.stop()
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            for worker in list(self.workers.values()):
                worker.conn.close()
        self.done.set()
        leaked = self._threads.join_all(timeout=10.0)
        if leaked:
            self.warning("kill() leaked threads: %s",
                         [t.name for t in leaked])

    def _handle_retract(self, worker: WorkerState, msg: Dict) -> None:
        """A relay hands back jobs whose downstream worker died: each
        retracted job resolves as requeued (exactly-once: issued ==
        applied + discarded + requeued) and the workflow takes back
        one pending record per job. Unknown ids (already resolved by
        a racing update) are ignored."""
        now = time.time()
        requeued = 0
        with self._lock:
            for job_id in msg.get("job_ids") or ():
                if worker.note_retracted(job_id, now):
                    requeued += 1
                worker.job_ctx.pop(job_id, None)
            self.requeued_jobs += requeued
            unpark = min(requeued, worker.deferred_request)
            worker.deferred_request -= unpark
            for _ in range(unpark):
                self._requests.put(worker)
        requeue = getattr(self.workflow, "requeue_one_job", None)
        if requeue is not None:
            # apply-lock fence: same torn-capture hazard as _drop
            with self._apply_lock:
                for _ in range(requeued):
                    requeue(worker.wid)
        elif requeued:
            self.warning(
                "workflow lacks requeue_one_job: %d retracted job(s) "
                "from %s dropped at the workflow layer", requeued,
                worker.wid)
        if requeued:
            self.info("worker %s retracted %d job(s); requeued",
                      worker.wid, requeued)
        self._maybe_finish()

    # -- failure handling --------------------------------------------------
    def _drop(self, worker: WorkerState) -> None:
        with self._lock:
            if self.workers.pop(worker.wid, None) is None:
                return
            worker.dropped = True
            pending = len(worker.in_flight)
            worker.in_flight.clear()
            worker.job_ctx.clear()  # traces of requeued jobs die here
            self.requeued_jobs += pending
            if pending and worker.jobs_done == 0:
                # Blacklist only machines that never complete a job
                # (reference: hanged-slave heuristic, server.py:383-395)
                # — a transient death after real work, or one bad worker
                # among many on a host, must not poison the machine.
                self.blacklist[worker.mid] = \
                    self.blacklist.get(worker.mid, 0) + 1
            self._accumulate_wire(worker)
            self._idle_closed[worker.wid] = \
                worker.idle_fraction(time.time())
        # subtree: a relay's downstream peers were absorbed under
        # "<wid>/<peer>" keys and depart with it
        self.obs.forget(worker.wid, subtree=True)
        # The apply lock fences checkpoint capture (producer thread):
        # a death timed against a capture must not mutate the loader's
        # pending structures mid-pickle.
        with self._apply_lock:
            self.workflow.drop_slave(worker.wid)  # requeues minibatches
        # NOTE: _drained stays latched even though the requeue may put
        # a minibatch back: NoMoreJobs comes from a latched condition
        # (decision.complete, generations exhausted) that raises again
        # immediately — and resetting it would hang the coordinator
        # when the remaining workers have already been told "done".
        worker.conn.close()
        self.info("worker %s dropped (%d jobs done, %d in-flight "
                  "requeued)", worker.wid, worker.jobs_done, pending)
        self._maybe_finish()

    def _watchdog_loop(self) -> None:
        """Kill workers whose OLDEST in-flight job exceeds their
        adaptive timeout (reference: veles/server.py:619-635)."""
        while not self.done.wait(1.0):
            now = time.time()
            with self._lock:
                workers = list(self.workers.values())
            for worker in workers:
                with self._lock:
                    issued = worker.oldest_issue()
                if issued is None:
                    continue
                limit = max(worker.adaptive_timeout or 0,
                            self.job_timeout)
                if worker.jobs_done == 0:
                    # The first job builds the kernels and warms up — grace it.
                    limit *= 10
                if now - issued > limit:
                    self.warning(
                        "worker %s exceeded job timeout %.1fs — killing",
                        worker.wid, limit)
                    worker.conn.close()  # handler thread drops it

    def _maybe_finish(self) -> None:
        with self._lock:
            if not self._drained:
                return
            busy = [w for w in self.workers.values() if w.in_flight]
            if not busy:
                self.done.set()

    # -- operator controls (reference: veles/server.py:734-745) -----------
    def pause(self, wid: str) -> None:
        with self._lock:
            worker = self.workers.get(wid)
        if worker is not None:
            worker.paused = True

    def resume(self, wid: str) -> None:
        with self._lock:
            worker = self.workers.get(wid)
        if worker is not None:
            worker.paused = False


def resume_farm(path: str, prefix: str = "farm",
                required: bool = True):
    """Restore a coordinator's master workflow from the newest
    committed farm checkpoint.

    ``path`` is the checkpoint directory (or one manifest inside it).
    Shard checksums are verified; a corrupt newest generation falls
    back to the previous good one with a clear log line. The restored
    workflow gets a :meth:`~veles_tpu_torch.workflow.Workflow.farm_resume`
    sweep: every worker of the dead incarnation is gone, so their
    in-flight jobs requeue through the exactly-once machinery before
    the first new worker joins (workers themselves bootstrap via the
    normal full-param join path — ``param_stale`` is set at join).

    Returns ``(workflow, meta, generation)``; with ``required=False``
    returns ``(None, None, None)`` when no checkpoint exists yet (the
    ``--resume auto`` cold-start case)."""
    import os

    from veles_tpu_torch.checkpoint import (CheckpointStore,
                                      CheckpointUnavailable,
                                      parse_manifest_name)
    max_gen = None
    if os.path.isdir(path):
        directory = path
    else:
        directory, name = os.path.split(os.path.abspath(path))
        parsed = parse_manifest_name(name)
        if parsed is not None:
            # a NAMED manifest resumes THAT generation (falling back
            # only to older ones), not whatever is newest in the dir
            prefix, max_gen = parsed
    store = CheckpointStore(directory, prefix=prefix)
    try:
        _, workflow, meta, generation = store.load_latest(
            max_generation=max_gen)
    except CheckpointUnavailable:
        if not required:
            return None, None, None
        raise
    if workflow is None:
        raise CheckpointUnavailable(
            "farm checkpoint %s has no workflow capture" % path)
    active = (meta or {}).get("active_wids") or ()
    farm_resume = getattr(workflow, "farm_resume", None)
    if farm_resume is not None:
        farm_resume(active)
    else:  # duck-typed master (bench harness): just the drop sweep
        for wid in active:
            workflow.drop_slave(wid)
    logging_info = getattr(workflow, "info", None)
    if logging_info is not None:
        logging_info(
            "resumed farm from generation %d (%d applied updates at "
            "capture, %d in-flight jobs requeued)", generation,
            (meta or {}).get("applied", 0), len(active))
    return workflow, meta, generation


def run_coordinator(workflow, address: str,
                    timeout: Optional[float] = None,
                    **coordinator_kwargs) -> None:
    """CLI -l entry: serve until training completes."""
    coordinator = Coordinator(workflow, address, **coordinator_kwargs)
    workflow._coordinator_ = coordinator  # status-reporter hook
    coordinator.start()
    try:
        coordinator.run(timeout)
    finally:
        if coordinator.killed:  # fault-injected crash: nothing to drain
            return
        coordinator.stop()
