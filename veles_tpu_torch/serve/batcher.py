"""Dynamic micro-batching over a forward engine, and continuous
batching over the generative decode plane.

Port of ``veles_tpu/serve/batcher.py``: the admission exceptions,
:class:`ServeMetrics` and :class:`MicroBatcher` (a dispatch loop closes
a batch when it holds ``max_batch`` rows, the oldest ticket has waited
``max_delay_ms`` or the queue went quiet; the batch pads to the
engine's bucket and runs as ONE captured graph; a failing batch is
bisected to isolate the poisoned rows), :class:`GenMetrics`, the
sampling validation and :class:`TokenBatcher` (Orca-style continuous
batching: decode steps run back to back, queued requests join at token
boundaries, finished sequences retire mid-flight) over either decode
plane. Over the paged engine it also trims each admission to what the
page pool holds, requeues preempted tickets at the queue head (they
re-prefill prompt + emitted tokens and resume their sampling counter),
and routes the several tokens a speculative round commits per slot.
Each dispatch calls the step profiler's hook (``obs.profile``). With a
scheduler tenant (``tenant=`` / ``set_tenant``, ``veles_tpu_torch.sched``)
every device call runs as one quantum: a ``MicroBatcher`` batch (and
each bisecting retry), a ``TokenBatcher`` prefill admission and every
decode round (a paged round with its page admission, whose
copy-on-write copies are device work; the reference admits pages just
before its quantum), each handing the most urgent client budget of its
tickets to the scheduler's deadline boost, and traced requests gain a
``sched_wait`` span per dispatch.

Threading rides :class:`veles_tpu_torch.thread_pool.ManagedThreads`
(non-daemon dispatch thread, joined in ``stop()``). Admission control
is a bounded queue: ``submit`` raises :class:`QueueFull` instead of
queueing unbounded work, and a draining batcher refuses new work while
finishing what it accepted.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from veles_tpu_torch.logger import log_context
from veles_tpu_torch.obs import profile as obs_profile
from veles_tpu_torch.obs.trace import (EXEMPLARS, TRACER, TraceContext,
                                       elapsed_s)
from veles_tpu_torch.sched import quantum_or_null
from veles_tpu_torch.thread_pool import ManagedThreads


class QueueFull(RuntimeError):
    """Admission control: the bounded request queue is full.
    ``retry_after`` (seconds) rides the HTTP front's Retry-After."""

    def __init__(self, msg: str, retry_after: float = 1.0) -> None:
        super().__init__(msg)
        self.retry_after = retry_after


class Shed(RuntimeError):
    """Admission control: the request provably cannot make its
    deadline, so it is rejected on arrival."""

    def __init__(self, msg: str, retry_after: float = 1.0) -> None:
        super().__init__(msg)
        self.retry_after = retry_after


class Draining(RuntimeError):
    """The batcher is draining/stopped and accepts no new work."""


class DeadlineExceeded(RuntimeError):
    """The request's client deadline passed before (or while) it was
    served; expired work is shed at admission or at token boundaries,
    never dispatched to the device."""


class PoisonedRequest(RuntimeError):
    """This request's rows made the batch fail. Bisection isolated it;
    co-batched innocent tickets were re-dispatched and succeeded.
    ``__cause__`` carries the engine's original error."""


class NonFiniteLogits(RuntimeError):
    """The sequence's decode step produced non-finite logits; only
    this ticket fails — its slot is freed at the token boundary."""


class ServeMetrics:
    """Thread-safe serving counters + distributions.

    Tracks completed/rejected requests, a sliding completion window
    for qps, per-request latency (bounded reservoir -> p50/p95/p99)
    and a power-of-two batch-size histogram. ``snapshot()`` is the
    JSON surface; ``prometheus_text()`` the text exposition — both
    carry the same numbers.
    """

    #: batch-size histogram bucket upper bounds (rows per dispatch)
    BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

    def __init__(self, window: int = 2048,
                 qps_window_s: float = 30.0) -> None:
        self._lock = threading.Lock()
        self._started = time.monotonic()
        self._qps_window_s = qps_window_s
        self.requests_total = 0                  # guarded-by: _lock
        self.rows_total = 0                      # guarded-by: _lock
        self.rejected_total = 0                  # guarded-by: _lock
        self.shed_total = 0                      # guarded-by: _lock
        self.expired_total = 0                   # guarded-by: _lock
        self.poisoned_total = 0                  # guarded-by: _lock
        self.dispatches_total = 0                # guarded-by: _lock
        self.errors_total = 0                    # guarded-by: _lock
        self._completions: deque = deque(  # timestamps; guarded-by: _lock
            maxlen=window)
        self._latencies: deque = deque(    # seconds; guarded-by: _lock
            maxlen=window)
        self._batch_hist: Dict[int, int] = {     # guarded-by: _lock
            b: 0 for b in self.BATCH_BUCKETS}
        self._batch_overflow = 0                 # guarded-by: _lock

    # -- recording ---------------------------------------------------------
    def observe_request(self, latency_s: float, rows: int) -> None:
        now = time.monotonic()
        with self._lock:
            self.requests_total += 1
            self.rows_total += rows
            self._completions.append(now)
            self._latencies.append(latency_s)

    def observe_reject(self) -> None:
        with self._lock:
            self.rejected_total += 1

    def observe_shed(self) -> None:
        """Drain-rate-aware admission rejection (counted apart from
        queue-full rejects: shedding is a policy decision, not a
        capacity cliff)."""
        with self._lock:
            self.shed_total += 1

    def observe_expired(self, n: int = 1) -> None:
        """Tickets dropped at batch formation (client deadline passed
        or submitter abandoned) — work that never reached the device."""
        with self._lock:
            self.expired_total += n

    def observe_poisoned(self, rows: int = 1) -> None:
        """Rows isolated by split-and-retry as the cause of a batch
        failure (their co-batched innocents succeeded)."""
        with self._lock:
            self.poisoned_total += rows

    def observe_error(self) -> None:
        with self._lock:
            self.errors_total += 1

    def observe_batch(self, rows: int) -> None:
        with self._lock:
            self.dispatches_total += 1
            for bound in self.BATCH_BUCKETS:
                if rows <= bound:
                    self._batch_hist[bound] += 1
                    return
            self._batch_overflow += 1

    # -- reading -----------------------------------------------------------
    def _qps(self, now: float) -> float:  # holds: _lock
        horizon = now - self._qps_window_s
        recent = sum(1 for t in self._completions if t >= horizon)
        span = min(self._qps_window_s, max(now - self._started, 1e-6))
        return recent / span

    def _percentiles(self) -> Dict[str, float]:  # holds: _lock
        if not self._latencies:
            return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
        lat_ms = np.asarray(self._latencies) * 1000.0
        p50, p95, p99 = np.percentile(lat_ms, (50, 95, 99))
        return {"p50": float(p50), "p95": float(p95), "p99": float(p99)}

    def qps(self) -> float:
        """Current completion rate alone (the light read ``/healthz``
        uses — no percentile arrays, no histogram copy)."""
        with self._lock:
            return self._qps(time.monotonic())

    def snapshot(self, queue_depth: int = 0) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            return {
                "qps": self._qps(now),
                "queue_depth": queue_depth,
                "requests_total": self.requests_total,
                "rows_total": self.rows_total,
                "rejected_total": self.rejected_total,
                "shed_total": self.shed_total,
                "expired_total": self.expired_total,
                "poisoned_total": self.poisoned_total,
                "errors_total": self.errors_total,
                "dispatches_total": self.dispatches_total,
                "batch_size_histogram": {
                    str(b): c for b, c in self._batch_hist.items()},
                "batch_size_overflow": self._batch_overflow,
                "latency_ms": self._percentiles(),
                "uptime_s": now - self._started,
            }

    def prometheus_text(self, model: str,
                        queue_depth: int = 0) -> str:
        """Prometheus text exposition for one model label — rendered
        by THE one renderer (veles_tpu_torch.obs.metrics); the snapshot
        keys are the contract, the text is derived."""
        from veles_tpu_torch.obs import metrics as obs_metrics
        return obs_metrics.render(obs_metrics.serve_samples(
            model, self.snapshot(queue_depth)))


class GenMetrics:
    """Decode-plane serving counters + distributions.

    The unit of work is the TOKEN. Tracks a sliding token-completion
    window (tokens/sec), per-decode-step latency (reservoir ->
    p50/p99), per-request end-to-end latency, and admission/retirement
    counters. ``snapshot()`` merges the engine's live gauges (active
    sequences, slot occupancy, compile count).
    """

    def __init__(self, window: int = 4096,
                 rate_window_s: float = 30.0) -> None:
        self._lock = threading.Lock()
        self._started = time.monotonic()
        self._rate_window_s = rate_window_s
        self.requests_total = 0                  # guarded-by: _lock
        self.tokens_total = 0                    # guarded-by: _lock
        self.rejected_total = 0                  # guarded-by: _lock
        self.expired_total = 0                   # guarded-by: _lock
        self.nonfinite_total = 0                 # guarded-by: _lock
        self.errors_total = 0                    # guarded-by: _lock
        self.prefills_total = 0                  # guarded-by: _lock
        self.decode_steps_total = 0              # guarded-by: _lock
        # (timestamp, token_count) per STEP, so a high token rate never
        # evicts its own window
        self._token_stamps: deque = deque(maxlen=window)  # guarded-by: _lock
        self._decode_lat: deque = deque(maxlen=window)    # guarded-by: _lock
        self._request_lat: deque = deque(maxlen=window)   # guarded-by: _lock

    # -- recording ---------------------------------------------------------
    def observe_decode(self, latency_s: float, tokens: int) -> None:
        now = time.monotonic()
        with self._lock:
            self.decode_steps_total += 1
            self.tokens_total += tokens
            self._decode_lat.append(latency_s)
            self._token_stamps.append((now, tokens))

    def observe_prefill(self, tokens: int) -> None:
        now = time.monotonic()
        with self._lock:
            self.prefills_total += 1
            # prefill emits each sequence's FIRST generated token
            self.tokens_total += tokens
            self._token_stamps.append((now, tokens))

    def observe_request(self, latency_s: float) -> None:
        with self._lock:
            self.requests_total += 1
            self._request_lat.append(latency_s)

    def observe_reject(self) -> None:
        with self._lock:
            self.rejected_total += 1

    def observe_expired(self, n: int = 1) -> None:
        with self._lock:
            self.expired_total += n

    def observe_nonfinite(self, n: int = 1) -> None:
        with self._lock:
            self.nonfinite_total += n

    def observe_error(self) -> None:
        with self._lock:
            self.errors_total += 1

    # -- reading -----------------------------------------------------------
    def _tokens_per_sec(self, now: float) -> float:  # holds: _lock
        horizon = now - self._rate_window_s
        recent = sum(count for t, count in self._token_stamps
                     if t >= horizon)
        span = min(self._rate_window_s, max(now - self._started, 1e-6))
        return recent / span

    @staticmethod
    def _pcts(lat: deque) -> Dict[str, float]:
        if not lat:
            return {"p50": 0.0, "p99": 0.0}
        ms = np.asarray(lat) * 1000.0
        p50, p99 = np.percentile(ms, (50, 99))
        return {"p50": float(p50), "p99": float(p99)}

    def tokens_per_sec(self) -> float:
        with self._lock:
            return self._tokens_per_sec(time.monotonic())

    def snapshot(self, queue_depth: int = 0,
                 engine=None) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            snap = {
                "tokens_per_sec": self._tokens_per_sec(now),
                "queue_depth": queue_depth,
                "requests_total": self.requests_total,
                "tokens_total": self.tokens_total,
                "rejected_total": self.rejected_total,
                "expired_total": self.expired_total,
                "nonfinite_total": self.nonfinite_total,
                "errors_total": self.errors_total,
                "prefills_total": self.prefills_total,
                "decode_steps_total": self.decode_steps_total,
                "decode_ms": self._pcts(self._decode_lat),
                "request_ms": self._pcts(self._request_lat),
                "uptime_s": now - self._started,
            }
        if engine is not None and hasattr(engine, "decode_stats"):
            snap.update(engine.decode_stats())
        return snap

    def prometheus_text(self, model: str, queue_depth: int = 0,
                        engine=None) -> str:
        from veles_tpu_torch.obs import metrics as obs_metrics
        return obs_metrics.render(obs_metrics.gen_samples(
            model, self.snapshot(queue_depth, engine)))


def most_urgent_budget_ms(tickets) -> Optional[float]:
    """Most-urgent remaining client budget in ms across ``tickets``
    (deadline-carrying ones; None when none carry a deadline) — the
    serve plane's per-dispatch deadline handoff to the scheduler's
    boost (``TenantHandle.quantum(deadline_ms=)``)."""
    now = time.monotonic()
    urgent = None
    for ticket in tickets:
        if ticket.deadline is not None:
            remaining = (ticket.deadline - now) * 1000.0
            urgent = remaining if urgent is None else \
                min(urgent, remaining)
    return None if urgent is None else max(urgent, 0.0)


class _Ticket:
    """One in-flight request: rows in, output chunks back."""

    __slots__ = ("rows", "offset", "chunks", "enqueued", "abandoned",
                 "deadline", "priority", "ctx", "taken", "queue_ms",
                 "sched_ms", "device_ms")

    def __init__(self, rows: np.ndarray,
                 deadline: Optional[float] = None,
                 priority: str = "interactive",
                 ctx: Optional[TraceContext] = None) -> None:
        self.rows = rows
        self.offset = 0           # rows already taken into a batch
        self.chunks: "queue.Queue" = queue.Queue()
        self.enqueued = time.monotonic()
        self.abandoned = False    # submitter timed out; drop outputs
        #: absolute monotonic client deadline (None = patient client)
        self.deadline = deadline
        self.priority = priority
        #: propagated trace identity (None = untraced request); the
        #: dispatch loop accumulates the request's latency breakdown
        #: next to it for the exemplar table
        self.ctx = ctx
        self.taken = False        # first batch-formation take recorded
        self.queue_ms = 0.0
        self.sched_ms = 0.0
        self.device_ms = 0.0

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


class MicroBatcher:
    """Ticketed dynamic micro-batcher over an engine.

    ``engine`` is anything with ``apply(np[N, ...]) -> np[N, ...]``
    (an :class:`~veles_tpu_torch.serve.engine.InferenceEngine`, or a stub in
    tests). ``max_batch`` caps rows per dispatch; ``max_delay_ms``
    bounds how long the OLDEST queued ticket waits before a partial
    batch dispatches; ``max_queue_rows`` is the admission bound.
    ``tenant``: a scheduler ``TenantHandle`` (see :meth:`set_tenant`).
    """

    def __init__(self, engine, *, max_batch: int = 64,
                 max_delay_ms: float = 2.0,
                 quiet_ms: Optional[float] = None,
                 max_queue_rows: int = 1024,
                 name: str = "serve",
                 metrics: Optional[ServeMetrics] = None,
                 tenant=None, isolate_poison: bool = True,
                 batch_class_frac: float = 0.5,
                 shed_margin: float = 0.7) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if not 0.0 < batch_class_frac <= 1.0:
            raise ValueError("batch_class_frac must be in (0, 1], "
                             "got %r" % (batch_class_frac,))
        self.engine = engine                     # guarded-by: _cond
        self.name = name
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        # Work-conserving early close (Clipper-style adaptive
        # batching): once the queue stops growing for a quiet quantum,
        # dispatch what is there — with C closed-loop clients a
        # max_batch > C would otherwise ALWAYS wait out max_delay for
        # rows that cannot arrive. quiet_ms = max_delay_ms disables
        # the early close (deterministic full-delay batching).
        self.quiet_s = (float(quiet_ms) / 1000.0) if quiet_ms \
            is not None else max(self.max_delay_s / 8.0, 0.0002)
        self.max_queue_rows = int(max_queue_rows)
        #: on a batch exception, bisect (split-and-retry) to isolate
        #: the poisoned row(s) so co-batched innocents still succeed
        self.isolate_poison = bool(isolate_poison)
        #: two-class shedding: "batch"-priority requests are refused
        #: once the queue passes this fraction of max_queue_rows —
        #: the batch class sheds FIRST, keeping headroom for
        #: interactive traffic
        self.batch_class_frac = float(batch_class_frac)
        #: admission safety factor: a deadline-carrying request is
        #: shed on arrival once the predicted time-to-service exceeds
        #: this fraction of its remaining budget. The headroom covers
        #: what the queue-depth model cannot see — the request's own
        #: service time, batch-formation delay, and estimator lag
        #: under a shifting load — so admitted work actually finishes
        #: inside its deadline instead of expiring in the queue.
        if not 0.0 < shed_margin <= 1.0:
            raise ValueError("shed_margin must be in (0, 1], got %r"
                             % (shed_margin,))
        self.shed_margin = float(shed_margin)
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self._cond = threading.Condition()
        self._pending: deque = deque()           # guarded-by: _cond
        self._pending_rows = 0                   # guarded-by: _cond
        self._draining = False                   # guarded-by: _cond
        # -- drain-rate estimate + dispatch watchdog heartbeat --
        #: EWMA seconds of device time per dispatched row (None until
        #: the first batch completes) — the admission controller's
        #: time-to-service model
        self._row_seconds: Optional[float] = None
        #: monotonic start of the engine call currently on the device,
        #: or None when the dispatch thread is between calls — the
        #: watchdog reads it to flag a hung device call
        self._dispatch_t0: Optional[float] = None
        #: multi-tenant device sharing (veles_tpu_torch.sched): each
        #: dispatched batch runs as ONE scheduler quantum, the batch
        #: boundary being the forward plane's natural preemption point
        self._tenant = None
        self._threads = ManagedThreads(name="%s-batcher" % name)
        self.set_tenant(tenant)
        self._threads.spawn(self._dispatch_loop, name="dispatch")

    # -- multi-tenancy -----------------------------------------------------
    def set_tenant(self, tenant) -> None:
        """Attach this batcher to a scheduler tenant: every dispatched
        batch becomes one quantum. A tenant without its own
        ManagedThreads adopts the batcher's, so ``Scheduler.stop()``
        request-stops the dispatch loop. The engine knows nothing of
        the tenant: a caller that warms it (captures its graphs) while
        other tenants run does so inside ``with tenant.quantum():``."""
        self._tenant = tenant
        if tenant is not None and tenant.threads is None:
            tenant.threads = self._threads

    def _quantum(self, deadline_ms: Optional[float] = None):
        return quantum_or_null(self._tenant, deadline_ms=deadline_ms)

    # -- client side -------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        """Rows currently queued (admission-control occupancy)."""
        with self._cond:
            return self._pending_rows

    @property
    def stuck_for_s(self) -> float:
        """Seconds the CURRENT engine call has been on the device
        (0.0 between calls) — the dispatch-watchdog heartbeat
        ``/healthz`` reads. Recovers to 0 the moment the call
        returns."""
        t0 = self._dispatch_t0
        return 0.0 if t0 is None else max(0.0, elapsed_s(t0))

    @property
    def drain_rate_rows_per_s(self) -> float:
        """Observed service rate (rows/s) from the dispatch-time EWMA
        — the admission controller's time-to-service model, exported
        through ``/healthz`` so a fleet router can weight this replica
        without a second ``/metrics`` scrape. 0.0 until the first
        dispatch calibrates it."""
        row_seconds = self._row_seconds
        return 0.0 if not row_seconds else 1.0 / row_seconds

    def eta_seconds(self, extra_rows: int = 0  # holds: _cond
                    ) -> Optional[float]:
        """Predicted time-to-service for a request arriving NOW:
        queue depth (+ ``extra_rows``) x the observed per-row batch
        latency. None until the first dispatch calibrates the
        estimate."""
        if self._row_seconds is None:
            return None
        return (self._pending_rows + extra_rows) * self._row_seconds

    def _retry_after(self, rows: int) -> float:  # holds: _cond
        """Retry-After from the REAL drain rate: how long until the
        current backlog (plus this request) would have drained."""
        eta = self.eta_seconds(rows)
        return max(eta, 0.05) if eta is not None else 1.0

    def submit(self, batch: np.ndarray, timeout: float = 30.0,
               deadline_ms: Optional[float] = None,
               priority: str = "interactive",
               ctx: Optional[TraceContext] = None) -> np.ndarray:
        """Called on request threads: enqueue rows, block for outputs.

        ``deadline_ms`` is the client's end-to-end budget: a ticket
        that cannot make it is shed ON ARRIVAL (:class:`Shed`, with
        ``retry_after`` from the observed drain rate), and one that
        expires while queued is dropped at batch formation
        (:class:`DeadlineExceeded`) — expired work never reaches the
        device. ``priority`` is the two-class knob: ``"batch"``
        traffic sheds first (see ``batch_class_frac``).

        Raises :class:`QueueFull` / :class:`Shed` (admission),
        :class:`Draining` (shutting down), :class:`DeadlineExceeded`,
        :class:`PoisonedRequest` (this request's rows fail the
        engine), ``TimeoutError``, or the engine's error."""
        rows = np.ascontiguousarray(np.asarray(batch))
        if rows.ndim < 2 or rows.shape[0] == 0:
            raise ValueError(
                "submit needs a non-empty [N, ...] batch, got shape %s"
                % (rows.shape,))
        if priority not in ("interactive", "batch"):
            raise ValueError("priority must be 'interactive' or "
                             "'batch', got %r" % (priority,))
        now = time.monotonic()
        abs_deadline = now + deadline_ms / 1000.0 \
            if deadline_ms is not None else None
        if ctx is None and TRACER.enabled:
            ctx = TraceContext.new()  # direct callers trace too
        ticket = _Ticket(rows, deadline=abs_deadline,
                         priority=priority, ctx=ctx)
        with self._cond:
            if self._draining or self._threads.stop_requested:
                raise Draining("batcher is draining")
            if self._pending_rows + len(rows) > self.max_queue_rows:
                self.metrics.observe_reject()
                raise QueueFull(
                    "queue full (%d queued + %d requested > %d rows)"
                    % (self._pending_rows, len(rows),
                       self.max_queue_rows),
                    retry_after=self._retry_after(len(rows)))
            # two-class shedding: batch traffic is refused while the
            # queue is past its fraction — interactive keeps the
            # remaining headroom. Occupancy only: counting the
            # request's own rows would permanently shed any batch
            # request bigger than the headroom, even on an idle
            # server.
            if priority == "batch" and \
                    self._pending_rows > \
                    self.batch_class_frac * self.max_queue_rows:
                self.metrics.observe_shed()
                raise Shed(
                    "batch-class shed (%d queued > %.0f%% of %d rows)"
                    % (self._pending_rows,
                       self.batch_class_frac * 100,
                       self.max_queue_rows),
                    retry_after=self._retry_after(len(rows)))
            # drain-rate-aware shedding: reject on arrival anything
            # that cannot make its deadline — a doomed request must
            # not burn queue space and device time. shed_margin keeps
            # admitted work comfortably inside its budget.
            eta = self.eta_seconds(len(rows))
            if abs_deadline is not None and eta is not None and \
                    eta >= self.shed_margin * (abs_deadline - now):
                self.metrics.observe_shed()
                raise Shed(
                    "cannot meet deadline (eta %.1f ms vs budget "
                    "%.1f ms x margin %.2f)"
                    % (eta * 1000.0, deadline_ms, self.shed_margin),
                    retry_after=self._retry_after(len(rows)))
            self._pending.append(ticket)
            self._pending_rows += len(rows)
            self._cond.notify_all()
        chunks: List[np.ndarray] = []
        got = 0
        wait_deadline = now + timeout
        if abs_deadline is not None:
            wait_deadline = min(wait_deadline, abs_deadline)
        while got < len(rows):
            remaining = wait_deadline - time.monotonic()
            if remaining <= 0:
                ticket.abandoned = True
                if ticket.expired(time.monotonic()):
                    raise DeadlineExceeded("client deadline exceeded")
                raise TimeoutError("inference timed out")
            try:
                chunk = ticket.chunks.get(timeout=remaining)
            except queue.Empty:
                ticket.abandoned = True
                if ticket.expired(time.monotonic()):
                    raise DeadlineExceeded(
                        "client deadline exceeded") from None
                raise TimeoutError("inference timed out") from None
            if isinstance(chunk, BaseException):
                raise chunk
            chunks.append(chunk)
            got += len(chunk)
        done = time.monotonic()
        latency = done - ticket.enqueued
        self.metrics.observe_request(latency, len(rows))
        if ticket.ctx is not None:
            TRACER.add("request", "serve", ticket.ctx,
                       ticket.enqueued, done, rows=len(rows))
            EXEMPLARS.record(
                self.name, ticket.ctx.trace_id, latency * 1000.0,
                queue_ms=ticket.queue_ms, sched_ms=ticket.sched_ms,
                device_ms=ticket.device_ms)
        out = chunks[0] if len(chunks) == 1 else \
            np.concatenate(chunks, axis=0)
        return out

    # -- hot swap ----------------------------------------------------------
    def swap_engine(self, engine) -> None:
        """Atomic between-batches engine replacement: the dispatch
        loop snapshots ``self.engine`` under the queue lock, so a
        swap never lands mid-batch."""
        with self._cond:
            self.engine = engine

    # -- dispatch loop -----------------------------------------------------
    def _close_batch(self  # holds: _cond
                     ) -> Tuple[List[Tuple[_Ticket, np.ndarray]],
                                Any]:
        """Under the lock: take up to max_batch rows FIFO (splitting
        an oversized head ticket) + the engine to run them on. Only
        tickets whose rows share the head ticket's trailing shape and
        dtype join a batch — mixed shapes (e.g. variable-length LM
        requests) dispatch as separate shape groups instead of
        blowing up the concatenate and killing the dispatch thread.

        Deadline shed happens HERE, before any rows are taken: a
        ticket whose client deadline passed (or whose submitter
        already abandoned it — the timed-out-client orphan case) is
        dropped whole, its remaining rows never dispatch, and the
        waiting client (if any) gets :class:`DeadlineExceeded`."""
        parts: List[Tuple[_Ticket, np.ndarray]] = []
        taken = 0
        shape_key = None
        now = time.monotonic()
        while self._pending and taken < self.max_batch:
            ticket = self._pending[0]
            if ticket.abandoned or ticket.expired(now):
                # expired/cancelled work must not occupy batch rows:
                # drop ALL its remaining rows at formation
                self._pending.popleft()
                self._pending_rows -= len(ticket.rows) - ticket.offset
                self.metrics.observe_expired()
                if not ticket.abandoned:
                    ticket.chunks.put(DeadlineExceeded(
                        "deadline passed while queued"))
                    ticket.abandoned = True
                continue
            key = (ticket.rows.shape[1:], ticket.rows.dtype)
            if shape_key is None:
                shape_key = key
            elif key != shape_key:
                break  # next shape group gets its own batch
            if not ticket.taken:
                # first take = end of this request's queue wait
                ticket.taken = True
                ticket.queue_ms = (now - ticket.enqueued) * 1000.0
                if ticket.ctx is not None:
                    TRACER.add("queue", "serve", ticket.ctx,
                               ticket.enqueued, now)
            avail = len(ticket.rows) - ticket.offset
            count = min(avail, self.max_batch - taken)
            parts.append(
                (ticket,
                 ticket.rows[ticket.offset:ticket.offset + count]))
            ticket.offset += count
            if ticket.offset == len(ticket.rows):
                self._pending.popleft()
            taken += count
        self._pending_rows -= taken
        return parts, self.engine

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending:
                    if self._threads.stop_requested:
                        return
                    self._cond.wait(0.05)
                # batch-closing: wait for more rows until the OLDEST
                # ticket has waited max_delay, the batch is full, or
                # the queue has gone quiet for a quantum
                deadline = self._pending[0].enqueued + self.max_delay_s
                while (self._pending_rows < self.max_batch and
                       not self._threads.stop_requested):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    before = self._pending_rows
                    self._cond.wait(min(remaining, self.quiet_s))
                    if self._pending_rows == before:
                        break  # quiet: more waiting = pure latency
                parts, engine = self._close_batch()
            if not parts:
                continue  # stop(drain=False) raced the delay wait
            try:  # assembly inside the trap: a bad batch must fail
                # its tickets, never the dispatch thread
                rows = np.concatenate([p for _, p in parts], axis=0) \
                    if len(parts) > 1 else parts[0][1]
                self.metrics.observe_batch(len(rows))
                t0 = time.monotonic()
                self._dispatch_t0 = t0  # watchdog heartbeat
                head_ctx = parts[0][0].ctx
                try:
                    # dispatch-scope log correlation (off by default
                    # costs one thread-local store)
                    with log_context(
                            batcher=self.name,
                            trace=head_ctx.trace_id
                            if head_ctx else None), \
                            self._quantum(self._urgency_ms(parts)) \
                            as lease:
                        # None = no scheduler attached (nullcontext):
                        # no sched_wait spans get recorded at all
                        waited_s = getattr(lease, "waited_s", None)
                        td0 = time.monotonic()
                        out = engine.apply(rows)
                finally:
                    self._dispatch_t0 = None
                t1 = time.monotonic()
                obs_profile.on_step()
                self._trace_dispatch(parts, waited_s, td0, t1)
                self._observe_drain(elapsed_s(t0), len(rows))
            except BaseException as e:  # noqa: BLE001 — per-batch trap
                self.metrics.observe_error()
                if self.isolate_poison and len(parts[0][1]) + sum(
                        len(p) for _, p in parts[1:]) > 1 and \
                        not self._threads.stop_requested:
                    self._finish_with_isolation(engine, parts, e)
                else:
                    for ticket, _ in parts:
                        if not ticket.abandoned:
                            ticket.chunks.put(e)
                continue
            offset = 0
            for ticket, part in parts:
                chunk = out[offset:offset + len(part)]
                offset += len(part)
                if not ticket.abandoned:
                    ticket.chunks.put(np.array(chunk))

    # -- drain-rate helpers (dispatch thread only) -------------------------
    def _observe_drain(self, took_s: float, rows: int) -> None:
        """EWMA the per-row service time — the admission controller's
        time-to-service model (one reader, one writer; a float store
        is atomic in CPython)."""
        per_row = took_s / max(rows, 1)
        self._row_seconds = per_row if self._row_seconds is None else \
            0.8 * self._row_seconds + 0.2 * per_row

    @staticmethod
    def _trace_dispatch(parts, waited_s, td0: float, t1: float) -> None:
        """Record the scheduler-wait and device spans of one
        dispatched batch against every traced co-batched ticket, and
        accumulate the per-ticket breakdown the exemplar table reports.
        ``waited_s`` None means no scheduler is attached: then no
        sched_wait spans are recorded (a zero-length span per ticket
        per dispatch would only churn the ring buffer)."""
        for ticket, part in parts:
            ticket.sched_ms += (waited_s or 0.0) * 1000.0
            ticket.device_ms += (t1 - td0) * 1000.0
            if ticket.ctx is None:
                continue
            if waited_s is not None:
                TRACER.add("sched_wait", "sched", ticket.ctx,
                           td0 - waited_s, td0)
            TRACER.add("device", "serve", ticket.ctx, td0, t1,
                       rows=len(part))

    @staticmethod
    def _urgency_ms(parts: List[Tuple[_Ticket, np.ndarray]]
                    ) -> Optional[float]:
        """Most urgent remaining client budget in this batch (ms),
        handed to the scheduler so a shared-device serve batch carrying
        an imminent deadline gets the deadline boost."""
        return most_urgent_budget_ms(t for t, _ in parts)

    def _finish_with_isolation(self, engine, parts, cause) -> None:
        """The batch failed: bisect (split-and-retry) to isolate the
        poisoned row(s) — O(log n) extra dispatches per poisoned row —
        so innocent co-batched tickets still get answers. Tickets
        owning a poisoned row get :class:`PoisonedRequest` (with the
        engine's error as ``__cause__``)."""
        rows = np.concatenate([p for _, p in parts], axis=0) \
            if len(parts) > 1 else parts[0][1]
        errors: Dict[int, BaseException] = {}
        outs: List[Tuple[int, np.ndarray]] = []

        # bisection retries stay on the request's trace: segments are
        # spans against every traced co-batched ticket, so the
        # isolation work is visible in the same timeline
        traced = [t for t, _ in parts if t.ctx is not None]

        def run(segment: np.ndarray, base: int) -> None:
            self._dispatch_t0 = time.monotonic()
            t0 = self._dispatch_t0
            try:
                # each retry is a device call of its own: it takes a
                # scheduler quantum like every other dispatch (a shared
                # device must not see unleased serve work)
                with self._quantum(self._urgency_ms(parts)):
                    out = engine.apply(segment)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — bisecting
                if len(segment) == 1:
                    errors[base] = e
                    return
                mid = len(segment) // 2
                run(segment[:mid], base)
                run(segment[mid:], base + mid)
                return
            finally:
                self._dispatch_t0 = None
                done = time.monotonic()
                for ticket in traced:
                    TRACER.add("bisect_retry", "serve", ticket.ctx,
                               t0, done, base=base,
                               rows=len(segment))
            outs.append((base, np.asarray(out)))

        run(rows, 0)
        self.metrics.observe_poisoned(len(errors))
        full = None
        if outs:
            head = outs[0][1]
            full = np.zeros((len(rows),) + head.shape[1:], head.dtype)
            for base, out in outs:
                full[base:base + len(out)] = out
        offset = 0
        for ticket, part in parts:
            span = range(offset, offset + len(part))
            offset += len(part)
            if ticket.abandoned:
                continue
            bad = next((i for i in span if i in errors), None)
            if bad is not None:
                err = PoisonedRequest(
                    "request rows made the batch fail: %r"
                    % (errors[bad],))
                err.__cause__ = errors[bad]
                ticket.chunks.put(err)
            elif full is not None:
                ticket.chunks.put(np.array(full[span.start:span.stop]))
            else:  # cannot happen: no errors in span => outs exist
                ticket.chunks.put(cause)

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout: float = 30.0) -> bool:
        """Refuse new work, finish accepted work; True when empty."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cond:
                if not self._pending:
                    return True
            time.sleep(0.005)
        return False

    @property
    def draining(self) -> bool:
        # lock-free bool gauge (monotonic False->True); admission
        # re-checks it under the lock in submit()
        return self._draining  # noqa: VC002

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Drain (optionally), then stop and JOIN the dispatch thread
        — the ManagedThreads discipline: a leak is loud, not silent."""
        if drain:
            self.drain(timeout)
        else:
            with self._cond:
                self._draining = True
                # fail queued-but-undispatched tickets fast
                for ticket in self._pending:
                    if not ticket.abandoned:
                        ticket.chunks.put(Draining("batcher stopped"))
                self._pending.clear()
                self._pending_rows = 0
        self._threads.request_stop()
        with self._cond:
            self._cond.notify_all()
        leaked = self._threads.join_all()
        if leaked:
            raise RuntimeError("batcher leaked threads: %s"
                               % [t.name for t in leaked])


# ---------------------------------------------------------------------------
# continuous batching (the generative decode plane)
# ---------------------------------------------------------------------------

#: end-of-stream sentinel on a generation ticket's token queue
_GEN_DONE = object()


def _validate_sampling(engine, temperature=None, top_k=None,
                       top_p=None, seed=None,
                       draft: bool = False) -> Optional[Dict[str, Any]]:
    """Normalize + validate the sampling knobs a request carries.
    Returns the engine-facing options dict, or None for a plain greedy
    request. Raises ``ValueError`` on out-of-range values, and on any
    sampling/draft ask against an engine that lacks the capability:
    the slab plane is greedy-only, the paged plane samples, and only a
    paged engine with a draft model speculates."""
    opts: Dict[str, Any] = {}
    if temperature is not None:
        temperature = float(temperature)
        if not np.isfinite(temperature) or temperature < 0.0:
            raise ValueError(
                "temperature must be a finite float >= 0")
        if temperature > 0.0:
            opts["temperature"] = temperature
    if top_k is not None:
        if isinstance(top_k, bool) or int(top_k) != top_k:
            raise ValueError("top_k must be an integer >= 0")
        top_k = int(top_k)
        if top_k < 0:
            raise ValueError("top_k must be an integer >= 0")
        if top_k > 0:
            opts["top_k"] = top_k
    if top_p is not None:
        top_p = float(top_p)
        if not np.isfinite(top_p) or not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if top_p < 1.0:
            opts["top_p"] = top_p
    if seed is not None:
        if isinstance(seed, bool) or int(seed) != seed:
            raise ValueError("seed must be an integer >= 0")
        seed = int(seed)
        if seed < 0:
            raise ValueError("seed must be an integer >= 0")
        opts["seed"] = seed
    if draft:
        if not getattr(engine, "has_draft", False):
            raise ValueError(
                "draft=true needs a serving engine with a draft "
                "model (speculative decoding is not configured)")
        opts["draft"] = True
    if opts and not getattr(engine, "supports_sampling", False):
        raise ValueError(
            "sampling parameters need the paged decode plane "
            "(this engine is greedy-only)")
    return opts or None


class _GenTicket:
    """One generation request: prompt in, a stream of tokens back."""

    __slots__ = ("prompt", "max_tokens", "eos", "tokens", "enqueued",
                 "abandoned", "slot", "generated", "deadline", "ctx",
                 "queue_ms", "sched_ms", "device_ms", "sampling",
                 "emitted")

    def __init__(self, prompt: np.ndarray, max_tokens: int,
                 eos: Optional[int],
                 deadline: Optional[float] = None,
                 ctx: Optional[TraceContext] = None,
                 sampling: Optional[Dict[str, Any]] = None) -> None:
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.eos = eos
        self.tokens: "queue.Queue" = queue.Queue()
        self.enqueued = time.monotonic()
        self.abandoned = False
        self.slot: Optional[int] = None
        self.generated = 0
        #: absolute monotonic client deadline (None = patient client)
        self.deadline = deadline
        #: propagated trace identity + latency breakdown (exemplars)
        self.ctx = ctx
        self.queue_ms = 0.0
        self.sched_ms = 0.0
        self.device_ms = 0.0
        #: validated sampling options (None = greedy)
        self.sampling = sampling
        #: every token emitted so far: a preempted ticket re-prefills
        #: prompt + emitted and resumes its sampling counter at
        #: ``generated``, so its stream continues where it left off
        self.emitted: List[int] = []

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


class TokenBatcher:
    """Continuous batching over a
    :class:`~veles_tpu_torch.serve.engine.GenerativeEngine` or a
    :class:`~veles_tpu_torch.serve.engine.PagedGenerativeEngine`.

    - the dispatch loop runs **decode steps back to back** while any
      sequence is active;
    - queued requests JOIN at token boundaries — whenever slots are
      free, the next prefill admits up to ``free_slots`` of them in one
      bucketed batch, then decoding resumes with the bigger batch (a
      paged engine admits only what its page pool holds now; the rest
      waits at the queue head);
    - finished sequences (EOS or ``max_tokens``) RETIRE mid-flight:
      their slot frees immediately and the next admission reuses it;
    - every generated token streams onto its ticket's queue the step
      it is produced (``submit`` collects, ``stream`` yields).

    Admission control: a bounded pending queue (:class:`QueueFull` ->
    HTTP 503) and a drain mode that finishes accepted sequences while
    refusing new ones. Page-pool exhaustion during decode PREEMPTS
    sequences: their tickets requeue at the head and re-prefill (prompt
    + emitted) once pages free; the client only waits.

    ``tenant``: a scheduler ``TenantHandle``; each prefill admission
    and each decode round is then one quantum (:meth:`set_tenant`).
    """

    def __init__(self, engine, *, max_queue: int = 64,
                 name: str = "generate", tenant=None) -> None:
        # the dispatch loop is the ONLY reader/writer once the thread
        # starts; _enqueue's advisory max_len pre-check is the one
        # sanctioned off-thread peek
        self.engine = engine                     # owned-by: dispatch
        self.name = name
        self.max_queue = int(max_queue)
        self.metrics = GenMetrics()
        self._cond = threading.Condition()
        self._pending: deque = deque()           # guarded-by: _cond
        self._by_slot: Dict[int, _GenTicket] = {}  # owned-by: dispatch
        self._draining = False                   # guarded-by: _cond
        #: engine queued by :meth:`swap_engine`; the dispatch loop
        #: switches once every active sequence retired
        self._next_engine = None                 # guarded-by: _cond
        #: watchdog heartbeat: monotonic start of the engine call on
        #: the device, None between calls
        self._dispatch_t0: Optional[float] = None
        #: multi-tenant device sharing: one prefill admission or one
        #: decode round per quantum, the token boundary being the
        #: decode plane's natural preemption point
        self._tenant = None
        self._threads = ManagedThreads(name="%s-batcher" % name)
        self.set_tenant(tenant)
        self._threads.spawn(self._dispatch_loop, name="dispatch")

    # -- multi-tenancy -----------------------------------------------------
    def set_tenant(self, tenant) -> None:
        """Attach to a scheduler tenant (see MicroBatcher.set_tenant):
        prefill and every decode round become quanta."""
        self._tenant = tenant
        if tenant is not None and tenant.threads is None:
            tenant.threads = self._threads

    def _quantum(self, deadline_ms: Optional[float] = None):
        return quantum_or_null(self._tenant, deadline_ms=deadline_ms)

    # -- client side -------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._pending)

    @property
    def stuck_for_s(self) -> float:
        """Seconds the CURRENT engine call (prefill or decode step) has
        been out; 0.0 between calls — the watchdog heartbeat."""
        t0 = self._dispatch_t0
        return 0.0 if t0 is None else max(0.0, elapsed_s(t0))

    @property
    def drain_rate_rows_per_s(self) -> float:
        """The decode plane's service rate: generated tokens/s."""
        return self.metrics.tokens_per_sec()

    def swap_engine(self, engine) -> None:
        """Hot-swap the engine: in-flight sequences FINISH on the old
        engine (their KV cache lives in its slab); new admissions wait
        and land on the new engine once the old one drained."""
        with self._cond:
            self._next_engine = engine
            self._cond.notify_all()

    def _enqueue(self, prompt, max_tokens: int, eos: Optional[int],
                 deadline_ms: Optional[float] = None,
                 ctx: Optional[TraceContext] = None,
                 temperature=None, top_k=None, top_p=None, seed=None,
                 draft: bool = False) -> _GenTicket:
        """Validate + admit one generation request."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("submit needs a non-empty prompt")
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        # advisory capability read (supports_sampling/has_draft are
        # ctor-fixed booleans, never mutated): a stale read across a
        # hot-swap only mis-times the 400 — dispatch re-reads the
        # CURRENT engine's capability before passing sampling along
        sampling = _validate_sampling(
            self.engine, temperature=temperature,  # noqa: VC003
            top_k=top_k, top_p=top_p, seed=seed, draft=draft)
        # advisory pre-check against the CURRENT engine: a stale
        # read only mis-times the error; _admit re-validates on the
        # dispatch thread before prefill
        limit = getattr(self.engine, "max_len", None)  # noqa: VC003
        if limit is not None and len(prompt) + max_tokens > limit:
            raise ValueError(
                "prompt (%d) + max_tokens (%d) exceeds the engine's "
                "max_len %d" % (len(prompt), max_tokens, limit))
        deadline = time.monotonic() + deadline_ms / 1000.0 \
            if deadline_ms is not None else None
        if ctx is None and TRACER.enabled:
            ctx = TraceContext.new()
        ticket = _GenTicket(prompt, int(max_tokens), eos,
                            deadline=deadline, ctx=ctx,
                            sampling=sampling)
        with self._cond:
            if self._draining or self._threads.stop_requested:
                raise Draining("batcher is draining")
            if len(self._pending) >= self.max_queue:
                self.metrics.observe_reject()
                raise QueueFull(
                    "generation queue full (%d pending)"
                    % len(self._pending))
            self._pending.append(ticket)
            self._cond.notify_all()
        return ticket

    def submit(self, prompt, max_tokens: int = 16,
               eos: Optional[int] = None,
               timeout: float = 60.0,
               deadline_ms: Optional[float] = None,
               ctx: Optional[TraceContext] = None,
               temperature=None, top_k=None, top_p=None, seed=None,
               draft: bool = False) -> np.ndarray:
        """Generate up to ``max_tokens`` tokens after ``prompt`` (1-D
        int token array); blocks until the sequence retires and returns
        the generated tokens (EOS included when hit). Greedy by
        default; ``temperature`` / ``top_k`` / ``top_p`` / ``seed``
        turn on sampling and ``draft=True`` speculative decoding, both
        on a paged engine only (``ValueError`` otherwise; the same seed
        replays the same tokens whatever the batch around it).
        ``deadline_ms`` is the client's end-to-end budget. Raises
        :class:`QueueFull`, :class:`Draining`,
        :class:`DeadlineExceeded`, :class:`NonFiniteLogits`,
        ``TimeoutError``, ``ValueError``, or the engine's error."""
        ticket = self._enqueue(prompt, max_tokens, eos, deadline_ms,
                               ctx=ctx, temperature=temperature,
                               top_k=top_k, top_p=top_p, seed=seed,
                               draft=draft)
        out: List[int] = []
        deadline = time.monotonic() + timeout
        if ticket.deadline is not None:
            deadline = min(deadline, ticket.deadline)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                ticket.abandoned = True
                if ticket.expired(time.monotonic()):
                    raise DeadlineExceeded("client deadline exceeded")
                raise TimeoutError("generation timed out")
            try:
                item = ticket.tokens.get(timeout=remaining)
            except queue.Empty:
                ticket.abandoned = True
                if ticket.expired(time.monotonic()):
                    raise DeadlineExceeded(
                        "client deadline exceeded") from None
                raise TimeoutError("generation timed out") from None
            if item is _GEN_DONE:
                break
            if isinstance(item, BaseException):
                raise item
            out.append(item)
        self.metrics.observe_request(elapsed_s(ticket.enqueued))
        self._trace_request(ticket)
        return np.asarray(out, np.int32)

    def stream(self, prompt, max_tokens: int = 16,
               eos: Optional[int] = None, timeout: float = 60.0,
               deadline_ms: Optional[float] = None,
               ctx: Optional[TraceContext] = None,
               temperature=None, top_k=None, top_p=None, seed=None,
               draft: bool = False):
        """Streaming form of :meth:`submit`: validates + admits the
        request EAGERLY (admission errors raise here, before any bytes
        go on the wire), then returns an iterator yielding each token
        the decode step it is produced. ``timeout`` bounds the gap
        BETWEEN tokens. A consumer that stops iterating early abandons
        the ticket: its slot frees at the next token boundary."""
        ticket = self._enqueue(prompt, max_tokens, eos, deadline_ms,
                               ctx=ctx, temperature=temperature,
                               top_k=top_k, top_p=top_p, seed=seed,
                               draft=draft)

        def tokens():
            done = False
            try:
                while True:
                    try:
                        item = ticket.tokens.get(timeout=timeout)
                    except queue.Empty:
                        raise TimeoutError(
                            "generation timed out") from None
                    if item is _GEN_DONE:
                        done = True
                        self.metrics.observe_request(
                            elapsed_s(ticket.enqueued))
                        self._trace_request(ticket)
                        return
                    if isinstance(item, BaseException):
                        raise item
                    yield int(item)
            finally:
                if not done:  # early close/error frees the slot
                    ticket.abandoned = True

        return tokens()

    # -- dispatch loop (everything below runs ONLY on the dispatch
    # thread — slot state never needs a lock) ------------------------------
    def _retire(self, slot: int,  # runs-on: dispatch
                ticket: _GenTicket) -> None:
        if self._by_slot.pop(slot, None) is None:
            return
        self.engine.release(slot)
        if not ticket.abandoned:
            ticket.tokens.put(_GEN_DONE)

    def _emit(self, slot: int, ticket: _GenTicket,  # runs-on: dispatch
              token: int) -> None:
        """Route one token; retire on EOS / max_tokens — or at once
        when the submitter gave up (an abandoned ticket frees its slot
        at the next token boundary)."""
        if ticket.abandoned:
            self._retire(slot, ticket)
            return
        ticket.generated += 1
        ticket.emitted.append(int(token))
        ticket.tokens.put(int(token))
        if (ticket.eos is not None and int(token) == ticket.eos) or \
                ticket.generated >= ticket.max_tokens:
            self._retire(slot, ticket)

    @staticmethod
    def _urgency_ms(tickets) -> Optional[float]:
        """Most urgent remaining client budget (ms) across
        ``tickets``, handed to the scheduler's deadline boost."""
        return most_urgent_budget_ms(tickets)

    def _trace_request(self, ticket: _GenTicket) -> None:
        """Record the end-to-end request span + exemplar breakdown
        (called by the client thread when the stream closes)."""
        if ticket.ctx is None:
            return
        done = time.monotonic()
        TRACER.add("request", "gen", ticket.ctx, ticket.enqueued,
                   done, tokens=ticket.generated)
        EXEMPLARS.record(
            self.name, ticket.ctx.trace_id,
            (done - ticket.enqueued) * 1000.0,
            queue_ms=ticket.queue_ms, sched_ms=ticket.sched_ms,
            device_ms=ticket.device_ms)

    def _admit(self) -> None:  # runs-on: dispatch
        """Move pending tickets into free engine slots (one bucketed
        prefill); called at token boundaries only. Abandoned and
        deadline-expired tickets are shed HERE, before prefill.
        Prompts are re-validated against the CURRENT engine's
        max_len."""
        now = time.monotonic()
        limit = getattr(self.engine, "max_len", None)
        with self._cond:
            batch: List[_GenTicket] = []
            while self._pending and len(batch) < self.engine.free_slots:
                ticket = self._pending.popleft()
                if ticket.abandoned:  # timed out while queued
                    self.metrics.observe_expired()
                    continue
                if ticket.expired(now):
                    self.metrics.observe_expired()
                    ticket.tokens.put(DeadlineExceeded(
                        "deadline passed while queued"))
                    ticket.abandoned = True
                    continue
                if limit is not None and \
                        len(ticket.prompt) + ticket.max_tokens > limit:
                    self.metrics.observe_error()
                    ticket.tokens.put(ValueError(
                        "prompt (%d) + max_tokens (%d) exceeds the "
                        "serving engine's max_len %d (engine was "
                        "hot-swapped after admission)"
                        % (len(ticket.prompt), ticket.max_tokens,
                           limit)))
                    ticket.abandoned = True
                    continue
                batch.append(ticket)
        # page-pool backpressure: trim the batch to what the pool can
        # admit RIGHT NOW (conservative, sharing ignored); the tail goes
        # back to the queue head in order and joins at a later token
        # boundary, once sequences retire or pages free
        if batch and hasattr(self.engine, "admit_capacity"):
            fits = self.engine.admit_capacity(
                [len(t.prompt) + len(t.emitted) for t in batch])
            if fits < len(batch):
                with self._cond:
                    self._pending.extendleft(reversed(batch[fits:]))
                batch = batch[:fits]
        if not batch:
            return
        admit_t0 = time.monotonic()
        for ticket in batch:
            ticket.queue_ms = (admit_t0 - ticket.enqueued) * 1000.0
            if ticket.ctx is not None:
                TRACER.add("queue", "gen", ticket.ctx,
                           ticket.enqueued, admit_t0)
        try:
            self._dispatch_t0 = admit_t0
            try:
                with self._quantum(self._urgency_ms(batch)) as lease:
                    waited_s = getattr(lease, "waited_s", None)
                    td0 = time.monotonic()
                    # a preempted ticket re-prefills prompt + every
                    # token already emitted (recompute preemption) and
                    # resumes its sampling counter at ``generated``: the
                    # client's stream continues where it left off
                    rows = [np.concatenate(
                        [t.prompt, np.asarray(t.emitted, np.int32)])
                        if t.emitted else t.prompt for t in batch]
                    if getattr(self.engine, "supports_sampling", False):
                        sampling = []
                        for t in batch:
                            opts = dict(t.sampling or {})
                            opts["counter"] = t.generated
                            sampling.append(opts)
                        slots, first = self.engine.admit(rows, sampling)
                    else:
                        slots, first = self.engine.admit(rows)
            finally:
                self._dispatch_t0 = None
        except BaseException as e:  # noqa: BLE001 — per-batch trap
            self.metrics.observe_error()
            for ticket in batch:
                if not ticket.abandoned:
                    ticket.tokens.put(e)
            return
        t1 = time.monotonic()
        obs_profile.on_step()
        for ticket in batch:
            ticket.sched_ms += (waited_s or 0.0) * 1000.0
            ticket.device_ms += (t1 - td0) * 1000.0
            if ticket.ctx is not None:
                if waited_s is not None:  # scheduler attached
                    TRACER.add("sched_wait", "sched", ticket.ctx,
                               td0 - waited_s, td0)
                TRACER.add("prefill", "gen", ticket.ctx, td0, t1,
                           prompt=len(ticket.prompt))
        self.metrics.observe_prefill(len(batch))
        for ticket, slot, token in zip(batch, slots, first):
            ticket.slot = slot
            self._by_slot[slot] = ticket
            self._emit(slot, ticket, token)

    def _retire_expired(self) -> None:  # runs-on: dispatch
        """Token-boundary deadline sweep: an ACTIVE sequence whose
        client deadline passed retires now."""
        now = time.monotonic()
        for slot, ticket in list(self._by_slot.items()):
            if ticket.abandoned:
                continue  # _emit retires it at its next token
            if ticket.expired(now):
                self.metrics.observe_expired()
                ticket.tokens.put(DeadlineExceeded(
                    "deadline passed mid-generation"))
                ticket.abandoned = True
                self._retire(slot, ticket)

    def _decode_once(self) -> None:  # runs-on: dispatch
        t0 = time.monotonic()
        paged = hasattr(self.engine, "decode_many")
        try:
            self._dispatch_t0 = t0
            try:
                with self._quantum(
                        self._urgency_ms(self._by_slot.values())) \
                        as lease:
                    waited_s = getattr(lease, "waited_s", None)
                    td0 = time.monotonic()
                    if paged:
                        # page admission for this round (its copy-on-
                        # write copies are device work, so they run in
                        # the round's quantum); pool exhaustion PREEMPTS
                        # sequences: their tickets requeue at the head
                        # and re-prefill (prompt + emitted) once pages
                        # free. The preempted client just waits.
                        for slot in self.engine.prepare_step():
                            ticket = self._by_slot.pop(slot, None)
                            if ticket is None or ticket.abandoned:
                                continue
                            ticket.slot = None
                            with self._cond:
                                self._pending.appendleft(ticket)
                        if not self._by_slot:
                            return
                        toks2d, counts = self.engine.decode_many()
                    else:
                        nxt = self.engine.decode()
            finally:
                self._dispatch_t0 = None
        except BaseException as e:  # noqa: BLE001 — per-step trap
            self.metrics.observe_error()
            for slot, ticket in list(self._by_slot.items()):
                del self._by_slot[slot]
                self.engine.release(slot)
                if not ticket.abandoned:
                    ticket.tokens.put(e)
            return
        t1 = time.monotonic()
        obs_profile.on_step()
        active = list(self._by_slot.items())
        self.metrics.observe_decode(
            elapsed_s(t0),
            int(sum(int(counts[slot]) for slot, _ in active))
            if paged else len(active))
        for slot, ticket in active:
            ticket.sched_ms += (waited_s or 0.0) * 1000.0
            ticket.device_ms += (t1 - td0) * 1000.0
            if ticket.ctx is not None:
                if waited_s is not None:  # scheduler attached
                    TRACER.add("sched_wait", "sched", ticket.ctx,
                               td0 - waited_s, td0)
                TRACER.add("decode_step", "gen", ticket.ctx, td0, t1,
                           slot=slot)
        # per-slot finite-logits sentinel: a NaN'd sequence fails
        # ALONE — its ticket gets NonFiniteLogits and its slot frees
        finite = getattr(self.engine, "last_finite", None)
        for slot, ticket in active:
            if finite is not None and not bool(finite[slot]):
                self.metrics.observe_nonfinite()
                if not ticket.abandoned:
                    ticket.tokens.put(NonFiniteLogits(
                        "decode step produced non-finite logits for "
                        "this sequence (slot %d)" % slot))
                    ticket.abandoned = True
                self._retire(slot, ticket)
                continue
            if paged:
                # one paged round can commit several tokens per slot
                # (speculative acceptance); the slot may retire
                # mid-round (EOS / max_tokens): stop routing then
                for w in range(int(counts[slot])):
                    if slot not in self._by_slot:
                        break
                    self._emit(slot, ticket, toks2d[slot, w])
            else:
                self._emit(slot, ticket, nxt[slot])

    def _abort_in_flight(self) -> None:  # runs-on: dispatch
        """stop(drain=False) epilogue, on the dispatch thread: fail
        every pending and active ticket fast."""
        with self._cond:
            pending = list(self._pending)
            self._pending.clear()
        for ticket in pending:
            if not ticket.abandoned:
                ticket.tokens.put(Draining("batcher stopped"))
        for slot, ticket in list(self._by_slot.items()):
            del self._by_slot[slot]
            self.engine.release(slot)
            if not ticket.abandoned:
                ticket.tokens.put(Draining("batcher stopped"))

    def _dispatch_loop(self) -> None:  # runs-on: dispatch
        with log_context(model=self.name):
            while True:
                with self._cond:
                    while not self._pending and not self._by_slot:
                        if self._threads.stop_requested:
                            return
                        if self._next_engine is not None:
                            # idle: a queued hot-swap lands immediately
                            self.engine = self._next_engine
                            self._next_engine = None
                        self._cond.wait(0.05)
                if self._threads.stop_requested:
                    self._abort_in_flight()
                    return
                # token boundary: shed expired sequences, land a
                # pending hot-swap once the old engine drained, admit
                # joiners, then one decode step
                self._retire_expired()
                with self._cond:
                    if self._next_engine is not None and \
                            not self._by_slot:
                        self.engine = self._next_engine
                        self._next_engine = None
                    may_admit = self._next_engine is None and \
                        bool(self._pending)
                if may_admit and self.engine.free_slots:
                    self._admit()
                if self._by_slot:
                    self._decode_once()

    # -- lifecycle ---------------------------------------------------------
    def drain(self, timeout: float = 30.0) -> bool:
        """Refuse new work, finish active sequences; True when idle."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cond:
                # emptiness poll of dispatch-owned slot state: an
                # atomic bool(dict) peek; the loop re-checks
                if not self._pending and not self._by_slot:  # noqa: VC003
                    return True
            time.sleep(0.005)
        return False

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Drain (optionally), then stop and join. In-flight cleanup
        happens on the dispatch thread itself (it owns slot state), so
        a forced stop cannot race a decode step."""
        if drain:
            self.drain(timeout)
        with self._cond:
            self._draining = True
        self._threads.request_stop()
        with self._cond:
            self._cond.notify_all()
        leaked = self._threads.join_all()
        if leaked:
            raise RuntimeError("token batcher leaked threads: %s"
                               % [t.name for t in leaked])
