"""Continuous batching over the generative decode plane.

Port of the generative half of ``veles_tpu/serve/batcher.py``: the
admission exceptions, :class:`GenMetrics`, the sampling validation and
:class:`TokenBatcher` (Orca-style continuous batching: decode steps
run back to back, queued requests join at token boundaries, finished
sequences retire mid-flight) over either decode plane. Over the paged
engine it also trims each admission to what the page pool holds,
requeues preempted tickets at the queue head (they re-prefill prompt
+ emitted tokens and resume their sampling counter), and routes the
several tokens a speculative round commits per slot. Left out until
their slices: scheduler tenancy (one quantum per prefill/decode) and
the profiler's per-step hook.

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
from typing import Any, Dict, List, Optional

import numpy as np

from veles_tpu_torch.logger import log_context
from veles_tpu_torch.obs.trace import (EXEMPLARS, TRACER, TraceContext,
                                       elapsed_s)
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


class NonFiniteLogits(RuntimeError):
    """The sequence's decode step produced non-finite logits; only
    this ticket fails — its slot is freed at the token boundary."""


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
                 "queue_ms", "device_ms", "sampling", "emitted")

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
    """

    def __init__(self, engine, *, max_queue: int = 64,
                 name: str = "generate") -> None:
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
        self._threads = ManagedThreads(name="%s-batcher" % name)
        self._threads.spawn(self._dispatch_loop, name="dispatch")

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
        sampling = _validate_sampling(
            self.engine, temperature=temperature, top_k=top_k,
            top_p=top_p, seed=seed, draft=draft)
        # advisory pre-check against the CURRENT engine; _admit
        # re-validates on the dispatch thread before prefill
        limit = getattr(self.engine, "max_len", None)
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
            queue_ms=ticket.queue_ms, device_ms=ticket.device_ms)

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
                # a preempted ticket re-prefills prompt + every token
                # already emitted (recompute preemption) and resumes
                # its sampling counter at ``generated``: the client's
                # stream continues where it left off
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
        for ticket in batch:
            ticket.device_ms += (t1 - admit_t0) * 1000.0
            if ticket.ctx is not None:
                TRACER.add("prefill", "gen", ticket.ctx, admit_t0, t1,
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
                if paged:
                    # page admission for this round; pool exhaustion
                    # PREEMPTS sequences: their tickets requeue at the
                    # head and re-prefill (prompt + emitted) once pages
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
        active = list(self._by_slot.items())
        self.metrics.observe_decode(
            elapsed_s(t0),
            int(sum(int(counts[slot]) for slot, _ in active))
            if paged else len(active))
        for slot, ticket in active:
            ticket.device_ms += (t1 - t0) * 1000.0
            if ticket.ctx is not None:
                TRACER.add("decode_step", "gen", ticket.ctx, t0, t1,
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
                if not self._pending and not self._by_slot:
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
