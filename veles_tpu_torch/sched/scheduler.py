"""Cooperative multi-tenant device scheduler (port of
``veles_tpu/sched/scheduler.py``).

Many tenants share one device: the trainers, the serving planes and
the unit-graph workflows time-slice it at their natural dispatch
boundaries, in the spirit of Gandiva (OSDI '18) and Salus (MLSys '20):
time-slicing at iteration boundaries gives high utilization with a
small switch cost, because the port already has cheap preemption
points:

- trainers yield at **dispatch-window edges**
  (``FusedClassifierTrainer.step_many`` /
  ``TransformerTrainer.step_many``, K steps a window);
- serving yields at **batch boundaries**
  (``MicroBatcher``/``TokenBatcher`` dispatch one batch / one decode
  step per quantum — the registry already hot-swaps between batches);
- unit-graph workflows yield **between unit runs**
  (:func:`attach_workflow`).

The contract is the :class:`DeviceLease` protocol: a tenant *acquires*
the pool, runs exactly ONE quantum (one dispatch window, one batch,
one evaluation), and *yields*. Leases are revocable only **between**
quanta — the scheduler never interrupts device work mid-flight — so
every tenant's trajectory is bit-identical to an unscheduled run: the
same dispatches issue in the same per-tenant order, only their
interleaving across tenants changes, and the device executes each
tenant's stream exactly as it would alone.

**The one change for the card.** On a TPU the reference's quantum ends
when its dispatch returns. A CUDA launch or a graph replay returns
before the device has done the work, so a released tenant's backlog
would sit on the card in front of the next tenant's quantum, and the
weights, the deadline boost and the accounting would measure host
enqueue time. Here the outermost quantum's exit records a CUDA event
on the thread's current stream and waits for it before it releases the
pool: a lease covers host time plus device time, and the next tenant's
work never queues behind it. A quantum whose body already ended in a
device-to-host read (the batchers read their tokens and rows back)
finds the event done. Without CUDA initialized (CPU tenants) the wait
is a no-op.

Scheduling policy (per :meth:`Scheduler._pick`):

1. **deadline boost** — a waiter whose queue wait exceeded its
   ``deadline_ms`` outranks everything (earliest overrun first);
2. **priority classes with starvation aging** — higher ``priority``
   wins; a waiter gains one effective priority step per ``aging_ms``
   waited, so a low-priority tenant's queue wait is bounded by
   ``aging_ms x (priority gap)`` rather than unbounded;
3. **weighted fair queuing** within a class — start-time fair
   queuing (SFQ): each quantum gets a virtual *start tag*
   ``max(vclock, tenant's last finish tag)`` and a *finish tag*
   ``start + held_seconds / weight``; the pool goes to the minimum
   start tag, and the global virtual clock advances to the granted
   start. A backlogged weight-8 tenant's tags advance 8x slower than
   a weight-1 peer's, so it wins ~8 of every 9 grants; an idle
   tenant re-arrives at the current vclock, so sleeping never banks
   credit;
4. FIFO arrival order as the final tie-break.

Cooperative loops re-request the pool microseconds after releasing
it, which opens a handoff race: the sole *parked* waiter would
self-grant before the better-ranked just-released tenant re-enqueues,
collapsing every weight ratio to 1:1 alternation. The fix is a
bounded **handoff grace** (``handoff_grace_ms``): a would-be grantee
holds off while the last holder — not yet re-enqueued — would outrank
it, until the pool has sat free for the grace window. Deadline-overrun
waiters are exempt (tail latency beats fairness), and a tenant that
really left costs at most one grace window of idleness.

Accounting is first-class: per tenant quanta, device-ms (lease-held
wall time, which on the card includes the quantum's device work),
queue-wait p50/p99, preemption count (a tenant that wanted to continue
but lost the pool to another tenant), achieved share. ``snapshot()``
is the JSON surface (the serve ``/metrics`` endpoint renders it);
``prometheus_text()`` is the text exposition of the same numbers.

Thread model: the scheduler is passive — there is no scheduler thread.
Arbitration happens inside :meth:`TenantHandle.quantum` under one
condition variable; tenant admission/teardown ties into the
:class:`~veles_tpu_torch.thread_pool.ManagedThreads` lifecycle (register
a tenant with its owner's ManagedThreads and ``Scheduler.stop()`` /
``unregister`` request-stops them; a stopping scheduler wakes every
waiter with :class:`SchedulerStopped` instead of leaving it parked).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from veles_tpu_torch.thread_pool import ManagedThreads

#: queue-wait reservoir size per tenant (p50/p99 window)
WAIT_WINDOW = 2048


def quantum_or_null(tenant: Optional["TenantHandle"],
                    deadline_ms: Optional[float] = None):
    """One scheduler quantum when ``tenant`` is set; a no-op context
    otherwise — the shared guard every dispatch site (trainers,
    batchers, GA evaluations) wraps its device work in.
    ``deadline_ms`` is the per-acquire deadline handoff: a serve
    batch carrying an imminent client deadline passes its remaining
    budget here, overriding the tenant-level ``deadline_ms`` for
    this one acquire (see :meth:`TenantHandle.quantum`)."""
    return nullcontext() if tenant is None else \
        tenant.quantum(deadline_ms=deadline_ms)


class SchedulerStopped(RuntimeError):
    """The scheduler is stopping; no more quanta will be granted."""


class DeviceLease:
    """One granted quantum: the right to issue device work until
    :meth:`TenantHandle.quantum` exits. Revocation only ever happens
    between quanta (the scheduler simply grants the next quantum to
    someone else), so holding a lease means the pool is yours for the
    whole quantum."""

    __slots__ = ("tenant", "acquired_at", "waited_s")

    def __init__(self, tenant: "TenantHandle", acquired_at: float,
                 waited_s: float) -> None:
        self.tenant = tenant
        self.acquired_at = acquired_at
        self.waited_s = waited_s

    @property
    def held_ms(self) -> float:
        return (time.monotonic() - self.acquired_at) * 1000.0

    def __repr__(self) -> str:
        return "<DeviceLease %s held %.2fms>" % (self.tenant.name,
                                                 self.held_ms)


class _Waiter:
    """One pending acquire. Wait state is PER-ACQUIRE, not
    per-tenant: parallel graph branches share one TenantHandle
    (``attach_workflow`` marks every device unit with the same
    handle), so two threads may acquire the same tenant concurrently
    — each gets its own record, served FIFO within the tenant."""

    __slots__ = ("enqueued", "arrival", "vclock0", "deadline_ms")

    def __init__(self, enqueued: float, arrival: int,
                 vclock0: float,
                 deadline_ms: Optional[float] = None) -> None:
        self.enqueued = enqueued
        self.arrival = arrival
        #: virtual clock at enqueue: this acquire's SFQ start tag is
        #: max(tenant finish, vclock0) — waiting must not inflate it
        self.vclock0 = vclock0
        #: per-acquire deadline override (the serve plane hands the
        #: most-urgent co-batched client budget down here); None
        #: falls back to the tenant-level deadline_ms
        self.deadline_ms = deadline_ms


class _Quantum:
    """Context manager for one lease cycle (acquire -> run -> yield)."""

    __slots__ = ("_scheduler", "_tenant", "_lease", "_deadline_ms")

    def __init__(self, scheduler: "Scheduler", tenant: "TenantHandle",
                 deadline_ms: Optional[float] = None) -> None:
        self._scheduler = scheduler
        self._tenant = tenant
        self._lease: Optional[DeviceLease] = None
        self._deadline_ms = deadline_ms

    def __enter__(self) -> DeviceLease:
        self._lease = self._scheduler._acquire(
            self._tenant, deadline_ms=self._deadline_ms)
        return self._lease

    def __exit__(self, *exc) -> None:
        try:
            if self._scheduler._outermost(self._tenant):
                _wait_for_device()
        finally:
            self._scheduler._release(self._tenant)
        return None


def _wait_for_device() -> None:
    """Block until the work this thread queued on its current CUDA
    stream is done (an event recorded there, then synchronized); a
    no-op while CUDA is not initialized (CPU-only tenants). A quantum
    that already ended in a device-to-host read finds the event done
    and returns at once."""
    if not torch.cuda.is_initialized():
        return
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream())
    done.synchronize()


class TenantHandle:
    """One admitted tenant: identity, scheduling knobs, accounting.

    Knobs (mutable between quanta):

    - ``weight`` — WFQ share within a priority class (a weight-8
      tenant gets ~8x the device time of a weight-1 peer when both
      are backlogged);
    - ``priority`` — strict class; higher runs first, subject to
      aging;
    - ``deadline_ms`` — queue-wait bound; once exceeded the waiter
      outranks every class (latency-critical serve tenants set this).
    """

    def __init__(self, scheduler: "Scheduler", name: str, *,
                 weight: float = 1.0, priority: int = 0,
                 deadline_ms: Optional[float] = None,
                 threads: Optional[ManagedThreads] = None) -> None:
        if weight <= 0:
            raise ValueError("weight must be > 0, got %r" % (weight,))
        self.scheduler = scheduler
        self.name = name
        self.weight = float(weight)
        self.priority = int(priority)
        self.deadline_ms = deadline_ms
        self.threads = threads
        # -- accounting (mutated only under the scheduler lock) --
        self.quanta = 0
        self.device_ms = 0.0
        self.preemptions = 0
        self.waits_total = 0
        self._waits: deque = deque(maxlen=WAIT_WINDOW)  # seconds
        # -- SFQ tags (virtual seconds; device seconds / weight) --
        self._start = 0.0          # start tag of the granted quantum
        self._finish = 0.0         # finish tag of the last quantum
        self._waiters: deque = deque()  # pending acquires, FIFO
        self._removed = False

    def quantum(self, deadline_ms: Optional[float] = None) -> _Quantum:
        """``with tenant.quantum() as lease:`` — one acquire → run →
        yield cycle. The body is the quantum; keep it ONE natural unit
        of device work (a dispatch window, a batch, an evaluation) and
        do not host-sync inside it for no reason. On a CUDA device the
        quantum's exit waits for its device work before it releases the
        pool (module docstring).

        ``deadline_ms`` overrides the tenant-level deadline for THIS
        acquire — the deadline handoff: a serve batch whose most
        urgent co-batched client has N ms of budget left competes as
        a deadline-N waiter, so imminent client deadlines get the
        boost even when the tenant's static deadline is looser (or
        unset)."""
        return _Quantum(self.scheduler, self, deadline_ms=deadline_ms)

    # -- reading (lock-free approximations are fine for gauges) -----------
    @property
    def waiting(self) -> bool:
        return bool(self._waiters)

    def wait_percentiles(self) -> Dict[str, float]:
        if not self._waits:
            return {"p50": 0.0, "p99": 0.0}
        ms = np.asarray(self._waits) * 1000.0
        p50, p99 = np.percentile(ms, (50, 99))
        return {"p50": float(p50), "p99": float(p99)}

    def __repr__(self) -> str:
        return "<TenantHandle %s w=%g prio=%d quanta=%d>" % (
            self.name, self.weight, self.priority, self.quanta)


class Scheduler:
    """Cooperative WFQ arbiter over one device pool.

    >>> sched = Scheduler()
    >>> train = sched.register("train", weight=1)
    >>> serve = sched.register("serve", weight=4, deadline_ms=50)
    >>> with train.quantum():
    ...     trainer.step_many(window)       # one dispatch window
    >>> sched.stop()
    """

    def __init__(self, name: str = "sched",
                 aging_ms: float = 250.0,
                 handoff_grace_ms: float = 1.0) -> None:
        if aging_ms <= 0:
            raise ValueError(
                "aging_ms must be > 0 (it divides queue waits), "
                "got %r" % (aging_ms,))
        if handoff_grace_ms < 0:
            raise ValueError("handoff_grace_ms must be >= 0, got %r"
                             % (handoff_grace_ms,))
        self.name = name
        #: one effective-priority step gained per this many ms waited
        #: (bounds a low-priority tenant's queue wait to
        #: aging_ms x priority-gap instead of "forever")
        self.aging_ms = float(aging_ms)
        #: how long a would-be grantee defers to the better-ranked
        #: just-released holder before taking the free pool anyway
        #: (see the module docstring's handoff-race note); the cost
        #: of a tenant that never returns is one grace window
        self.handoff_grace_ms = float(handoff_grace_ms)
        self._cond = threading.Condition()
        self._tenants: Dict[str, TenantHandle] = {}  # guarded-by: _cond
        self._current: Optional[TenantHandle] = None  # guarded-by: _cond
        self._depth = 0          # reentrant holder quanta; guarded-by: _cond
        self._holder_thread: Optional[
            threading.Thread] = None                 # guarded-by: _cond
        self._last_holder: Optional[
            TenantHandle] = None                     # guarded-by: _cond
        self._grant_t0 = 0.0                         # guarded-by: _cond
        self._pool_free_since = time.monotonic()     # guarded-by: _cond
        #: virtual clock = max granted start tag
        self._vclock = 0.0                           # guarded-by: _cond
        self._arrivals = 0    # FIFO tie-break source; guarded-by: _cond
        self._stopped = False                        # guarded-by: _cond
        self._started = time.monotonic()

    # -- admission / teardown ----------------------------------------------
    def register(self, name: str, *, weight: float = 1.0,
                 priority: int = 0,
                 deadline_ms: Optional[float] = None,
                 threads: Optional[ManagedThreads] = None
                 ) -> TenantHandle:
        """Admit a tenant. ``threads`` ties its lifecycle to the
        owner's ManagedThreads: :meth:`stop` / :meth:`unregister`
        request-stop them so a torn-down tenant's loops exit instead
        of parking forever on the next quantum."""
        with self._cond:
            if self._stopped:
                raise SchedulerStopped(
                    "%s is stopped; refusing tenant %r" %
                    (self.name, name))
            if name in self._tenants:
                raise ValueError("tenant %r already registered" % name)
            tenant = TenantHandle(self, name, weight=weight,
                                  priority=priority,
                                  deadline_ms=deadline_ms,
                                  threads=threads)
            # start-time fairness: arrive at the current virtual clock,
            # not at 0 (a newcomer must not replay the past)
            tenant._finish = self._vclock
            self._tenants[name] = tenant
            return tenant

    def unregister(self, name: str, stop_threads: bool = True) -> None:
        """Tear a tenant down: it takes no further quanta; its pending
        acquire (if any) raises :class:`SchedulerStopped`; its
        ManagedThreads get a stop request (the owner joins them)."""
        with self._cond:
            tenant = self._tenants.pop(name, None)
            if tenant is None:
                raise KeyError(name)
            tenant._removed = True
            self._cond.notify_all()
        if stop_threads and tenant.threads is not None:
            tenant.threads.request_stop()

    def tenants(self) -> List[str]:
        with self._cond:
            return list(self._tenants)

    @property
    def stopped(self) -> bool:
        # lock-free bool gauge: monotonic False->True flip, and every
        # decision taken on it is re-checked under the lock in
        # _acquire — a stale read costs one extra park/wake round
        return self._stopped  # noqa: VC002

    def stop(self) -> None:
        """Stop granting: every parked and future acquire raises
        :class:`SchedulerStopped`; every tenant's ManagedThreads get a
        stop request (owners join them — the loud-leak discipline)."""
        with self._cond:
            self._stopped = True
            tenants = list(self._tenants.values())
            self._cond.notify_all()
        for tenant in tenants:
            if tenant.threads is not None:
                tenant.threads.request_stop()

    # -- arbitration -------------------------------------------------------
    def _rank(self, tenant: TenantHandle, now: float):  # holds: _cond
        """Sort key for :meth:`_pick` over the tenant's OLDEST
        pending acquire — smaller wins."""
        head = tenant._waiters[0]
        waited_ms = (now - head.enqueued) * 1000.0
        deadline_ms = head.deadline_ms if head.deadline_ms is not None \
            else tenant.deadline_ms
        overrun = (deadline_ms is not None and
                   waited_ms >= deadline_ms)
        if overrun:
            # rank deadline-overrun waiters by how long past the
            # deadline they are (earliest overrun == most overdue)
            return (0, -(waited_ms - deadline_ms), 0.0, 0)
        aged = tenant.priority + int(waited_ms / self.aging_ms)
        # SFQ start tag: resume from this tenant's own finish tag or
        # the virtual clock at enqueue, whichever is later (an idle
        # tenant re-arrives at its enqueue-time NOW; sleeping banks
        # no credit, and waiting never inflates the tag)
        start = max(tenant._finish, head.vclock0)
        return (1, -aged, start, head.arrival)

    def _pick(self, now: float) -> Optional[TenantHandle]:  # holds: _cond
        waiters = [t for t in self._tenants.values() if t._waiters]
        if not waiters:
            return None
        return min(waiters, key=lambda t: self._rank(t, now))

    def _handoff_pending(self, tenant: TenantHandle,  # holds: _cond
                         now: float) -> bool:
        """True while ``tenant`` (the best-ranked *waiter*) should
        hold off because the just-released holder — which has not
        re-enqueued yet — would outrank it if it came straight back
        (the cooperative-loop handoff race; module docstring)."""
        if (now - self._pool_free_since) * 1000.0 >= \
                self.handoff_grace_ms:
            return False  # grace spent: take the free pool
        last = self._last_holder
        if (last is None or last is tenant or last._removed or
                last._waiters or
                last.name not in self._tenants):
            return False
        head = tenant._waiters[0]
        waited_ms = (now - head.enqueued) * 1000.0
        deadline_ms = head.deadline_ms if head.deadline_ms is not None \
            else tenant.deadline_ms
        if deadline_ms is not None and waited_ms >= deadline_ms:
            return False  # tail latency beats fairness
        # the phantom's rank if it re-arrived right now (waited 0)
        start = max(self._vclock, last._finish)
        phantom = (1, -last.priority, start, self._arrivals + 1)
        return phantom < self._rank(tenant, now)

    def _acquire(self, tenant: TenantHandle,
                 deadline_ms: Optional[float] = None) -> DeviceLease:
        with self._cond:
            if self._stopped or tenant._removed:
                raise SchedulerStopped(
                    "scheduler %s stopped (tenant %s)" %
                    (self.name, tenant.name))
            if self._current is tenant and \
                    self._holder_thread is threading.current_thread():
                # reentrant: a unit-level quantum may wrap a trainer-
                # level one of the SAME tenant (graph path over a
                # tenant-attached trainer) — nesting must not deadlock
                self._depth += 1
                return DeviceLease(tenant, self._grant_t0, 0.0)
            now = time.monotonic()
            self._arrivals += 1
            me = _Waiter(now, self._arrivals, self._vclock,
                         deadline_ms=deadline_ms)
            tenant._waiters.append(me)
            # wake parked waiters deferring to a phantom: a real
            # arrival re-ranks the contest immediately
            self._cond.notify_all()
            try:
                while True:
                    if self._stopped or tenant._removed:
                        raise SchedulerStopped(
                            "scheduler %s stopped while %s waited" %
                            (self.name, tenant.name))
                    now = time.monotonic()
                    # grant order: the pool is free, this TENANT is
                    # the best-ranked waiter, and within the tenant
                    # this acquire is the oldest (FIFO — concurrent
                    # acquires through one shared handle serialize)
                    if self._current is None and \
                            tenant._waiters[0] is me and \
                            self._pick(now) is tenant and \
                            not self._handoff_pending(tenant, now):
                        break
                    if self._current is None:
                        # pool free but this waiter is not (yet) the
                        # grantee: bounded wait so aging/deadline
                        # promotions and the handoff grace expiring
                        # take effect with no release/notify between
                        self._cond.wait(0.0002)
                    else:
                        # pool held: no promotion can produce a grant
                        # before the release, and _release / stop /
                        # unregister / new arrivals all notify_all —
                        # an untimed wait burns no wakeups
                        self._cond.wait()
            except BaseException:
                tenant._waiters.remove(me)
                self._cond.notify_all()
                raise
            tenant._waiters.popleft()
            waited = now - me.enqueued
            tenant.waits_total += 1
            tenant._waits.append(waited)
            # preemption accounting: the last holder wanted to
            # continue (it is parked in the waiter set right now) but
            # the pool went to someone else between its quanta
            last = self._last_holder
            if (last is not None and last is not tenant and
                    last._waiters):
                last.preemptions += 1
            self._current = tenant
            self._holder_thread = threading.current_thread()
            self._grant_t0 = now
            tenant._start = max(tenant._finish, me.vclock0)
            # the virtual clock is the latest granted start tag, so a
            # tenant arriving mid-backlog starts *here*, not in the past
            self._vclock = max(self._vclock, tenant._start)
            return DeviceLease(tenant, now, waited)

    def _outermost(self, tenant: TenantHandle) -> bool:
        """True when ``tenant`` holds the pool on this thread with no
        nested quantum open: the exit that will release it."""
        with self._cond:
            return (self._current is tenant and self._depth == 0 and
                    self._holder_thread is threading.current_thread())

    def _release(self, tenant: TenantHandle) -> None:
        with self._cond:
            if self._current is not tenant:
                return  # stop() raced the quantum body
            if self._depth > 0:
                self._depth -= 1  # close a nested quantum only
                return
            now = time.monotonic()
            held = now - self._grant_t0
            tenant.quanta += 1
            tenant.device_ms += held * 1000.0
            tenant._finish = tenant._start + held / tenant.weight
            self._current = None
            self._holder_thread = None
            self._last_holder = tenant
            self._pool_free_since = now
            self._cond.notify_all()

    # -- observability -----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON surface: per-tenant accounting + pool totals (what
        ``web_status.py`` renders as the tenant table and the serve
        ``/metrics`` endpoint embeds under ``_scheduler``)."""
        now = time.monotonic()
        with self._cond:
            tenants = {}
            total_ms = sum(t.device_ms
                           for t in self._tenants.values()) or 1.0
            weight_sum = sum(t.weight
                             for t in self._tenants.values()) or 1.0
            for t in self._tenants.values():
                tenants[t.name] = {
                    "weight": t.weight,
                    "priority": t.priority,
                    "deadline_ms": t.deadline_ms,
                    "quanta": t.quanta,
                    "device_ms": round(t.device_ms, 3),
                    "share": round(t.device_ms / total_ms, 4),
                    "weighted_share": round(t.weight / weight_sum, 4),
                    "queue_wait_ms": t.wait_percentiles(),
                    "preemptions": t.preemptions,
                    "waiting": t.waiting,
                    "holding": t is self._current,
                }
            return {
                "name": self.name,
                "aging_ms": self.aging_ms,
                "tenants": tenants,
                "total_device_ms": round(
                    sum(t.device_ms for t in self._tenants.values()),
                    3),
                "uptime_s": now - self._started,
                "stopped": self._stopped,
            }

    def prometheus_text(self) -> str:
        """Prometheus text exposition of :meth:`snapshot` (tenant
        label per series) — rendered by THE one renderer
        (veles_tpu_torch.obs.metrics); the snapshot keys are the contract,
        the text is derived."""
        from veles_tpu_torch.obs import metrics as obs_metrics
        return obs_metrics.render(
            obs_metrics.sched_samples(self.snapshot()))


def attach_workflow(workflow, tenant: TenantHandle,
                    view_groups: Optional[tuple] = None) -> List[Any]:
    """Register a unit-graph workflow as a scheduler tenant: every
    device-work unit takes ONE quantum per ``run()`` — the graph
    path's natural boundary, exactly where the coordinator already
    fences job application. By default every
    :class:`~veles_tpu.accelerated_units.AcceleratedUnit` (forwards,
    gradient units, evaluators) plus the ``TRAINER``/``EVALUATOR``
    view groups is attached; pass explicit ``view_groups`` to select
    by group instead. Host-side units (loaders, plotters, decisions)
    run unscheduled.

    The marker attribute is ``sched_tenant_`` (trailing underscore:
    dropped from pickles by the Pickleable discipline — a snapshot
    must not capture a live scheduler). Returns the attached units.
    """
    from veles_tpu_torch.accelerated_units import AcceleratedUnit
    attached = []
    for unit in workflow.units:
        if view_groups is not None:
            device_work = getattr(unit, "view_group",
                                  None) in view_groups
        else:
            device_work = (isinstance(unit, AcceleratedUnit) or
                           getattr(unit, "view_group", None) in
                           ("TRAINER", "EVALUATOR"))
        if device_work:
            unit.sched_tenant_ = tenant
            attached.append(unit)
    # The workflow-level marker is a DIFFERENT attribute on purpose:
    # Workflow is itself a Unit, and a NESTED workflow (ensemble
    # member, genetics inner training) executes through the same
    # unit wrapper that honors `sched_tenant_` — marking the
    # workflow object with it would wrap the whole inner graph in
    # ONE outer quantum, turning every inner unit's quantum into a
    # reentrant no-op (an unbounded hold). `sched_pool_tenant_` is
    # observability-only (launcher status doc).
    workflow.sched_pool_tenant_ = tenant
    return attached


def detach_workflow(workflow) -> None:
    """Remove the tenancy markers :func:`attach_workflow` set."""
    for unit in workflow.units:
        if getattr(unit, "sched_tenant_", None) is not None:
            unit.sched_tenant_ = None
    workflow.sched_pool_tenant_ = None
