"""Port parity of the multi-tenant device scheduler
(``veles_tpu_torch.sched`` against ``veles_tpu.sched``), on the CPU.

The reference's own scheduler cases that need no CLI, genetics or
status page run on both packages (``pkg``; the timing ones, which keep
cores busy, on the port only): WFQ shares, the deadline
boost, starvation aging, the lifecycle (stop, unregister, ManagedThreads
tie-in), reentrancy, concurrent acquires through one handle, the
accounting surfaces and ``attach_workflow``. Two parity tests then hold
the port's decisions to the reference's exactly: a table of waiter
states under a frozen clock gives the same ``_pick`` choice, and one
scripted sequence of quanta under a stepping clock gives the same
``snapshot()`` counters. Timing tests keep the reference's generous
bounds (they measure host wall time on a shared CPU).
"""

import threading
import time
import types

import numpy as np
import pytest

import veles_tpu.sched.scheduler as ref_sched
import veles_tpu_torch.sched.scheduler as port_sched
from veles_tpu.thread_pool import ManagedThreads as RefManagedThreads
from veles_tpu.units import TrivialUnit as RefTrivialUnit
from veles_tpu.workflow import Workflow as RefWorkflow
from veles_tpu_torch.thread_pool import ManagedThreads
from veles_tpu_torch.units import TrivialUnit
from veles_tpu_torch.workflow import Workflow

PACKAGES = {
    "reference": types.SimpleNamespace(
        sched=ref_sched, ManagedThreads=RefManagedThreads,
        TrivialUnit=RefTrivialUnit, Workflow=RefWorkflow),
    "port": types.SimpleNamespace(
        sched=port_sched, ManagedThreads=ManagedThreads,
        TrivialUnit=TrivialUnit, Workflow=Workflow),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture
def port():
    """The port alone, for the timing tests: they keep cores busy for
    a second or so, and ``tests/test_sched.py`` runs them on the
    reference already (its decisions are held to the port's exactly by
    the parity tests below)."""
    return PACKAGES["port"]


def _spin(pkg, tenant, work_s, stop, count):
    """Saturating tenant loop: one fixed-length quantum per cycle."""
    while not stop.is_set():
        try:
            with tenant.quantum():
                time.sleep(work_s)
        except pkg.sched.SchedulerStopped:
            return
        count[tenant.name] = count.get(tenant.name, 0) + 1


def _run_tenants(pkg, tenants, work_s=0.001, seconds=0.6):
    stop = threading.Event()
    count: dict = {}
    threads = [threading.Thread(target=_spin,
                                args=(pkg, t, work_s, stop, count))
               for t in tenants]
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join()
    return count


def _park(pkg, tenant, enqueued, arrival, vclock0=0.0, deadline_ms=None):
    """Install one synthetic pending acquire."""
    tenant._waiters.clear()
    tenant._waiters.append(pkg.sched._Waiter(enqueued, arrival, vclock0,
                                             deadline_ms=deadline_ms))


# -- basic protocol ---------------------------------------------------------

def test_single_tenant_free_runs(pkg):
    sched = pkg.sched.Scheduler()
    t = sched.register("solo")
    for _ in range(5):
        with t.quantum() as lease:
            assert lease.tenant is t
    snap = sched.snapshot()
    assert snap["tenants"]["solo"]["quanta"] == 5
    assert not snap["tenants"]["solo"]["waiting"]
    sched.stop()


def test_nested_quantum_same_tenant_does_not_deadlock(pkg):
    sched = pkg.sched.Scheduler()
    t = sched.register("t")
    with t.quantum():
        with t.quantum():
            pass
        # inner exit must not release the outer lease
        assert sched.snapshot()["tenants"]["t"]["holding"]
    assert t.quanta == 1  # one OUTER quantum accounted
    sched.stop()


def test_register_validates(pkg):
    sched = pkg.sched.Scheduler()
    sched.register("a")
    with pytest.raises(ValueError):
        sched.register("a")
    with pytest.raises(ValueError):
        sched.register("b", weight=0)
    sched.stop()
    with pytest.raises(pkg.sched.SchedulerStopped):
        sched.register("late")
    with pytest.raises(ValueError):
        pkg.sched.Scheduler(aging_ms=0)
    with pytest.raises(ValueError):
        pkg.sched.Scheduler(handoff_grace_ms=-1)


def test_concurrent_acquires_through_one_shared_handle(port):
    pkg = port
    """Several threads acquire one TenantHandle (parallel graph
    branches of an attached workflow): none is lost or parked."""
    sched = pkg.sched.Scheduler()
    shared = sched.register("wf", weight=1)
    other = sched.register("other", weight=1)
    per_thread, n_threads = 25, 3
    done, errors = [], []

    def branch(idx):
        try:
            for _ in range(per_thread):
                with shared.quantum():
                    time.sleep(0.0002)
            done.append(idx)
        except BaseException as e:  # noqa: BLE001 — report, not hang
            errors.append(repr(e))

    stop = threading.Event()
    contender = threading.Thread(
        target=_spin, args=(pkg, other, 0.0002, stop, {}))
    threads = [threading.Thread(target=branch, args=(i,))
               for i in range(n_threads)]
    contender.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    contender.join(timeout=10)
    snap = sched.snapshot()
    sched.stop()
    assert not errors, errors
    assert sorted(done) == list(range(n_threads))
    assert snap["tenants"]["wf"]["quanta"] == per_thread * n_threads
    assert not snap["tenants"]["wf"]["waiting"]


# -- lifecycle --------------------------------------------------------------

def test_stop_wakes_parked_waiter(pkg):
    sched = pkg.sched.Scheduler()
    holder = sched.register("holder")
    waiter = sched.register("waiter")
    raised = threading.Event()

    def wait_forever():
        try:
            with waiter.quantum():
                pass
        except pkg.sched.SchedulerStopped:
            raised.set()

    with holder.quantum():
        th = threading.Thread(target=wait_forever)
        th.start()
        deadline = time.monotonic() + 2.0
        while not waiter.waiting and time.monotonic() < deadline:
            time.sleep(0.001)
        sched.stop()
        th.join(timeout=2.0)
    assert raised.is_set()
    assert not th.is_alive()
    with pytest.raises(pkg.sched.SchedulerStopped):
        with holder.quantum():
            pass


def test_unregister_ejects_tenant(pkg):
    sched = pkg.sched.Scheduler()
    a = sched.register("a")
    sched.register("b")
    sched.unregister("a")
    assert sched.tenants() == ["b"]
    with pytest.raises(pkg.sched.SchedulerStopped):
        with a.quantum():
            pass
    with pytest.raises(KeyError):
        sched.unregister("a")
    sched.stop()


def test_stop_requests_tenant_managed_threads(pkg):
    mt = pkg.ManagedThreads(name="tenant-loops")
    sched = pkg.sched.Scheduler()
    sched.register("t", threads=mt)
    assert not mt.stop_requested
    sched.stop()
    assert mt.stop_requested


# -- policy: WFQ / deadline / aging ----------------------------------------

def test_wfq_weights_translate_to_device_share(port):
    pkg = port
    sched = pkg.sched.Scheduler()
    lo = sched.register("lo", weight=1)
    hi = sched.register("hi", weight=4)
    _run_tenants(pkg, (lo, hi), work_s=0.001, seconds=0.8)
    snap = sched.snapshot()
    sched.stop()
    lo_ms = snap["tenants"]["lo"]["device_ms"]
    hi_ms = snap["tenants"]["hi"]["device_ms"]
    assert lo_ms > 0 and hi_ms > 0
    ratio = hi_ms / lo_ms
    assert 2.0 < ratio < 8.0, \
        "weight 1:4 split gave device-ms ratio %.2f" % ratio


def test_deadline_overrun_outranks_everything(pkg):
    sched = pkg.sched.Scheduler()
    vip = sched.register("vip", weight=8, priority=5)
    dl = sched.register("dl", weight=1, deadline_ms=5.0)
    now = time.monotonic()
    with sched._cond:
        _park(pkg, vip, now - 0.001, 1)
        dl._finish = 99.0
        _park(pkg, dl, now - 0.010, 2)
        assert sched._pick(now) is dl
        _park(pkg, dl, now - 0.001, 2)
        assert sched._pick(now) is vip
        vip._waiters.clear()
        dl._waiters.clear()
    sched.stop()


def test_priority_aging_promotes_long_waiter(pkg):
    sched = pkg.sched.Scheduler(aging_ms=10.0)
    low = sched.register("low", priority=0)
    high = sched.register("high", priority=3)
    now = time.monotonic()
    with sched._cond:
        _park(pkg, high, now - 0.001, 1)
        _park(pkg, low, now - 0.001, 2)
        assert sched._pick(now) is high
        _park(pkg, low, now - 0.045, 2)    # 45 ms / 10 ms = +4 steps
        assert sched._pick(now) is low
        low._waiters.clear()
        high._waiters.clear()
    sched.stop()


def test_per_acquire_deadline_handoff_overrides_tenant_deadline(pkg):
    sched = pkg.sched.Scheduler()
    vip = sched.register("vip", weight=8, priority=5)
    serve = sched.register("serve", weight=1)   # no tenant deadline
    now = time.monotonic()
    with sched._cond:
        _park(pkg, vip, now - 0.001, 1)
        serve._finish = 99.0
        _park(pkg, serve, now - 0.010, 2, deadline_ms=5.0)
        assert sched._pick(now) is serve
        _park(pkg, serve, now - 0.010, 2)
        assert sched._pick(now) is vip
        _park(pkg, serve, now - 0.010, 2, deadline_ms=500.0)
        assert sched._pick(now) is vip
        vip._waiters.clear()
        serve._waiters.clear()
    sched.stop()


def test_starvation_weight_1_behind_weight_8_still_progresses(port):
    pkg = port
    sched = pkg.sched.Scheduler(aging_ms=50.0)
    lo = sched.register("lo", weight=1)
    hi = sched.register("hi", weight=8)
    count = _run_tenants(pkg, (lo, hi), work_s=0.002, seconds=1.0)
    snap = sched.snapshot()
    sched.stop()
    assert count.get("hi", 0) > count.get("lo", 0)
    assert count.get("lo", 0) >= 10, count
    p99 = snap["tenants"]["lo"]["queue_wait_ms"]["p99"]
    assert p99 < 250.0, "weight-1 p99 queue wait %.1f ms" % p99


def test_preemption_accounting_counts_losses(port):
    pkg = port
    sched = pkg.sched.Scheduler()
    a = sched.register("a", weight=1)
    b = sched.register("b", weight=1)
    count = _run_tenants(pkg, (a, b), work_s=0.001, seconds=0.4)
    snap = sched.snapshot()
    sched.stop()
    assert count.get("a", 0) > 0 and count.get("b", 0) > 0
    assert sum(t["preemptions"] for t in snap["tenants"].values()) > 0


# -- accounting surfaces ----------------------------------------------------

def test_snapshot_and_prometheus_surfaces(pkg):
    sched = pkg.sched.Scheduler(name="pool0")
    t = sched.register("train", weight=2, priority=1, deadline_ms=25.0)
    with t.quantum():
        time.sleep(0.002)
    snap = sched.snapshot()
    row = snap["tenants"]["train"]
    for key in ("weight", "priority", "deadline_ms", "quanta",
                "device_ms", "share", "weighted_share",
                "queue_wait_ms", "preemptions", "waiting", "holding"):
        assert key in row, key
    assert row["quanta"] == 1 and row["device_ms"] >= 2.0
    assert row["share"] == pytest.approx(1.0, abs=0.01)
    assert set(row["queue_wait_ms"]) == {"p50", "p99"}
    text = sched.prometheus_text()
    for series in ("veles_sched_quanta_total",
                   "veles_sched_device_ms_total",
                   "veles_sched_share", "veles_sched_weight",
                   "veles_sched_preemptions_total",
                   "veles_sched_queue_wait_ms"):
        assert series in text, series
    assert 'tenant="train"' in text
    sched.stop()


def test_prometheus_text_equals_the_reference():
    """The same snapshot renders to the same exposition in both
    packages (one renderer each, the same series and labels)."""
    snap = {"tenants": {
        "train": {"quanta": 3, "device_ms": 12.5, "share": 0.25,
                  "weight": 1.0, "preemptions": 2,
                  "queue_wait_ms": {"p50": 0.5, "p99": 1.75}},
        "serve": {"quanta": 9, "device_ms": 37.5, "share": 0.75,
                  "weight": 4.0, "preemptions": 0,
                  "queue_wait_ms": {"p50": 0.0, "p99": 0.25}}}}
    from veles_tpu.obs import metrics as ref_metrics
    from veles_tpu_torch.obs import metrics as port_metrics
    assert port_metrics.render(port_metrics.sched_samples(snap)) == \
        ref_metrics.render(ref_metrics.sched_samples(snap))


def test_attach_workflow_marks_device_units_only(pkg):
    sched = pkg.sched.Scheduler()
    tenant = sched.register("wf")
    wf = pkg.Workflow(None, name="wf")
    dev = pkg.TrivialUnit(wf, name="dev")
    dev.view_group = "TRAINER"
    host = pkg.TrivialUnit(wf, name="host")
    host.view_group = "SERVICE"
    attached = pkg.sched.attach_workflow(wf, tenant,
                                         view_groups=("TRAINER",))
    assert attached == [dev]
    assert dev.sched_tenant_ is tenant
    assert getattr(host, "sched_tenant_", None) is None
    assert getattr(wf, "sched_tenant_", None) is None
    assert wf.sched_pool_tenant_ is tenant
    # the marker is transient: a pickled unit drops it
    assert "sched_tenant_" not in dev.__getstate__()
    pkg.sched.detach_workflow(wf)
    assert dev.sched_tenant_ is None
    assert wf.sched_pool_tenant_ is None
    sched.stop()


def test_attach_workflow_defaults_to_accelerated_units_and_views():
    """Without ``view_groups`` both packages attach every
    AcceleratedUnit plus the TRAINER/EVALUATOR view groups."""
    from veles_tpu.accelerated_units import AcceleratedUnit as RefAccel
    from veles_tpu_torch.accelerated_units import AcceleratedUnit

    names = {}
    for key, accel in (("reference", RefAccel), ("port", AcceleratedUnit)):
        pkg = PACKAGES[key]
        sched = pkg.sched.Scheduler()
        tenant = sched.register("wf")
        wf = pkg.Workflow(None, name="wf")
        accel(wf, name="accel")
        ev = pkg.TrivialUnit(wf, name="eval")
        ev.view_group = "EVALUATOR"
        pkg.TrivialUnit(wf, name="host")
        names[key] = [u.name for u in
                      pkg.sched.attach_workflow(wf, tenant)]
        sched.stop()
    assert names["port"] == names["reference"] == ["accel", "eval"]


# -- parity: the same decisions under a frozen clock -------------------------

def _random_table(rng, n_tenants):
    """One random waiter table: per tenant its knobs, its SFQ finish
    tag and its head waiter (wait, arrival, vclock0, deadline)."""
    rows = []
    for i in range(n_tenants):
        rows.append(dict(
            name="t%d" % i,
            weight=float(rng.choice([0.5, 1.0, 2.0, 4.0, 8.0])),
            priority=int(rng.integers(0, 4)),
            deadline_ms=None if rng.random() < 0.6
            else float(rng.choice([1.0, 5.0, 20.0, 100.0])),
            finish=float(rng.random() * 0.05),
            waiting=bool(rng.random() < 0.8),
            waited_ms=float(rng.random() * 120.0),
            arrival=int(rng.permutation(50)[0]),
            vclock0=float(rng.random() * 0.05),
            acquire_deadline_ms=None if rng.random() < 0.7
            else float(rng.choice([2.0, 10.0, 60.0]))))
    return rows


def _pick_for(sched_mod, rows, now, aging_ms, grace_ms, last_holder):
    sched = sched_mod.Scheduler(aging_ms=aging_ms,
                                handoff_grace_ms=grace_ms)
    handles = {}
    for row in rows:
        handles[row["name"]] = sched.register(
            row["name"], weight=row["weight"], priority=row["priority"],
            deadline_ms=row["deadline_ms"])
    with sched._cond:
        sched._vclock = 0.01
        sched._arrivals = 60
        sched._pool_free_since = now - 0.0005
        if last_holder is not None:
            sched._last_holder = handles[last_holder]
        for row in rows:
            t = handles[row["name"]]
            t._finish = row["finish"]
            if row["waiting"]:
                t._waiters.append(sched_mod._Waiter(
                    now - row["waited_ms"] / 1000.0, row["arrival"],
                    row["vclock0"],
                    deadline_ms=row["acquire_deadline_ms"]))
        best = sched._pick(now)
        pending = None if best is None else \
            sched._handoff_pending(best, now)
        ranks = {name: sched._rank(t, now) for name, t in handles.items()
                 if t._waiters}
        for t in handles.values():
            t._waiters.clear()
    sched.stop()
    return (None if best is None else best.name), pending, ranks


@pytest.mark.parametrize("seed", range(8))
def test_pick_decisions_equal_the_reference_under_a_frozen_clock(seed):
    """40 random waiter tables a seed (priority, weight, enqueued time,
    tenant and per-acquire deadlines, last finish tag, the last holder
    for the handoff grace): the port picks the same tenant, ranks every
    waiter alike and defers to the same phantom."""
    rng = np.random.default_rng(seed)
    now = 1000.0
    for _ in range(40):
        rows = _random_table(rng, int(rng.integers(1, 6)))
        aging = float(rng.choice([10.0, 50.0, 250.0]))
        grace = float(rng.choice([0.0, 1.0, 5.0]))
        last = None if rng.random() < 0.3 else \
            rows[int(rng.integers(len(rows)))]["name"]
        ref = _pick_for(ref_sched, rows, now, aging, grace, last)
        port = _pick_for(port_sched, rows, now, aging, grace, last)
        assert port == ref, rows


class _SteppingClock:
    """``time`` stand-in whose monotonic() advances a fixed step per
    call: one scripted sequence of calls reads the same times in both
    packages."""

    def __init__(self, step_s=0.0005):
        self.now = 100.0
        self.step = step_s

    def monotonic(self):
        self.now += self.step
        return self.now

    def sleep(self, seconds):
        self.now += seconds


def _scripted_snapshot(sched_mod, monkeypatch):
    clock = _SteppingClock()
    monkeypatch.setattr(sched_mod, "time", clock)
    sched = sched_mod.Scheduler(name="pool", aging_ms=5.0)
    tenants = [sched.register("train", weight=1),
               sched.register("serve", weight=4, deadline_ms=2.0),
               sched.register("graph", weight=1, priority=1)]
    order = np.random.default_rng(11).integers(0, 3, 60)
    for i, which in enumerate(order):
        with tenants[which].quantum(
                deadline_ms=1.0 if i % 7 == 0 else None):
            clock.sleep(0.001 * (1 + which))
            if i % 5 == 0:
                with tenants[which].quantum():   # reentrant
                    clock.sleep(0.0005)
    snap = sched.snapshot()
    snap.pop("uptime_s")
    sched.stop()
    return snap


def test_snapshot_counters_equal_the_reference_on_a_scripted_run(
        monkeypatch):
    """60 quanta of three tenants (reentrant ones among them, per-
    acquire deadlines on some) under a stepping clock: the port's
    ``snapshot()`` (quanta, device-ms, shares, queue-wait percentiles,
    preemptions) equals the reference's."""
    ref = _scripted_snapshot(ref_sched, monkeypatch)
    port = _scripted_snapshot(port_sched, monkeypatch)
    assert port == ref
    assert sum(t["quanta"] for t in port["tenants"].values()) == 60


def test_quantum_exit_waits_for_the_device_only_when_outermost(
        monkeypatch):
    """The port's one change: the outermost quantum's exit waits for
    the device before it releases; a nested exit does not, and the
    release happens even when the wait raises."""
    waits = []
    monkeypatch.setattr(port_sched, "_wait_for_device",
                        lambda: waits.append("wait"))
    sched = port_sched.Scheduler()
    t = sched.register("t")
    with t.quantum():
        with t.quantum():
            pass
        assert waits == []
    assert waits == ["wait"]

    def broken():
        raise RuntimeError("device fault")

    monkeypatch.setattr(port_sched, "_wait_for_device", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        with t.quantum():
            pass
    snap = sched.snapshot()["tenants"]["t"]
    assert snap["quanta"] == 2 and not snap["holding"]
    sched.stop()


def test_device_wait_is_free_without_cuda(monkeypatch):
    """Without CUDA initialized the wait records nothing."""
    monkeypatch.setattr(port_sched.torch.cuda, "is_initialized",
                        lambda: False)

    def no_event(*a, **k):
        raise AssertionError("no CUDA event without CUDA")

    monkeypatch.setattr(port_sched.torch.cuda, "Event", no_event)
    port_sched._wait_for_device()


def test_mutual_exclusion_under_stress(port):
    pkg = port
    """More tenant threads than cores, a short switch interval: no two
    quanta ever overlap, and every quantum is accounted (a lost update
    of the holder or of the counters would break one of the two)."""
    import os
    import sys

    sched = pkg.sched.Scheduler(handoff_grace_ms=0.2)
    tenants = [sched.register("t%d" % i, weight=1 + i % 3,
                              priority=i % 2) for i in range(4)]
    n_threads = (os.cpu_count() or 1) + 2
    per_thread = 30
    state = {"inside": 0, "overlaps": 0, "done": 0}
    guard = threading.Lock()

    def worker(i):
        tenant = tenants[i % len(tenants)]
        for _ in range(per_thread):
            with tenant.quantum():
                with guard:
                    state["inside"] += 1
                    if state["inside"] > 1:
                        state["overlaps"] += 1
                time.sleep(0)
                with guard:
                    state["inside"] -= 1
                    state["done"] += 1

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    snap = sched.snapshot()
    sched.stop()
    assert state["overlaps"] == 0
    assert state["done"] == n_threads * per_thread
    assert sum(t["quanta"] for t in snap["tenants"].values()) == \
        n_threads * per_thread
