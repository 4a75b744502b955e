"""The port's runtime lock-order recorder (``veles_tpu_torch/analysis/
lockcheck.py``): the counterpart of ``tests/test_concurrency.py``'s
lockcheck tests.

The JAX package's recorder is installed for the whole tier-1 session
(``tests/conftest.py``), patching ``threading.Lock`` in this process,
so the port's never installs here: its recorders are private
(``Recorder()``) in these tests, or run in a subprocess of their own
(``VELES_LOCKCHECK=1 python -c ...``) that drives the port's threaded
paths — a ``TokenBatcher`` round trip, the ``Scheduler`` and a
``Router`` over two ``LocalReplica``s — and asserts an acyclic graph
at teardown.
"""

import os
import subprocess
import sys
import textwrap
import threading

import pytest

from veles_tpu_torch.analysis import lockcheck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_recorder_reproduces_an_abba_cycle_with_witnesses():
    rec = lockcheck.Recorder()
    lock_a = rec.wrap_lock(site="fixture.py:10")
    lock_b = rec.wrap_lock(site="fixture.py:11")
    with lock_a:
        with lock_b:
            pass
    rec.assert_acyclic()
    with lock_b:
        with lock_a:
            pass
    with pytest.raises(lockcheck.LockOrderError) as excinfo:
        rec.assert_acyclic()
    err = excinfo.value
    assert "fixture.py:10" in str(err) and "fixture.py:11" in str(err)
    assert err.cycle[0] == err.cycle[-1]
    assert err.witnesses and "first seen at" in str(err)


def test_consistent_order_and_same_site_reentry():
    rec = lockcheck.Recorder()
    a = rec.wrap_lock(site="s.py:1")
    b = rec.wrap_lock(site="s.py:2")
    b2 = rec.wrap_lock(site="s.py:2")
    for _ in range(3):
        with a:
            with b:
                pass
    with b:
        with b2:
            pass
    rec.assert_acyclic()
    assert ("s.py:1", "s.py:2") in rec.edges()
    assert ("s.py:2", "s.py:2") not in rec.edges()
    assert rec.acquisitions == 8


def test_nested_scope_reentry_is_not_a_cycle():
    rec = lockcheck.Recorder()
    outer_run = rec.wrap_lock(site="units.py:112")
    outer_data = rec.wrap_lock(site="distributable.py:88")
    inner_run = rec.wrap_lock(site="units.py:112")
    inner_data = rec.wrap_lock(site="distributable.py:88")
    with outer_run:
        with outer_data:
            with inner_run:
                with inner_data:
                    pass
    rec.assert_acyclic()
    assert ("distributable.py:88", "units.py:112") not in rec.edges()
    foreign = rec.wrap_lock(site="metrics.py:9")
    with foreign:
        with outer_run:
            pass
    with outer_run:
        with foreign:
            pass
    with pytest.raises(lockcheck.LockOrderError):
        rec.assert_acyclic()


def test_condition_wait_keeps_the_stack_consistent():
    rec = lockcheck.Recorder()
    cond = threading.Condition(rec.wrap_lock(site="c.py:1"))
    inner = rec.wrap_lock(site="c.py:2")
    state = {"ready": False}

    def producer():
        with cond:
            with inner:
                state["ready"] = True
            cond.notify_all()

    thread = threading.Thread(target=producer)
    with cond:
        thread.start()
        while not state["ready"]:
            cond.wait(1.0)
    thread.join()
    rec.assert_acyclic()
    assert ("c.py:1", "c.py:2") in rec.edges()


def test_rlock_wrapper_with_condition():
    rec = lockcheck.Recorder()
    cond = threading.Condition(rec.wrap_rlock(site="r.py:1"))
    with cond:
        with cond:
            cond.notify_all()
    rec.assert_acyclic()


def test_real_factories_come_from_thread_module():
    """The recorder's own locks are C locks whatever ``threading.Lock``
    is at import (here: possibly another recorder's wrapper)."""
    import _thread
    assert lockcheck._REAL_LOCK is _thread.allocate_lock
    assert lockcheck._REAL_RLOCK is _thread.RLock
    assert type(lockcheck.Recorder()._mutex).__module__ == "_thread"


def test_never_wraps_or_removes_another_recorders_patch():
    """In this process ``threading.Lock`` may be the JAX package's
    recorder (tests/conftest.py): the port's install refuses and leaves
    it in place, and its uninstall does not restore over it. Where no
    other recorder runs, install and uninstall round-trip."""
    before = (threading.Lock, threading.RLock)
    if lockcheck._foreign_patch():
        with pytest.raises(lockcheck.ForeignRecorderError):
            lockcheck.install()
        lockcheck.uninstall()
        assert lockcheck.installed() is None
    else:
        rec = lockcheck.install()
        try:
            assert lockcheck.install() is rec
            assert threading.Lock is not before[0]
        finally:
            lockcheck.uninstall()
    assert (threading.Lock, threading.RLock) == before


def test_noop_passthrough_when_unset():
    env = {k: v for k, v in os.environ.items()
           if k != lockcheck.ENV_VAR}
    code = textwrap.dedent("""
        import threading
        original = threading.Lock
        from veles_tpu_torch.analysis import lockcheck
        assert lockcheck.maybe_install() is None
        assert lockcheck.installed() is None
        assert threading.Lock is original
        assert threading.Lock is lockcheck._REAL_LOCK
        assert type(threading.Lock()).__module__ == "_thread"
        print("noop ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "noop ok" in proc.stdout


_THREADED_PATHS = textwrap.dedent("""
    import json, threading, time, urllib.request
    import numpy as np
    from veles_tpu_torch.analysis import lockcheck
    rec = lockcheck.maybe_install()
    assert rec is not None, "VELES_LOCKCHECK did not install"
    import torch
    torch.set_num_threads(1)
    from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)
    from veles_tpu_torch.sched import Scheduler
    from veles_tpu_torch.serve import (GenerativeEngine, InferenceEngine,
                                       TokenBatcher)
    from veles_tpu_torch.serve.fleet import FleetManager, LocalReplica
    from veles_tpu_torch.serve.router import Router, RouterServer

    # a TokenBatcher round trip over a CPU slab engine
    cfg = TransformerConfig(vocab=64, embed=32, heads=2, layers=1,
                            seq_len=32)
    engine = GenerativeEngine(cfg, init_params(cfg, seed=0),
                              max_slots=2, device="cpu")
    batcher = TokenBatcher(engine)
    try:
        out = batcher.submit(np.array([1, 2, 3]), max_tokens=3,
                             timeout=60)
    finally:
        batcher.stop()
    assert len(np.asarray(out).reshape(-1)) == 3, out

    # the scheduler: two tenants taking quanta from two threads
    sched = Scheduler()
    tenants = [sched.register("t%d" % i) for i in range(2)]
    def work(t):
        for _ in range(5):
            with t.quantum():
                time.sleep(0.001)
    threads = [threading.Thread(target=work, args=(t,)) for t in tenants]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    sched.stop()

    # a router over two in-process replicas of a small MLP engine
    rng = np.random.default_rng(0)
    params = [{"w": rng.standard_normal((4, 8)).astype(np.float32),
               "b": np.zeros(8, np.float32)},
              {"w": rng.standard_normal((8, 3)).astype(np.float32),
               "b": np.zeros(3, np.float32)}]
    specs = (("fc", "tanh"), ("fc", "softmax"))
    make = lambda: InferenceEngine.from_specs(specs, params, device="cpu")
    replicas = [LocalReplica("r%d" % i, make, watchdog_s=None,
                             batcher_kwargs={"max_batch": 8,
                                             "max_delay_ms": 1.0})
                for i in range(2)]
    server = RouterServer(Router(health_interval_s=0.05))
    fleet = FleetManager(server.router, replicas=replicas)
    try:
        deadline = time.monotonic() + 60
        while server.router.routable_count() < 2:
            assert time.monotonic() < deadline, "never routable"
            time.sleep(0.02)
        base = "http://%s:%d" % server.endpoint
        for i in range(6):
            req = urllib.request.Request(
                base + "/apply", data=json.dumps(
                    {"input": [[1.0, 2.0, 3.0, 4.0]],
                     "session": "s%d" % i}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
    finally:
        fleet.stop()
        server.stop()
    rec.assert_acyclic()
    print(json.dumps({"edges": len(rec.edges()),
                      "acquisitions": rec.acquisitions}))
""")


def test_threaded_paths_record_an_acyclic_lock_order():
    """A process of its own with ``VELES_LOCKCHECK=1`` (the recorder
    installed before the port imports): a TokenBatcher round trip, the
    Scheduler and a Router over two LocalReplicas record real
    acquisition edges, and their graph is acyclic."""
    env = dict(os.environ, VELES_LOCKCHECK="1", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _THREADED_PATHS],
                          env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    import json
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["acquisitions"] > 100, doc
    assert doc["edges"] >= 1, doc
