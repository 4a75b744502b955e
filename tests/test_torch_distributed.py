"""The port's training farm (``veles_tpu_torch.distributed``): the JAX
package's ``tests/test_distributed.py`` cases on the port's
``MnistWorkflow``, an in-process coordinator and workers over loopback
(reference model: veles/tests/test_network.py builds a real
Server+Client pair in one process, :52-80), on the CPU at f32. The
one-worker farm is bitwise the port's standalone run, and within 1e-4
of the JAX package's one-worker farm from the same seed. The duck-typed
farm of ``torch_farm_duck.py`` drives the codec, relay and elastic
paths without a model."""

import threading

import numpy as np
import pytest
import torch

import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.distributed as R_distributed
import veles_tpu.models.mnist as R_mnist
import veles_tpu.prng as R_prng
import veles_tpu_torch.config as P_config
import veles_tpu_torch.prng as prng
from veles_tpu_torch.backends import Device
from veles_tpu_torch.distributed import Coordinator, Worker
from veles_tpu_torch.distributed.client import WorkerDeath
from veles_tpu_torch.models.mnist import MnistWorkflow

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_prng():
    saved = [(c.root.common.engine.compute_type, c.root.common.random.seed)
             for c in (R_config, P_config)]
    for c in (R_config, P_config):
        c.root.common.engine.compute_type = "float32"
        c.root.common.random.seed = 31
    prng.reset()
    R_prng.reset()
    yield
    prng.reset()
    R_prng.reset()
    for c, (compute, seed) in zip((R_config, P_config), saved):
        c.root.common.engine.compute_type = compute
        c.root.common.random.seed = seed


CFG = dict(layers=(16, 10), max_epochs=3, fail_iterations=100,
           learning_rate=0.1, momentum=0.9)
LOADER = dict(n_train=300, n_valid=100, minibatch_size=50)


def _master(device):
    wf = MnistWorkflow(loader_kwargs=dict(LOADER), **CFG)
    wf.thread_pool = None
    wf.is_standalone = False
    wf.is_master = True
    wf.initialize(device=device)
    return wf


def _worker_wf(device, i):
    lk = dict(LOADER)
    lk["prng_stream"] = "worker%d_loader" % i
    wf = MnistWorkflow(loader_kwargs=lk, **CFG)
    wf.thread_pool = None
    wf.is_standalone = False
    wf.is_slave = True
    wf.initialize(device=device)
    return wf


def _run_cluster(device, n_workers, death_probability=0.0,
                 timeout=180.0, coordinator_kwargs=None,
                 worker_kwargs=None, deaths=1):
    master = _master(device)
    coordinator = Coordinator(master, "127.0.0.1:0", job_timeout=30,
                              **(coordinator_kwargs or {}))
    coordinator.start()
    results = {}

    def work(i, death):
        wf = _worker_wf(device, i)
        worker = Worker(wf, coordinator.address,
                        death_probability=death,
                        **(worker_kwargs or {}))
        try:
            results[i] = worker.run()
        except WorkerDeath:
            results[i] = "died"
        except Exception as e:  # surfaced by asserts below
            results[i] = repr(e)

    threads = [threading.Thread(
        target=work, args=(i, death_probability if i < deaths else 0.0),
        daemon=True) for i in range(n_workers)]
    for t in threads:
        t.start()
    finished = coordinator.run(timeout)
    coordinator.stop()
    for t in threads:
        t.join(timeout=10)
    return master, coordinator, results, finished


@pytest.fixture
def device():
    return Device(backend="cpu")


def test_single_worker_matches_standalone(device):
    """With one worker shipping params both ways, the distributed
    trajectory equals the standalone one (same seed)."""
    standalone = MnistWorkflow(loader_kwargs=dict(LOADER), **CFG)
    standalone.thread_pool = None
    standalone.initialize(device=device)
    standalone.run()
    expected = [np.array(f.weights.map_read())
                for f in standalone.forwards]
    expected_err = standalone.decision.min_validation_error

    prng.reset()
    master, coordinator, results, finished = _run_cluster(device, 1)
    assert finished, "cluster did not finish: %s" % (results,)
    assert results[0] > 0
    assert bool(master.decision.complete)
    assert master.decision.min_validation_error == expected_err
    for fwd, exp in zip(master.forwards, expected):
        np.testing.assert_array_equal(np.array(fwd.weights.map_read()),
                                      exp)


def _reference_one_worker_farm():
    """The JAX package's one-worker farm of the same workflow and seed
    (its own Coordinator and Worker, in this process)."""
    dev = R_backends.Device(backend="cpu")
    master = R_mnist.MnistWorkflow(loader_kwargs=dict(LOADER), **CFG)
    master.thread_pool = None
    master.is_standalone = False
    master.is_master = True
    master.initialize(device=dev)
    coordinator = R_distributed.Coordinator(master, "127.0.0.1:0",
                                            job_timeout=30)
    coordinator.start()
    lk = dict(LOADER, prng_stream="worker0_loader")
    slave = R_mnist.MnistWorkflow(loader_kwargs=lk, **CFG)
    slave.thread_pool = None
    slave.is_standalone = False
    slave.is_slave = True
    slave.initialize(device=dev)
    done = {}
    thread = threading.Thread(target=lambda: done.setdefault(
        0, R_distributed.Worker(slave, coordinator.address).run()),
        daemon=True)
    thread.start()
    finished = coordinator.run(180)
    coordinator.stop()
    thread.join(timeout=10)
    assert finished and done.get(0, 0) > 0
    return master


def test_single_worker_matches_the_reference_farm(device):
    """The port's one-worker farm against the JAX package's, from the
    same seed: the same jobs in the same order, the same validation
    error, and weights within 1e-4 of their scale (the two frameworks'
    sum orders differ)."""
    ref = _reference_one_worker_farm()
    master, coordinator, results, finished = _run_cluster(device, 1)
    assert finished, "cluster did not finish: %s" % (results,)
    assert results[0] > 0
    assert master.decision.min_validation_error == \
        ref.decision.min_validation_error
    for fwd, rfwd in zip(master.forwards, ref.forwards):
        got = np.array(fwd.weights.map_read())
        want = np.array(rfwd.weights.map_read())
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(got - want).max() <= 1e-4 * scale


def test_two_workers_complete(device):
    master, coordinator, results, finished = _run_cluster(device, 2)
    assert finished, "cluster did not finish: %s" % (results,)
    assert coordinator.total_updates >= 3 * (400 // 50)
    assert bool(master.decision.complete)
    assert master.decision.min_validation_error < 90.0


def test_worker_death_requeues_and_survivors_finish(device):
    master, coordinator, results, finished = _run_cluster(
        device, 2, death_probability=0.15)
    assert finished, "cluster did not finish: %s" % (results,)
    assert bool(master.decision.complete)
    # the dying worker either died (requeue path exercised) or got
    # lucky; either way the survivor drove training to completion
    assert isinstance(results[1], int) and results[1] > 0


def test_single_worker_pipelined_bit_identical_to_stop_and_wait(device):
    """The pipelined defaults (double-buffered
    client, max_outstanding=2, zero-copy frames, param skip, discard
    of post-completion updates) produce the EXACT final weights of the
    pre-pipelining stop-and-wait configuration — checksum equality,
    not allclose."""
    import hashlib

    def weight_checksums(master):
        return [hashlib.sha1(
            np.ascontiguousarray(f.weights.map_read()).tobytes())
            .hexdigest() for f in master.forwards]

    # arm A: exact pre-pipelining semantics
    master_a, _, results_a, finished_a = _run_cluster(
        device, 1,
        coordinator_kwargs=dict(max_outstanding=1, wire_version=1,
                                param_skip=False),
        worker_kwargs=dict(pipeline=False, wire_version=1))
    assert finished_a, results_a
    sums_a = weight_checksums(master_a)
    err_a = master_a.decision.min_validation_error

    prng.reset()
    # arm B: the pipelined defaults
    master_b, coordinator_b, results_b, finished_b = _run_cluster(
        device, 1)
    assert finished_b, results_b
    assert weight_checksums(master_b) == sums_a
    assert master_b.decision.min_validation_error == err_a

    prng.reset()
    # arm C: pipelined client against a credit window of 1 — the
    # request for job N+1 is PARKED until update N applies, which is
    # stop-and-wait issue semantics by construction. encoding="none"
    # is passed EXPLICITLY (it is also the default): the codec layer
    # must be a true identity on this path — verified below via the
    # update-payload accounting (raw == wire, nothing re-encoded).
    master_c, coordinator_c, results_c, finished_c = _run_cluster(
        device, 1, coordinator_kwargs=dict(max_outstanding=1,
                                           encoding="none"))
    assert finished_c, results_c
    assert weight_checksums(master_c) == sums_a
    wire_c = coordinator_c.wire_stats()
    assert wire_c["update_raw_bytes"] == wire_c["update_wire_bytes"]
    assert wire_c["update_raw_bytes"] > 0
    # the pipeline actually ran pipelined: params were skipped on the
    # single worker's steady-state jobs and at most one update (the
    # one in flight when completion latched) was discarded
    assert coordinator_b.discarded_updates <= 1
    assert coordinator_b.jobs_issued == (
        coordinator_b.total_updates + coordinator_b.discarded_updates +
        coordinator_b.requeued_jobs)


def test_pipelined_soak_faults_exactly_once(device):
    """Pipelined soak under fault injection: 4 workers with
    death_probability killing mid-flight at max_outstanding=2 — every
    job is resolved exactly once (applied, discarded-after-complete,
    or requeued on drop; no loss, no double-apply), training completes,
    and the blacklist behaves as at max_outstanding=1 (workers that do
    real work between deaths never poison the machine)."""
    master, coordinator, results, finished = _run_cluster(
        device, 4, death_probability=0.15, timeout=240.0, deaths=2)
    assert finished, "soak did not finish: %s" % (results,)
    assert bool(master.decision.complete)
    # no worker hit an unexpected exception — a double-apply would
    # raise "no pending minibatch" in a handler and surface here as a
    # connection error after reconnect exhaustion
    bad = {i: r for i, r in results.items()
           if not (isinstance(r, int) or r == "died")}
    assert not bad, bad
    # exactly-once job conservation: every issued job has exactly one
    # fate
    assert coordinator.jobs_issued == (
        coordinator.total_updates + coordinator.discarded_updates +
        coordinator.requeued_jobs), (
        coordinator.jobs_issued, coordinator.total_updates,
        coordinator.discarded_updates, coordinator.requeued_jobs)
    assert coordinator.total_updates >= 3 * (400 // 50)
    # blacklist parity with max_outstanding=1: the shared in-process
    # machine id must not have accumulated permanent strikes (deaths
    # interleave with completed jobs, which reset the counter)
    assert max(coordinator.blacklist.values(), default=0) < \
        coordinator.blacklist_after


def test_worker_states_reports_pipelining_health(device):
    """worker_states() carries the new idle-fraction and
    wire-throughput fields while workers are connected."""
    master = _master(device)
    coordinator = Coordinator(master, "127.0.0.1:0", job_timeout=30)
    coordinator.start()
    states = {}

    def work():
        wf = _worker_wf(device, 3)
        worker = Worker(wf, coordinator.address)
        try:
            worker.run()
        except Exception:
            pass

    t = threading.Thread(target=work, daemon=True)
    t.start()
    import time
    for _ in range(200):
        states = coordinator.worker_states()
        if states and any(s["jobs_done"] > 0 for s in states.values()):
            break
        time.sleep(0.05)
    finished = coordinator.run(120)
    coordinator.stop()
    t.join(timeout=10)
    assert finished
    assert states, "worker never joined"
    for s in states.values():
        for key in ("state", "power", "jobs_done", "paused",
                    "in_flight", "idle_frac", "wire_mb_in",
                    "wire_mb_out", "wire_mb_per_sec"):
            assert key in s, key
        assert 0.0 <= s["idle_frac"] <= 1.0
        assert s["wire_mb_in"] > 0 and s["wire_mb_out"] > 0
        assert 0 <= s["in_flight"] <= coordinator.max_outstanding


def test_checksum_mismatch_rejected(device):
    master = _master(device)
    coordinator = Coordinator(master, "127.0.0.1:0")
    coordinator.start()
    try:
        other = MnistWorkflow(
            layers=(16, 12, 10), max_epochs=1,
            loader_kwargs=dict(LOADER, prng_stream="other"))
        other.thread_pool = None
        other.is_standalone = False
        other.is_slave = True
        other.initialize(device=device)
        worker = Worker(other, coordinator.address,
                        reconnect_attempts=0)
        with pytest.raises((ConnectionError, OSError)):
            worker.run()
    finally:
        coordinator.stop()


def test_pause_resume(device):
    master = _master(device)
    coordinator = Coordinator(master, "127.0.0.1:0")
    coordinator.start()
    done = {}

    def work():
        wf = _worker_wf(device, 9)
        done["jobs"] = Worker(wf, coordinator.address).run()

    t = threading.Thread(target=work, daemon=True)
    t.start()
    # wait for the worker to join, then pause/resume it
    import time
    for _ in range(100):
        if coordinator.workers:
            break
        time.sleep(0.05)
    wid = next(iter(coordinator.workers))
    coordinator.pause(wid)
    time.sleep(0.3)
    coordinator.resume(wid)
    assert coordinator.run(120), "did not finish after resume"
    coordinator.stop()
    t.join(timeout=10)
    assert done.get("jobs", 0) > 0


# -- compressed updates, elastic membership, relay tier ----------
def test_int8_single_worker_tracks_standalone_within_tolerance(device):
    """Documented int8-delta tolerance (docs/manual.md): with one
    worker and param skip, the worker's local trajectory is EXACT
    (jobs carry no params after the f32-keyframe bootstrap), and the
    master's adopted params are the int8-decoded image of the
    worker's true state — within half an int8 LSB of the final
    update's delta range per element. The decision metrics ride the
    update uncompressed, so the error curve is exact."""
    standalone = MnistWorkflow(loader_kwargs=dict(LOADER), **CFG)
    standalone.thread_pool = None
    standalone.initialize(device=device)
    standalone.run()
    expected = [np.array(f.weights.map_read())
                for f in standalone.forwards]
    expected_err = standalone.decision.min_validation_error

    prng.reset()
    master, coordinator, results, finished = _run_cluster(
        device, 1, coordinator_kwargs=dict(encoding="int8"))
    assert finished, results
    assert master.decision.min_validation_error == expected_err
    for fwd, exp in zip(master.forwards, expected):
        got = np.array(fwd.weights.map_read())
        assert np.abs(got - exp).max() < 5e-3, np.abs(got - exp).max()
    # the codec really engaged: update-direction wire bytes shrank
    wire = coordinator.wire_stats()
    assert wire["update_wire_bytes"] < wire["update_raw_bytes"] / 3.0
    assert coordinator.stale_applies == 0


def test_int8_two_worker_farm_converges(device):
    """Multi-worker int8-delta farm trains MNIST to the same
    acceptance bar as the f32 farm (async multi-worker runs are
    order-nondeterministic either way; the tolerance statement is the
    single-worker test above)."""
    master, coordinator, results, finished = _run_cluster(
        device, 2, coordinator_kwargs=dict(encoding="int8"))
    assert finished, results
    assert bool(master.decision.complete)
    assert master.decision.min_validation_error < 90.0
    assert coordinator.jobs_issued == (
        coordinator.total_updates + coordinator.discarded_updates +
        coordinator.requeued_jobs)


def test_encoding_negotiation_mixed_and_legacy_workers(device):
    """An int8 coordinator serves an int8-capable worker and a
    pre-codec worker (empty encodings list) in ONE farm: each
    connection negotiates independently, both finish."""
    master = _master(device)
    coordinator = Coordinator(master, "127.0.0.1:0", job_timeout=30,
                              encoding="int8")
    coordinator.start()
    encodings_seen = {}
    results = {}

    def work(i, encodings):
        wf = _worker_wf(device, i)
        worker = Worker(wf, coordinator.address, encodings=encodings)
        try:
            results[i] = worker.run()
            encodings_seen[i] = worker.encoding
        except Exception as e:
            results[i] = repr(e)

    threads = [
        threading.Thread(target=work, args=(0, None), daemon=True),
        threading.Thread(target=work, args=(1, ()), daemon=True),
    ]
    for t in threads:
        t.start()
    finished = coordinator.run(180)
    coordinator.stop()
    for t in threads:
        t.join(timeout=10)
    assert finished, results
    assert bool(master.decision.complete)
    assert encodings_seen.get(0) == "int8"   # negotiated up
    assert encodings_seen.get(1) == "none"   # legacy interop


def test_worker_states_reports_encoding_under_delta_path():
    """worker_states()/wire_stats() under the delta path: wire_mb
    reflects COMPRESSED bytes, the compression ratio is reported per
    encoding, and int8 buffers never hit the gzip probe."""
    from unittest import mock

    import veles_tpu_torch.distributed.protocol as protocol
    from torch_farm_duck import FarmMaster, FarmSlave

    n_jobs, elems = 24, 100000
    master = FarmMaster(n_jobs, elems)
    coordinator = Coordinator(master, "127.0.0.1:0", job_timeout=30,
                              encoding="int8")
    coordinator.start()
    states = {}
    probes = []
    real_probe = protocol._probe_compressible

    def counting_probe(view):
        probes.append(len(view))
        return real_probe(view)

    def work():
        slave = FarmSlave(elems, compute_ms=5.0)
        Worker(slave, coordinator.address).run()

    with mock.patch.object(protocol, "_probe_compressible",
                           counting_probe):
        t = threading.Thread(target=work, daemon=True)
        t.start()
        import time
        for _ in range(400):
            states = coordinator.worker_states()
            if states and any(s["jobs_done"] > 2
                              for s in states.values()):
                break
            time.sleep(0.02)
        finished = coordinator.run(60)
        wire = coordinator.wire_stats()
        coordinator.stop()
        t.join(timeout=10)
    assert finished
    assert states, "worker never produced states"
    for s in states.values():
        assert s["encoding"] == "int8"
        assert s["bootstrapped"] is True
        # wire accounting reflects COMPRESSED bytes: the per-update
        # wire traffic is ~1 byte/elem + control, far below raw f32
        assert s["update_ratio"] > 3.0
    assert wire["update_wire_bytes"] * 3.9 <= wire["update_raw_bytes"]
    # the worker's conn-level wire_mb counts what actually crossed the
    # socket: updates at ~elems bytes each, not 4x that
    per_update_wire = wire["bytes_in"] / master.applied
    assert per_update_wire < 1.6 * elems
    # int8/bf16 payloads ship raw — the gzip probe never ran on a
    # coded buffer (all observed probes are small control payloads,
    # never the ~elems-sized quantized blobs)
    assert not [n for n in probes if n > 32768], probes


def test_elastic_join_and_kill_mid_run_conserves():
    """Elastic membership on the duck farm: one worker joins mid-run
    (full-param bootstrap asserted via stale_applies == 0), one dies
    mid-run (in-flight jobs requeue); every job resolves exactly
    once and the closed loop completes."""
    from torch_farm_duck import run_arm

    r = run_arm(3, 48, 50000, 2.0, pipeline=True, max_outstanding=2,
                wire_version=2, param_skip=True, encoding="int8",
                join_workers=1, kill_after=2, timeout=120)
    assert r["conserved"] == 1
    assert r["requeued"] >= 1       # the kill really had jobs in flight


def test_relay_tier_aggregates_and_conserves():
    """6 workers behind 2 relays: the root sees 2 connections, per-job
    exactly-once accounting holds, updates arrive coalesced
    (update_multi batches), and the farm completes."""
    from torch_farm_duck import FarmMaster, FarmSlave
    from veles_tpu_torch.distributed.relay import Relay

    n_jobs, elems = 48, 50000
    master = FarmMaster(n_jobs, elems)
    coordinator = Coordinator(master, "127.0.0.1:0", job_timeout=60,
                              encoding="int8")
    coordinator.start()
    relays = [Relay(coordinator.address, listen="127.0.0.1:0",
                    credits=8) for _ in range(2)]
    for relay in relays:
        relay.start()
    errors = {}

    def work(i):
        slave = FarmSlave(elems, compute_ms=3.0)
        try:
            Worker(slave, relays[i % 2].address).run()
        except Exception as e:
            errors[i] = repr(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(6)]
    for t in threads:
        t.start()
    finished = coordinator.run(120)
    for relay in relays:
        relay.stop()
    coordinator.stop()
    for t in threads:
        t.join(timeout=15)
    assert finished, errors
    assert not errors, errors
    assert master.applied == n_jobs
    # fan-in topology: the root registered only the relays
    assert coordinator._wid_seq == 2
    assert coordinator.jobs_issued == (
        coordinator.total_updates + coordinator.discarded_updates +
        coordinator.requeued_jobs)
    assert coordinator.stale_applies == 0
    relayed = sum(r.updates_relayed for r in relays)
    upstream = sum(r.upstream_sends for r in relays)
    assert relayed >= n_jobs  # every job's update passed a relay
    assert 0 < upstream <= relayed


def test_relay_downstream_death_retracts_upstream():
    """A worker dying BEHIND a relay: the relay retracts its in-flight
    jobs upstream (requeued at the root), survivors finish the closed
    loop, conservation intact."""
    from torch_farm_duck import run_arm

    r = run_arm(3, 36, 50000, 3.0, pipeline=True, max_outstanding=2,
                wire_version=2, param_skip=True, encoding="int8",
                n_relays=1, kill_after=2, timeout=120)
    assert r["conserved"] == 1
    assert r["requeued"] >= 1


def test_announce_and_discover_coordinator():
    """The coordinator's UDP beacon is heard by discover_coordinator
    (loopback), carries the workflow checksum, and filtering by a
    WRONG checksum times out instead of mis-joining."""
    import socket as socket_mod

    from torch_farm_duck import FarmMaster
    from veles_tpu_torch.distributed import discovery

    # pick a free UDP port to keep parallel test runs independent
    probe = socket_mod.socket(socket_mod.AF_INET,
                              socket_mod.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()

    master = FarmMaster(4, 1024)
    coordinator = Coordinator(master, "127.0.0.1:0",
                              announce=True, announce_port=port)
    coordinator.start()
    try:
        found = discovery.discover_coordinator(
            timeout=10.0, port=port, checksum=master.checksum)
        assert found == coordinator.address
        assert discovery.discover_coordinator(
            timeout=1.5, port=port, checksum="someone-elses-farm") \
            is None
    finally:
        coordinator.stop()


@pytest.mark.slow
def test_elastic_soak_16_workers_join4_kill2():
    """Soak: a 16-worker farm at max_outstanding=2 where 4
    workers JOIN mid-run and 2 are KILLED mid-run (deterministic
    die_after). Exactly-once conservation counters assert clean and
    every joiner bootstrapped before its first apply."""
    from torch_farm_duck import FarmMaster, FarmSlave
    from veles_tpu_torch.distributed.client import WorkerDeath

    n_jobs, elems = 400, 25000
    master = FarmMaster(n_jobs, elems)
    coordinator = Coordinator(master, "127.0.0.1:0", job_timeout=60,
                              max_outstanding=2, encoding="int8")
    coordinator.start()
    errors = {}
    threads = []

    def work(i, die_after=None):
        slave = FarmSlave(elems, compute_ms=2.0)
        worker = Worker(slave, coordinator.address,
                        die_after=die_after)
        try:
            worker.run()
        except WorkerDeath:
            errors[i] = "died"
        except Exception as e:
            errors[i] = repr(e)

    # 12 initial workers, 2 of them fated to die
    for i in range(12):
        t = threading.Thread(
            target=work, args=(i,),
            kwargs=dict(die_after=3 if i < 2 else None))
        threads.append(t)
        t.start()

    # join 4 more once a quarter of the jobs have applied
    import time
    deadline = time.time() + 120
    while master.applied < n_jobs // 4 and time.time() < deadline:
        time.sleep(0.005)
    for i in range(12, 16):
        t = threading.Thread(target=work, args=(i,))
        threads.append(t)
        t.start()

    finished = coordinator.run(240)
    coordinator.stop()
    for t in threads:
        t.join(timeout=15)
    bad = {i: e for i, e in errors.items() if e != "died"}
    assert finished, errors
    assert not bad, bad
    assert sorted(i for i, e in errors.items() if e == "died") == [0, 1]
    assert master.applied == n_jobs
    assert coordinator.jobs_issued == (
        coordinator.total_updates + coordinator.discarded_updates +
        coordinator.requeued_jobs), (
        coordinator.jobs_issued, coordinator.total_updates,
        coordinator.discarded_updates, coordinator.requeued_jobs)
    assert coordinator.requeued_jobs >= 1   # the kills had jobs in flight
    assert coordinator.stale_applies == 0   # joiners bootstrapped first


@pytest.mark.slow
def test_soak_32_workers_with_deaths(device):
    """Job-pump soak (reference '100 nodes' claim, scaled to CI): 32
    in-process workers, several with fault injection, against the
    request-queue producer — training completes, every surviving
    worker did real work, and the update count covers the epochs."""
    cfg = dict(CFG, max_epochs=5)
    loader_big = dict(LOADER, n_train=1600)  # ~175 jobs for 32 workers

    def master_wf():
        wf = MnistWorkflow(loader_kwargs=dict(loader_big), **cfg)
        wf.thread_pool = None
        wf.is_standalone = False
        wf.is_master = True
        wf.initialize(device=device)
        return wf

    def worker_wf(i):
        lk = dict(loader_big)
        lk["prng_stream"] = "worker%d_loader" % i
        wf = MnistWorkflow(loader_kwargs=lk, **cfg)
        wf.thread_pool = None
        wf.is_standalone = False
        wf.is_slave = True
        wf.initialize(device=device)
        return wf

    master = master_wf()
    # Build every worker BEFORE opening the job stream so all 32
    # connect at once (elastic late join is test_two_workers' job).
    worker_wfs = [worker_wf(i) for i in range(32)]
    coordinator = Coordinator(master, "127.0.0.1:0", job_timeout=30)
    coordinator.start()
    results = {}

    def work(i, death):
        worker = Worker(worker_wfs[i], coordinator.address,
                        death_probability=death)
        try:
            results[i] = worker.run()
        except WorkerDeath:
            results[i] = "died"
        except ConnectionRefusedError:
            # only legitimate once training already completed and the
            # listener closed; anything earlier is a real failure
            results[i] = "late" if coordinator.done.is_set() else \
                "refused-while-running"
        except Exception as e:
            results[i] = repr(e)

    threads = [threading.Thread(
        target=work, args=(i, 0.10 if i % 8 == 0 else 0.0),
        daemon=True) for i in range(32)]
    for t in threads:
        t.start()
    finished = coordinator.run(300.0)
    coordinator.stop()
    for t in threads:
        t.join(timeout=15)
    assert finished, "soak did not finish: %s" % (results,)
    assert bool(master.decision.complete)
    # no worker hit an unexpected exception
    bad = {i: r for i, r in results.items()
           if not (isinstance(r, int) or r in ("died", "late"))}
    assert not bad, bad
    workers_that_worked = [r for r in results.values()
                           if isinstance(r, int) and r > 0]
    # the pump must have spread jobs across the fleet, not starved it
    assert len(workers_that_worked) >= 16, results
    assert coordinator.total_updates >= 5 * (1700 // 50)
