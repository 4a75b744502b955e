"""Cluster runs of the port's farmed workflows over
``veles_tpu_torch.distributed``, on the CPU: the LM workflow, the genetics
optimizer and the ensemble trainer farmed to in-process workers over
loopback (the JAX package's ``tests/test_lm_workflow.py``,
``tests/test_services.py`` cluster cases), and the farm's checkpoints:
``resume_farm`` over the port's ``CheckpointStore``, ``corrupt_shard``
forcing a fall back one generation, and a coordinator killed by its
``FaultPlan`` between checkpoints and resumed on the same port with
every job applied exactly once.
"""

import logging
import threading

import numpy as np
import pytest
import torch

import veles_tpu_torch.config as P_config
import veles_tpu_torch.prng as P_prng
from torch_farm_duck import FarmMaster, run_arm, run_chaos_arm
from veles_tpu_torch.backends import Device
from veles_tpu_torch.checkpoint import CheckpointStore, capture_object
from veles_tpu_torch.distributed import Coordinator, Worker, resume_farm
from veles_tpu_torch.distributed.faults import FaultPlan, corrupt_shard
from veles_tpu_torch.ensemble import EnsembleTrainerWorkflow
from veles_tpu_torch.genetics import OptimizationWorkflow, Range, Tuneable
from veles_tpu_torch.models.lm import TransformerWorkflow
from veles_tpu_torch.models.mnist import MnistWorkflow
from veles_tpu_torch.models.transformer import _tree_leaves

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _f32_and_fresh_streams():
    root = P_config.root
    saved = (root.common.engine.compute_type, root.common.random.seed)
    root.common.engine.compute_type = "float32"
    root.common.random.seed = 7
    P_prng.reset()
    yield
    root.common.engine.compute_type, root.common.random.seed = saved
    P_prng.reset()


@pytest.fixture
def device():
    return Device(backend="cpu")


def _farm(master, make_worker, timeout=180.0, job_timeout=30):
    """Run ``master`` under a coordinator with one in-process worker
    built by ``make_worker``; returns (finished, worker jobs)."""
    coordinator = Coordinator(master, "127.0.0.1:0",
                              job_timeout=job_timeout)
    coordinator.start()
    results = {}

    def work():
        try:
            results["n"] = Worker(make_worker(), coordinator.address).run()
        except Exception as e:  # noqa: BLE001 — surfaced by the asserts
            results["n"] = repr(e)

    thread = threading.Thread(target=work, daemon=True)
    thread.start()
    finished = coordinator.run(timeout)
    coordinator.stop()
    thread.join(timeout=10)
    return finished, results.get("n")


# -- the LM workflow --------------------------------------------------------

def _lm(stream=None):
    kwargs = dict(n_tokens=16 * 33 * 8)
    if stream:
        kwargs["prng_stream"] = stream
    wf = TransformerWorkflow(max_epochs=2, fail_iterations=100,
                             loader_kwargs=kwargs)
    wf.thread_pool = None
    return wf


def _lm_params(wf):
    return [t.detach().numpy().copy()
            for t in _tree_leaves(wf.trainer_unit._trainer_.params)]


def test_lm_farm_matches_standalone(device):
    """One worker shipping the trainer state both ways: the farmed LM
    trajectory is bitwise the standalone one (same seed)."""
    standalone = _lm()
    standalone.initialize(device=device)
    standalone.run()
    expected = _lm_params(standalone)

    P_prng.reset()
    master = _lm()
    master.is_standalone, master.is_master = False, True
    master.initialize(device=device)

    def make_worker():
        # its own loader stream: in-process master and worker share
        # the stream registry, and the worker must not perturb the
        # master's shuffles (its indices come from the jobs)
        wf = _lm("lm_worker_loader")
        wf.is_standalone, wf.is_slave = False, True
        wf.initialize(device=device)
        return wf

    finished, jobs = _farm(master, make_worker)
    assert finished, "cluster did not finish: %s" % (jobs,)
    assert isinstance(jobs, int) and jobs > 0
    assert bool(master.decision.complete)
    assert master.decision.min_validation_error == \
        standalone.decision.min_validation_error
    for got, want in zip(_lm_params(master), expected):
        assert got.tobytes() == want.tobytes()


# -- genetics and the ensemble ----------------------------------------------

def _sphere_tuneables():
    return [Tuneable("root.test_ga.x", Range(0.0, -5.0, 5.0)),
            Tuneable("root.test_ga.y", Range(0.0, -5.0, 5.0))]


def _sphere(values):
    return -(values["root.test_ga.x"] ** 2 + values["root.test_ga.y"] ** 2)


def test_optimization_farmed(device):
    """Chromosomes farmed to a worker over the job channel: every
    chromosome is evaluated once (the elites keep their fitness), and
    the farm's best is the standalone run's."""
    def mk(mode):
        wf = OptimizationWorkflow(evaluate=_sphere, size=8, generations=3,
                                  tuneables=_sphere_tuneables())
        wf.thread_pool = None
        if mode != "standalone":
            wf.is_standalone = False
            setattr(wf, "is_%s" % mode, True)
        wf.initialize(device=device)
        return wf

    standalone = mk("standalone")
    standalone.run()
    want = standalone.gather_results()
    P_prng.reset()
    master = mk("master")

    def make_worker():
        P_prng.reset()   # a worker process would have its own streams
        return mk("slave")

    finished, jobs = _farm(master, make_worker, timeout=120)
    assert finished, "GA cluster did not finish: %s" % (jobs,)
    # gen0 evaluates all 8; later gens reuse the 2 elites' fitness
    assert jobs == 8 + 2 * (8 - 2)
    assert master.optimizer.population.generation == 3
    assert master.gather_results() == want


def test_ensemble_farmed(device):
    """Three members trained by a worker, one job each."""
    def factory(index, seed, train_ratio):
        P_config.root.common.random.seed = seed
        P_prng.reset()
        wf = MnistWorkflow(layers=(16, 10), max_epochs=1, loader_kwargs=dict(
            n_train=200, n_valid=80, minibatch_size=40,
            train_ratio=train_ratio))
        wf.thread_pool = None
        wf.initialize(device=device)
        wf.run()
        return wf

    def mk(mode):
        wf = EnsembleTrainerWorkflow(model_factory=factory, size=3,
                                     train_ratio=0.8)
        wf.thread_pool = None
        wf.is_standalone = False
        setattr(wf, "is_%s" % mode, True)
        wf.initialize(device=device)
        return wf

    master = mk("master")
    finished, jobs = _farm(master, lambda: mk("slave"), job_timeout=60)
    assert finished, "ensemble cluster did not finish: %s" % (jobs,)
    assert jobs == 3
    assert all(m is not None for m in master.members)


# -- farm checkpoints -------------------------------------------------------

def test_resume_farm_named_manifest_restores_that_generation(tmp_path):
    """resume_farm(dir) restores the newest commit; resume_farm(a named
    manifest) restores THAT generation (the roll-back form)."""
    store = CheckpointStore(str(tmp_path), prefix="farm", keep=4)
    for step in (1, 2, 3):
        payload, buffers = capture_object({"step": step})
        store.commit(obj_payload=payload, obj_buffers=buffers,
                     meta={"applied": step, "active_wids": []})
    gens = store.generations()
    obj, meta, gen = resume_farm(str(tmp_path))
    assert obj["step"] == 3 and gen == gens[-1]
    obj, meta, gen = resume_farm(store._manifest_path(gens[0]))
    assert obj["step"] == 1 and gen == gens[0] and meta["applied"] == 1


def test_farm_checkpoints_fall_back_past_a_corrupt_shard(tmp_path, caplog):
    """A farm that checkpoints every 4 applied updates; the newest
    generation's shard is corrupted (``corrupt_shard``), and
    ``resume_farm`` restores the generation before it, whose master has
    applied fewer jobs."""
    r = run_arm(2, 24, 20000, 1.0, pipeline=True, max_outstanding=2,
                wire_version=2, param_skip=True, encoding="none",
                checkpoint_dir=str(tmp_path), checkpoint_every=4,
                timeout=120)
    assert r["conserved"] == 1
    store = CheckpointStore(str(tmp_path), prefix="farm")
    gens = store.generations()
    assert len(gens) >= 2
    newest, _, newest_gen = resume_farm(str(tmp_path))
    assert newest_gen == gens[-1]
    path = corrupt_shard(str(tmp_path), prefix="farm", generation=gens[-1])
    assert path.endswith(".shard")
    with caplog.at_level(logging.WARNING):
        master, meta, gen = resume_farm(str(tmp_path))
    assert gen == gens[-2]
    assert isinstance(master, FarmMaster)
    assert master.applied < newest.applied
    assert meta["applied"] == master.applied
    assert any("corrupt" in rec.message and "falling back" in rec.message
               for rec in caplog.records)


def test_coordinator_killed_and_resumed_serves_every_job_once(tmp_path):
    """Two workers die by the plan and the coordinator is crash-killed
    between checkpoints, then resumed from its last committed
    generation on the same port: every job is applied exactly once."""
    r = run_chaos_arm(3, 48, 20000, 1.0, max_outstanding=2,
                      checkpoint_dir=str(tmp_path), timeout=120)
    assert r["conserved"] == 1
    assert r["worker_kills"] == 2
    assert r["resume_generation"] >= 1


def test_fault_plan_arms_the_checkpoint_store(tmp_path):
    """``hang-save@G`` installs the store's pre-commit hook: the shards
    of generation G are written, its manifest is not (here the hang is
    a short sleep)."""
    store = CheckpointStore(str(tmp_path), prefix="farm")
    FaultPlan("hang-save@2").arm_checkpoint_store(store, hang_seconds=0.01)
    assert store.mid_commit_hook is not None
    store.commit(arrays={"a": np.zeros(8, np.float32)})
    store.commit(arrays={"a": np.ones(8, np.float32)})
    arrays, _, _, gen = store.load_latest()
    assert gen == 2 and arrays["a"][0] == 1.0



# -- the launcher -----------------------------------------------------------

def _launched(mode, **kwargs):
    from veles_tpu_torch.launcher import Launcher
    launcher = Launcher(mode=mode, **kwargs)
    wf = MnistWorkflow(launcher, layers=(16, 10), max_epochs=1,
                       loader_kwargs={"n_train": 120, "n_valid": 40,
                                      "minibatch_size": 40})
    wf.thread_pool = None
    return launcher, wf


def test_launcher_standalone_boot_trains():
    """Standalone: initialize on the named backend, run, stop; the
    workflow sees the launcher's mode."""
    launcher, wf = _launched("standalone")
    launcher.boot(backend="cpu")
    assert wf.is_standalone and not wf.is_master and not wf.is_slave
    assert bool(wf.decision.complete)
    assert launcher.device.backend_name == "cpu"


@pytest.mark.parametrize("mode,flags", [("coordinator", (True, False)),
                                        ("worker", (False, True))])
def test_launcher_farm_modes(mode, flags):
    launcher, wf = _launched(mode)
    launcher.initialize(backend="cpu")
    try:
        assert (wf.is_master, wf.is_slave) == flags
        assert not wf.is_standalone
    finally:
        launcher.stop()


def test_launcher_joins_through_multiprocess(monkeypatch):
    """``mesh_join`` goes through ``parallel.multiprocess.initialize``
    with the caller's membership."""
    from veles_tpu_torch.parallel import multiprocess
    joined = []
    monkeypatch.setattr(multiprocess, "initialize",
                        lambda **kw: joined.append(kw))
    join = dict(coordinator="127.0.0.1:1", num_processes=1, process_id=0,
                backend="gloo", device="cpu")
    launcher, _ = _launched("standalone", mesh_join=join)
    launcher.initialize(backend="cpu")
    launcher.stop()
    assert joined == [join]


@pytest.mark.parametrize("key", ["graphics.dir", "web.status_url"])
def test_launcher_unported_services_raise(key, tmp_path):
    """The graphics server and the status reporter, refused before the
    services were ported, start under the Launcher now:
    ``graphics.dir`` spawns the renderer child, which writes the
    plotters' PNGs (or ``plots.jsonl`` without matplotlib) there;
    ``web.status_url`` posts status documents to a web-status server.
    Both stop with the launcher. (The name is the refusal test's, kept
    so that this case replaces it one for one.)"""
    import json
    import os
    import urllib.request

    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.web_status import WebStatusServer
    common = P_config.root.common
    status = WebStatusServer() if key == "web.status_url" else None
    if status is not None:
        common.web.status_url = status.url
        common.web.status_interval = 0.1
    else:
        common.graphics.dir = str(tmp_path / "plots")
    try:
        launcher = Launcher()
        wf = MnistWorkflow(launcher, layers=(16, 10), max_epochs=2,
                           plotters=True,
                           loader_kwargs={"n_train": 120, "n_valid": 40,
                                          "minibatch_size": 40})
        wf.thread_pool = None
        launcher.boot(backend="cpu")
        assert launcher._reporter is None and launcher._graphics is None
        if status is None:
            written = sorted(os.listdir(tmp_path / "plots"))
            assert written in (["confusion.png", "validation_error.png"],
                               ["plots.jsonl"]), written
        else:
            docs = json.load(urllib.request.urlopen(
                status.url + "/status.json", timeout=10))
            (doc,) = docs.values()
            assert doc["workflow"] == "MnistWorkflow"
            assert doc["mode"] == "standalone" and "cpu" in doc["device"]
            assert {"epoch", "best_error", "metrics"} <= set(doc)
    finally:
        common.graphics.dir = None
        common.web.status_url = None
        common.web.status_interval = 10.0
        if status is not None:
            status.close()
