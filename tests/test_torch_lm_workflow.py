"""Port parity of the LM workflow (``veles_tpu_torch.models.lm`` against
``veles_tpu.models.lm``), on the CPU.

The reference's default configuration (vocab 64, embed 64, 2 heads, 2
layers, seq_len 32, f32) with its corpus cut to 8 minibatches of 16
windows (``n_tokens`` 16 x 33 x 8; the reference tests cut theirs the
same way): the per-epoch TRAIN and VALID losses and
``min_validation_error`` agree with the reference's within 1e-4
relative (the weights and the corpus are bitwise the reference's; the
two frameworks sum in different orders, ``tests/test_torch_train.py``).
Killed after its epoch-2 snapshot and resumed, the port's run is
bitwise its uninterrupted run. An lr policy reaches the trainer, the
job methods round-trip the trainer state in-process, and a restore
copies into the trainer's own tensors (the captured step reads them by
address).
"""

import glob

import numpy as np
import pytest
import torch

import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.models.lm as R_lm
import veles_tpu.prng as R_prng
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.config as P_config
import veles_tpu_torch.models.lm as P_lm
import veles_tpu_torch.prng as P_prng
from veles_tpu_torch.models.transformer import _tree_leaves
from veles_tpu_torch.snapshotter import Snapshotter

torch.set_num_threads(1)

TOL = 1e-4
LOADER = dict(n_tokens=16 * 33 * 8)

REF = dict(backends=R_backends, prng=R_prng, lm=R_lm)
PORT = dict(backends=P_backends, prng=P_prng, lm=P_lm)


@pytest.fixture(autouse=True)
def _fresh_streams():
    saved = [c.root.common.random.seed for c in (R_config, P_config)]
    for c in (R_config, P_config):
        c.root.common.random.seed = 7
    yield
    for c, p, seed in zip((R_config, P_config), (R_prng, P_prng), saved):
        c.root.common.random.seed = seed
        p.reset()


def _mk(mods, max_epochs, snapdir=None, **kwargs):
    mods["prng"].reset()
    wf = mods["lm"].TransformerWorkflow(
        max_epochs=max_epochs, fail_iterations=100,
        loader_kwargs=dict(LOADER, **kwargs.pop("loader_kwargs", {})),
        snapshot_dir=str(snapdir) if snapdir else None,
        snapshot_prefix="lm", **kwargs)
    wf.thread_pool = None
    return wf


def _train(mods, max_epochs, snapdir=None, **kwargs):
    wf = _mk(mods, max_epochs, snapdir, **kwargs)
    wf.initialize(device=mods["backends"].Device(backend="cpu"))
    wf.run()
    return wf


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _params(wf):
    return [t.detach().numpy().copy()
            for t in _tree_leaves(wf.trainer_unit._trainer_.params)]


def test_lm_workflow_matches_reference():
    ref = _train(REF, 3)
    port = _train(PORT, 3)
    assert bool(port.decision.complete)
    for klass in (1, 2):
        got = port.decision.epoch_errors[klass]
        want = ref.decision.epoch_errors[klass]
        assert len(got) == len(want) and got
        assert _rel(got, want) < TOL, (klass, got, want)
    assert _rel(port.decision.min_validation_error,
                ref.decision.min_validation_error) < TOL
    assert port.decision.min_validation_epoch == \
        ref.decision.min_validation_epoch
    results = port.gather_results()
    assert results["epochs"] == ref.gather_results()["epochs"]
    assert results["min_validation_loss"] == pytest.approx(
        ref.gather_results()["min_validation_loss"], rel=TOL)


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    wf_a = _train(PORT, 3, tmp_path)
    snaps = sorted(glob.glob(str(tmp_path / "lm_2_*.pickle.gz")))
    assert snaps, sorted(glob.glob(str(tmp_path / "*")))
    P_prng.reset()
    wf_b = Snapshotter.load(snaps[0])
    assert wf_b._restored_from_snapshot_
    assert wf_b.trainer_unit._saved_state["step_count"] == 16
    wf_b.thread_pool = None
    wf_b.stopped = False
    wf_b.initialize(device=P_backends.Device(backend="cpu"))
    wf_b.run()
    assert wf_b.decision.epoch_errors == wf_a.decision.epoch_errors
    assert wf_b.decision.min_validation_error == \
        wf_a.decision.min_validation_error
    for a, b in zip(_params(wf_a), _params(wf_b)):
        assert a.tobytes() == b.tobytes()
    for tree in ("opt_m", "opt_v"):
        for a, b in zip(_tree_leaves(getattr(wf_a.trainer_unit._trainer_,
                                             tree)),
                        _tree_leaves(getattr(wf_b.trainer_unit._trainer_,
                                             tree))):
            assert torch.equal(a, b)
    assert wf_b.trainer_unit._trainer_._step_count == \
        wf_a.trainer_unit._trainer_._step_count


def test_lr_policy_schedules_trainer():
    wf = _mk(PORT, 3, lr_policy={"type": "step", "gamma": 0.1, "every": 1},
             learning_rate=3e-3)
    wf.initialize(device=P_backends.Device(backend="cpu"))
    assert wf.trainer_unit.learning_rate == pytest.approx(3e-3)
    wf.run()
    assert wf.trainer_unit.learning_rate < 3e-3 * 0.11
    # the trainer took the decayed rate at its TRAIN steps (the last
    # decay lands after the last step), on the device scalar too
    trainer = wf.trainer_unit._trainer_
    assert trainer.learning_rate < 3e-3 * 0.11
    assert float(trainer._lr) == pytest.approx(trainer.learning_rate)


def test_job_data_round_trips_in_process():
    """The coordinator's pieces: the master's state goes to a worker,
    the worker trains one TRAIN minibatch and ships its state back, and
    the master ends with the worker's params, Adam state and step
    count; ``resume_overrides`` applies to the LM's keys."""
    cpu = P_backends.Device(backend="cpu")
    master = _mk(PORT, 1)
    master.initialize(device=cpu)
    worker = _mk(PORT, 1, seed=3)
    worker.initialize(device=cpu)
    mu, wu = master.trainer_unit, worker.trainer_unit
    assert not all(torch.equal(a, b) for a, b in zip(
        _tree_leaves(mu._trainer_.params), _tree_leaves(wu._trainer_.params)))
    assert mu.job_data_is_param_state
    wu.apply_data_from_master(mu.generate_data_for_slave())
    for a, b in zip(_params(master), _params(worker)):
        assert a.tobytes() == b.tobytes()
    loader = worker.loader
    while True:
        loader.run()
        if loader.minibatch_class == 2:
            break
    wu.run()
    assert wu._trainer_._step_count == 1 and np.isfinite(wu.loss)
    mu.apply_data_from_slave(wu.generate_data_for_master())
    assert mu.sum_loss == wu.sum_loss and mu.loss == wu.loss
    assert mu._trainer_._step_count == 1
    for a, b in zip(_params(master), _params(worker)):
        assert a.tobytes() == b.tobytes()
    master.resume_overrides(max_epochs=5, learning_rate=1e-3)
    assert master.decision.max_epochs == 5
    assert mu.learning_rate == 1e-3
    with pytest.raises(TypeError):
        master.resume_overrides(layers=3)


def test_load_state_copies_into_the_trainer_tensors():
    """A restore keeps the trainer's tensors (a captured step reads them
    by address) and writes the snapshot's values into them."""
    wf = _mk(PORT, 1)
    wf.initialize(device=P_backends.Device(backend="cpu"))
    unit = wf.trainer_unit
    trainer = unit._trainer_
    before = [t.data_ptr() for t in _tree_leaves(trainer.params) +
              _tree_leaves(trainer.opt_m) + _tree_leaves(trainer.opt_v)]
    state = unit._host_state()
    state["params"]["embed"] = state["params"]["embed"] + 1.0
    state["step_count"] = 9
    unit._load_state(state)
    after = [t.data_ptr() for t in _tree_leaves(trainer.params) +
             _tree_leaves(trainer.opt_m) + _tree_leaves(trainer.opt_v)]
    assert before == after
    assert np.array_equal(trainer.params["embed"].detach().numpy(),
                          state["params"]["embed"])
    assert trainer._step_count == 9 and float(trainer._step) == 9.0
    host = unit._host_state()
    assert all(isinstance(a, np.ndarray)
               for a in _tree_leaves(host["params"]))


def test_mesh_waits_for_the_ports_mesh():
    """``mesh=`` takes a ``parallel.mesh.Mesh`` over a joined group (the
    meshed LM runs are tests/test_torch_parallel.py's)."""
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        P_lm.TransformerWorkflow(mesh=object())
