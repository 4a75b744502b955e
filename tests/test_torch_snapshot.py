"""Port parity of the Snapshotter (``veles_tpu_torch.snapshotter``), on
the CPU: the cases of ``tests/test_snapshot.py`` and the snapshot cases
of ``tests/test_checkpoint.py`` on the port's ``MnistWorkflow``.

A workflow killed after its epoch-2 snapshot and resumed from it ends
bitwise equal to the uninterrupted run (weights and every epoch's
errors), and the uninterrupted run's errors by epoch are the
reference's exactly (the datasets, initial weights and minibatch order
are bitwise the reference's; ``tests/test_torch_standard.py``). The
reference holds its resumed weights to rtol 1e-5 / atol 1e-6; the port
to bitwise equality. Snapshots hold host data only: the pickles of the
workflows here hold no tensor at all.
"""

import glob
import gzip
import io
import logging
import os
import pickle
import sqlite3
import time

import numpy as np
import pytest
import torch

import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.models.mnist as R_mnist
import veles_tpu.prng as R_prng
import veles_tpu_torch.config as P_config
import veles_tpu_torch.prng as prng
from veles_tpu_torch.backends import Device
from veles_tpu_torch.models.mnist import MnistWorkflow
from veles_tpu_torch.snapshotter import (Snapshotter, SnapshotterToDB,
                                         SnapshotterToDict,
                                         SnapshotUnavailable,
                                         attach_snapshotter)

torch.set_num_threads(1)

LOADER = dict(n_train=300, n_valid=100, minibatch_size=50)


@pytest.fixture(autouse=True)
def _f32_and_fresh_streams():
    saved = [(c.root.common.engine.compute_type, c.root.common.random.seed)
             for c in (R_config, P_config)]
    for c in (R_config, P_config):
        c.root.common.engine.compute_type = "float32"
        c.root.common.random.seed = 7
    R_prng.reset()
    prng.reset()
    yield
    for c, (ct, seed) in zip((R_config, P_config), saved):
        c.root.common.engine.compute_type = ct
        c.root.common.random.seed = seed
    R_prng.reset()
    prng.reset()


@pytest.fixture
def device():
    return Device(backend="cpu")


def _mk(max_epochs, snapdir=None, **snap_kwargs):
    wf = MnistWorkflow(layers=(16, 10), max_epochs=max_epochs,
                       fail_iterations=100, loader_kwargs=dict(LOADER))
    wf.thread_pool = None
    if snapdir is not None:
        attach_snapshotter(wf, prefix="mnist", directory=str(snapdir),
                           compression="gz", **snap_kwargs)
    return wf


def _weights(wf):
    return [np.array(getattr(f, a).map_read()) for f in wf.forwards
            for a in ("weights", "bias")]


def _resume(path, device):
    prng.reset()
    wf = Snapshotter.load(path)
    assert wf._restored_from_snapshot_
    assert all(u._restored_from_snapshot_ for u in wf.units)
    wf.thread_pool = None
    wf.stopped = False
    wf.initialize(device=device)
    wf.run()
    return wf


def _tensors_in(obj):
    found = []

    class Scan(pickle.Pickler):
        def reducer_override(self, o):
            if isinstance(o, torch.Tensor):
                found.append(tuple(o.shape))
            return NotImplemented

    Scan(io.BytesIO(), protocol=5).dump(obj)
    return found


def test_snapshot_files_and_symlink(tmp_path, device):
    wf = _mk(3, tmp_path)
    wf.initialize(device=device)
    wf.run()
    files = sorted(glob.glob(str(tmp_path / "mnist_*.pickle.gz")))
    assert files, "no snapshots written"
    link = tmp_path / "mnist_current.pickle.gz"
    assert link.is_symlink()
    assert (tmp_path / os.readlink(link)).exists()
    assert not glob.glob(str(tmp_path / "*.tmp.*"))
    for path in files:            # every committed file is whole
        with gzip.open(path, "rb") as f:
            pickle.load(f)
    assert _tensors_in(wf) == []


def test_kill_and_resume_matches_uninterrupted(tmp_path, device):
    """Train 4 epochs with snapshots; restore the epoch-2 snapshot and
    train to 4: bitwise the uninterrupted run, whose errors by epoch
    are the reference's."""
    wf_a = _mk(4, tmp_path)
    wf_a.initialize(device=device)
    wf_a.run()
    snaps = sorted(glob.glob(str(tmp_path / "mnist_2_*.pickle.gz")))
    assert snaps, "no epoch-2 snapshot"
    wf_b = _resume(snaps[0], device)
    assert wf_b.decision.min_validation_error == \
        wf_a.decision.min_validation_error
    assert wf_b.decision.epoch_errors == wf_a.decision.epoch_errors
    for a, b in zip(_weights(wf_a), _weights(wf_b)):
        assert a.tobytes() == b.tobytes()
    R_prng.reset()
    ref = R_mnist.MnistWorkflow(layers=(16, 10), max_epochs=4,
                                fail_iterations=100,
                                loader_kwargs=dict(LOADER))
    ref.thread_pool = None
    ref.initialize(device=R_backends.Device(backend="cpu"))
    ref.run()
    assert wf_a.decision.epoch_errors == ref.decision.epoch_errors


def test_standard_workflow_snapshot_dir(tmp_path, device):
    """``StandardWorkflow(snapshot_dir=)`` attaches the Snapshotter as
    the reference does (prefix: the class name), and its snapshots
    resume to the uninterrupted run, bitwise."""
    def mk():
        wf = MnistWorkflow(layers=(16, 10), max_epochs=3,
                           fail_iterations=100, loader_kwargs=dict(LOADER),
                           snapshot_dir=str(tmp_path))
        wf.thread_pool = None
        return wf

    wf_a = mk()
    assert isinstance(wf_a.snapshotter, Snapshotter)
    assert wf_a.snapshotter.prefix == "mnistworkflow"
    wf_a.initialize(device=device)
    wf_a.run()
    snaps = sorted(glob.glob(str(tmp_path / "mnistworkflow_1_*")))
    wf_b = _resume(snaps[0], device)
    for a, b in zip(_weights(wf_a), _weights(wf_b)):
        assert a.tobytes() == b.tobytes()


def test_restored_links_and_gates_live(tmp_path, device):
    wf = _mk(2, tmp_path)
    wf.initialize(device=device)
    wf.run()
    snaps = sorted(glob.glob(str(tmp_path / "mnist_*_*.pickle.gz")))
    wf2 = Snapshotter.load(snaps[-1])
    assert wf2.evaluator.labels is wf2.loader.minibatch_labels
    wf2.decision.complete <<= False
    assert bool(wf2.end_point.gate_block)
    wf2.decision.complete <<= True
    assert not bool(wf2.end_point.gate_block)
    assert wf2.gds[0].weights is wf2.forwards[-1].weights


def test_db_sink_round_trip(tmp_path, device):
    db = str(tmp_path / "snaps.sqlite")

    def mk(max_epochs, with_db):
        wf = _mk(max_epochs)
        if with_db:
            snap = SnapshotterToDB(wf, prefix="mnist", database=db,
                                   compression="xz")
            decision = wf.decision
            snap.link_from(decision)
            wf.gds[0].unlink_from(decision)
            wf.gds[0].link_from(snap)
            snap.gate_skip = ~(wf.loader.epoch_ended & decision.improved)
        return wf

    wf_a = mk(4, True)
    wf_a.initialize(device=device)
    wf_a.run()
    rows = SnapshotterToDB.list(db)
    assert rows and all(r["size"] > 0 for r in rows)
    epoch2 = [r for r in rows if r["suffix"].startswith("2_")]
    assert epoch2, rows
    wf_b = _resume("db://%s#mnist_%s" % (db, epoch2[-1]["suffix"]), device)
    assert wf_b.decision.epoch_errors == wf_a.decision.epoch_errors
    for a, b in zip(_weights(wf_a), _weights(wf_b)):
        assert a.tobytes() == b.tobytes()
    assert Snapshotter.load("db://%s" % db)._restored_from_snapshot_
    with pytest.raises(FileNotFoundError):
        Snapshotter.load("db://%s#missing_key" % db)


def test_db_load_uri_missing_database_is_clean(tmp_path):
    with pytest.raises(SnapshotUnavailable):
        SnapshotterToDB.load_uri(
            "db://%s#key" % (tmp_path / "missing.sqlite"))


def test_db_load_uri_locked_database_times_out_bounded(tmp_path):
    db = str(tmp_path / "snaps.sqlite")
    conn = sqlite3.connect(db)
    conn.execute(SnapshotterToDB.TABLE)
    conn.commit()
    locker = sqlite3.connect(db, isolation_level=None)
    locker.execute("BEGIN EXCLUSIVE")
    try:
        t0 = time.perf_counter()
        with pytest.raises(SnapshotUnavailable) as err:
            SnapshotterToDB.load_uri("db://%s" % db, timeout=0.05,
                                     attempts=2)
        assert time.perf_counter() - t0 < 10.0
        assert "attempts" in str(err.value)
    finally:
        locker.execute("ROLLBACK")
        locker.close()
        conn.close()


def test_nonfinite_guard_refuses_then_force_overrides(tmp_path, device):
    """A NaN'd model must not overwrite the last good restore point:
    a NaN on the host copy, then an Inf in the device tensor, are each
    refused unless ``force=True``."""
    wf = _mk(1, tmp_path)
    wf.initialize(device=device)
    wf.run()
    snap = next(u for u in wf.units if isinstance(u, Snapshotter))
    assert snap.nonfinite_params() == []
    assert os.path.exists(snap.save())
    weights = wf.forwards[0].weights
    w = np.array(weights.map_read())
    w[0, 0] = np.nan
    weights.mem = w
    weights._host_dirty_ = True
    assert snap.nonfinite_params() == ["%s.weights" % wf.forwards[0].name]
    snap.suffix = "poisoned"
    with pytest.raises(SnapshotUnavailable) as exc:
        snap.save()
    assert "force=True" in str(exc.value)
    assert not glob.glob(str(tmp_path / "mnist_poisoned*"))
    assert os.path.exists(snap.save(force=True))
    w[0, 0] = 0.0
    weights.mem = w
    weights._host_dirty_ = True
    assert not snap.nonfinite_params()
    bias = wf.forwards[1].bias
    dev = bias.devmem.clone()
    dev[1] = float("inf")
    bias.devmem = dev          # a device result, newer than the host
    assert snap.nonfinite_params() == ["%s.bias" % wf.forwards[1].name]
    snap.suffix = "healed"
    with pytest.raises(SnapshotUnavailable):
        snap.save()


def test_nonfinite_guard_reads_trainer_params(tmp_path):
    """An attached trainer's params are checked, leaf by leaf."""
    from veles_tpu_torch.models.lm import TransformerWorkflow
    from veles_tpu_torch.models.transformer import TransformerConfig
    wf = TransformerWorkflow(
        config=TransformerConfig(vocab=16, embed=16, heads=2, layers=1,
                                 seq_len=8),
        max_epochs=1, loader_kwargs=dict(n_tokens=9 * 64,
                                         minibatch_size=8))
    wf.thread_pool = None
    wf.initialize(device=Device(backend="cpu"))
    snap = Snapshotter(wf, directory=str(tmp_path), prefix="lm")
    assert snap.nonfinite_params() == []
    with torch.no_grad():
        wf.trainer_unit._trainer_.params["pos"][0, 0] = float("nan")
    bad = snap.nonfinite_params()
    assert len(bad) == 1 and "_trainer_.params" in bad[0]
    with pytest.raises(SnapshotUnavailable):
        snap.save()


def test_snapshot_load_falls_back_on_corruption(tmp_path, device, caplog):
    wf = _mk(3, tmp_path)
    wf.initialize(device=device)
    wf.run()
    snaps = sorted(glob.glob(str(tmp_path / "mnist_*_*.pickle.gz")),
                   key=os.path.getmtime)
    assert len(snaps) >= 2
    with open(snaps[-1], "rb") as f:
        head = f.read(100)
    with open(snaps[-1], "wb") as f:
        f.write(head)
    with caplog.at_level(logging.WARNING):
        restored = Snapshotter.load(snaps[-1])
    assert restored._restored_from_snapshot_
    assert any("corrupt" in r.message for r in caplog.records)
    assert any("fell back to previous snapshot" in r.message
               for r in caplog.records)


def test_snapshot_load_missing_and_unrecoverable(tmp_path):
    with pytest.raises(SnapshotUnavailable):
        Snapshotter.load(str(tmp_path / "nope_1.pickle.gz"))
    bad = tmp_path / "only_1.pickle"
    bad.write_bytes(b"\x00garbage")
    with pytest.raises(SnapshotUnavailable):
        Snapshotter.load(str(bad))
    with pytest.raises(SnapshotUnavailable):
        Snapshotter.load(str(tmp_path))          # no manifests


def test_sharded_snapshotter_round_trip(tmp_path, device):
    """``sharded=True``: the workflow goes out as crc-checked shards
    through the AsyncCheckpointer; the epoch-2 manifest restores to a
    run bitwise equal to the uninterrupted one."""
    wf_a = _mk(4, tmp_path, sharded=True)
    wf_a.initialize(device=device)
    wf_a.run()
    snap = next(u for u in wf_a.units if isinstance(u, Snapshotter))
    assert snap.checkpointer.wait(timeout=30.0)
    stats = snap.checkpointer.stats()
    assert stats["saves_committed"] >= 4 and stats["failures"] == 0
    assert stats["bytes_written"] > 0
    store = snap.checkpointer.store
    newest = store.generations()[-1]
    assert glob.glob(os.path.join(store._gen_dir(newest), "*.shard"))
    target = None
    for gen in store.generations():
        _, _, meta, _ = store.load_generation(gen)
        if meta.get("suffix", "").startswith("2"):
            target = gen
    assert target is not None, "no epoch-2 generation"
    wf_b = _resume(store._manifest_path(target), device)
    assert wf_b.decision.epoch_errors == wf_a.decision.epoch_errors
    for a, b in zip(_weights(wf_a), _weights(wf_b)):
        assert a.tobytes() == b.tobytes()
    # the directory form restores the newest generation
    assert Snapshotter.load(str(tmp_path))._restored_from_snapshot_
    wf_b.stop()
    wf_a.stop()


def test_dict_sink_round_trip(device):
    wf = _mk(1)
    wf.initialize(device=device)
    wf.run()
    snap = SnapshotterToDict(wf, prefix="d")
    key = snap.save()
    restored = SnapshotterToDict.load_key(key)
    assert restored._restored_from_snapshot_
    for a, b in zip(_weights(wf), _weights(restored)):
        assert a.tobytes() == b.tobytes()
    del SnapshotterToDict.storage[key]
