"""Port parity of crash-safe checkpointing (``veles_tpu_torch.checkpoint``
against ``veles_tpu.checkpoint``), on the CPU.

The reference's store and writer cases run on the port: round trips,
sharding and restacking, resume on another shard count, the crc
fallback, the invisible uncommitted generation, GC, coalescing, save
after stop and a SIGKILL inside the commit window (a subprocess).
Two cases are the port's own. The on-disk format is the reference's:
each package reads the arrays-only store the other wrote, bitwise.
And a tensor updated in place after ``save()`` returns is written with
its value at capture (the port's trainers update their tensors in
place, where the reference's JAX arrays are immutable and are captured
by reference). The card's version of that case, a CUDA tensor cloned
on the device at capture, is in ``tests/test_torch_cuda.py``.
"""

import glob
import json
import logging
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import veles_tpu.checkpoint as R_ckpt
from veles_tpu_torch.checkpoint import (AsyncCheckpointer, CheckpointStore,
                                        CheckpointUnavailable, atomic_file,
                                        capture_object, dumps_host, reshard)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def corrupt_shard(directory, prefix, generation, offset=16):
    """Flip one byte of the first shard of a committed generation."""
    gdir = os.path.join(directory, "%s-%06d" % (prefix, generation))
    path = sorted(glob.glob(os.path.join(gdir, "*.shard")))[0]
    with open(path, "rb+") as f:
        f.seek(min(offset, max(os.path.getsize(path) - 1, 0)))
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    return path


# -- CheckpointStore -------------------------------------------------------

def test_store_round_trip_arrays_and_meta(tmp_path):
    store = CheckpointStore(str(tmp_path), prefix="t")
    a = np.arange(2048, dtype=np.float32).reshape(64, 32)
    b = np.array([1, 2, 3], dtype=np.int32)
    gen = store.commit(arrays={"a": a, "b": b}, meta={"step": 41})
    arrays, obj, meta, loaded_gen = store.load_latest()
    assert loaded_gen == gen and obj is None
    assert meta["step"] == 41
    np.testing.assert_array_equal(arrays["a"], a)
    np.testing.assert_array_equal(arrays["b"], b)
    assert arrays["a"].dtype == np.float32


def test_store_shards_large_arrays_and_restacks(tmp_path):
    store = CheckpointStore(str(tmp_path), prefix="t", shard_bytes=1024)
    a = np.random.default_rng(3).standard_normal(
        (64, 32)).astype(np.float32)          # 8 KiB -> 8 shards
    gen = store.commit(arrays={"w": a})
    shard_files = glob.glob(str(tmp_path / ("t-%06d" % gen) / "*.shard"))
    assert len(shard_files) >= 4
    arrays, _, _, _ = store.load_latest()
    assert arrays["w"].tobytes() == a.tobytes()


def test_resume_on_different_shard_count(tmp_path):
    """An 8-way pre-sharded capture restores to its logical array, and
    re-splits for 1, 2 and 16 shards concatenate back to it."""
    store = CheckpointStore(str(tmp_path), prefix="t", shard_bytes=512)
    logical = np.random.default_rng(5).standard_normal(
        (32, 16)).astype(np.float32)
    store.commit(arrays={"w": list(np.array_split(logical, 8))})
    arrays, _, _, _ = store.load_latest()
    np.testing.assert_array_equal(arrays["w"], logical)
    for num_shards in (1, 2, 16):
        parts = reshard(arrays["w"], num_shards)
        assert len(parts) == num_shards
        np.testing.assert_array_equal(np.concatenate(parts, axis=0),
                                      logical)


def test_store_object_capture_round_trip(tmp_path):
    store = CheckpointStore(str(tmp_path), prefix="t")
    state = {"weights": np.random.default_rng(1).standard_normal(
        500).astype(np.float32), "epoch": 3, "name": "wf"}
    payload, buffers = capture_object(state)
    assert buffers, "numpy buffers should leave the pickle out of band"
    store.commit(obj_payload=payload, obj_buffers=buffers,
                 meta={"kind": "object"})
    _, obj, meta, _ = store.load_latest()
    assert obj["epoch"] == 3 and obj["name"] == "wf"
    np.testing.assert_array_equal(obj["weights"], state["weights"])


def test_host_pickler_refuses_device_tensors():
    """Snapshots hold host data only: the pickler refuses a tensor that
    is not on the CPU (a meta tensor stands in for a CUDA one here)."""
    assert dumps_host({"a": np.ones(3)})
    with pytest.raises(TypeError, match="host data only"):
        dumps_host({"t": torch.empty(3, device="meta")})
    with pytest.raises(TypeError, match="host data only"):
        capture_object([torch.empty(2, device="meta")])


def test_corrupt_shard_falls_back_to_previous_generation(tmp_path, caplog):
    store = CheckpointStore(str(tmp_path), prefix="t")
    a = np.arange(512, dtype=np.float32)
    store.commit(arrays={"a": a}, meta={"step": 1})
    gen2 = store.commit(arrays={"a": a * 2}, meta={"step": 2})
    corrupt_shard(str(tmp_path), "t", gen2)
    with caplog.at_level(logging.WARNING):
        arrays, _, meta, gen = store.load_latest()
    assert meta["step"] == 1 and gen == gen2 - 1
    np.testing.assert_array_equal(arrays["a"], a)
    assert any("corrupt" in r.message and "falling back" in r.message
               for r in caplog.records)


def test_every_generation_corrupt_raises(tmp_path):
    store = CheckpointStore(str(tmp_path), prefix="t", keep=2)
    store.commit(arrays={"a": np.ones(64, np.float32)})
    gen2 = store.commit(arrays={"a": np.zeros(64, np.float32)})
    corrupt_shard(str(tmp_path), "t", gen2 - 1)
    corrupt_shard(str(tmp_path), "t", gen2)
    with pytest.raises(CheckpointUnavailable):
        store.load_latest()


def test_uncommitted_generation_is_invisible(tmp_path):
    store = CheckpointStore(str(tmp_path), prefix="t")
    a = np.arange(64, dtype=np.float32)
    store.commit(arrays={"a": a}, meta={"step": 1})
    marker = {}

    def crash_hook(gen):
        marker["gen"] = gen
        raise RuntimeError("simulated crash before manifest commit")

    store.mid_commit_hook = crash_hook
    with pytest.raises(RuntimeError):
        store.commit(arrays={"a": a * 7}, meta={"step": 2})
    store.mid_commit_hook = None
    assert os.path.isdir(str(tmp_path / ("t-%06d" % marker["gen"])))
    arrays, _, meta, _ = store.load_latest()
    assert meta["step"] == 1
    np.testing.assert_array_equal(arrays["a"], a)
    # a later commit takes the next number and GC drops the orphan
    gen3 = store.commit(arrays={"a": a * 3}, meta={"step": 3})
    assert gen3 == marker["gen"] + 1
    assert not os.path.isdir(str(tmp_path / ("t-%06d" % marker["gen"])))


def test_named_generation_and_max_generation(tmp_path):
    store = CheckpointStore(str(tmp_path), prefix="t", keep=4)
    for step in (1, 2, 3):
        store.commit(arrays={"a": np.full(4, step, np.float32)},
                     meta={"step": step})
    gens = store.generations()
    assert store.load_latest()[2]["step"] == 3
    assert store.load_latest(max_generation=gens[0])[2]["step"] == 1
    assert store.load_generation(gens[1])[2]["step"] == 2


def test_gc_keeps_configured_generations(tmp_path):
    store = CheckpointStore(str(tmp_path), prefix="t", keep=2)
    for step in range(5):
        store.commit(arrays={"a": np.full(32, step, np.float32)},
                     meta={"step": step})
    assert len(store.generations()) == 2
    _, _, meta, _ = store.load_latest()
    assert meta["step"] == 4


def test_atomic_file_crash_leaves_previous_content(tmp_path):
    path = str(tmp_path / "state.bin")
    with atomic_file(path) as f:
        f.write(b"generation-1")
    with pytest.raises(RuntimeError):
        with atomic_file(path) as f:
            f.write(b"gener")
            raise RuntimeError("crash mid-save")
    with open(path, "rb") as f:
        assert f.read() == b"generation-1"
    assert not glob.glob(str(tmp_path / "*.tmp.*"))


# -- the format, across the two packages ----------------------------------

def _arrays():
    rng = np.random.default_rng(11)
    return {"w": rng.standard_normal((48, 16)).astype(np.float32),
            "i": np.arange(7, dtype=np.int32),
            "d": rng.standard_normal(5)}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_stores_read_each_other_bitwise(tmp_path, writer):
    """An arrays-only store (sharded at 512 bytes) written by one
    package loads in the other with the same names, dtypes, shapes and
    bytes, and the same meta; the manifests list the same shards."""
    arrays = _arrays()
    cls = {"reference": R_ckpt.CheckpointStore,
           "port": CheckpointStore}
    other = "port" if writer == "reference" else "reference"
    cls[writer](str(tmp_path / "w"), prefix="x",
                shard_bytes=512).commit(arrays=arrays, meta={"step": 9})
    got, obj, meta, gen = cls[other](str(tmp_path / "w"),
                                     prefix="x").load_latest()
    assert obj is None and meta == {"step": 9} and gen == 1
    assert sorted(got) == sorted(arrays)
    for name, value in arrays.items():
        assert got[name].dtype == value.dtype, name
        assert got[name].shape == value.shape, name
        assert got[name].tobytes() == value.tobytes(), name
    # the same commit from the other package lists the same shards
    cls[other](str(tmp_path / "o"), prefix="x",
               shard_bytes=512).commit(arrays=arrays, meta={"step": 9})
    mans = []
    for sub in ("w", "o"):
        with open(str(tmp_path / sub / "x-000001.json")) as f:
            man = json.load(f)
        mans.append({k: v for k, v in man.items() if k != "created"})
    assert mans[0] == mans[1]


# -- AsyncCheckpointer -----------------------------------------------------

def test_async_save_commits_off_thread_and_stall_is_capture_only(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), prefix="ac")
    entered = []

    def slow_hook(gen):
        entered.append(gen)
        time.sleep(0.3)

    ck.store.mid_commit_hook = slow_hook
    a = np.random.default_rng(2).standard_normal(
        (256, 64)).astype(np.float32)
    t0 = time.perf_counter()
    ticket = ck.save(arrays={"w": torch.from_numpy(a.copy())})
    enqueue_s = time.perf_counter() - t0
    assert enqueue_s < 0.2
    assert ticket.wait(10.0) and ticket.error is None
    assert entered
    arrays, _, _, _ = ck.store.load_latest()
    np.testing.assert_array_equal(arrays["w"], a)
    stats = ck.stats()
    assert stats["saves_committed"] == 1
    assert stats["save_seconds"] >= 0.3
    assert stats["stall_seconds"] < 0.2
    assert stats["bytes_written"] == a.nbytes
    ck.stop()


def test_async_capture_is_immune_to_later_mutation(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), prefix="ac")
    a = np.zeros(1024, dtype=np.float32)
    ticket = ck.save(arrays={"w": a})
    a += 999.0
    assert ticket.wait(10.0)
    arrays, _, _, _ = ck.store.load_latest()
    np.testing.assert_array_equal(arrays["w"], np.zeros(1024, np.float32))
    ck.stop()


def test_async_tensor_updated_in_place_is_written_as_captured(tmp_path):
    """The port's case in place of the reference's capture by
    reference: tensors (one whole, one as shards, a bf16 one) updated
    in place right after ``save()`` returns, with the writer held in
    its commit window, are written with their values at capture."""
    ck = AsyncCheckpointer(str(tmp_path), prefix="ac")
    gate = {"hold": 0.3}
    ck.store.mid_commit_hook = lambda gen: time.sleep(gate["hold"])
    w = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    parts = [torch.ones(8, 4), torch.zeros(8, 4)]
    half = torch.full((5,), 1.5, dtype=torch.bfloat16)
    want_w = w.clone().numpy()
    ticket = ck.save(arrays={"w": w, "p": parts, "h": half})
    with torch.no_grad():
        w.mul_(-3.0).add_(1.0)
        parts[0].fill_(7.0)
        half.fill_(-2.0)
    assert ticket.wait(10.0) and ticket.error is None
    arrays, _, _, _ = ck.store.load_latest()
    assert arrays["w"].tobytes() == want_w.tobytes()
    np.testing.assert_array_equal(
        arrays["p"], np.concatenate([np.ones((8, 4)), np.zeros((8, 4))]))
    assert arrays["h"].dtype == np.float32
    np.testing.assert_array_equal(arrays["h"], np.full(5, 1.5, np.float32))
    ck.stop()


def test_async_coalesces_backlogged_saves(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), prefix="ac")
    release = {"hold": 0.2}
    ck.store.mid_commit_hook = lambda gen: time.sleep(release["hold"])
    tickets = [ck.save(arrays={"w": np.full(64, i, np.float32)})
               for i in range(5)]
    assert ck.wait(timeout=20.0)
    release["hold"] = 0.0
    assert ck.saves_superseded >= 1
    assert any(t.superseded for t in tickets[:-1])
    assert tickets[-1].error is None and not tickets[-1].superseded
    arrays, _, _, _ = ck.store.load_latest()
    np.testing.assert_array_equal(arrays["w"], np.full(64, 4, np.float32))
    ck.stop()


def test_save_after_stop_raises(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), prefix="ac")
    ck.save(arrays={"w": np.ones(8, np.float32)}, block=True)
    ck.stop()
    with pytest.raises(RuntimeError):
        ck.save(arrays={"w": np.ones(8, np.float32)})
    with pytest.raises(ValueError):
        AsyncCheckpointer(str(tmp_path), prefix="x").save()


# -- SIGKILL inside the commit window (a subprocess) -----------------------

_KILL_CHILD = r"""
import sys, time
import numpy as np
from veles_tpu_torch.checkpoint import CheckpointStore

store = CheckpointStore(sys.argv[1], prefix="kill")
weights = np.random.default_rng(1234).standard_normal(4096).astype(
    np.float32)
store.commit(arrays={"w": weights}, meta={"step": 1})
print("COMMITTED1", flush=True)
# generation 2's shards land on disk and the manifest never commits:
# the parent SIGKILLs this process inside the window
store.mid_commit_hook = lambda gen: time.sleep(600)
print("SAVING2", flush=True)
store.commit(arrays={"w": weights * 2.0}, meta={"step": 2})
print("UNREACHABLE", flush=True)
"""


def test_sigkill_mid_save_restores_previous_generation_bit_identical(
        tmp_path, caplog):
    env = dict(os.environ, PYTHONPATH=REPO)
    child = subprocess.Popen(
        [sys.executable, "-c", _KILL_CHILD, str(tmp_path)],
        stdout=subprocess.PIPE, text=True, cwd=REPO, env=env)
    try:
        assert child.stdout.readline().strip() == "COMMITTED1"
        assert child.stdout.readline().strip() == "SAVING2"
        gen2_dir = str(tmp_path / "kill-000002")
        deadline = time.time() + 60
        while time.time() < deadline and not (
                os.path.isdir(gen2_dir) and
                glob.glob(os.path.join(gen2_dir, "*.shard")) and
                os.path.exists(os.path.join(gen2_dir, "..",
                                            "kill-000001.json"))):
            time.sleep(0.01)
        assert glob.glob(os.path.join(gen2_dir, "*.shard"))
        time.sleep(0.2)  # inside the hook: shards fsynced, no manifest
        os.kill(child.pid, signal.SIGKILL)
    finally:
        child.wait(timeout=60)
        child.stdout.close()
    assert child.returncode == -signal.SIGKILL
    store = CheckpointStore(str(tmp_path), prefix="kill")
    arrays, _, meta, gen = store.load_latest()
    assert gen == 1 and meta["step"] == 1
    expected = np.random.default_rng(1234).standard_normal(
        4096).astype(np.float32)
    assert arrays["w"].tobytes() == expected.tobytes()
    gen3 = store.commit(arrays={"w": expected * 3}, meta={"step": 3})
    corrupt_shard(str(tmp_path), "kill", gen3)
    with caplog.at_level(logging.WARNING):
        arrays, _, meta, gen = store.load_latest()
    assert gen == 1 and meta["step"] == 1
    assert arrays["w"].tobytes() == expected.tobytes()
    assert any("corrupt" in r.message and "falling back" in r.message
               for r in caplog.records)
