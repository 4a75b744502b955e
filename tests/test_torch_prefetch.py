"""Port parity of the prefetching input pipeline on the CPU:
``veles_tpu_torch.loader.PrefetchingServer`` against the synchronous
loaders of both packages, its failure and shutdown discipline, and the
K-steps-a-dispatch paths it feeds.

Tolerances. The prefetched stream's bookkeeping (class, size, offset,
epoch, flags) is compared exactly; its data and labels bitwise against
the port's synchronous loader and the reference's (both gather the
same rows of the same f32 data, no normalizer). The steps it feeds:
the port against itself bitwise (``step_many`` over the ring takes the
ops of K ``step`` calls on the same batches), and against the
reference's trainers within 1e-4 relative (f32; products differ from
XLA's in summation order only). Every test ends with no producer
thread alive.
"""

import threading

import numpy as np
import pytest
import torch

import veles_tpu.accelerated_units as R_acc
import veles_tpu.backends as R_backends
import veles_tpu.loader.fullbatch as R_fullbatch
import veles_tpu.models.flagship as JF
import veles_tpu.parallel.fused as JFused
import veles_tpu_torch.accelerated_units as P_acc
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.loader.fullbatch as P_fullbatch
from veles_tpu_torch.loader import PrefetchingServer
from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.models import flagship as PF
from veles_tpu_torch.parallel.fused import FusedClassifierTrainer

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

REF = dict(acc=R_acc, backends=R_backends, fullbatch=R_fullbatch)
PORT = dict(acc=P_acc, backends=P_backends, fullbatch=P_fullbatch)
N_SAMPLES = 40
HYPER = dict(learning_rate=0.1, momentum=0.9)
LAYERS = [{"type": "all2all_tanh", "output_sample_shape": 16},
          {"type": "softmax", "output_sample_shape": 5}]


def _synth(mods):
    """8 VALID + 32 TRAIN samples of 6 features, 5 classes."""

    class SynthLoader(mods["fullbatch"].FullBatchLoader):
        def load_data(self):
            rng = np.random.default_rng(7)
            self.has_labels = True
            self.original_data = rng.random((N_SAMPLES, 6),
                                            dtype=np.float32)
            self.original_labels = (np.arange(N_SAMPLES) % 5).astype(
                np.int32)
            self.class_lengths[:] = [0, 8, 32]

    return SynthLoader


def _train_only(mods):
    class TrainOnly(mods["fullbatch"].FullBatchLoader):
        def load_data(self):
            rng = np.random.default_rng(11)
            self.has_labels = True
            self.original_data = rng.random((24, 6, 6, 3),
                                            dtype=np.float32)
            self.original_labels = rng.integers(0, 5, 24).astype(np.int32)
            self.class_lengths[:] = [0, 0, 24]

    return TrainOnly


def _make_loader(cls, mods=PORT, **kwargs):
    kwargs.setdefault("minibatch_size", 8)
    kwargs.setdefault("shuffle_limit", 0)  # deterministic serve order
    loader = cls(mods["acc"].AcceleratedWorkflow(None, name="wf"), **kwargs)
    assert loader.initialize(
        device=mods["backends"].Device(backend="cpu")) is None
    return loader


def _no_prefetch_threads():
    return not [t for t in threading.enumerate()
                if t.name.startswith("prefetch")]


def _served(loader):
    return (int(loader.minibatch_class), int(loader.minibatch_size),
            int(loader.minibatch_offset), int(loader.epoch_number),
            bool(loader.last_minibatch), bool(loader.epoch_ended),
            bool(loader.train_ended),
            np.array(loader.minibatch_data.map_read()),
            np.array(loader.minibatch_labels.map_read()))


def test_order_and_flag_parity_with_synchronous_loader():
    """The prefetched stream IS the loader's serve order: the same data,
    class/size/offset bookkeeping and flags as driving ``run()`` on the
    port's loader and on the reference's, across two epoch
    boundaries."""
    n_serves = 12  # 5 minibatches an epoch
    expect = {}
    for side, mods in (("port", PORT), ("ref", REF)):
        loader = _make_loader(_synth(mods), mods)
        expect[side] = []
        for _ in range(n_serves):
            loader.run()
            expect[side].append(_served(loader))

    with PrefetchingServer(_make_loader(_synth(PORT)), depth=3) as server:
        got = server.get_many(n_serves, timeout=60)
        assert server.stream is None  # a CPU loader: no CUDA stream

    assert [b.serial for b in got] == list(range(n_serves))
    assert any(b.minibatch_class == VALID for b in got)
    assert any(b.epoch_ended for b in got)
    for port, ref, batch in zip(expect["port"], expect["ref"], got):
        assert port[:7] == ref[:7]
        assert (batch.minibatch_class, batch.size, batch.offset,
                batch.epoch_number, batch.last_minibatch,
                batch.epoch_ended, batch.train_ended) == port[:7]
        for i, tensor in ((7, batch.data), (8, batch.labels)):
            np.testing.assert_array_equal(tensor.numpy(), port[i])
            np.testing.assert_array_equal(tensor.numpy(), ref[i])
    assert _no_prefetch_threads()


def test_host_serve_path_is_copied_and_placed():
    """A loader serving from host buffers (no device gather) has its
    reused minibatch buffer COPIED per batch and placed by the
    producer: late consumption still sees each batch's own data."""
    loader = _make_loader(_synth(PORT), store_on_device=False)
    assert loader._dataset_dev_ is None  # really the host path
    placed = []

    def place(data, labels):
        placed.append(data)
        return torch.from_numpy(data), torch.from_numpy(labels)

    with PrefetchingServer(loader, depth=4, place=place) as server:
        got = server.get_many(4, timeout=60)
    assert all(isinstance(b.data, torch.Tensor) for b in got)
    assert len(placed) >= 4
    datas = [b.data.numpy() for b in got]
    # consecutive VALID/TRAIN windows serve different samples, and no
    # batch aliases the loader's buffer
    assert not np.array_equal(datas[0], datas[1])
    assert all(not np.shares_memory(d, loader.minibatch_data.mem)
               for d in datas)
    with PrefetchingServer(_make_loader(_synth(PORT),
                                        store_on_device=False)) as default:
        batch = default.get(timeout=60)
    np.testing.assert_array_equal(batch.data.numpy(), datas[0])
    assert _no_prefetch_threads()


def test_producer_exception_propagates_to_consumer():
    class Exploding(_synth(PORT)):
        def fill_indices(self, start, size):
            if self.minibatches_served >= 2:
                raise RuntimeError("synthetic loader failure")
            return super().fill_indices(start, size)

    server = PrefetchingServer(_make_loader(Exploding), depth=2).start()
    try:
        with pytest.raises(RuntimeError, match="synthetic loader"):
            for _ in range(10):
                server.get(timeout=60)
        # sticky: later gets re-raise the ORIGINAL error, never hang
        with pytest.raises(RuntimeError, match="synthetic loader"):
            server.get(timeout=5)
    finally:
        server.stop()
    assert _no_prefetch_threads()


def test_clean_shutdown_mid_epoch():
    """stop() interrupts a producer blocked on a full ring and joins
    it: no thread survives, and a late get() raises instead of
    hanging."""
    server = PrefetchingServer(_make_loader(_synth(PORT)), depth=2).start()
    batch = server.get(timeout=60)
    assert batch.serial == 0
    server.stop()
    assert _no_prefetch_threads()
    with pytest.raises(RuntimeError, match="stopped"):
        server.get(timeout=1)
    server.stop()  # idempotent


def test_depth_validation_and_double_start():
    with pytest.raises(ValueError, match="depth"):
        PrefetchingServer(_make_loader(_synth(PORT)), depth=0)
    server = PrefetchingServer(_make_loader(_synth(PORT)), depth=1).start()
    with pytest.raises(RuntimeError, match="started"):
        server.start()
    server.stop()
    assert _no_prefetch_threads()


def _trainers():
    specs, params, _ = JF.fused_from_layer_dicts(LAYERS, (6, 6, 3))
    assert PF.fused_from_layer_dicts(LAYERS, (6, 6, 3))[0] == specs
    return (JFused.FusedClassifierTrainer(specs, params, **HYPER),
            lambda: FusedClassifierTrainer(specs, params, device="cpu",
                                           **HYPER))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _loader_losses(trainer, mods, k):
    loader = _make_loader(_train_only(mods), mods)
    loader.minibatch_class = TRAIN
    step = trainer.make_loader_step(loader, steps_per_dispatch=k)
    losses = []
    for _ in range(6 // k):
        if k == 1:
            loader.run()
        losses.extend(np.asarray(step()["loss"]).reshape(-1).tolist())
    return losses


def test_make_loader_step_k_matches_k1():
    """K steps a dispatch serve the same minibatches and reach the same
    losses as the K = 1 path: bitwise in the port, and within 1e-4 of
    the reference's K = 1 losses."""
    ref, port = _trainers()
    ref_losses = _loader_losses(ref, REF, 1)
    k1 = _loader_losses(port(), PORT, 1)
    k3 = _loader_losses(port(), PORT, 3)
    assert k3 == k1
    assert _rel(k3, ref_losses) <= 1e-4


def test_prefetch_feeds_step_many_matches_sequential():
    """The ring feeding ``step_many`` reaches the same losses and
    params as serve -> ``step()``: bitwise in the port, within 1e-4 of
    the reference's sequential path."""
    ref, port = _trainers()
    seq = {}
    for side, trainer, mods in (("ref", ref, REF), ("port", port(), PORT)):
        loader = _make_loader(_train_only(mods), mods)
        loader.minibatch_class = TRAIN
        seq[side] = []
        for _ in range(6):
            loader.run()
            m = trainer.step(loader.minibatch_data.devmem,
                             loader.minibatch_labels.devmem)
            seq[side].append(float(m["loss"]))
        seq[side + "_params"] = [{k: np.asarray(v) for k, v in p.items()}
                                 for p in trainer.params] \
            if side == "ref" else trainer.params_numpy()

    trainer_k = port()
    loader = _make_loader(_train_only(PORT))
    loader.minibatch_class = TRAIN
    k_losses = []
    with PrefetchingServer(loader, depth=2) as server:
        for _ in range(2):
            batches = server.get_many(3, timeout=60)
            m = trainer_k.step_many([b.data for b in batches],
                                    [b.labels for b in batches])
            k_losses.extend(m["loss"].tolist())
    assert k_losses == seq["port"]
    for a, b, c in zip(trainer_k.params_numpy(), seq["port_params"],
                       seq["ref_params"]):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
            assert _rel(a[key], c[key]) <= 1e-4
    assert _rel(k_losses, seq["ref"]) <= 1e-4
    assert _no_prefetch_threads()
