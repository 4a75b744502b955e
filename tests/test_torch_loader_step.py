"""Port parity of the fused loader step on the CPU:
``FusedClassifierTrainer.make_loader_step`` of ``veles_tpu_torch``
against the JAX package's, over ``FullBatchLoader``s of the same numpy
data, and the port's own dispatch shapes against each other.

Tolerances. Against the reference (f32 on both sides, no dropout
layer: the port's masks are Philox draws, not JAX's): every loss and
every parameter after the run within 1e-4 relative to its scale (the
port's f32 parity bound; products differ from XLA's in summation order
only), and the n_err counts equal. The port against itself, with
dropout on: bitwise. The loader step gathers through the loader's own
``gather`` and takes the ops of ``step``, on the same counters,
dropout keys and learning rates, so K steps a dispatch, the
two-dispatch path (``loader.run()`` + ``trainer.step`` on the served
minibatch) and K single loader steps give identical bits.
"""

import numpy as np
import pytest
import torch

import veles_tpu.accelerated_units as R_acc
import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.loader.fullbatch as R_fullbatch
import veles_tpu.models.flagship as JF
import veles_tpu.parallel.fused as JFused
import veles_tpu.prng as R_prng
import veles_tpu_torch.accelerated_units as P_acc
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.config as P_config
import veles_tpu_torch.loader.fullbatch as P_fullbatch
import veles_tpu_torch.prng as P_prng
from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.models import flagship as PF
from veles_tpu_torch.parallel.fused import FusedClassifierTrainer
from veles_tpu_torch.sched import Scheduler

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

REF = dict(acc=R_acc, backends=R_backends, fullbatch=R_fullbatch)
PORT = dict(acc=P_acc, backends=P_backends, fullbatch=P_fullbatch)
HYPER = dict(learning_rate=0.1, momentum=0.9, weight_decay=5e-4)
IMAGE = (6, 6, 3)
FC_LAYERS = [{"type": "all2all_tanh", "output_sample_shape": 16},
             {"type": "softmax", "output_sample_shape": 5}]
DROPOUT_LAYERS = [
    {"type": "conv_relu", "n_kernels": 4, "kx": 3, "padding": 1},
    {"type": "max_pooling", "kx": 2, "sliding": (2, 2)},
    {"type": "all2all_relu", "output_sample_shape": 16},
    {"type": "dropout", "dropout_ratio": 0.5},
    {"type": "softmax", "output_sample_shape": 5}]


@pytest.fixture(autouse=True)
def _fresh_streams():
    saved = [c.root.common.random.seed for c in (R_config, P_config)]
    for c, p in ((R_config, R_prng), (P_config, P_prng)):
        c.root.common.random.seed = 7
        p.reset()
    yield
    for c, p, seed in zip((R_config, P_config), (R_prng, P_prng), saved):
        c.root.common.random.seed = seed
        p.reset()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _dataset(n, seed=4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        data = rng.integers(0, 256, (n,) + IMAGE, dtype=np.uint8)
    else:
        data = rng.random((n,) + IMAGE, dtype=np.float32)
    return data, rng.integers(0, 5, n).astype(np.int32)


def _loader(mods, data, labels, lengths=None, init=True, **kw):
    """A full-batch loader over ``data`` on the CPU; ``lengths`` the
    TEST/VALID/TRAIN class sizes (default: all TRAIN)."""
    lengths = lengths or [0, 0, len(data)]

    class Loader(mods["fullbatch"].FullBatchLoader):
        def load_data(self):
            self.has_labels = True
            self.original_data = data
            self.original_labels = labels
            self.class_lengths[:] = lengths

    kw.setdefault("minibatch_size", 8)
    kw.setdefault("shuffle_limit", 0)
    loader = Loader(mods["acc"].AcceleratedWorkflow(None, name="wf"), **kw)
    if init:
        assert loader.initialize(
            device=mods["backends"].Device(backend="cpu")) is None
        loader.minibatch_class = TRAIN
    return loader


def _specs(layers=FC_LAYERS):
    specs, params, _ = PF.fused_from_layer_dicts(layers, IMAGE)
    return specs, params


def _port_trainer(layers=FC_LAYERS, **kw):
    specs, params = _specs(layers)
    return FusedClassifierTrainer(specs, params, device="cpu",
                                  **dict(HYPER, **kw))


def _params(trainer):
    if isinstance(trainer, FusedClassifierTrainer):
        return trainer.params_numpy()
    return [{k: np.asarray(v) for k, v in p.items()}
            for p in trainer.params]


# ----------------------------------------------------- against the JAX one

def _run_reference_and_port(data, labels, n_steps, reupload=None,
                            **loader_kw):
    """``n_steps`` loader steps on each side; ``reupload`` (step,
    array) swaps the loader's device dataset before that step's
    serve. Returns [(losses, n_errs, params)] for the JAX side and the
    port."""
    specs, params, _ = JF.fused_from_layer_dicts(FC_LAYERS, IMAGE)
    out = []
    for mods in (REF, PORT):
        if mods is REF:
            trainer = JFused.FusedClassifierTrainer(specs, params, **HYPER)
        else:
            trainer = FusedClassifierTrainer(specs, params, device="cpu",
                                             **HYPER)
        loader = _loader(mods, data, labels, **loader_kw)
        step = trainer.make_loader_step(loader)
        losses, errs = [], []
        for i in range(n_steps):
            if reupload is not None and i == reupload[0]:
                loader._dataset_dev_ = loader.device.put(reupload[1])
            loader.run()
            m = step()
            losses.append(float(m["loss"]))
            errs.append(int(m["n_err"]))
        out.append((losses, errs, _params(trainer)))
    return out


def _assert_runs_close(ref, port):
    (rl, re_, rp), (pl, pe, pp) = ref, port
    assert pe == re_
    assert _rel(pl, rl) <= 1e-4, (pl, rl)
    for a, b in zip(pp, rp):
        for k in a:
            assert _rel(a[k], b[k]) <= 1e-4, k


@pytest.mark.parametrize("n,normalization", [
    (24, "none"),             # full minibatches, three an epoch
    (20, "linear"),           # a short tail (the padded path), stats
])
def test_loader_step_matches_reference(n, normalization):
    data, labels = _dataset(n)
    ref, port = _run_reference_and_port(
        data, labels, 7, normalization_type=normalization)
    _assert_runs_close(ref, port)


def test_loader_step_uint8_range_linear_matches_reference():
    """bench.py's dataset: uint8 pixels, range_linear 0..255 -> 0..1 on
    the way in (no cast copy: the dataset is not floating)."""
    data, labels = _dataset(24, seed=5, dtype=np.uint8)
    ref, port = _run_reference_and_port(
        data, labels, 6, normalization_type="range_linear",
        normalization_parameters=dict(source=(0.0, 255.0),
                                      interval=(0.0, 1.0)))
    _assert_runs_close(ref, port)


def test_loader_step_sees_dataset_reupload_like_reference():
    """The step reads the loader's device dataset afresh each dispatch:
    a re-upload in mid-run trains on the new data on both sides."""
    data, labels = _dataset(16, seed=11)
    fresh = _dataset(16, seed=12)[0] + 0.5
    ref, port = _run_reference_and_port(data, labels, 4,
                                        reupload=(2, fresh))
    _assert_runs_close(ref, port)
    # and the new data made a difference
    plain = _run_reference_and_port(data, labels, 4)[1]
    assert plain[0][2:] != port[0][2:]


# ------------------------------------------------ the port against itself

def _loader_steps(k, n_steps, layers=DROPOUT_LAYERS, n=20, **loader_kw):
    """``n_steps`` loader steps at K a dispatch (K = 0: the two-dispatch
    path, ``loader.run()`` then ``trainer.step`` on the served batch).
    Returns the trainer and the [n_steps] losses and n_errs."""
    P_prng.reset()  # each run shuffles from the same stream state
    data, labels = _dataset(n, seed=9)
    trainer = _port_trainer(layers)
    loader = _loader(PORT, data, labels, **loader_kw)
    losses, errs = [], []
    if k == 0:
        for _ in range(n_steps):
            loader.run()
            m = trainer.step(loader.minibatch_data.devmem,
                             loader.minibatch_labels.devmem)
            losses.append(m["loss"])
            errs.append(m["n_err"])
    else:
        step = trainer.make_loader_step(loader, steps_per_dispatch=k)
        for _ in range(n_steps // k):
            if k == 1:
                loader.run()
            m = step()
            losses.extend(m["loss"].reshape(-1))
            errs.extend(m["n_err"].reshape(-1))
    return trainer, torch.stack(losses), torch.stack(errs)


def _assert_bitwise(a, b):
    (ta, la, ea), (tb, lb, eb) = a, b
    assert torch.equal(la, lb) and torch.equal(ea, eb)
    for pa, pb in zip(ta.params, tb.params):
        for k in pa:
            assert torch.equal(pa[k], pb[k])
    for va, vb in zip(ta.velocity, tb.velocity):
        for k in va:
            assert torch.equal(va[k], vb[k])
    assert ta._step_counter == tb._step_counter


def test_loader_step_equals_two_dispatch_path_bitwise():
    """Dropout on, short tails included: the fused loader step and the
    loader's own serve + ``step`` give identical bits."""
    _assert_bitwise(_loader_steps(1, 6), _loader_steps(0, 6))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("shuffle_limit", [0, 3])
def test_k_steps_a_dispatch_equal_k_single_steps_bitwise(shuffle_limit, k):
    """K = 2 and 3 over 12 steps cross epoch boundaries (20 samples:
    windows of 8, 8, 4), with and without reshuffles; at K = 2 a
    reshuffle falls inside a dispatch, after its first window was
    taken: each window keeps the permutation it was taken from."""
    one = _loader_steps(1, 12, shuffle_limit=shuffle_limit)
    many = _loader_steps(k, 12, shuffle_limit=shuffle_limit)
    _assert_bitwise(many, one)
    assert many[1].shape == (12,)


def test_trainer_knob_is_the_default_k():
    data, labels = _dataset(16)
    trainer = _port_trainer(steps_per_dispatch=2)
    step = trainer.make_loader_step(_loader(PORT, data, labels))
    out = step()
    assert out["loss"].shape == (2,) and trainer._step_counter == 2
    loader = _loader(PORT, data, labels)
    single = _port_trainer().make_loader_step(loader)
    loader.run()
    assert single()["loss"].shape == ()


def test_loader_step_counts_nonfinite_like_step():
    """A NaN in the data: ``skip`` leaves the params bitwise untouched
    and the counter sees the step, as ``step`` does."""
    data, labels = _dataset(8)
    data[3, 0, 0, 0] = np.nan
    trainer = _port_trainer(nan_policy="skip")
    before = trainer.params_numpy()
    loader = _loader(PORT, data, labels)
    step = trainer.make_loader_step(loader)
    loader.run()
    assert int(step()["nonfinite"]) == 1
    assert trainer.nonfinite_count == 1
    for a, b in zip(before, trainer.params_numpy()):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------- guards and knobs

def test_external_gather_guard_is_loud_and_lossless():
    """While the flag is set, a VALID minibatch raises and goes back on
    ``failed_minibatches``; once the flag is cleared the same window is
    served normally. TRAIN windows serve bookkeeping only."""
    data, labels = _dataset(24)
    loader = _loader(PORT, data, labels, lengths=[0, 8, 16])
    trainer = _port_trainer()
    step = trainer.make_loader_step(loader)
    assert loader.external_gather
    stale = loader.minibatch_data.devmem
    with pytest.raises(RuntimeError, match="validation minibatch"):
        loader.run()
    assert loader.failed_minibatches == [(8, 8)]
    loader.external_gather = False
    loader.run()
    assert loader.minibatch_class == VALID
    assert (loader.minibatch_offset, loader.minibatch_size) == (8, 8)
    expect = loader.gather(0, 8)[0]
    assert torch.equal(loader.minibatch_data.devmem, expect)
    assert not loader.failed_minibatches
    loader.external_gather = True
    loader.run()                      # TRAIN: bookkeeping, no serve
    assert loader.minibatch_class == TRAIN
    served = loader.minibatch_data.devmem
    assert served is not stale and torch.equal(served, expect)
    assert np.isfinite(float(step()["loss"]))


def test_mse_loader_refuses_external_gather():
    class Targets(P_fullbatch.FullBatchLoaderMSE):
        def load_data(self):
            self.original_data = np.zeros((8, 3), np.float32)
            self.original_targets = np.zeros((8, 2), np.float32)
            self.class_lengths[:] = [0, 0, 8]

    loader = Targets(P_acc.AcceleratedWorkflow(None, name="wf"),
                     minibatch_size=4)
    assert loader.initialize(device=P_backends.Device(backend="cpu")) \
        is None
    loader.external_gather = True
    with pytest.raises(RuntimeError, match="MSE"):
        loader.run()


def test_uninitialized_loader_and_bad_k_raise():
    data, labels = _dataset(8)
    trainer = _port_trainer()
    loader = _loader(PORT, data, labels, init=False)
    with pytest.raises(RuntimeError, match="initialized loader"):
        trainer.make_loader_step(loader)
    assert not loader.external_gather
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        trainer.make_loader_step(_loader(PORT, data, labels),
                                 steps_per_dispatch=0)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        _port_trainer(steps_per_dispatch=0)


@pytest.mark.parametrize("k", [1, 4])
def test_loader_step_is_one_quantum_a_dispatch(k):
    """With ``sched_tenant`` set, each dispatch (K steps) is one
    quantum, and the trajectory is bitwise the free-running one."""
    sched = Scheduler()
    try:
        tenant = sched.register("train")
        scheduled = _port_trainer(DROPOUT_LAYERS)
        scheduled.sched_tenant = tenant
        data, labels = _dataset(20, seed=9)
        loader = _loader(PORT, data, labels)
        step = scheduled.make_loader_step(loader, steps_per_dispatch=k)
        losses = []
        for _ in range(8 // k):
            if k == 1:
                loader.run()
            losses.extend(step()["loss"].reshape(-1))
        assert sched.snapshot()["tenants"]["train"]["quanta"] == 8 // k
        free = _loader_steps(1, 8)
        assert torch.equal(torch.stack(losses), free[1])
    finally:
        sched.stop()
