"""The classifier trainer's step through device scalars, on the CPU.

On the card ``FusedClassifierTrainer`` captures its step into a CUDA
graph that reads the step's dropout key, learning rate, momentum and
weight decay from device tensors the host rewrites before each replay,
and K8 reads the key from device memory (``ops.rng``'s keyed entry,
as the reference's ``_fill_tpu`` reads ``seed_ref``). The CPU has no
graphs; the eager step reads the same tensors, and the plain fill
computes the keyed bits in tensor arithmetic. These tests hold that
path to the host-keyed one (an integer key and host rates handed to
``_train_step``), to the reference trainer, and the loader's device
window gather to its host-sized gather.

Tolerances. The keyed fill against the integer-seed fill, the trainer
against the host-keyed steps and ``gather_indices`` against
``gather``: bitwise (the same integer and f32 operations on the same
values). Against the JAX trainer at dropout ratio 0 (the port's masks
are Philox draws, not JAX's): each loss within 1e-4 relative and every
parameter within 1e-4 of its scale, ``tests/test_torch_fused.py``'s
bounds.
"""

import numpy as np
import pytest
import torch

import veles_tpu.parallel.fused as JFused
import veles_tpu_torch.accelerated_units as P_acc
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.loader.fullbatch as P_fullbatch
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.models import flagship as PF
from veles_tpu_torch.ops import rng
from veles_tpu_torch.parallel import fused as PFused
from veles_tpu_torch.parallel.fused import FusedClassifierTrainer
from veles_tpu_torch.parallel.mesh import Mesh

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

# -- K8's keyed entry: the plain version ------------------------------------

SEEDS = [0, 1, 2 ** 32 - 1, 2 ** 32, 2 ** 63 - 1,
         int(np.random.default_rng(0).integers(0, 2 ** 63))]
FOLDS = [None, 0, 1, 7, 2 ** 32 + 3]
SIZES = [(1,), (3,), (4,), (5,), (128, 4096)]


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_keyed_plain_fill_equals_int_seed_fill_bitwise(seed, fold):
    """The fill keyed by an int64 tensor (its layer folded in on the
    device) gives the bits of the integer seed ``fold_in(seed,
    fold)``, at counts around the four words of a Philox block and at
    a dropout mask's size."""
    key = rng.key_tensor(seed, "cpu")
    host = seed if fold is None else rng.fold_in(seed, fold)
    for shape in SIZES:
        want = rng.uniform_fill(host, shape, device="cpu")
        got = rng.uniform_fill(key, shape, fold=fold)
        assert got.shape == want.shape and got.device.type == "cpu"
        assert torch.equal(_bits(got), _bits(want))
        # an integer seed with ``fold=`` folds on the host alike
        assert torch.equal(_bits(rng.uniform_fill(
            seed, shape, fold=fold, device="cpu")), _bits(want))


@pytest.mark.parametrize("low,high", [(0.0, 1.0), (-2.0, 3.0)])
def test_keyed_fill_scaling_and_dtype(low, high):
    key = rng.key_tensor(12345, "cpu")
    got = rng.uniform_fill(key, (7, 9), dtype=torch.bfloat16, low=low,
                           high=high, fold=3)
    want = rng.uniform_fill(rng.fold_in(12345, 3), (7, 9),
                            dtype=torch.bfloat16, low=low, high=high,
                            device="cpu")
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_write_key_rewrites_the_stream_in_place():
    """A key tensor rewritten in place (two's complement above 2^63)
    gives the new seed's stream: what a captured step sees between
    replays."""
    key = rng.key_tensor(5, "cpu")
    first = rng.uniform_fill(key, (64,), fold=1)
    ptr = key.data_ptr()
    for seed in (6, 2 ** 63, 2 ** 64 - 1):
        assert rng.write_key(key, seed) is key and key.data_ptr() == ptr
        assert int(key) & (2 ** 64 - 1) == seed
        assert torch.equal(rng.uniform_fill(key, (64,), fold=1),
                           rng.uniform_fill(rng.fold_in(seed, 1), (64,),
                                            device="cpu"))
    assert not torch.equal(rng.uniform_fill(key, (64,), fold=1), first)


def test_keyed_fill_refusals():
    key = rng.key_tensor(1, "cpu")
    with pytest.raises(ValueError, match="key tensor lies on"):
        rng.uniform_fill(key, (4,), device="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        rng.uniform_fill(key, (4,), impl="cuda")
    rng.reset_launches()
    rng.uniform_fill(key, (4,), fold=2)
    assert rng.LAUNCHES["uniform_fill"] == 0      # the plain fill


# -- the trainer's step through its device scalars --------------------------

IMAGE = (12, 12, 3)
HYPER = dict(learning_rate=0.05, momentum=0.9, weight_decay=5e-4)
LAYERS = [
    {"type": "conv_relu", "n_kernels": 4, "kx": 3, "padding": 1},
    {"type": "max_pooling", "kx": 2, "sliding": (2, 2)},
    {"type": "all2all_relu", "output_sample_shape": 16},
    {"type": "dropout", "dropout_ratio": 0.5},
    {"type": "softmax", "output_sample_shape": 5}]


def _specs(dropout=0.5):
    layers = [dict(lay, dropout_ratio=dropout) if lay["type"] == "dropout"
              else lay for lay in LAYERS]
    specs, params, _ = PF.fused_from_layer_dicts(layers, IMAGE)
    return specs, params


def _batches(k, b=6, seed=3):
    rng_ = np.random.default_rng(seed)
    return (rng_.random((k, b) + IMAGE, dtype=np.float32),
            rng_.integers(0, 5, (k, b)))


def _policy(base, epoch, step):
    """A learning rate that changes every step."""
    return base / (1.0 + 0.5 * step)


def _host_keyed(trainer, x, y, counter):
    """Step ``counter`` on ``trainer``'s state by the host-keyed path:
    the integer key and host rates handed to ``_train_step``."""
    return PFused._train_step(
        trainer.specs, trainer.params, trainer.velocity, trainer._x(x),
        trainer._labels(y), rng.fold_in(trainer.dropout_seed, counter),
        trainer._lr(counter), float(trainer.weight_decay),
        float(trainer.momentum), trainer.compute_dtype)


def _assert_state_equal(a, b):
    for pa, pb in zip(a.params + a.velocity, b.params + b.velocity):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k


def test_step_and_step_many_equal_the_host_keyed_path_bitwise():
    """Dropout 0.5 and a learning rate that changes every step: one
    ``step`` then a K = 3 ``step_many``, reading the key and the rates
    from the trainer's device scalars, give the losses, error counts
    and state of four host-keyed ``_train_step`` calls, bitwise."""
    specs, params = _specs()
    xs, ys = _batches(4)
    kw = dict(HYPER, lr_policy=_policy, dropout_seed=11, device="cpu")
    trainer = FusedClassifierTrainer(specs, params, **kw)
    one = trainer.step(xs[0], ys[0])
    many = trainer.step_many(xs[1:], ys[1:])
    got_loss = [float(one["loss"])] + many["loss"].tolist()
    got_err = [int(one["n_err"])] + many["n_err"].tolist()
    assert one["loss"].shape == () and many["loss"].shape == (3,)
    assert many["n_err"].dtype == torch.int32
    ref = FusedClassifierTrainer(specs, params, **kw)
    want = [_host_keyed(ref, xs[c - 1], ys[c - 1], c) for c in (1, 2, 3, 4)]
    assert got_loss == [float(m[0]) for m in want]
    assert got_err == [int(m[1]) for m in want]
    _assert_state_equal(trainer, ref)
    assert int(trainer._key) & (2 ** 64 - 1) == rng.fold_in(11, 4)
    assert float(trainer._lr_dev) == np.float32(trainer._lr(4))


@pytest.mark.parametrize("knob,value", [("momentum", 0.5),
                                        ("weight_decay", 0.05)])
def test_a_rate_changed_between_steps_shows_in_the_next_step(knob, value):
    """``momentum`` and ``weight_decay`` are read every step: a change
    between two steps gives the host-keyed trajectory with that change,
    not the unchanged one."""
    specs, params = _specs()
    xs, ys = _batches(2, seed=8)
    runs = {}
    for name in ("changed", "host", "unchanged"):
        t = FusedClassifierTrainer(specs, params, device="cpu", **HYPER)
        for c in (1, 2):
            if c == 2 and name != "unchanged":
                setattr(t, knob, value)
            if name == "host":
                _host_keyed(t, xs[c - 1], ys[c - 1], c)
            else:
                t.step(xs[c - 1], ys[c - 1])
        runs[name] = t
    _assert_state_equal(runs["changed"], runs["host"])
    assert not torch.equal(runs["changed"].velocity[0]["w"],
                           runs["unchanged"].velocity[0]["w"])


def test_scalar_path_trains_like_the_reference():
    """Dropout 0: a step and a K = 3 ``step_many`` with an lr policy,
    then a momentum and a weight-decay change and one more step, on
    the port's device scalars and on the JAX trainer."""
    specs, params = _specs(dropout=0.0)
    xs, ys = _batches(5, b=8, seed=4)
    kw = dict(HYPER, lr_policy={"type": "inv", "gamma": 0.1,
                                "power": 0.75})
    jt = JFused.FusedClassifierTrainer(specs, params, **kw)
    pt = FusedClassifierTrainer(specs, params, device="cpu", **kw)
    losses = []
    for t in (jt, pt):
        run = [float(t.step(xs[0], ys[0])["loss"])]
        run += [float(v) for v in t.step_many(xs[1:4], ys[1:4])["loss"]]
        t.momentum, t.weight_decay = 0.8, 1e-3
        run.append(float(t.step(xs[4], ys[4])["loss"]))
        losses.append(run)
    for jl, pl in zip(*losses):
        assert abs(pl - jl) <= 1e-4 * abs(jl)
    for a, b in zip(pt.params_numpy(), jt.params):
        for k in a:
            ref = np.asarray(b[k])
            assert np.abs(a[k] - ref).max() <= \
                1e-4 * max(np.abs(ref).max(), 1e-30)


def test_load_state_copies_into_the_step_tensors():
    """``load_state`` writes into the tensors a captured step reads
    (their addresses kept), resets the momentum when none is given,
    and refuses a leaf of another shape."""
    specs, params = _specs()
    t = FusedClassifierTrainer(specs, params, device="cpu", **HYPER)
    xs, ys = _batches(1)
    t.step(xs[0], ys[0])
    ptrs = [v.data_ptr() for p in t.params + t.velocity for v in p.values()]
    other = FusedClassifierTrainer(specs, _specs()[1], device="cpu",
                                   dropout_seed=4, **HYPER)
    other.step(xs[0], ys[0])
    t.load_state(other.params_numpy(), step=9)
    assert [v.data_ptr() for p in t.params + t.velocity
            for v in p.values()] == ptrs
    assert t._step_counter == 9
    for a, b in zip(t.params, other.params):
        for k in a:
            assert torch.equal(a[k], b[k]) and a[k].requires_grad
    assert all(float(v.abs().sum()) == 0 for p in t.velocity
               for v in p.values())
    bad = [dict(p) for p in other.params_numpy()]
    bad[0]["w"] = bad[0]["w"][..., :2]
    with pytest.raises(ValueError, match="state leaf of shape"):
        t.load_state(bad)


class _TwoRanks(Mesh):
    """A two-rank mesh as the trainer's constructor sees it (no process
    group is joined: the refusal comes first)."""
    n_devices = 2
    backend = "gloo"
    device = torch.device("cpu")

    def __init__(self):
        pass


def test_cuda_graphs_true_on_a_mesh_of_two_ranks_raises():
    specs, params = _specs()
    with pytest.raises(ValueError, match="mesh of 2 ranks"):
        FusedClassifierTrainer(specs, params, mesh=_TwoRanks(),
                               cuda_graphs=True)


# -- the loader's device window ----------------------------------------------

def _loader(n=20, labels=True, mbs=8):
    data_rng = np.random.default_rng(6)
    data = data_rng.random((n,) + IMAGE, dtype=np.float32)
    targets = data_rng.integers(0, 5, n).astype(np.int32)

    class Loader(P_fullbatch.FullBatchLoader):
        def load_data(self):
            self.has_labels = labels
            self.original_data = data
            if labels:
                self.original_labels = targets
            self.class_lengths[:] = [0, 0, n]

    loader = Loader(P_acc.AcceleratedWorkflow(None, name="wf"),
                    minibatch_size=mbs, shuffle_limit=0,
                    normalization_type="mean_disp")
    assert loader.initialize(device=P_backends.Device(backend="cpu")) \
        is None
    loader.minibatch_class = TRAIN
    return loader


@pytest.mark.parametrize("labels", [True, False])
@pytest.mark.parametrize("size", [8, 5, 1])
def test_gather_indices_equals_gather_bitwise(labels, size):
    """The device-sized gather of a permutation's window equals the
    host-sized gather, and both equal the rows normalized and then
    masked by assignment: zeroed padding rows and -1 labels."""
    loader = _loader(labels=labels)
    loader.run()
    perm = loader._perm_dev_
    for start in (0, 8, 12):
        want = loader.gather(start, size)
        idx = perm[start:start + loader.max_minibatch_size]
        got = loader.gather_indices(
            idx, None if size == len(idx) else torch.tensor(size))
        assert len(want) == len(got) == 2
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        rows = loader.normalizer.apply_torch(
            loader._dataset_dev_.index_select(0, idx), loader._stats_dev_)
        rows[size:] = 0
        assert torch.equal(got[0], rows)
        if labels:
            plain = loader._labels_dev_.index_select(0, idx)
            plain[size:] = -1
            assert torch.equal(got[1], plain)
        else:
            assert not got[1].any()
