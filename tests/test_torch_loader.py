"""Port parity of the data stack on the CPU: ``veles_tpu_torch``'s
normalizers, loader base, full-batch loaders and synthetic datasets
against the JAX package's on the same seeds and numpy inputs.

Tolerances. The synthetic datasets are drawn on the host from the same
numpy generator on both sides and compared bitwise, data and labels.
The minibatch sequence over two epochs (classes, sizes, offsets,
indices, flags, labels and the served data) is compared exactly: both
sides shuffle with the same generator and gather the same rows; with
a normalizer the served data is each side's f32 arithmetic on the same
statistics and agrees within 1e-6 of its scale. The normalizers'
statistics are host numpy on both sides and compared exactly; their
application is f32 elementwise arithmetic (``exp`` included), within
1e-6 of the output's scale.
"""

import numpy as np
import pytest
import torch

import veles_tpu.accelerated_units as R_acc
import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.loader.datasets as R_datasets
import veles_tpu.loader.fullbatch as R_fullbatch
import veles_tpu.normalization as R_norm
import veles_tpu.prng as R_prng
import veles_tpu_torch.accelerated_units as P_acc
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.config as P_config
import veles_tpu_torch.loader.datasets as P_datasets
import veles_tpu_torch.loader.fullbatch as P_fullbatch
import veles_tpu_torch.normalization as P_norm
import veles_tpu_torch.prng as P_prng
from veles_tpu_torch.loader import CLASS_NAME, UserLoaderRegistry

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

REF = dict(acc=R_acc, backends=R_backends, config=R_config,
           datasets=R_datasets, fullbatch=R_fullbatch, norm=R_norm,
           prng=R_prng)
PORT = dict(acc=P_acc, backends=P_backends, config=P_config,
            datasets=P_datasets, fullbatch=P_fullbatch, norm=P_norm,
            prng=P_prng)


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


# ---------------------------------------------------------- datasets

def test_synthetic_digits_bitwise():
    r = R_datasets.synthetic_digits(50, R_prng.get("d"), 24, max_shift=3)
    p = P_datasets.synthetic_digits(50, P_prng.get("d"), 24, max_shift=3)
    for a, b in zip(p, r):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)


def test_synthetic_color_images_bitwise():
    r = R_datasets.synthetic_color_images(40, R_prng.get("c"), 24)
    p = P_datasets.synthetic_color_images(40, P_prng.get("c"), 24)
    for a, b in zip(p, r):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)


def _loader(mods, cls, **kw):
    wf = mods["acc"].AcceleratedWorkflow(None, name="loader")
    loader = getattr(mods["datasets"], cls)(wf, **kw)
    assert loader.initialize(
        device=mods["backends"].Device(backend="cpu")) is None
    return loader


@pytest.mark.parametrize("cls,kw", [
    ("SyntheticDigitsLoader", dict(n_train=30, n_valid=10, n_test=5)),
    ("SyntheticColorImagesLoader", dict(n_train=20, n_valid=6,
                                        image_size=24))])
def test_dataset_loaders_bitwise(cls, kw):
    ref = _loader(REF, cls, minibatch_size=8, **kw)
    port = _loader(PORT, cls, minibatch_size=8, **kw)
    assert np.array_equal(port.original_data, ref.original_data)
    assert np.array_equal(port.original_labels, ref.original_labels)
    assert port.class_lengths == ref.class_lengths
    assert port.labels_mapping == ref.labels_mapping
    assert np.array_equal(port.shuffled_indices.map_read(),
                          np.asarray(ref.shuffled_indices.map_read()))


def test_real_mnist_npz_is_served(tmp_path):
    """A local mnist.npz under root.common.dirs.datasets replaces the
    synthetic digits (uint8 pixels scaled to [0, 1])."""
    rng = np.random.default_rng(1)
    np.savez(tmp_path / "mnist.npz",
             x_train=rng.integers(0, 256, (12, 28, 28)).astype(np.uint8),
             y_train=rng.integers(0, 10, 12),
             x_test=rng.integers(0, 256, (4, 28, 28)).astype(np.uint8),
             y_test=rng.integers(0, 10, 4))
    saved = [c.root.common.dirs.datasets for c in (R_config, P_config)]
    try:
        for c in (R_config, P_config):
            c.root.common.dirs.datasets = str(tmp_path)
        ref = _loader(REF, "SyntheticDigitsLoader", minibatch_size=5)
        port = _loader(PORT, "SyntheticDigitsLoader", minibatch_size=5)
    finally:
        for c, s in zip((R_config, P_config), saved):
            c.root.common.dirs.datasets = s
    assert port.class_lengths == ref.class_lengths == [0, 4, 12]
    assert port.original_data.max() <= 1.0
    assert np.array_equal(port.original_data, ref.original_data)
    assert np.array_equal(port.original_labels, ref.original_labels)


def test_loader_registry():
    loaders = UserLoaderRegistry.loaders
    assert loaders["synthetic_digits"] is P_datasets.SyntheticDigitsLoader
    assert loaders["synthetic_color"] is \
        P_datasets.SyntheticColorImagesLoader
    assert CLASS_NAME == ("test", "validation", "train")


# ---------------------------------------------------------- normalizers

NORMALIZERS = {
    "none": {}, "linear": dict(interval=(-2.0, 3.0)),
    "range_linear": dict(source=(0.0, 2.0), interval=(0.0, 1.0)),
    "mean_disp": {}, "internal_mean": {}, "pointwise": {}, "exp": {},
    "external_mean": dict(mean_source=np.linspace(
        0, 1, 4 * 3 * 2).reshape(4, 3, 2).astype(np.float32)),
}


@pytest.mark.parametrize("name", sorted(NORMALIZERS))
def test_normalizer_matches_reference(name):
    assert sorted(P_norm.NormalizerRegistry.normalizers) == \
        sorted(NORMALIZERS)
    rng = np.random.default_rng(2)
    batches = [(rng.standard_normal((5, 4, 3, 2)) * 3 + 1).astype(
        np.float32) for _ in range(3)]
    batches[0][:, 0, 0, 0] = 0.5          # a constant feature
    ref = R_norm.normalizer(name, **NORMALIZERS[name])
    port = P_norm.normalizer(name, **NORMALIZERS[name])
    for b in batches:
        ref.analyze(b)
        port.analyze(b)
    assert port.is_initialized
    for field in port.ARRAY_FIELDS:
        assert np.array_equal(port.stat_arrays()[field],
                              ref.jax_arrays()[field])
    x = (rng.standard_normal((6, 4, 3, 2)) * 2).astype(np.float32)
    want = np.asarray(ref.apply_jax(x))
    got = port.apply_torch(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    assert _rel(got.numpy(), want) < 1e-6
    host = x.copy()
    port.normalize(host)
    assert _rel(host, want) < 1e-6
    # the statistics travel in the state
    again = P_norm.normalizer(name, **NORMALIZERS[name])
    again.state = port.state
    assert again.is_initialized
    assert np.array_equal(again.apply_torch(torch.from_numpy(x)).numpy(),
                          got.numpy())
    # passed in as device tensors (the full-batch loader's form)
    stats = {k: torch.from_numpy(v) for k, v in port.stat_arrays().items()}
    assert np.array_equal(port.apply_torch(torch.from_numpy(x),
                                           stats).numpy(), got.numpy())


def test_normalizer_unknown_name():
    with pytest.raises(ValueError, match="Unknown normalization"):
        P_norm.normalizer("zscore")
    with pytest.raises(ValueError, match="mean_source"):
        P_norm.normalizer("external_mean")


# ---------------------------------------------------------- serving

def _serve_sequence(mods, n_serves, **kw):
    loader = _loader(mods, "SyntheticDigitsLoader", **kw)
    seq = []
    for _ in range(n_serves):
        loader.run()
        seq.append(dict(
            klass=loader.minibatch_class, size=loader.minibatch_size,
            offset=loader.minibatch_offset, epoch=loader.epoch_number,
            flags=(bool(loader.last_minibatch), bool(loader.epoch_ended),
                   bool(loader.train_ended), bool(loader.test_ended)),
            indices=np.array(loader.minibatch_indices.map_read()),
            labels=np.array(loader.minibatch_labels.map_read()),
            data=np.array(loader.minibatch_data.map_read())))
    return loader, seq


@pytest.mark.parametrize("store_on_device,normalization", [
    (True, "none"), (False, "none"), (True, "mean_disp"),
    (False, "linear")])
def test_minibatch_sequence_two_epochs(store_on_device, normalization):
    """TEST, VALID and TRAIN with short last minibatches, two epochs
    (the TRAIN slice reshuffled in between): every served field equal
    to the reference's."""
    kw = dict(n_test=7, n_valid=9, n_train=23, minibatch_size=5,
              image_size=24, store_on_device=store_on_device,
              normalization_type=normalization)
    n_serves = 2 * (2 + 2 + 5)
    _, ref = _serve_sequence(REF, n_serves, **kw)
    port_loader, port = _serve_sequence(PORT, n_serves, **kw)
    exact = normalization == "none"
    for i, (r, p) in enumerate(zip(ref, port)):
        for key in ("klass", "size", "offset", "epoch", "flags"):
            assert p[key] == r[key], (i, key)
        assert np.array_equal(p["indices"], r["indices"]), i
        assert np.array_equal(p["labels"], r["labels"]), i
        if exact:
            assert np.array_equal(p["data"], r["data"]), i
        else:
            assert _rel(p["data"], r["data"]) < 1e-6, i
        if p["size"] < 5:
            assert not p["data"][p["size"]:].any()
            assert (p["labels"][p["size"]:] == -1).all()
    assert [s["klass"] for s in port[:9]] == [0, 0, 1, 1, 2, 2, 2, 2, 2]
    assert port[-1]["epoch"] == 1 and port[-1]["flags"][2]
    # the two epochs' TRAIN orders differ (reshuffled)
    assert not np.array_equal(port[4]["indices"], port[13]["indices"])
    if store_on_device:
        assert port_loader.minibatch_data.devmem_ is not None


def test_job_indices_patch_the_device_permutation():
    """A worker's job (apply_data_from_master) writes its indices into
    the device permutation in place, and the serve gathers those rows."""
    loader = _loader(PORT, "SyntheticDigitsLoader", n_train=12, n_valid=0,
                     minibatch_size=4, image_size=24)
    loader.run()                                 # uploads the permutation
    perm = loader._perm_dev_
    indices = np.array([11, 3, 7, 0], dtype=np.int32)
    loader.apply_data_from_master(dict(
        indices=indices, minibatch_class=2, minibatch_size=4,
        minibatch_offset=8, epoch_number=0))
    assert loader._perm_dev_ is perm
    assert np.array_equal(perm[4:8].numpy(), indices)
    data, labels = loader.gather(4, 4)
    assert np.array_equal(data.numpy(), loader.original_data[indices])
    mapped = [loader.labels_mapping[int(lbl)]
              for lbl in loader.original_labels[indices]]
    assert labels.tolist() == mapped


class _Targets:
    """A FullBatchLoaderMSE over a small regression set."""

    @staticmethod
    def make(mods):
        class Regression(mods["fullbatch"].FullBatchLoaderMSE):
            def load_data(self):
                rng = np.random.default_rng(3)
                self.original_data = rng.standard_normal(
                    (14, 6)).astype(np.float32)
                self.original_targets = rng.standard_normal(
                    (14, 2)).astype(np.float32)
                self.class_lengths = [0, 4, 10]
        wf = mods["acc"].AcceleratedWorkflow(None, name="mse")
        loader = Regression(wf, minibatch_size=4)
        loader.initialize(device=mods["backends"].Device(backend="cpu"))
        return loader


def test_fullbatch_mse_targets():
    ref, port = _Targets.make(REF), _Targets.make(PORT)
    for _ in range(6):
        ref.run()
        port.run()
        assert port.minibatch_size == ref.minibatch_size
        assert np.array_equal(port.minibatch_targets.map_read(),
                              np.asarray(ref.minibatch_targets.map_read()))
        assert np.array_equal(port.minibatch_data.map_read(),
                              np.asarray(ref.minibatch_data.map_read()))
