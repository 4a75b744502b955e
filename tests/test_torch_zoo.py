"""Port parity of the model zoo on the CPU: ``veles_tpu_torch``'s
``AutoencoderWorkflow``, ``ConvAutoencoderWorkflow``, the row-wise LSTM
classifier, ``LenetWorkflow``, ``CifarWorkflow``, ``VggWorkflow`` and
``Stl10Workflow`` trained against the JAX package's from the same seed
(f32, ``compute_type`` float32 on both sides), narrow and for a few
epochs, and ``load_params`` / ``params_of`` with a Deconv and an LSTM.

Tolerances (those of ``tests/test_torch_standard.py``). The initial
weights, the datasets and the minibatch order are bitwise the
reference's. Error counts per minibatch and per epoch are compared
exactly; losses, reconstruction RMSEs and the final weights agree
within 1e-4 of their scale (the two frameworks sum in different
orders); the biases of ReLU nets, zero at the start and so the sums of
their gradients, within 5e-2 of their scale (the ReLU note there).
Dropout is set to ratio 0 where the packages are compared: the port's
masks are Philox draws, not JAX's; with dropout on, the port is held
to itself, bitwise, from one seed.
"""

import numpy as np
import pytest
import torch

import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.loader.image as R_image
import veles_tpu.models.autoencoder as R_autoencoder
import veles_tpu.models.cifar as R_cifar
import veles_tpu.models.lenet as R_lenet
import veles_tpu.models.standard as R_standard
import veles_tpu.models.stl10 as R_stl10
import veles_tpu.models.vgg as R_vgg
import veles_tpu.prng as R_prng
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.config as P_config
import veles_tpu_torch.loader.image as P_image
import veles_tpu_torch.models.autoencoder as P_autoencoder
import veles_tpu_torch.models.cifar as P_cifar
import veles_tpu_torch.models.lenet as P_lenet
import veles_tpu_torch.models.standard as P_standard
import veles_tpu_torch.models.stl10 as P_stl10
import veles_tpu_torch.models.vgg as P_vgg
import veles_tpu_torch.prng as P_prng
from veles_tpu_torch.nn import GDLSTM, LSTM, Deconv, GDDeconv

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

TOL = 1e-4
#: biases of a ReLU net: see the module docstring
TOL_SUMMED_GRAD = 5e-2

REF = dict(backends=R_backends, prng=R_prng, autoencoder=R_autoencoder,
           lenet=R_lenet, cifar=R_cifar, vgg=R_vgg, stl10=R_stl10,
           standard=R_standard, image=R_image)
PORT = dict(backends=P_backends, prng=P_prng, autoencoder=P_autoencoder,
            lenet=P_lenet, cifar=P_cifar, vgg=P_vgg, stl10=P_stl10,
            standard=P_standard, image=P_image)
PARAM_ATTRS = ("weights", "weights_x", "weights_h", "bias")

LSTM_LAYERS = [{"type": "lstm", "hidden": 8},
               {"type": "softmax", "output_sample_shape": 10}]
SMALL = dict(n_train=100, n_valid=50, minibatch_size=50)


def _narrow_vgg(dropout=0.0):
    return R_vgg.vgg_layers((1, 1, 1, 1, 1), (8, 8, 16, 16, 16), fc=(32,),
                            n_classes=10, dropout=dropout)


@pytest.fixture(autouse=True)
def _f32_and_fresh_streams():
    saved = [(c.root.common.engine.compute_type, c.root.common.random.seed)
             for c in (R_config, P_config)]
    for c in (R_config, P_config):
        c.root.common.engine.compute_type = "float32"
        c.root.common.random.seed = 7
    yield
    for c, p, (ct, seed) in zip((R_config, P_config), (R_prng, P_prng),
                                saved):
        c.root.common.engine.compute_type = ct
        c.root.common.random.seed = seed
        p.reset()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _params(wf):
    """(unit name, attr, host copy) of every forward parameter."""
    return [(u.name, attr, np.array(getattr(u, attr).map_read()))
            for u in wf.forwards for attr in PARAM_ATTRS
            if hasattr(getattr(u, attr, None), "map_read")]


def _train(mods, make):
    """Build with ``make(mods)`` from fresh streams, initialize on the
    CPU, record every minibatch's (class, metric, loss), run to the
    end. The metric is n_err for a classifier, the RMSE sum for an
    autoencoder."""
    mods["prng"].reset()
    wf = make(mods)
    wf.initialize(device=mods["backends"].Device(backend="cpu"))
    initial = _params(wf)
    log = []
    run = wf.evaluator.run

    def recording():
        run()
        ev = wf.evaluator
        log.append((wf.loader.minibatch_class,
                    getattr(ev, "n_err", None), ev.sum_rmse
                    if hasattr(ev, "sum_rmse") else ev.loss))

    wf.evaluator.run = recording
    wf.run()
    wf.thread_pool.shutdown()
    return wf, initial, log


def _assert_trained_alike(make, bias_tol=TOL):
    (ref, r_init, r_log), (port, p_init, p_log) = (
        _train(mods, make) for mods in (REF, PORT))
    assert [(n, a) for n, a, _ in p_init] == [(n, a) for n, a, _ in r_init]
    for (name, attr, a), (_, _, b) in zip(p_init, r_init):
        assert np.array_equal(a, b), (name, attr)
    assert np.array_equal(port.loader.original_data,
                          ref.loader.original_data)
    assert [r[:2] for r in p_log] == [r[:2] for r in r_log]
    assert _rel([r[2] for r in p_log], [r[2] for r in r_log]) < TOL
    for klass, want in ref.decision.epoch_errors.items():
        got = port.decision.epoch_errors[klass]
        assert len(got) == len(want), klass
        assert not want or _rel(got, want) < TOL, klass
    for (name, attr, a), (_, _, b) in zip(_params(port), _params(ref)):
        tol = bias_tol if attr == "bias" else TOL
        assert _rel(a, b) < tol, (name, attr)
    assert bool(port.decision.complete)
    assert port.gather_results().keys() == ref.gather_results().keys()
    return ref, port


def test_autoencoder_workflow_trains_like_reference():
    ref, port = _assert_trained_alike(
        lambda m: m["autoencoder"].AutoencoderWorkflow(
            layers=(16,), max_epochs=2, loader_kwargs=dict(SMALL)))
    assert port.forwards[-1].output.shape == (50, 784)
    rmse = port.gather_results()["min_validation_rmse"]
    assert abs(rmse - ref.gather_results()["min_validation_rmse"]) <= \
        TOL * rmse


def test_conv_autoencoder_workflow_trains_like_reference():
    _, port = _assert_trained_alike(
        lambda m: m["autoencoder"].ConvAutoencoderWorkflow(
            max_epochs=2, loader_kwargs=dict(SMALL)), TOL_SUMMED_GRAD)
    assert [type(u).__name__ for u in port.forwards] == ["ConvRELU",
                                                         "Deconv"]
    assert port.forwards[-1].output.shape == (50, 28, 28, 1)
    assert type(port.gds[0]) is GDDeconv
    assert port.gds[0].learning_rate == 3e-4


def test_conv_autoencoder_from_letterboxed_image_files(tmp_path):
    """``FullBatchImageLoaderMSE`` letterboxes PNG files of several
    aspect ratios onto a background color and serves the targets; the
    conv autoencoder trains from them like the reference."""
    from PIL import Image

    rng = np.random.RandomState(3)
    for split, count in (("train", 16), ("valid", 8)):
        d = tmp_path / split / "x"
        d.mkdir(parents=True)
        for i in range(count):
            h, w = rng.choice([8, 12, 16]), rng.choice([8, 12, 16])
            arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            Image.fromarray(arr).save(d / ("i%d.png" % i))
    layers = [
        {"type": "conv_relu", "n_kernels": 8, "kx": 3,
         "padding": 1, "sliding": (2, 2)},      # 16 -> 8
        {"type": "deconv", "n_kernels": 3, "kx": 3,
         "sliding": (2, 2), "weights_filling": "gaussian",
         "weights_stddev": 0.02},               # 8 -> 16
    ]
    _, port = _assert_trained_alike(
        lambda m: m["autoencoder"].ConvAutoencoderWorkflow(
            layers=layers, max_epochs=2, learning_rate=1e-3,
            loader_cls=m["image"].FullBatchImageLoaderMSE,
            loader_kwargs=dict(
                train_paths=[str(tmp_path / "train")],
                validation_paths=[str(tmp_path / "valid")],
                size=(16, 16), scale_mode="letterbox",
                background_color=(255, 20, 147), minibatch_size=8)),
        TOL_SUMMED_GRAD)
    assert port.loader.original_data.shape[1:] == (16, 16, 3)
    assert port.forwards[-1].output.shape == (8, 16, 16, 3)
    assert port.evaluator.target is not None


def test_lstm_workflow_trains_like_reference():
    """Sequential digits (28 steps of 28 pixels). The LSTM is not one of
    the workflow's parametric layers, on both sides: its twin trains
    with GDLSTM's own learning rate 0.01 and no momentum, not the
    workflow's."""
    ref, port = _assert_trained_alike(
        lambda m: m["standard"].StandardWorkflow(
            layers=LSTM_LAYERS, max_epochs=2, learning_rate=0.1,
            loader_kwargs=dict(SMALL)))
    for wf in (ref, port):
        gd = wf.gds[-1]
        assert type(gd).__name__ == "GDLSTM"
        assert (gd.learning_rate, gd.momentum, gd.need_err_input) == \
            (0.01, 0.0, True)
        assert wf.gds[0].learning_rate == 0.1
    assert isinstance(port.forwards[0], LSTM)
    assert type(port.gds[-1]) is GDLSTM
    assert port.forwards[0].output.shape == (50, 28, 8)


def test_lenet_workflow_trains_like_reference():
    _, port = _assert_trained_alike(
        lambda m: m["lenet"].LenetWorkflow(max_epochs=1,
                                           loader_kwargs=dict(SMALL)))
    assert port.forwards[3].output.shape == (50, 5, 5, 16)


def test_cifar_workflow_trains_like_reference():
    _, port = _assert_trained_alike(
        lambda m: m["cifar"].CifarWorkflow(
            max_epochs=1, loader_kwargs=dict(n_train=40, n_valid=20,
                                             minibatch_size=20)),
        TOL_SUMMED_GRAD)
    assert port.loader.original_data.shape[1:] == (32, 32, 3)


def test_vgg_workflow_narrow_trains_like_reference():
    _, port = _assert_trained_alike(
        lambda m: m["vgg"].VggWorkflow(
            depth=11, max_epochs=1, layers=_narrow_vgg(),
            loader_kwargs=dict(n_train=40, n_valid=20, minibatch_size=20)),
        TOL_SUMMED_GRAD)
    # 5 stride-2 pools: 32 -> 1
    assert port.forwards[-3].output.shape[1:3] == (1, 1)
    assert port.gds[0].weight_decay == 5e-4


def test_stl10_workflow_trains_like_reference():
    layers = [dict(s, dropout_ratio=0.0) if s["type"] == "dropout" else s
              for s in R_stl10.STL10_LAYERS]
    _, port = _assert_trained_alike(
        lambda m: m["stl10"].Stl10Workflow(
            max_epochs=1, layers=layers,
            loader_kwargs=dict(n_train=20, n_valid=10, minibatch_size=10)),
        TOL_SUMMED_GRAD)
    assert port.loader.original_data.shape[1:] == (96, 96, 3)
    # the stride-2 stem halves, two pools quarter: 96 -> 48 -> 23 -> 11
    assert port.forwards[0].output.shape[1:3] == (48, 48)
    assert port.forwards[3].output.shape[1:3] == (11, 11)


def test_zoo_layer_lists_equal_the_reference():
    assert P_vgg.VGG11_LAYERS == R_vgg.VGG11_LAYERS
    assert P_vgg.VGG16_LAYERS == R_vgg.VGG16_LAYERS
    for args in (((1,), (16,), (32,), 5, 0), ((2, 3), (4, 8), (16, 8), 3,
                                              0.25)):
        assert P_vgg.vgg_layers(*args) == R_vgg.vgg_layers(*args)
    assert P_lenet.LENET_LAYERS == R_lenet.LENET_LAYERS
    assert P_cifar.CIFAR_LAYERS == R_cifar.CIFAR_LAYERS
    assert P_stl10.STL10_LAYERS == R_stl10.STL10_LAYERS
    assert sum(s["type"] == "conv_relu" for s in P_vgg.VGG16_LAYERS) == 13
    with pytest.raises(ValueError, match="depth must be 11 or 16"):
        P_vgg.VggWorkflow(depth=19)
    wf = P_vgg.VggWorkflow(depth=16)
    assert [s["type"] for s in P_vgg.VGG16_LAYERS] == \
        [u.MAPPING for u in wf.forwards]
    assert wf.loader.image_size == 32 and wf.gds[0].weight_decay == 5e-4


def _cpu_params(mods, make, seed=None):
    mods["prng"].reset()
    if seed is not None:
        mods["prng"].get("default").seed(seed)
    wf = make(mods)
    wf.initialize(device=mods["backends"].Device(backend="cpu"))
    return wf


@pytest.mark.parametrize("model", ["conv_autoencoder", "lstm"])
def test_load_params_and_params_of_round_trip(model):
    """The reference's weights (``map_read``) loaded into the port's
    workflow, then both forwards on the same minibatch."""
    if model == "lstm":
        def make(m):
            return m["standard"].StandardWorkflow(
                layers=LSTM_LAYERS, max_epochs=1, loader_kwargs=dict(SMALL))
        kinds = [("weights_x", "weights_h", "bias"), ("weights", "bias")]
    else:
        def make(m):
            return m["autoencoder"].ConvAutoencoderWorkflow(
                max_epochs=1, loader_kwargs=dict(SMALL))
        kinds = [("weights", "bias")] * 2
    ref = _cpu_params(REF, make)
    params = [{attr: np.asarray(getattr(u, attr).map_read())
               for attr in attrs} for u, attrs in zip(ref.forwards, kinds)]
    port = _cpu_params(PORT, make, seed=8)   # other weights, same data
    assert not np.array_equal(P_standard.params_of(port)[0][kinds[0][0]],
                              params[0][kinds[0][0]])
    P_standard.load_params(port, params)
    back = P_standard.params_of(port)
    assert [sorted(p) for p in back] == [sorted(p) for p in params]
    for a, b in zip(back, params):
        for key in a:
            assert np.array_equal(a[key], b[key])
    if model == "conv_autoencoder":
        assert isinstance(port.forwards[1], Deconv)
        assert back[1]["weights"].shape == (3, 3, 8, 1)   # HWIO, I = in
    else:
        assert back[0]["weights_x"].shape == (28, 32)
        assert back[0]["weights_h"].shape == (8, 32)
    for wf in (ref, port):
        wf.loader.run()
        for unit in wf.forwards:
            unit.run()
    assert _rel(port.forwards[-1].output.map_read(),
                ref.forwards[-1].output.map_read()) < TOL
    # the backward units share the loaded Arrays
    assert port.gds[-1].bias is port.forwards[0].bias
    bad = [dict(p) for p in params]
    bad[0]["bias"] = bad[0]["bias"][:-1]
    with pytest.raises(ValueError, match="shape"):
        P_standard.load_params(port, bad)
    ref.thread_pool.shutdown()
    port.thread_pool.shutdown()


def test_port_dropout_zoo_reproducible_on_cpu():
    """The narrow VGG with dropout 0.5 twice from one seed: the same
    per-minibatch errors and losses and the same weights, bitwise."""
    runs = []
    for _ in range(2):
        wf, _, log = _train(PORT, lambda m: m["vgg"].VggWorkflow(
            max_epochs=1, layers=_narrow_vgg(0.5),
            loader_kwargs=dict(n_train=40, n_valid=20, minibatch_size=20)))
        runs.append((log, _params(wf)))
    (log1, p1), (log2, p2) = runs
    assert log1 == log2
    for (_, _, a), (_, _, b) in zip(p1, p2):
        assert np.array_equal(a, b)
    assert all(np.isfinite(r[2]) for r in log1)


@pytest.mark.parametrize("key,module", [
    ("autoencoder", "autoencoder"), ("lenet", "lenet"), ("cifar", "cifar"),
    ("vgg", "vgg"), ("stl10", "stl10")])
def test_run_reads_its_config_subtree_like_reference(key, module):
    """``run(load, main)`` loads the module's workflow with the kwargs
    of ``root.<key>`` (none when the subtree is unset, as both packages
    define no defaults for it), then calls ``main``."""
    calls = []
    for mods, config in ((REF, R_config), (PORT, P_config)):
        for values in ({}, {"max_epochs": 3, "learning_rate": 0.5}):
            config.root.__dict__.pop(key, None)
            if values:
                getattr(config.root, key).update(values)
            seen = []
            mods[module].run(lambda cls, **kw: seen.append((cls.__name__,
                                                            kw)),
                             lambda: seen.append("main"))
            calls.append(seen)
        config.root.__dict__.pop(key, None)
    ref, port = calls[:2], calls[2:]
    assert port == ref
    assert port[1][0][1] == {"max_epochs": 3, "learning_rate": 0.5}
    assert port[0][1] == "main"
