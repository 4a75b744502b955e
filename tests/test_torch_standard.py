"""Port parity of the unit-graph classifier on the CPU: ``veles_tpu_torch``'s
``StandardWorkflow``, ``MnistWorkflow`` and ``AlexNetWorkflow`` trained
end to end against the JAX package's from the same seed (f32,
``compute_type`` float32 on both sides), and ``load_params`` /
``params_of`` carrying one set of weights through both packages.

Tolerances. The initial weights, the datasets and the minibatch order
are bitwise the reference's (host draws from the same numpy
generators). Per-epoch and per-minibatch error counts are compared
exactly. Losses and the final weights agree within 1e-4 of their scale:
the two frameworks sum products and convolutions in different orders,
and SGD moves each weight by the learning rate times gradients that
differ at f32 noise (``tests/test_torch_fused.py``'s bound); so are
the MNIST net's biases (tanh layers). The AlexNet biases start at 0,
so they are the sums of their layers' gradients and are held to 5e-2
of their scale: a ReLU whose input lies within
rounding of 0 takes slope 1 on one side and 0 on the other, which moves
one column of a layer's gradient by a whole sample's share, and every
layer below it through err_input (on the 64 x 64 AlexNet one such unit
in the first TRAIN minibatch puts the biases 1e-3 to 1e-2 of their
scale apart; ``tests/test_torch_units.py`` holds each unit's gradients
on the same inputs to 1e-4 and 1e-3). Dropout is set to ratio 0 where the two frameworks are
compared: the port's masks are Philox draws, not JAX's; the port is
held to itself with dropout on, bitwise, from one seed.
"""

import numpy as np
import pytest
import torch

import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.models.alexnet as R_alexnet
import veles_tpu.models.mnist as R_mnist
import veles_tpu.models.standard as R_standard
import veles_tpu.prng as R_prng
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.config as P_config
import veles_tpu_torch.models.alexnet as P_alexnet
import veles_tpu_torch.models.mnist as P_mnist
import veles_tpu_torch.models.standard as P_standard
import veles_tpu_torch.prng as P_prng
from veles_tpu_torch.accelerated_units import AcceleratedWorkflow

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

TOL = 1e-4
#: biases of a ReLU net (zero at the start, so the sums of their
#: gradients): see the ReLU note in the module docstring
TOL_SUMMED_GRAD = 5e-2

REF = dict(backends=R_backends, prng=R_prng, mnist=R_mnist,
           alexnet=R_alexnet, standard=R_standard)
PORT = dict(backends=P_backends, prng=P_prng, mnist=P_mnist,
            alexnet=P_alexnet, standard=P_standard)

MNIST = dict(layers=(32, 10), max_epochs=2,
             loader_kwargs=dict(n_train=300, n_valid=100,
                                minibatch_size=50))


def _alexnet_kw(dropout=0.0, **extra):
    return dict(n_classes=10, image_size=64, max_epochs=1,
                layers=R_alexnet.alexnet_layers(10, dropout=dropout),
                loader_kwargs=dict(n_train=60, n_valid=20,
                                   minibatch_size=20, image_size=64),
                **extra)


@pytest.fixture(autouse=True)
def _f32_and_fresh_streams():
    saved = [(c.root.common.engine.compute_type, c.root.common.random.seed)
             for c in (R_config, P_config)]
    for c in (R_config, P_config):
        c.root.common.engine.compute_type = "float32"
        c.root.common.random.seed = 5
    yield
    for c, p, (ct, seed) in zip((R_config, P_config), (R_prng, P_prng),
                                saved):
        c.root.common.engine.compute_type = ct
        c.root.common.random.seed = seed
        p.reset()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _train(mods, make, log=None):
    """Build with ``make(mods)`` from fresh streams, initialize on the
    CPU, record (class, n_err, loss) per minibatch, run to the end."""
    mods["prng"].reset()
    wf = make(mods)
    wf.initialize(device=mods["backends"].Device(backend="cpu"))
    initial = [np.array(u.weights.map_read()) for u in wf.forwards
               if hasattr(u, "weights")]
    if log is not None:
        run = wf.evaluator.run

        def recording():
            run()
            log.append((wf.loader.minibatch_class, wf.evaluator.n_err,
                        wf.evaluator.loss))

        wf.evaluator.run = recording
    wf.run()
    wf.thread_pool.shutdown()
    return wf, initial


def _weights(wf):
    return [(u.name, np.array(u.weights.map_read()),
             np.array(u.bias.map_read()))
            for u in wf.forwards if hasattr(u, "weights")]


def _assert_trained_alike(make, bias_tol):
    logs = ([], [])
    (ref, r_init), (port, p_init) = (
        _train(mods, make, log) for mods, log in zip((REF, PORT), logs))
    for a, b in zip(p_init, r_init):
        assert np.array_equal(a, b)
    assert np.array_equal(port.loader.original_data,
                          ref.loader.original_data)
    assert port.decision.epoch_errors == ref.decision.epoch_errors
    assert [r[:2] for r in logs[1]] == [r[:2] for r in logs[0]]
    losses = np.array([r[2] for r in logs[1]])
    want = np.array([r[2] for r in logs[0]])
    assert _rel(losses, want) < TOL
    for (name, pw, pb), (_, rw, rb) in zip(_weights(port), _weights(ref)):
        assert _rel(pw, rw) < TOL, name
        assert _rel(pb, rb) < bias_tol, name
    assert bool(port.decision.complete)
    return ref, port


def test_mnist_workflow_trains_like_reference():
    _, port = _assert_trained_alike(
        lambda m: m["mnist"].MnistWorkflow(**MNIST), TOL)
    assert len(port.decision.epoch_errors[2]) == 2


def test_alexnet_small_workflow_trains_like_reference():
    _, port = _assert_trained_alike(
        lambda m: m["alexnet"].AlexNetWorkflow(**_alexnet_kw()),
        TOL_SUMMED_GRAD)
    assert [type(u).__name__ for u in port.forwards][:3] == \
        ["ConvRELU", "LRNormalizerForward", "MaxPooling"]


def test_lr_policy_workflow_like_reference():
    """The learning rate each TRAIN minibatch trains with, and the
    results, under a step policy. (Whether the scheduler also runs at
    the last boundary, after the decision completed, is a race with the
    end point on both sides: its value trains nothing.)"""
    policy = {"type": "step", "gamma": 0.5, "every": 1}
    seqs = []
    for mods in (REF, PORT):
        mods["prng"].reset()
        wf = mods["mnist"].MnistWorkflow(lr_policy=policy,
                                         **dict(MNIST, max_epochs=3))
        wf.initialize(device=mods["backends"].Device(backend="cpu"))
        seen = []
        run = wf.evaluator.run

        def recording(wf=wf, run=run, seen=seen):
            run()
            if wf.loader.minibatch_class == 2:
                seen.append([(g.learning_rate, g.learning_rate_bias)
                             for g in wf.gds])

        wf.evaluator.run = recording
        wf.run()
        wf.thread_pool.shutdown()
        seqs.append((seen, wf.lr_scheduler.base_lr,
                     wf.decision.epoch_errors))
    assert seqs[1][0] == seqs[0][0]
    assert seqs[1][1:] == seqs[0][1:]
    assert sorted({lr[0][0] for lr in seqs[1][0]}) == [0.025, 0.05, 0.1]


def test_load_params_and_params_of_round_trip():
    """A reference workflow's weights (``map_read``) loaded into the
    port's, then both forwards on the same minibatch."""
    R_prng.reset()
    ref = R_alexnet.AlexNetWorkflow(**_alexnet_kw())
    ref.initialize(device=R_backends.Device(backend="cpu"))
    params = [{"weights": np.asarray(u.weights.map_read()),
               "bias": np.asarray(u.bias.map_read())}
              if hasattr(u, "weights") else {} for u in ref.forwards]
    P_prng.reset()
    P_prng.get("default").seed(6)       # other weights, the same data
    port = P_alexnet.AlexNetWorkflow(**_alexnet_kw())
    port.initialize(device=P_backends.Device(backend="cpu"))
    assert not np.array_equal(port.forwards[0].weights.map_read(),
                              params[0]["weights"])
    P_standard.load_params(port, params)
    back = P_standard.params_of(port)
    assert [sorted(p) for p in back] == [sorted(p) for p in params]
    for a, b in zip(back, params):
        for key in a:
            assert np.array_equal(a[key], b[key])
    # the same minibatch through both forwards
    for wf in (ref, port):
        wf.loader.run()
    x = np.asarray(ref.loader.minibatch_data.map_read())
    assert np.array_equal(port.loader.minibatch_data.map_read(), x)
    for wf in (ref, port):
        for unit in wf.forwards:
            unit.run()
    assert _rel(port.forwards[-1].output.map_read(),
                ref.forwards[-1].output.map_read()) < TOL
    # the backward units share the loaded Arrays
    gd = port.gds[0]
    assert gd.weights is port.forwards[-1].weights
    with pytest.raises(ValueError, match="parameter dicts"):
        P_standard.load_params(port, params[:-1])
    bad = [dict(p) for p in params]
    bad[0]["weights"] = bad[0]["weights"][..., :5]
    with pytest.raises(ValueError, match="shape"):
        P_standard.load_params(port, bad)
    ref.thread_pool.shutdown()
    port.thread_pool.shutdown()


def test_load_params_before_initialize():
    R_prng.reset()
    ref = R_mnist.MnistWorkflow(**MNIST)
    ref.initialize(device=R_backends.Device(backend="cpu"))
    params = [{"weights": np.asarray(u.weights.map_read()) * 2,
               "bias": np.asarray(u.bias.map_read()) + 1}
              for u in ref.forwards]
    P_prng.reset()
    port = P_mnist.MnistWorkflow(**MNIST)
    P_standard.load_params(port, params)
    port.initialize(device=P_backends.Device(backend="cpu"))
    for a, b in zip(P_standard.params_of(port), params):
        assert np.array_equal(a["weights"], b["weights"])
        assert np.array_equal(a["bias"], b["bias"])
    ref.thread_pool.shutdown()
    port.thread_pool.shutdown()


def test_port_dropout_workflow_reproducible_on_cpu():
    """Dropout 0.5 through the unit graph: two runs from one seed give
    the same losses, error counts and weights, bitwise; the masks are
    the stream's Philox fills."""
    runs = []
    for _ in range(2):
        log = []
        wf, _ = _train(PORT, lambda m: m["alexnet"].AlexNetWorkflow(
            **_alexnet_kw(dropout=0.5)), log)
        runs.append((log, _weights(wf),
                     np.array(wf.forwards[11].mask.map_read())))
    (log1, w1, m1), (log2, w2, m2) = runs
    assert log1 == log2
    for (_, a, b), (_, c, d) in zip(w1, w2):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    assert np.array_equal(m1, m2)
    assert set(np.unique(m1)) == {0.0, 2.0}
    assert all(np.isfinite(r[2]) for r in log1)


def test_layer_types_are_the_reference_set_without_deconv():
    """The port's layer types are the reference's, the deconv, depooling
    and LSTM types included."""
    ref = set(R_standard.layer_types())
    port = set(P_standard.layer_types())
    assert port == ref
    assert {"conv_relu", "lrn", "max_pooling", "avg_pooling", "dropout",
            "all2all_relu", "all2all_tanh", "softmax", "deconv",
            "deconv_relu", "depooling", "lstm"} <= port


def test_export_specs_match_reference():
    specs = []
    for mods in (REF, PORT):
        mods["prng"].reset()
        wf = mods["alexnet"].AlexNetWorkflow(**_alexnet_kw())
        wf.initialize(device=mods["backends"].Device(backend="cpu"))
        specs.append([u.export_spec()[0] for u in wf.forwards])
        wf.thread_pool.shutdown()
    assert specs[1] == specs[0]


def test_unported_options_raise():
    # the name is the refusal test's, kept so that this case replaces
    # it one for one; plotters=True is ported (tests/test_torch_services.py): the
    # validation-error curve and the confusion matrix, both gated on
    # the loader's epoch end and fed from the decision
    from veles_tpu_torch.plotting import AccumulatingPlotter, MatrixPlotter
    wf = P_mnist.MnistWorkflow(plotters=True, **MNIST)
    err_plot, conf_plot = wf.plotters
    assert isinstance(err_plot, AccumulatingPlotter)
    assert isinstance(conf_plot, MatrixPlotter)
    assert (err_plot.plot_name, conf_plot.plot_name) == (
        "validation_error", "confusion")
    # one chain: decision -> validation-error curve -> confusion -> the
    # first GD unit, so the next minibatch waits for both plots
    assert set(err_plot._links_from) == {wf.decision}
    assert set(conf_plot._links_from) == {err_plot}
    assert set(wf.gds[0]._links_from) == {conf_plot}
    # snapshot_dir= is ported (tests/test_torch_snapshot.py): it
    # attaches a Snapshotter and writes nothing before a run
    wf = P_mnist.MnistWorkflow(snapshot_dir="snap", **MNIST)
    assert wf.snapshotter.directory == "snap"
    with pytest.raises(ValueError, match="unknown layer type"):
        P_standard.StandardWorkflow(layers=[{"type": "deconv3d"}])


def test_resume_overrides_and_single_pass():
    wf = P_mnist.MnistWorkflow(
        lr_policy="exp", **dict(MNIST, max_epochs=1))
    wf.initialize(device=P_backends.Device(backend="cpu"))
    wf.run()
    assert bool(wf.decision.complete)
    wf.resume_overrides(max_epochs=2, learning_rate=0.05, momentum=0.5)
    assert not bool(wf.decision.complete)
    assert all(g.learning_rate == 0.05 == g.learning_rate_bias and
               g.momentum == 0.5 for g in wf.gds)
    assert wf.lr_scheduler.base_lr == 0.05
    with pytest.raises(TypeError, match="unexpected"):
        wf.resume_overrides(batch=3)
    wf.run()
    assert bool(wf.decision.complete)
    assert len(wf.decision.epoch_errors[2]) == 2
    wf.thread_pool.shutdown()

    once = P_mnist.MnistWorkflow(**MNIST)
    once.prepare_single_pass()
    once.initialize(device=P_backends.Device(backend="cpu"))
    once.run()
    assert once.loader.minibatches_served == 1
    once.thread_pool.shutdown()


def test_initialize_without_a_device_takes_the_card():
    """``initialize()`` with no device picks ``Device()``, the card: it
    raises here, where there is none, and never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing raises")
    wf = P_mnist.MnistWorkflow(**MNIST)
    assert isinstance(wf, AcceleratedWorkflow)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wf.initialize()
