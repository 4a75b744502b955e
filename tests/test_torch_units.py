"""Port parity of the ``nn/`` units on the CPU: ``veles_tpu_torch``'s
activation derivatives, weight filling, forward units, gradient-descent
units, evaluators, decision units and learning-rate scheduler against
the JAX package's, one unit at a time on the same numpy inputs (f32,
``compute_type`` float32 on both sides).

Tolerances. The weight filling and the host-side control units
(decisions, the scheduler's learning rates) are compared exactly: both
sides draw from the same numpy generator and run the same host
arithmetic. Pooling and dropout at ratio 0 or outside TRAIN are exact:
they select, average or pass the same values. Products, convolutions,
LRN and the evaluators differ from XLA's in summation order only:
outputs within 1e-4 of the output's scale, and the conv units' weight
gradients (here: their new velocities) within 1e-3 (the bounds of
``tests/test_torch_fused.py``). The evaluators' error counts and
confusion matrices are integers and compared exactly. Dropout at a
non-zero ratio is not compared with the reference (the port's masks are
Philox draws, not JAX's): the port is held to itself, bitwise, from one
seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import veles_tpu.accelerated_units as R_acc
import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.memory as R_memory
import veles_tpu.nn.activation as R_act
import veles_tpu.nn.all2all as R_all2all
import veles_tpu.nn.conv as R_conv
import veles_tpu.nn.decision as R_decision
import veles_tpu.nn.dropout as R_dropout
import veles_tpu.nn.evaluator as R_evaluator
import veles_tpu.nn.filling as R_filling
import veles_tpu.nn.gd as R_gd
import veles_tpu.nn.lr_policy as R_lr
import veles_tpu.nn.lrn as R_lrn
import veles_tpu.nn.pooling as R_pooling
import veles_tpu.prng as R_prng
import veles_tpu_torch.accelerated_units as P_acc
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.config as P_config
import veles_tpu_torch.memory as P_memory
import veles_tpu_torch.nn.activation as P_act
import veles_tpu_torch.nn.all2all as P_all2all
import veles_tpu_torch.nn.conv as P_conv
import veles_tpu_torch.nn.decision as P_decision
import veles_tpu_torch.nn.dropout as P_dropout
import veles_tpu_torch.nn.evaluator as P_evaluator
import veles_tpu_torch.nn.filling as P_filling
import veles_tpu_torch.nn.gd as P_gd
import veles_tpu_torch.nn.lr_policy as P_lr
import veles_tpu_torch.nn.lrn as P_lrn
import veles_tpu_torch.nn.pooling as P_pooling
import veles_tpu_torch.prng as P_prng
from veles_tpu_torch.ops import lrn as lrn_ops
from veles_tpu_torch.ops import rng as rng_ops

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

TOL = 1e-4          # share of the output's scale
TOL_CONV_GRAD = 1e-3

REF = dict(acc=R_acc, backends=R_backends, config=R_config,
           memory=R_memory, prng=R_prng, all2all=R_all2all, conv=R_conv,
           decision=R_decision, dropout=R_dropout, evaluator=R_evaluator,
           gd=R_gd, lr=R_lr, lrn=R_lrn, pooling=R_pooling)
PORT = dict(acc=P_acc, backends=P_backends, config=P_config,
            memory=P_memory, prng=P_prng, all2all=P_all2all, conv=P_conv,
            decision=P_decision, dropout=P_dropout, evaluator=P_evaluator,
            gd=P_gd, lr=P_lr, lrn=P_lrn, pooling=P_pooling)


@pytest.fixture(autouse=True)
def _f32_and_fresh_streams():
    saved = [(c.root.common.engine.compute_type, c.root.common.random.seed)
             for c in (R_config, P_config)]
    for c, p in ((R_config, R_prng), (P_config, P_prng)):
        c.root.common.engine.compute_type = "float32"
        c.root.common.random.seed = 11
        p.reset()
    yield
    for c, p, (ct, seed) in zip((R_config, P_config), (R_prng, P_prng),
                                saved):
        c.root.common.engine.compute_type = ct
        c.root.common.random.seed = seed
        p.reset()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _randn(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


class _Side:
    """One package's workflow, CPU device and Array factory."""

    def __init__(self, mods):
        self.m = mods
        self.wf = mods["acc"].AcceleratedWorkflow(None, name="units")
        self.dev = mods["backends"].Device(backend="cpu")

    def array(self, data):
        arr = self.m["memory"].Array(np.ascontiguousarray(data))
        arr.initialize(self.dev)
        return arr

    def init(self, unit, **arrays):
        for name, data in arrays.items():
            setattr(unit, name, self.array(data) if isinstance(
                data, np.ndarray) else data)
        assert unit.initialize(device=self.dev) is None
        return unit


def _both():
    return _Side(REF), _Side(PORT)


def _read(arr):
    return np.asarray(arr.map_read())


# ---------------------------------------------------------- activation

@pytest.mark.parametrize("act", sorted(R_act.DERIVATIVES))
def test_derivatives_match_reference(act):
    x = _randn(1, (6, 7), 2.0)
    y_ref = np.asarray(R_act.ACTIVATIONS[act](jnp.asarray(x)))
    y_port = P_act.ACTIVATIONS[act](torch.from_numpy(x)).numpy()
    assert _rel(y_port, y_ref) < 1e-6
    d_ref = np.asarray(R_act.DERIVATIVES[act](jnp.asarray(y_ref)))
    d_port = P_act.DERIVATIVES[act](torch.from_numpy(y_ref.copy())).numpy()
    assert d_port.dtype == np.float32
    assert _rel(d_port, d_ref) < 1e-6


# ---------------------------------------------------------- filling

@pytest.mark.parametrize("filling,kw", [
    ("uniform", {}), ("uniform", dict(stddev=0.3)),
    ("gaussian", dict(stddev=0.05)),
    ("uniform", dict(fan_in=7, fan_out=3))])
def test_fill_weights_bitwise(filling, kw):
    r = R_filling.fill_weights(R_prng.get("w"), (5, 4, 3), filling, **kw)
    p = P_filling.fill_weights(P_prng.get("w"), (5, 4, 3), filling, **kw)
    assert p.dtype == r.dtype == np.float64
    assert np.array_equal(p, r)


def test_fill_weights_rejects_unknown_filling():
    with pytest.raises(ValueError, match="weights_filling"):
        P_filling.fill_weights(P_prng.get("w"), (2, 2), "orthogonal")


# ---------------------------------------------------------- forward units

A2A = ["All2All", "All2AllTanh", "All2AllRELU", "All2AllSigmoid",
       "All2AllSoftmax"]


@pytest.mark.parametrize("cls", A2A)
def test_all2all_forward(cls):
    x = _randn(2, (5, 3, 2, 2))           # flattened in NHWC order
    outs = []
    for side in _both():
        unit = getattr(side.m["all2all"], cls)(
            side.wf, output_sample_shape=7)
        side.init(unit, input=x)
        unit.run()
        outs.append(unit)
    ref, port = outs
    assert np.array_equal(_read(port.weights), _read(ref.weights))
    assert port.weights.shape == (12, 7)
    assert _rel(_read(port.output), _read(ref.output)) < TOL
    if cls == "All2AllSoftmax":
        assert np.array_equal(_read(port.max_idx), _read(ref.max_idx))
    props, arrays = port.export_spec()
    assert props == ref.export_spec()[0]
    assert sorted(arrays) == ["bias", "weights"]


CONV_CASES = {
    "int": dict(padding=1, kx=3),
    "pair": dict(padding=(2, 1), kx=3, ky=5),
    "same": dict(padding="same", kx=3, sliding=(2, 2)),
    "valid": dict(padding="VALID", kx=2, sliding=(1, 2)),
    "pairs": dict(padding=((1, 0), (2, 1)), kx=3),
    "groups": dict(padding=1, kx=3, n_groups=2),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
@pytest.mark.parametrize("cls", ["Conv", "ConvRELU"])
def test_conv_forward(case, cls):
    kw = CONV_CASES[case]
    x = _randn(3, (2, 9, 8, 4))
    outs = []
    for side in _both():
        unit = getattr(side.m["conv"], cls)(side.wf, n_kernels=6, **kw)
        side.init(unit, input=x)
        unit.run()
        outs.append(unit)
    ref, port = outs
    assert np.array_equal(_read(port.weights), _read(ref.weights))
    assert port.output.shape == ref.output.shape
    assert _rel(_read(port.output), _read(ref.output)) < TOL
    assert port.export_spec()[0] == ref.export_spec()[0]


def test_conv_forward_grayscale_input():
    x = _randn(4, (2, 7, 7))
    outs = []
    for side in _both():
        unit = side.m["conv"].ConvTanh(side.wf, n_kernels=3, kx=3)
        side.init(unit, input=x)
        unit.run()
        outs.append(_read(unit.output))
    assert outs[1].shape == (2, 5, 5, 3)
    assert _rel(outs[1], outs[0]) < TOL


@pytest.mark.parametrize("kind", ["MaxPooling", "AvgPooling"])
def test_pooling_forward_exact(kind):
    # ties: a ReLU-like input with plateaus of zeros
    x = np.maximum(_randn(5, (2, 9, 8, 3)), 0).round(1)
    outs = []
    for side in _both():
        unit = getattr(side.m["pooling"], kind)(side.wf, kx=3,
                                                sliding=(2, 2))
        side.init(unit, input=x)
        unit.run()
        outs.append(_read(unit.output))
    assert outs[1].shape == outs[0].shape == (2, 4, 3, 3)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=0)


def test_lrn_forward():
    x = _randn(6, (2, 5, 5, 16), 3.0)
    outs = []
    for side in _both():
        unit = side.m["lrn"].LRNormalizerForward(side.wf, k=2.0, n=5,
                                                 alpha=1e-2, beta=0.75)
        side.init(unit, input=x)
        unit.run()
        outs.append(_read(unit.output))
    assert _rel(outs[1], outs[0]) < TOL


@pytest.mark.parametrize("ratio,klass", [(0.0, 2), (0.5, 1), (0.5, 0)])
def test_dropout_identity_at_ratio_zero_and_outside_train(ratio, klass):
    x = _randn(7, (4, 10))
    outs = []
    for side in _both():
        unit = side.m["dropout"].Dropout(side.wf, dropout_ratio=ratio)
        side.init(unit, input=x, minibatch_class=klass)
        unit.run()
        outs.append(_read(unit.output))
    assert np.array_equal(outs[0], x)
    assert np.array_equal(outs[1], x)


def test_dropout_masks_reproducible_on_cpu():
    """The port's masks: the stream's plain Philox fill < keep, scaled
    by 1/keep, the same on two runs from one seed; the backward unit
    multiplies by the same mask."""
    x = _randn(8, (16, 64))
    keep = 0.6
    runs = []
    for _ in range(2):
        P_prng.reset()
        side = _Side(PORT)
        unit = P_dropout.Dropout(side.wf, dropout_ratio=1 - keep)
        side.init(unit, input=x, minibatch_class=2)
        masks = []
        for _ in range(3):
            unit.run()
            masks.append(_read(unit.mask).copy())
        gd = P_dropout.GDDropout(side.wf)
        side.init(gd, err_output=x, mask=unit.mask)
        gd.run()
        runs.append((masks, _read(unit.output), _read(gd.err_input)))
    (m1, y1, e1), (m2, y2, e2) = runs
    for a, b in zip(m1, m2):
        assert np.array_equal(a, b)
    assert not np.array_equal(m1[0], m1[1])     # the stream advances
    assert np.array_equal(y1, y2) and np.array_equal(e1, e2)
    assert set(np.unique(m1[0])) == {0.0, np.float32(1 / keep)}
    assert abs((m1[0] > 0).mean() - keep) < 0.05
    # the mask is the stream's fill, drawn as the K8 kernel draws it
    P_prng.reset()
    stream = P_prng.get("dropout")
    fill = rng_ops.uniform_fill(stream.split(), x.shape, device="cpu")
    assert np.array_equal(m1[0], ((fill < keep).float() / keep).numpy())
    assert np.array_equal(y1, x * m1[-1])
    assert np.array_equal(e1, x * m1[-1])


def _softmax_inputs(batch=6, classes=5):
    logits = _randn(9, (batch, classes), 2.0)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = np.random.default_rng(9).integers(0, classes, batch).astype(
        np.int32)
    labels[-1] = -1                      # a padding row
    return probs.astype(np.float32), labels


@pytest.mark.parametrize("size", [6, 4])
def test_evaluator_softmax(size):
    probs, labels = _softmax_inputs()
    outs = []
    for side in _both():
        unit = side.m["evaluator"].EvaluatorSoftmax(side.wf)
        side.init(unit, output=probs, labels=labels, batch_size=size)
        unit.run()
        outs.append(unit)
    ref, port = outs
    assert _rel(_read(port.err_output), _read(ref.err_output)) < TOL
    assert not _read(port.err_output)[size:].any()
    assert not _read(port.err_output)[-1].any()      # label -1
    assert port.n_err == ref.n_err
    assert abs(port.loss - ref.loss) <= TOL * abs(ref.loss)
    assert abs(port.max_err_output_sum - ref.max_err_output_sum) <= \
        TOL * ref.max_err_output_sum
    assert np.array_equal(port.confusion_matrix,
                          np.asarray(ref.confusion_matrix))
    assert port.get_metric_values().keys() == \
        ref.get_metric_values().keys()


@pytest.mark.parametrize("size", [5, 3])
def test_evaluator_mse(size):
    out = _randn(10, (5, 12))
    target = _randn(11, (5, 3, 4))
    outs = []
    for side in _both():
        unit = side.m["evaluator"].EvaluatorMSE(side.wf)
        side.init(unit, output=out, target=target, batch_size=size)
        unit.run()
        outs.append(unit)
    ref, port = outs
    assert _rel(_read(port.err_output), _read(ref.err_output)) < TOL
    for attr in ("sum_sq", "sum_rmse", "max_diff"):
        assert abs(getattr(port, attr) - getattr(ref, attr)) <= \
            TOL * abs(getattr(ref, attr))


def test_evaluator_reads_the_host_once_per_minibatch(monkeypatch):
    """The counters of a minibatch come back in one device-to-host copy
    (one ``Tensor.cpu`` call), not one per scalar."""
    probs, labels = _softmax_inputs()
    side = _Side(PORT)
    unit = P_evaluator.EvaluatorSoftmax(side.wf)
    side.init(unit, output=probs, labels=labels, batch_size=6)
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls.append(tuple(self.shape))
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    unit.run()
    assert calls == [(1 + 25 + 2,)]


# ---------------------------------------------------------- GD units

HYPER = dict(learning_rate=0.05, learning_rate_bias=0.02, momentum=0.9,
             weight_decay=1e-3)


def _gd_run(side, fwd_cls, fwd_kw, gd_cls, x, err_seed, runs=2,
            need_err_input=True):
    """A forward unit on ``x``, its twin through ``gd_for``-style links:
    ``runs`` steps with the same err_output (the second sees non-zero
    velocities)."""
    fwd = fwd_cls(side.wf, **fwd_kw)
    side.init(fwd, input=x)
    fwd.run()
    err = _randn(err_seed, fwd.output.shape, 0.1)
    kw = dict(HYPER, need_err_input=need_err_input)
    if gd_cls is None:
        gd = side.m["gd"].gd_for(fwd, side.wf, **kw)
    else:
        gd = gd_cls(side.wf, **kw)
        gd.link_attrs(fwd, "input", "output", "weights", "bias")
    side.init(gd, err_output=err)
    for _ in range(runs):
        gd.run()
    return fwd, gd


@pytest.mark.parametrize("cls", A2A)
def test_gd_all2all(cls):
    x = _randn(12, (6, 2, 2, 3))
    outs = []
    for side in _both():
        outs.append(_gd_run(side, getattr(side.m["all2all"], cls),
                            dict(output_sample_shape=5), None, x, 13))
    (_, rg), (pf, pg) = outs
    assert type(pg).__name__ == type(rg).__name__
    for attr in ("weights", "bias", "velocity_weights", "velocity_bias"):
        assert _rel(_read(getattr(pg, attr)),
                    _read(getattr(rg, attr))) < TOL, attr
    assert pg.err_input.shape == x.shape
    assert _rel(_read(pg.err_input), _read(rg.err_input)) < TOL
    # the forward twin sees the updated weights (one shared Array)
    assert np.array_equal(_read(pf.weights), _read(pg.weights))


def test_gd_all2all_without_err_input_and_bias():
    x = _randn(14, (4, 6))
    outs = []
    for side in _both():
        fwd = side.m["all2all"].All2AllTanh(side.wf, output_sample_shape=3,
                                            include_bias=False)
        side.init(fwd, input=x)
        fwd.run()
        gd = side.m["gd"].gd_for(fwd, side.wf, need_err_input=False,
                                 **HYPER)
        side.init(gd, err_output=_randn(15, (4, 3)))
        gd.run()
        outs.append(gd)
    ref, port = outs
    assert not port.include_bias
    assert not port.err_input
    assert np.array_equal(_read(port.bias), np.zeros(3, np.float32))
    assert _rel(_read(port.weights), _read(ref.weights)) < TOL


GD_CONV_CASES = {
    "int": dict(padding=1, kx=3),
    "same_strided": dict(padding="SAME", kx=3, sliding=(2, 2)),
    "pairs": dict(padding=((1, 0), (2, 1)), kx=3, ky=2),
    "groups": dict(padding=1, kx=3, n_groups=2),
}


@pytest.mark.parametrize("case", sorted(GD_CONV_CASES))
@pytest.mark.parametrize("cls", ["Conv", "ConvTanh", "ConvRELU",
                                 "ConvSigmoid"])
def test_gd_conv(case, cls):
    x = _randn(16, (2, 7, 6, 4))
    outs = []
    for side in _both():
        outs.append(_gd_run(side, getattr(side.m["conv"], cls),
                            dict(n_kernels=6, **GD_CONV_CASES[case]),
                            None, x, 17))
    (_, rg), (_, pg) = outs
    assert type(pg).__name__ == type(rg).__name__
    assert _rel(_read(pg.err_input), _read(rg.err_input)) < TOL
    assert _rel(_read(pg.velocity_weights),
                _read(rg.velocity_weights)) < TOL_CONV_GRAD
    assert _rel(_read(pg.velocity_bias), _read(rg.velocity_bias)) < TOL
    assert _rel(_read(pg.weights), _read(rg.weights)) < TOL
    assert _rel(_read(pg.bias), _read(rg.bias)) < TOL


@pytest.mark.parametrize("kind", ["MaxPooling", "AvgPooling"])
def test_gd_pooling_exact(kind):
    x = np.maximum(_randn(18, (2, 9, 8, 3)), 0).round(1)
    outs = []
    for side in _both():
        fwd = getattr(side.m["pooling"], kind)(side.wf, kx=3,
                                               sliding=(2, 2))
        side.init(fwd, input=x)
        fwd.run()
        gd = side.m["gd"].gd_for(fwd, side.wf)
        side.init(gd, err_output=_randn(19, fwd.output.shape))
        gd.run()
        outs.append(_read(gd.err_input))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-6, atol=1e-7)


def test_gd_lrn_runs_the_backward_alone(monkeypatch):
    """GDLRNormalizer's err_input is the reference's vjp, and the
    backward unit never runs the forward."""
    x = _randn(20, (2, 4, 4, 12), 3.0)
    err = _randn(21, (2, 4, 4, 12))
    outs = []
    for side in _both():
        fwd = side.m["lrn"].LRNormalizerForward(side.wf, alpha=1e-2)
        side.init(fwd, input=x)
        gd = side.m["gd"].gd_for(fwd, side.wf)
        side.init(gd, err_output=err)
        if side.m is PORT:
            def no_forward(*a, **k):
                raise AssertionError("the backward unit ran the forward")
            monkeypatch.setattr(P_lrn, "_lax_fwd", no_forward)
            monkeypatch.setattr(lrn_ops, "lrn_fwd", no_forward)
        gd.run()
        outs.append(gd)
    ref, port = outs
    assert (port.k, port.n, port.alpha, port.beta) == \
        (ref.k, ref.n, ref.alpha, ref.beta)
    assert _rel(_read(port.err_input), _read(ref.err_input)) < TOL


def test_lrn_backward_plain_matches_lax():
    """The plain path (the kernels' arithmetic, the card's oracle)
    against the reference's formulation the CPU path runs."""
    x = torch.from_numpy(_randn(22, (3, 5, 24), 3.0))
    dy = torch.from_numpy(_randn(23, (3, 5, 24)))
    a = P_lrn.lrn_backward(x, dy, 2.0, 5, 1e-2, 0.75)
    b = P_lrn.lrn_backward(x, dy, 2.0, 5, 1e-2, 0.75, impl="plain")
    assert _rel(b, a) < 1e-5
    with pytest.raises(ValueError, match="CUDA"):
        P_lrn.lrn_backward(x, dy, 2.0, 5, 1e-2, 0.75, impl="cuda")


def test_gd_for_rejects_an_unknown_forward():
    side = _Side(PORT)
    with pytest.raises(TypeError, match="no backward unit"):
        P_gd.gd_for(P_decision.DecisionGD(side.wf), side.wf)


# ---------------------------------------------------------- decision

def _script(n_valid, n_train, epochs, mbs):
    """(class, size, last) per served minibatch: VALID then TRAIN."""
    out = []
    for _ in range(epochs):
        for klass, n in ((1, n_valid), (2, n_train)):
            for start in range(0, n, mbs):
                size = min(mbs, n - start)
                out.append((klass, size, start + size >= n))
    return out


@pytest.mark.parametrize("kind,max_epochs,fail", [
    ("DecisionGD", 3, 100), ("DecisionGD", None, 2),
    ("DecisionMSE", 2, 100), ("DecisionMSE", None, 1)])
def test_decision_scripted(kind, max_epochs, fail):
    script = _script(30, 50, 6, 20)
    metric_rng = np.random.default_rng(24)
    metrics = [int(metric_rng.integers(0, 10)) if kind == "DecisionGD"
               else float(metric_rng.random() * 5) for _ in script]
    traces = []
    for side in _both():
        dec = getattr(side.m["decision"], kind)(
            side.wf, max_epochs=max_epochs, fail_iterations=fail)
        holder = {"epoch": 0}
        dec.class_lengths = [0, 30, 50]
        dec.minibatch_class = 1
        dec.minibatch_size = 0
        dec.last_minibatch = False
        dec.epoch_number = 0
        setattr(dec, "n_err" if kind == "DecisionGD" else "sum_rmse", 0)
        assert dec.initialize() is None
        trace = []
        for (klass, size, last), metric in zip(script, metrics):
            dec.minibatch_class, dec.minibatch_size = klass, size
            dec.last_minibatch = last
            dec.epoch_number = holder["epoch"]
            setattr(dec, "n_err" if kind == "DecisionGD" else "sum_rmse",
                    metric)
            dec.run()
            trace.append((bool(dec.complete), bool(dec.gd_skip),
                          bool(dec.improved)))
            if last and klass == 2:
                holder["epoch"] += 1
        traces.append((trace, dict(dec.epoch_errors),
                       dec.min_validation_error, dec.min_validation_epoch,
                       dec.min_train_error, dec.get_metric_values()))
    assert traces[1] == traces[0]
    assert any(t[0] for t in traces[1][0])      # completion was reached


def test_decision_no_more_jobs_once_complete():
    side = _Side(PORT)
    dec = P_decision.DecisionGD(side.wf)
    assert dec.generate_data_for_slave() is None
    dec.complete <<= True
    from veles_tpu_torch.workflow import NoMoreJobs
    with pytest.raises(NoMoreJobs):
        dec.generate_data_for_slave()
    assert dec.job_stream_complete


# ---------------------------------------------------------- LR scheduler

@pytest.mark.parametrize("policy", [
    None, "exp", {"type": "step", "gamma": 0.5, "every": 2},
    {"type": "warmup_cosine", "warmup_epochs": 2, "total_epochs": 6},
    {"type": "inv", "gamma": 0.1, "power": 0.5}])
def test_lr_scheduler_sequence(policy):
    seqs = []
    for side in _both():
        sched = side.m["lr"].LRScheduler(side.wf, policy=policy)
        gds = [side.m["gd"].GradientDescent(side.wf, learning_rate=0.1,
                                            learning_rate_bias=0.2),
               side.m["gd"].GDTanh(side.wf, learning_rate=0.05)]
        sched.gds = gds
        sched.epoch_number = 0
        assert sched.initialize() is None
        seq = [(sched.current_lr, [(g.learning_rate, g.learning_rate_bias)
                                   for g in gds])]
        for epoch in range(1, 7):
            sched.epoch_number = epoch
            sched.minibatches_served = epoch * 7
            sched.run()
            seq.append((sched.current_lr,
                        [(g.learning_rate, g.learning_rate_bias)
                         for g in gds]))
        sched.rebase(0.3)
        sched.run()
        seq.append((sched.base_lr, gds[0].learning_rate))
        seqs.append(seq)
    assert seqs[1] == seqs[0]
