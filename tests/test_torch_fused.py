"""Port parity of the fused classifier training path on the CPU:
``veles_tpu_torch``'s conv, pooling, activations, learning-rate
policies, flagship model and ``FusedClassifierTrainer`` against the
JAX package's on the same numpy inputs (f32 on both sides).

Tolerances. Convolutions, products and the forward differ from XLA's
in summation order only: values within 1e-4 relative to the output's
scale, weight gradients within 1e-3 (``tests/test_ops.py``'s bounds
for its own conv rewrite). Pooling is exact: both sides take the same
maxima and sums of the same values, and the max pool's gradient goes
to the first maximum of each window in row-major order on both (the
select-and-scatter rule), ties on ReLU's zero plateaus included.
Trainer losses and every parameter after 1 and 3 SGD steps agree
within 1e-4 of each leaf's scale: SGD moves each weight by lr times
its gradient, so sum-order differences stay at f32 noise. The model
constructor is pure numpy on both sides and compared bitwise. Dropout is
set to ratio 0 wherever the two frameworks are compared: the port's
masks are Philox draws, not JAX's, and at ratio 0 both are the
identity.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import veles_tpu.models.flagship as JF
import veles_tpu.parallel.fused as JFused
from veles_tpu.nn.activation import ACTIVATIONS as JACT
from veles_tpu.nn.conv import conv_raw as jconv_raw
from veles_tpu.nn.conv import conv_s2d_raw as jconv_s2d_raw
from veles_tpu.nn.lr_policy import make_policy as jmake_policy
from veles_tpu.nn.pooling import pool_raw as jpool_raw
from veles_tpu_torch.models import flagship as PF
from veles_tpu_torch.nn.activation import ACTIVATIONS
from veles_tpu_torch.nn.conv import conv_raw, conv_s2d_raw
from veles_tpu_torch.nn.lr_policy import make_policy
from veles_tpu_torch.nn.pooling import pool_raw
from veles_tpu_torch.ops import lrn as lrn_ops
from veles_tpu_torch.ops import rng as rng_ops
from veles_tpu_torch.parallel import fused as PFused
from veles_tpu_torch.parallel.fused import (FusedClassifierTrainer,
                                            NonFiniteUpdate)

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

HYPER = dict(learning_rate=0.01, momentum=0.9, weight_decay=5e-4)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _no_dropout(specs):
    return tuple(("dropout", 0.0) if s[0] == "dropout" else s
                 for s in specs)


def _jax_params(trainer):
    return [{k: np.asarray(v) for k, v in p.items()}
            for p in trainer.params]


def _assert_params_close(ours, theirs, tol=1e-4):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].shape == b[k].shape
            assert _rel(a[k], b[k]) <= tol, (k, a[k].shape)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

CONV_SHAPES = [(224, 224, 3, 11, 4, 2, 8),   # AlexNet conv1
               (17, 17, 2, 3, 2, 1, 4),      # odd size, k < 2 s
               (16, 16, 4, 4, 4, 0, 6)]      # k == s, no padding


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("s2d", [False, True])
def test_conv_matches_reference(shape, s2d):
    hh, ww, cc, kk, ss, pp, oo = shape
    rng = np.random.default_rng(kk)
    x = rng.standard_normal((2, hh, ww, cc)).astype(np.float32)
    w = (rng.standard_normal((kk, kk, cc, oo)) * 0.1).astype(np.float32)
    b = rng.standard_normal(oo).astype(np.float32)
    pad = ((pp, pp), (pp, pp))
    jf, tf = (jconv_s2d_raw, conv_s2d_raw) if s2d else (jconv_raw, conv_raw)
    y_ref, vjp = jax.vjp(lambda w_: jf(jnp.asarray(x), w_, jnp.asarray(b),
                                       (ss, ss), pad, jnp.float32),
                         jnp.asarray(w))
    dy = rng.standard_normal(y_ref.shape).astype(np.float32)
    gw_ref = vjp(jnp.asarray(dy))[0]
    wt = torch.from_numpy(w).requires_grad_()
    y = tf(torch.from_numpy(x), wt, torch.from_numpy(b), (ss, ss), pad,
           torch.float32)
    y.backward(torch.from_numpy(dy))
    assert tuple(y.shape) == tuple(y_ref.shape) and y.is_contiguous()
    assert _rel(y.detach(), y_ref) <= 1e-4
    assert _rel(wt.grad, gw_ref) <= 1e-3


@pytest.mark.parametrize("padding", [((1, 1), (2, 2)), ((0, 1), (1, 0)),
                                     "SAME", "VALID"])
def test_grouped_conv_matches_reference(padding):
    """Grouped weights (I = C / groups, the groups inferred from the
    shapes as the fused trainer does), symmetric, asymmetric and
    string paddings, stride 2."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 8, 6)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 4)) * 0.2).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda w_: jconv_raw(jnp.asarray(x), w_,
                                              jnp.asarray(b), (2, 2),
                                              padding, jnp.float32),
                         jnp.asarray(w))
    dy = rng.standard_normal(y_ref.shape).astype(np.float32)
    wt = torch.from_numpy(w).requires_grad_()
    y = conv_raw(torch.from_numpy(x), wt, torch.from_numpy(b), (2, 2),
                 padding, torch.float32)
    y.backward(torch.from_numpy(dy))
    assert tuple(y.shape) == tuple(y_ref.shape)
    assert _rel(y.detach(), y_ref) <= 1e-4
    assert _rel(wt.grad, vjp(jnp.asarray(dy))[0]) <= 1e-3
    with pytest.raises(ValueError, match="group"):
        conv_raw(torch.from_numpy(x), wt, None, (1, 1), "VALID",
                 torch.float32, groups=1)


@pytest.mark.parametrize("h,w,k,s", [(55, 55, 3, 2), (13, 13, 3, 2),
                                     (8, 8, 2, 2), (9, 7, 3, 3)])
@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool_matches_reference_exactly(h, w, k, s, kind):
    """Values and gradients bitwise, on ReLU-style zero plateaus where
    max-pool windows tie."""
    rng = np.random.default_rng(h * w + k)
    x = np.maximum(rng.standard_normal((2, h, w, 5)), 0).astype(np.float32)
    weights = np.arange(1.0, 6.0, dtype=np.float32)
    y_ref = jpool_raw(kind, k, k, (s, s), jnp.asarray(x))
    g_ref = jax.grad(lambda v: (jpool_raw(kind, k, k, (s, s), v) *
                                weights).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = pool_raw(kind, k, k, (s, s), xt)
    (y * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(g_ref))


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activations_match_reference(name):
    x = np.random.default_rng(0).standard_normal((6, 7)).astype(
        np.float32) * 3
    np.testing.assert_allclose(
        ACTIVATIONS[name](torch.from_numpy(x)).numpy(),
        np.asarray(JACT[name](jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spec", [
    None, "constant", "step", "exp", "inv",
    {"type": "step", "gamma": 0.5, "every": 3},
    {"type": "inv", "gamma": 1e-2, "power": 0.5},
    {"type": "warmup_cosine", "warmup_epochs": 2, "total_epochs": 10},
    {"type": "warmup_cosine", "warmup_epochs": 0, "total_epochs": 5,
     "floor": 0.1}])
def test_lr_policies_match_reference(spec):
    ours, theirs = make_policy(spec), jmake_policy(spec)
    for epoch in range(0, 25, 3):
        for step in (0, 1, 17, 5000):
            assert ours(0.1, epoch, step) == theirs(0.1, epoch, step)
    assert make_policy(lambda b, e, s: b * 2)(0.5, 0, 0) == 1.0


# ---------------------------------------------------------------------------
# the flagship model
# ---------------------------------------------------------------------------

def _assert_bitwise(ours, theirs):
    assert ours[0] == theirs[0]
    assert len(ours[1]) == len(theirs[1])
    for a, b in zip(ours[1], theirs[1]):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert ours[2:] == theirs[2:]


def test_alexnet_fused_bitwise_equal_to_reference():
    """The full flagship (1000 classes, 224 x 224 x 3, seed 0) and the
    small parity model."""
    ours, theirs = PF.alexnet_fused(), JF.alexnet_fused()
    _assert_bitwise(ours, theirs)
    assert sum(p["w"].size + p["b"].size for p in ours[1] if p) == \
        62_378_344
    _assert_bitwise(PF.alexnet_fused(n_classes=10, image_size=64, seed=3),
                    JF.alexnet_fused(n_classes=10, image_size=64, seed=3))
    assert PF.alexnet_layers(7, 0.25) == \
        __import__("veles_tpu.models.alexnet", fromlist=["x"]) \
        .alexnet_layers(7, 0.25)


def test_flagship_specs_bitwise_equal_to_reference():
    _assert_bitwise(PF.flagship_specs((64, 32, 10), in_dim=784, seed=2),
                    JF.flagship_specs((64, 32, 10), in_dim=784, seed=2))


# ---------------------------------------------------------------------------
# the trainer against the JAX trainer
# ---------------------------------------------------------------------------

def _small_alexnet():
    specs, params, _ = PF.alexnet_fused(n_classes=10, image_size=64)
    return _no_dropout(specs), params


def _batch(seed, b=4, shape=(64, 64, 3), classes=10):
    rng = np.random.default_rng(seed)
    return (rng.random((b,) + shape, dtype=np.float32),
            rng.integers(0, classes, b).astype(np.int32))


def test_apply_forward_logits_match_reference():
    specs, params = _small_alexnet()
    x, _ = _batch(1)
    ref = JFused._apply(specs, False, [{k: jnp.asarray(v) for k, v in
                                        p.items()} for p in params],
                        jnp.asarray(x), jax.random.PRNGKey(0), jnp.float32)
    trainer = FusedClassifierTrainer(specs, params, device="cpu")
    with torch.no_grad():
        ours = PFused._apply(trainer.specs, False, trainer.params,
                             torch.from_numpy(x), 0, torch.float32)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (4, 10)
    assert _rel(ours, ref) <= 1e-4
    assert _rel(trainer.predict(x), ref) <= 1e-4


@pytest.fixture(scope="module")
def alexnet_runs():
    """1 and 3 steps of each trainer on the small AlexNet, dropout 0,
    bench.py's hyperparameters, one numpy batch per step."""
    specs, params = _small_alexnet()
    batches = [_batch(10 + i) for i in range(3)]
    runs = {}
    for side in ("jax", "port"):
        if side == "jax":
            trainer = JFused.FusedClassifierTrainer(specs, params, **HYPER)
        else:
            trainer = FusedClassifierTrainer(specs, params, device="cpu",
                                             **HYPER)
        metrics, snaps = [], []
        for x, y in batches:
            m = trainer.step(x, y)
            metrics.append((float(m["loss"]), int(m["n_err"])))
            snaps.append(_jax_params(trainer) if side == "jax"
                         else trainer.params_numpy())
        runs[side] = (metrics, snaps)
    return runs


@pytest.mark.parametrize("steps", [1, 3])
def test_trainer_steps_match_reference(alexnet_runs, steps):
    (jm, jp), (pm, pp) = alexnet_runs["jax"], alexnet_runs["port"]
    for (jl, je), (pl, pe) in zip(jm[:steps], pm[:steps]):
        assert abs(pl - jl) <= 1e-4 * abs(jl)
        assert pe == je
    _assert_params_close(pp[steps - 1], jp[steps - 1])
    # the params moved: the comparison is not of two initial states
    assert _rel(pp[steps - 1][0]["w"], _small_alexnet()[1][0]["w"]) > 1e-6


def test_fc_stack_trains_like_reference():
    """``flagship_specs``' FC stack: tanh layers and the softmax tail,
    3 steps with an lr policy, then training continued from the JAX
    trainer's params, momentum and step count (``load_state``)."""
    specs, params = PF.flagship_specs((64, 32, 10), in_dim=784)
    policy = {"type": "inv", "gamma": 0.1, "power": 0.75}
    kw = dict(HYPER, lr_policy=policy)
    jt = JFused.FusedClassifierTrainer(specs, params, **kw)
    pt = FusedClassifierTrainer(specs, params, device="cpu", **kw)
    for i in range(3):
        x, y = _batch(20 + i, b=16, shape=(784,))
        jm, pm = jt.step(x, y), pt.step(x, y)
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= \
            1e-4 * abs(float(jm["loss"]))
        assert int(pm["n_err"]) == int(jm["n_err"])
    _assert_params_close(pt.params_numpy(), _jax_params(jt))
    resumed = FusedClassifierTrainer(specs, params, device="cpu", **kw)
    resumed.load_state(_jax_params(jt), [{k: np.asarray(v) for k, v in
                                          p.items()} for p in jt.velocity],
                       step=3)
    x, y = _batch(30, b=16, shape=(784,))
    jt.step(x, y)
    resumed.step(x, y)
    _assert_params_close(resumed.params_numpy(), _jax_params(jt))


def test_predict_and_count_errors_with_padding_match_reference():
    specs, params = PF.flagship_specs((64, 32, 10), in_dim=784, seed=4)
    jt = JFused.FusedClassifierTrainer(specs, params, **HYPER)
    pt = FusedClassifierTrainer(specs, params, device="cpu", **HYPER)
    x, y = _batch(5, b=24, shape=(784,))
    y[-5:] = -1                         # padding rows
    assert _rel(pt.predict(x), jt.predict(x)) <= 1e-5
    assert pt.count_errors(x, y) == jt.count_errors(x, y)
    pred = pt.predict(x).argmax(-1).numpy()
    assert pt.count_errors(x, y) == int(((pred != y) & (y >= 0)).sum())
    # a step on the padded batch: padding rows count in neither loss
    # nor errors
    jm, pm = jt.step(x, y), pt.step(x, y)
    assert abs(float(pm["loss"]) - float(jm["loss"])) <= \
        1e-4 * abs(float(jm["loss"]))
    assert int(pm["n_err"]) == int(jm["n_err"]) <= 19


# ---------------------------------------------------------------------------
# the trainer on its own
# ---------------------------------------------------------------------------

def _small_convnet(dropout=0.5):
    """Every layer kind of the flagship at a few channels (conv with
    the space-to-depth stem, LRN, max pool, FC, dropout, softmax)."""
    layers = [
        {"type": "conv_relu", "n_kernels": 8, "kx": 5, "sliding": (2, 2),
         "padding": 2},
        {"type": "lrn"},
        {"type": "max_pooling", "kx": 3, "sliding": (2, 2)},
        {"type": "conv_relu", "n_kernels": 16, "kx": 3, "padding": 1},
        {"type": "lrn", "n": 4},
        {"type": "avg_pooling", "kx": 2, "sliding": (2, 2)},
        {"type": "all2all_relu", "output_sample_shape": 32},
        {"type": "dropout", "dropout_ratio": dropout},
        {"type": "softmax", "output_sample_shape": 10}]
    specs, params, _ = PF.fused_from_layer_dicts(layers, (24, 24, 3))
    return specs, params


def test_step_many_equals_steps_bitwise_with_dropout():
    """Dropout 0.5 on: the masks are keyed by (seed, step, layer), so
    one step_many(3) equals 3 steps bitwise, and a different dropout
    seed gives another trajectory."""
    specs, params = _small_convnet()
    xs = np.stack([_batch(40 + i, b=6, shape=(24, 24, 3))[0]
                   for i in range(3)])
    ys = np.stack([_batch(40 + i, b=6, shape=(24, 24, 3))[1]
                   for i in range(3)])
    one = FusedClassifierTrainer(specs, params, device="cpu", **HYPER)
    losses = [float(one.step(x, y)["loss"]) for x, y in zip(xs, ys)]
    many = FusedClassifierTrainer(specs, params, device="cpu", **HYPER)
    out = many.step_many(xs, ys)
    assert tuple(out["loss"].shape) == (3,) and out["n_err"].shape == (3,)
    assert out["loss"].tolist() == losses
    for a, b in zip(one.params_numpy(), many.params_numpy()):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(one.velocity, many.velocity):
        for k in a:
            assert torch.equal(a[k], b[k])
    listed = FusedClassifierTrainer(specs, params, device="cpu", **HYPER)
    assert listed.step_many(list(xs), list(ys))["loss"].tolist() == losses
    other = FusedClassifierTrainer(specs, params, device="cpu",
                                   dropout_seed=1, **HYPER)
    assert float(other.step(xs[0], ys[0])["loss"]) != losses[0]


def test_dropout_masks_come_from_the_fill():
    """A dropout layer multiplies by (fill < keep) / keep with the fill
    keyed by fold_in(step seed, layer index)."""
    specs = (("fc", "linear"), ("dropout", 0.25), ("fc", "softmax"))
    rng = np.random.default_rng(0)
    params = [{"w": np.eye(6, dtype=np.float32),
               "b": np.zeros(6, np.float32)},
              {},
              {"w": np.eye(6, dtype=np.float32),
               "b": np.zeros(6, np.float32)}]
    x = torch.from_numpy(rng.random((5, 6), dtype=np.float32))
    trainer = FusedClassifierTrainer(specs, params, device="cpu")
    out = PFused._apply(trainer.specs, True, trainer.params, x, 1234,
                        torch.float32)
    fill = rng_ops.uniform_fill(rng_ops.fold_in(1234, 1), (5, 6),
                                device="cpu")
    expect = x * ((fill < 0.75).float() / 0.75)
    assert torch.equal(out.detach(), expect)


def _nan_setup():
    specs = [("fc", "relu"), ("fc", "softmax")]
    r = np.random.RandomState(0)
    params = [{"w": r.randn(8, 16).astype(np.float32),
               "b": np.zeros(16, np.float32)},
              {"w": r.randn(16, 4).astype(np.float32),
               "b": np.zeros(4, np.float32)}]
    x = np.random.RandomState(1).randn(32, 8).astype(np.float32)
    y = np.random.RandomState(2).randint(0, 4, 32)
    xbad = x.copy()
    xbad[0, 0] = np.nan
    return specs, params, x, y, xbad


def test_nan_policy_skip_raise_warn(caplog):
    """As the reference's sentinel test: skip leaves params and
    momentum bitwise intact on a NaN batch and counts it, raise raises,
    warn applies and warns LAG dispatches late."""
    specs, params, x, y, xbad = _nan_setup()
    with pytest.raises(ValueError):
        FusedClassifierTrainer(specs, params, nan_policy="eh",
                               device="cpu")
    tr = FusedClassifierTrainer(specs, params, nan_policy="skip",
                                device="cpu")
    tr.step(x, y)
    pw = tr.params[0]["w"].detach().clone()
    vw = tr.velocity[0]["w"].clone()
    pb = tr.params[1]["b"].detach().clone()
    metrics = tr.step(xbad, y)
    assert int(metrics["nonfinite"]) == 1
    assert torch.equal(tr.params[0]["w"].detach(), pw)
    assert torch.equal(tr.velocity[0]["w"], vw)
    assert torch.equal(tr.params[1]["b"].detach(), pb)
    assert tr.nonfinite_count == 1
    tr.step(x, y)                      # training continues cleanly
    assert tr.nonfinite_count == 1
    assert not torch.equal(tr.params[0]["w"].detach(), pw)

    with pytest.raises(NonFiniteUpdate):
        FusedClassifierTrainer(specs, params, nan_policy="raise",
                               device="cpu").step(xbad, y)
    tw = FusedClassifierTrainer(specs, params, nan_policy="warn",
                                device="cpu")
    with caplog.at_level(logging.WARNING, "FusedClassifierTrainer"):
        tw.step(xbad, y)
        assert not caplog.records      # lagged
        assert tw.nonfinite_count == 1
        assert caplog.records
    assert not np.isfinite(tw.params_numpy()[0]["w"]).all()


def test_skip_step_many_equals_steps():
    specs, params, x, y, xbad = _nan_setup()
    a = FusedClassifierTrainer(specs, params, nan_policy="skip",
                               device="cpu")
    for xb in (x, xbad, x):
        a.step(xb, y)
    b = FusedClassifierTrainer(specs, params, nan_policy="skip",
                               device="cpu")
    out = b.step_many(np.stack([x, xbad, x]), np.stack([y, y, y]))
    assert out["nonfinite"].tolist() == [0, 1, 0]
    assert a.nonfinite_count == b.nonfinite_count == 1
    for pa, pb in zip(a.params_numpy(), b.params_numpy()):
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k])


def test_params_numpy_round_trips():
    specs, params, _ = PF.alexnet_fused(n_classes=10, image_size=64,
                                        seed=5)
    specs = _no_dropout(specs)
    trainer = FusedClassifierTrainer(specs, params, device="cpu", **HYPER)
    for p, q in zip(trainer.params_numpy(), params):
        assert sorted(p) == sorted(q)
        for k in p:
            assert p[k].dtype == np.float32
            np.testing.assert_array_equal(p[k], q[k])
    x, y = _batch(6)
    trainer.step(x, y)
    out = trainer.params_numpy()
    copy = FusedClassifierTrainer(specs, out, device="cpu")
    assert torch.equal(copy.predict(x), trainer.predict(x))
    out[0]["w"][:] = 0          # a copy, not a view of the trainer's
    assert float(trainer.params[0]["w"].detach().abs().sum()) > 0


def test_trainer_options_and_device_policy(monkeypatch):
    specs, params = PF.flagship_specs((8, 4), in_dim=6)
    with pytest.raises(ValueError, match="kernel_impl"):
        FusedClassifierTrainer(specs, params, device="cpu",
                               kernel_impl="triton")
    with pytest.raises(ValueError, match="CUDA"):
        FusedClassifierTrainer(specs, params, device="cpu",
                               kernel_impl="cuda")
    with pytest.raises(ValueError, match="param entries"):
        FusedClassifierTrainer(specs, params[:1], device="cpu")
    assert FusedClassifierTrainer(specs, params, device="cpu",
                                  compute_dtype="bfloat16"
                                  ).compute_dtype is torch.bfloat16
    assert FusedClassifierTrainer(specs, params, device="cpu"
                                  ).compute_dtype is torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedClassifierTrainer(specs, params)


def test_plain_kernel_impl_on_cpu_trains_and_counts_no_launch():
    """``kernel_impl="plain"`` runs the kernels' plain versions (the
    Pallas LRN formula, the plain fill) and launches nothing; at f32 it
    agrees with the default CPU path (the lax LRN formula), dropout
    masks included."""
    specs, params = _small_convnet()
    x, y = _batch(7, b=6, shape=(24, 24, 3))
    lrn_ops.reset_launches()
    rng_ops.reset_launches()
    runs = {}
    for impl in (None, "plain"):
        t = FusedClassifierTrainer(specs, params, device="cpu",
                                   kernel_impl=impl, **HYPER)
        runs[impl] = (float(t.step(x, y)["loss"]), t.params_numpy())
    assert abs(runs[None][0] - runs["plain"][0]) <= 1e-5 * runs[None][0]
    _assert_params_close(runs["plain"][1], runs[None][1], tol=1e-5)
    assert set(lrn_ops.LAUNCHES.values()) == {0}
    assert rng_ops.LAUNCHES["uniform_fill"] == 0
