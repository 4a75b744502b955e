"""Port parity of the four unit families on the CPU: ``veles_tpu_torch``'s
deconvolution and depooling (``nn/deconv.py``), LSTM (``nn/rnn.py``),
RBM (``nn/rbm.py``) and Kohonen map (``nn/kohonen.py``) units, their
trainers and ``gd_for`` branches against the JAX package's, one unit at
a time on the same numpy inputs (f32, ``compute_type`` float32 on both
sides).

Tolerances. Initial weights and codebooks are host draws from the same
numpy generators: bitwise. Depooling and its backward select values:
exact. Products, convolutions and the LSTM's recursion differ from
XLA's in summation order only: within 1e-4 of each result's scale
(the bound ``tests/test_torch_units.py`` holds its units to), and the
deconv units' weight gradients (their new velocities) within 1e-3, the
conv units' bound there. The RBM's CD-1 is compared with the
reference's own uniform draw injected as the port's fill (the draw
``jax.random.bernoulli`` compares with), so both sample the same bits;
winners and error counts are integers and compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import veles_tpu.accelerated_units as R_acc
import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.memory as R_memory
import veles_tpu.models.standard as R_standard
import veles_tpu.nn.deconv as R_deconv
import veles_tpu.nn.gd as R_gd
import veles_tpu.nn.kohonen as R_kohonen
import veles_tpu.nn.rbm as R_rbm
import veles_tpu.nn.rnn as R_rnn
import veles_tpu.prng as R_prng
import veles_tpu.units as R_units
import veles_tpu_torch.accelerated_units as P_acc
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.config as P_config
import veles_tpu_torch.memory as P_memory
import veles_tpu_torch.models.standard as P_standard
import veles_tpu_torch.nn.deconv as P_deconv
import veles_tpu_torch.nn.gd as P_gd
import veles_tpu_torch.nn.kohonen as P_kohonen
import veles_tpu_torch.nn.rbm as P_rbm
import veles_tpu_torch.nn.rnn as P_rnn
import veles_tpu_torch.prng as P_prng
import veles_tpu_torch.units as P_units

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

TOL = 1e-4          # share of the result's scale
TOL_DECONV_GRAD = 1e-3

REF = dict(acc=R_acc, backends=R_backends, memory=R_memory, prng=R_prng,
           deconv=R_deconv, gd=R_gd, rnn=R_rnn, rbm=R_rbm,
           kohonen=R_kohonen)
PORT = dict(acc=P_acc, backends=P_backends, memory=P_memory, prng=P_prng,
            deconv=P_deconv, gd=P_gd, rnn=P_rnn, rbm=P_rbm,
            kohonen=P_kohonen)
HYPER = dict(learning_rate=0.05, momentum=0.9, weight_decay=1e-3)


@pytest.fixture(autouse=True)
def _f32_and_fresh_streams():
    saved = [(c.root.common.engine.compute_type, c.root.common.random.seed)
             for c in (R_config, P_config)]
    for c, p in ((R_config, R_prng), (P_config, P_prng)):
        c.root.common.engine.compute_type = "float32"
        c.root.common.random.seed = 13
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
        self.wf = mods["acc"].AcceleratedWorkflow(None, name="families")
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


# ---------------------------------------------------------- deconv

PADDINGS = {"same": "SAME", "valid": "VALID", "int": 1, "pair": (2, 1)}


@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("padding", sorted(PADDINGS))
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_deconv_raw(k, stride, padding, odd):
    x = _randn(1, (2, 5, 7, 3) if odd else (2, 6, 4, 3))
    w = _randn(2, (k, k + 1, 3, 4), 0.3)      # ky = k, kx = k + 1
    b = _randn(3, (4,))
    pad = R_deconv.normalize_padding(PADDINGS[padding])
    assert P_deconv.normalize_padding(PADDINGS[padding]) == pad
    strides = (stride, 3 - stride % 2)         # uneven (sh, sw)
    want = np.asarray(R_deconv.deconv_raw(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), strides, pad,
        jnp.float32))
    got = P_deconv.deconv_raw(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), strides, pad,
                              torch.float32).numpy()
    assert got.shape == want.shape
    assert P_deconv.deconv_output_hw(x.shape[1], x.shape[2], k, k + 1,
                                     strides, pad) == want.shape[1:3]
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("padding", sorted(PADDINGS))
@pytest.mark.parametrize("cls", ["Deconv", "DeconvTanh", "DeconvRELU",
                                 "DeconvSigmoid"])
def test_deconv_unit_forward(cls, padding):
    """The unit's weights (bitwise), output shape (the reference's
    ``eval_shape``), output and export spec."""
    x = _randn(4, (2, 5, 6, 3))
    outs = []
    for side in _both():
        unit = getattr(side.m["deconv"], cls)(
            side.wf, n_kernels=4, kx=3, sliding=(2, 2),
            padding=PADDINGS[padding])
        side.init(unit, input=x)
        unit.run()
        outs.append(unit)
    ref, port = outs
    assert np.array_equal(_read(port.weights), _read(ref.weights))
    assert tuple(port.output.shape) == tuple(ref.output.shape)
    assert _rel(_read(port.output), _read(ref.output)) < TOL
    assert port.export_spec()[0] == ref.export_spec()[0]
    assert sorted(port.export_spec()[1]) == sorted(ref.export_spec()[1])


def test_deconv_unit_grayscale_input():
    x = _randn(5, (2, 7, 7))
    outs = []
    for side in _both():
        unit = side.m["deconv"].Deconv(side.wf, n_kernels=2, kx=4,
                                       sliding=(3, 3), padding="VALID")
        side.init(unit, input=x)
        unit.run()
        outs.append(unit)
    ref, port = outs
    assert port.weights.shape == (4, 4, 1, 2)
    assert port.output.shape == ref.output.shape == (2, 22, 22, 2)
    assert _rel(_read(port.output), _read(ref.output)) < TOL


def _gd_deconv(side, cls, include_bias=True, need_err_input=True,
               runs=2):
    x = _randn(6, (3, 5, 4, 3))
    fwd = getattr(side.m["deconv"], cls)(
        side.wf, n_kernels=2, kx=3, sliding=(2, 2),
        include_bias=include_bias)
    side.init(fwd, input=x)
    fwd.run()
    gd = side.m["gd"].gd_for(fwd, side.wf, need_err_input=need_err_input,
                             **HYPER)
    side.init(gd, err_output=_randn(7, fwd.output.shape, 0.1))
    for _ in range(runs):
        gd.run()
    return fwd, gd


@pytest.mark.parametrize("cls", ["Deconv", "DeconvTanh", "DeconvRELU",
                                 "DeconvSigmoid"])
def test_gd_deconv(cls):
    (_, rg), (pf, pg) = (_gd_deconv(side, cls) for side in _both())
    assert type(pg).__name__ == type(rg).__name__ == "GD" + cls
    assert pg.err_input.shape == (3, 5, 4, 3)
    assert _rel(_read(pg.err_input), _read(rg.err_input)) < TOL
    assert _rel(_read(pg.velocity_weights),
                _read(rg.velocity_weights)) < TOL_DECONV_GRAD
    for attr in ("weights", "bias", "velocity_bias"):
        assert _rel(_read(getattr(pg, attr)),
                    _read(getattr(rg, attr))) < TOL, attr
    assert np.array_equal(_read(pf.weights), _read(pg.weights))


@pytest.mark.parametrize("include_bias,need_err_input",
                         [(False, True), (True, False), (False, False)])
def test_gd_deconv_without_bias_or_err_input(include_bias, need_err_input):
    (_, rg), (_, pg) = (_gd_deconv(side, "DeconvTanh", include_bias,
                                   need_err_input) for side in _both())
    assert pg.include_bias == include_bias
    assert bool(pg.err_input) == need_err_input
    if need_err_input:
        assert _rel(_read(pg.err_input), _read(rg.err_input)) < TOL
    if not include_bias:
        assert np.array_equal(_read(pg.bias), np.zeros(2, np.float32))
        assert np.array_equal(_read(pg.velocity_bias),
                              np.zeros(2, np.float32))
    for attr in ("weights", "bias"):
        assert _rel(_read(getattr(pg, attr)),
                    _read(getattr(rg, attr))) < TOL, attr
    assert _rel(_read(pg.velocity_weights),
                _read(rg.velocity_weights)) < TOL_DECONV_GRAD


@pytest.mark.parametrize("shape,k", [((2, 4, 3, 5), (2, 2)),
                                     ((3, 3, 5), (3, 2))])
def test_depooling_and_its_twin_exact(shape, k):
    x = _randn(8, shape)
    outs = []
    for side in _both():
        fwd = side.m["deconv"].Depooling(side.wf, ky=k[0], kx=k[1])
        side.init(fwd, input=x)
        fwd.run()
        gd = side.m["gd"].gd_for(fwd, side.wf)
        side.init(gd, err_output=_randn(9, fwd.output.shape))
        gd.run()
        outs.append((fwd, gd))
    (rf, rg), (pf, pg) = outs
    assert type(pg).__name__ == "GDDepooling"
    assert np.array_equal(_read(pf.output), _read(rf.output))
    assert np.array_equal(_read(pg.err_input), _read(rg.err_input))
    assert pg.err_input.shape == shape
    assert pf.export_spec() == rf.export_spec()


# ---------------------------------------------------------- LSTM

@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_scan(with_state):
    b, t, f, h = 3, 6, 5, 4
    args = [_randn(10, (b, t, f)), _randn(11, (f, 4 * h), 0.5),
            _randn(12, (h, 4 * h), 0.5), _randn(13, (4 * h,), 0.1)]
    if with_state:
        args += [_randn(14, (b, h)), _randn(15, (b, h))]
    want = R_rnn.lstm_scan(*(jnp.asarray(a) for a in args))
    got = P_rnn.lstm_scan(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert _rel(g.numpy(), np.asarray(w)) < TOL
    assert np.array_equal(got[1].numpy(), got[0][:, -1].numpy())


def test_lstm_unit_forward():
    x = _randn(16, (3, 7, 4))
    outs = []
    for side in _both():
        unit = side.m["rnn"].LSTM(side.wf, hidden=6)
        side.init(unit, input=x)
        unit.run()
        outs.append(unit)
    ref, port = outs
    for attr in ("weights_x", "weights_h", "bias"):
        assert np.array_equal(_read(getattr(port, attr)),
                              _read(getattr(ref, attr))), attr
    assert np.all(_read(port.bias)[6:12] == 1.0)
    assert port.output.shape == (3, 7, 6)
    assert _rel(_read(port.output), _read(ref.output)) < TOL
    props, arrays = port.export_spec()
    assert props == ref.export_spec()[0]
    assert sorted(arrays) == ["bias", "weights_h", "weights_x"]


def test_gd_lstm_three_steps_with_momentum_and_decay():
    x = _randn(17, (4, 5, 3))
    outs = []
    for side in _both():
        fwd = side.m["rnn"].LSTM(side.wf, hidden=5)
        side.init(fwd, input=x)
        gd = side.m["gd"].gd_for(fwd, side.wf, **HYPER)
        side.init(gd, err_output=_randn(18, (4, 5, 5), 0.1))
        for _ in range(3):
            fwd.run()
            gd.run()
        outs.append((fwd, gd))
    (_, rg), (pf, pg) = outs
    assert type(pg).__name__ == "GDLSTM"
    for attr in ("weights_x", "weights_h", "bias", "velocity_wx",
                 "velocity_wh", "velocity_b", "err_input"):
        assert _rel(_read(getattr(pg, attr)),
                    _read(getattr(rg, attr))) < TOL, attr
    assert pg.weights_x is pf.weights_x
    assert pg.err_input.shape == x.shape


# ---------------------------------------------------------- RBM

def test_rbm_forward():
    x = (np.random.default_rng(19).random((6, 4, 5)) > 0.5).astype(
        np.float32)
    outs = []
    for side in _both():
        unit = side.m["rbm"].RBM(side.wf, n_hidden=7)
        side.init(unit, input=x)
        unit.run()
        outs.append(unit)
    ref, port = outs
    for attr in ("weights", "vbias", "hbias"):
        assert np.array_equal(_read(getattr(port, attr)),
                              _read(getattr(ref, attr))), attr
    assert port.output.shape == (6, 7)
    assert _rel(_read(port.output), _read(ref.output)) < TOL
    assert port.export_spec()[0] == ref.export_spec()[0]
    assert port.EXPORT_UUID == ref.EXPORT_UUID == "veles.tpu.all2all"


def _rbm_pair(batch_size, steps=3):
    """RBM + RBMTrainer on both sides over the same minibatches; the
    port's fill is the reference's uniform draw under the key its
    trainer split for that step."""
    data = (np.random.default_rng(20).random((steps, 8, 12)) > 0.6
            ).astype(np.float32)
    sides = []
    for side in _both():
        rbm = side.m["rbm"].RBM(side.wf, n_hidden=6)
        side.init(rbm, input=data[0])
        trainer = side.m["rbm"].RBMTrainer(side.wf, learning_rate=0.3)
        trainer.link_attrs(rbm, "input", "weights", "vbias", "hbias")
        side.init(trainer, batch_size=batch_size)
        sides.append((rbm, trainer))
    (rr, rt), (pr, pt) = sides
    keys = []
    split = rt.rand.split

    def recording_split():
        keys.append(split())
        return keys[-1]

    rt.rand.split = recording_split

    def injected(shape, dtype=None, device=None):
        return torch.from_numpy(np.array(jax.random.uniform(
            keys[-1], shape, jnp.float32)))

    pt.rand.uniform = injected
    errs = []
    for step in range(steps):
        for rbm in (rr, pr):
            rbm.input.reset(data[step])
            rbm.input.initialize(rbm.device)
        rt.run()
        pt.run()
        errs.append((rt.recon_err, pt.recon_err))
    return (rr, rt), (pr, pt), errs


@pytest.mark.parametrize("batch_size", [8, 5])
def test_rbm_cd1_with_the_reference_fill(batch_size):
    (rr, _), (pr, _), errs = _rbm_pair(batch_size)
    for attr in ("weights", "vbias", "hbias"):
        assert _rel(_read(getattr(pr, attr)),
                    _read(getattr(rr, attr))) < TOL, attr
    for want, got in errs:
        assert abs(got - want) <= TOL * abs(want)


def test_rbm_cd1_function_with_injected_fill():
    rng = np.random.default_rng(21)
    w = (rng.standard_normal((10, 6)) * 0.1).astype(np.float32)
    vb = (rng.standard_normal(10) * 0.1).astype(np.float32)
    hb = (rng.standard_normal(6) * 0.1).astype(np.float32)
    v0 = (rng.random((7, 10)) > 0.5).astype(np.float32)
    key = jax.random.PRNGKey(3)
    fill = np.array(jax.random.uniform(key, (7, 6), jnp.float32))
    want = R_rbm._rbm_cd1(jnp.asarray(w), jnp.asarray(vb), jnp.asarray(hb),
                          jnp.asarray(v0), key, 4, 0.2, jnp.float32)
    tw, tvb, thb = (torch.from_numpy(a.copy()) for a in (w, vb, hb))
    err = P_rbm._rbm_cd1(tw, tvb, thb, torch.from_numpy(v0),
                         torch.from_numpy(fill), 4, 0.2, torch.float32)
    for got, ref in zip((tw, tvb, thb, err), want):
        assert _rel(got.numpy(), np.asarray(ref)) < TOL


def test_rbm_samples_reproducible_on_cpu():
    """Two port runs from one seed: the trainer's fills (its
    ``rbm_sample`` stream's Philox draws) and so its updates, bitwise."""
    data = (np.random.default_rng(22).random((4, 9, 8)) > 0.5).astype(
        np.float32)
    runs = []
    for _ in range(2):
        P_prng.reset()
        side = _Side(PORT)
        rbm = P_rbm.RBM(side.wf, n_hidden=5)
        side.init(rbm, input=data[0])
        trainer = P_rbm.RBMTrainer(side.wf)
        trainer.link_attrs(rbm, "input", "weights", "vbias", "hbias")
        side.init(trainer, batch_size=9)
        errs = []
        for x in data:
            rbm.input.reset(x)
            rbm.input.initialize(side.dev)
            trainer.run()
            errs.append(trainer.recon_err)
        runs.append((errs, _read(rbm.weights).copy(),
                     trainer.rand.state[1]))
    (e1, w1, c1), (e2, w2, c2) = runs
    assert e1 == e2 and np.array_equal(w1, w2)
    assert c1 == c2 == len(data)


# ---------------------------------------------------------- Kohonen

def test_winners():
    x = _randn(23, (9, 2, 3))
    cb = _randn(24, (5, 6))
    cb[3] = cb[1]                                   # a tie: first wins
    want = R_kohonen._winners(jnp.asarray(x), jnp.asarray(cb), jnp.float32)
    got = P_kohonen._winners(torch.from_numpy(x), torch.from_numpy(cb),
                             torch.float32)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int32
    assert _rel(got[1].numpy(), np.asarray(want[1])) < TOL
    assert 3 not in got[0].numpy()


@pytest.mark.parametrize("batch_size", [12, 9])
def test_kohonen_trainer_ten_steps(batch_size):
    rng = np.random.default_rng(25)
    centers = np.array([[0, 0, 0], [3, 3, 0], [0, 3, 3]], np.float32)
    data = [(centers[rng.integers(0, 3, 12)] +
             rng.standard_normal((12, 3)).astype(np.float32) * 0.1)
            for _ in range(10)]
    sides = []
    for side in _both():
        som = side.m["kohonen"].KohonenForward(side.wf, shape=(3, 4))
        side.init(som, input=data[0])
        trainer = side.m["kohonen"].KohonenTrainer(side.wf, decay=0.05)
        trainer.link_attrs(som, "input", "codebook")
        trainer.grid = som.grid_positions
        side.init(trainer, batch_size=batch_size)
        sides.append((som, trainer, _read(som.codebook).copy(), []))
    (_, _, r_cb0, r_log), (_, _, p_cb0, p_log) = sides
    assert np.array_equal(p_cb0, r_cb0)
    for x in data:
        for som, trainer, _, log in sides:
            som.input.reset(x)
            som.input.initialize(som.device)
            som.run()                 # the winners the step will use
            winners = _read(som.output).copy()
            trainer.run()
            log.append((winners, trainer.avg_quantization_err))
            if hasattr(trainer, "winners"):   # the port keeps them
                assert np.array_equal(trainer.winners.numpy(), winners)
    for (rw, re), (pw, pe) in zip(r_log, p_log):
        assert np.array_equal(pw, rw)
        assert abs(pe - re) <= TOL * abs(re)
    (rs, rt, _, _), (ps, pt, _, _) = sides
    assert _rel(_read(ps.codebook), _read(rt.codebook)) < TOL
    assert pt.step_count == rt.step_count == 10
    assert pt.radius == rt.radius
    assert ps.export_spec()[0] == rs.export_spec()[0]


# ---------------------------------------------------------- dispatch

def test_gd_for_new_dispatches_and_shared_arrays():
    side = _Side(PORT)
    x = _randn(26, (2, 4, 4, 3))
    deconv = P_deconv.DeconvRELU(side.wf, n_kernels=2, kx=3, sliding=2,
                                 padding=(1, 1), include_bias=False)
    side.init(deconv, input=x)
    gd = P_gd.gd_for(deconv, side.wf, name="gd_deconv", **HYPER)
    assert type(gd) is P_deconv.GDDeconvRELU
    assert gd.name == "gd_deconv"
    assert (gd.sliding, gd.padding, gd.include_bias) == \
        (deconv.sliding, deconv.padding, False)
    assert (gd.learning_rate, gd.momentum, gd.weight_decay) == \
        (0.05, 0.9, 1e-3)
    for attr in ("input", "output", "weights", "bias"):
        assert getattr(gd, attr) is getattr(deconv, attr), attr

    depool = P_deconv.Depooling(side.wf, kx=2, ky=3)
    side.init(depool, input=x)
    gd = P_gd.gd_for(depool, side.wf)
    assert type(gd) is P_deconv.GDDepooling
    assert (gd.ky, gd.kx) == (3, 2) and gd.input is depool.input

    lstm = P_rnn.LSTM(side.wf, hidden=3)
    side.init(lstm, input=_randn(27, (2, 4, 5)))
    gd = P_gd.gd_for(lstm, side.wf, learning_rate=0.2)
    assert type(gd) is P_rnn.GDLSTM
    assert (gd.learning_rate, gd.momentum, gd.need_err_input) == \
        (0.2, 0.0, True)
    for attr in ("input", "weights_x", "weights_h", "bias"):
        assert getattr(gd, attr) is getattr(lstm, attr), attr

    class DeconvSoftsign(P_deconv.Deconv):
        ACTIVATION = "softsign"
        MAPPING = None
        hide_from_registry = True

    odd = DeconvSoftsign(side.wf, n_kernels=1, kx=2)
    with pytest.raises(TypeError, match="no GDDeconv variant"):
        P_gd.gd_for(odd, side.wf)


# ---------------------------------------------------------- registries

def test_registries_equal_the_reference():
    assert set(P_standard.layer_types()) == set(R_standard.layer_types())
    assert {"deconv", "deconv_tanh", "deconv_relu", "deconv_sigmoid",
            "depooling", "lstm"} <= set(P_standard.layer_types())
    unsup = P_units.UnitRegistry.mapped["unsupervised"]
    assert set(unsup) == set(R_units.UnitRegistry.mapped["unsupervised"])
    assert {"rbm", "kohonen"} <= set(unsup)
    assert not {"rbm", "kohonen"} & set(P_standard.layer_types())
    assert unsup["rbm"] is P_rbm.RBM
    assert unsup["kohonen"] is P_kohonen.KohonenForward


def test_new_units_need_the_card_without_a_device(monkeypatch):
    """A unit of the new families initialized with no device takes
    ``Device()``, the card, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wf = P_acc.AcceleratedWorkflow(None, name="families")
    for unit, x in ((P_deconv.Deconv(wf, n_kernels=1, kx=2),
                     _randn(28, (1, 3, 3, 2))),
                    (P_rnn.LSTM(wf, hidden=2), _randn(29, (1, 3, 2))),
                    (P_rbm.RBM(wf, n_hidden=2), _randn(30, (2, 4))),
                    (P_kohonen.KohonenForward(wf), _randn(31, (2, 4)))):
        unit.input = P_memory.Array(x)
        with pytest.raises(RuntimeError, match="backend='cpu'"):
            unit.initialize()
