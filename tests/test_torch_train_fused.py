"""Port parity of the unit graph's way onto the fused plane and into
serving: ``fuse_forwards``, ``FusedClassifierTrainer.from_forwards``,
``write_back`` and ``train_fused`` (``veles_tpu_torch.parallel.fused``)
and ``InferenceEngine.from_forwards`` / ``from_workflow`` /
``from_snapshot`` (``veles_tpu_torch.serve.engine``), against the JAX
package's, on the CPU at f32.

Tolerances. ``fuse_forwards`` reads the same initial weights as the
reference (bitwise: the same numpy draws), so its specs are equal and
its params bitwise. ``train_fused`` then trains through both
frameworks: the error counts (so every error percentage) are equal,
and the trained weights agree within 1e-4 of their scale (the sum
orders differ; ``tests/test_torch_fused.py``'s bound). After
``write_back`` the unit graph's forward is the trainer's forward
through other code (units against the fused ``_apply``; conv1 without
space-to-depth): within 1e-4, and the same VALID errors. The engines
built from a workflow and from its snapshot read the same host
values: bitwise equal; against the reference's engine on the same
weights, within 1e-4. Dropout is at ratio 0 where the frameworks are
compared (the port's masks are Philox draws, not JAX's).
"""

import numpy as np
import pytest
import torch

import veles_tpu.backends as R_backends
import veles_tpu.config as R_config
import veles_tpu.models.alexnet as R_alexnet
import veles_tpu.models.mnist as R_mnist
import veles_tpu.parallel.fused as R_fused
import veles_tpu.prng as R_prng
import veles_tpu.serve.engine as R_engine
import veles_tpu_torch.backends as P_backends
import veles_tpu_torch.config as P_config
import veles_tpu_torch.models.alexnet as P_alexnet
import veles_tpu_torch.models.mnist as P_mnist
import veles_tpu_torch.parallel.fused as P_fused
import veles_tpu_torch.prng as P_prng
from veles_tpu_torch.loader.base import VALID
from veles_tpu_torch.serve.engine import InferenceEngine
from veles_tpu_torch.snapshotter import Snapshotter

torch.set_num_threads(1)

TOL = 1e-4

REF = dict(backends=R_backends, prng=R_prng, mnist=R_mnist,
           alexnet=R_alexnet, fused=R_fused)
PORT = dict(backends=P_backends, prng=P_prng, mnist=P_mnist,
            alexnet=P_alexnet, fused=P_fused)

MNIST = dict(layers=(32, 10), max_epochs=2,
             loader_kwargs=dict(n_train=300, n_valid=100,
                                minibatch_size=50))


def _alexnet_kw(dropout=0.0, **extra):
    return dict(n_classes=10, image_size=64, max_epochs=1,
                layers=R_alexnet.alexnet_layers(10, dropout=dropout),
                loader_kwargs=dict(n_train=60, n_valid=20,
                                   minibatch_size=20, image_size=64),
                **extra)


MAKERS = {
    "mnist": lambda mods, **kw: mods["mnist"].MnistWorkflow(
        **dict(MNIST, **kw)),
    "alexnet": lambda mods, **kw: mods["alexnet"].AlexNetWorkflow(
        **_alexnet_kw(**kw)),
}


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


def _build(mods, make, **kw):
    mods["prng"].reset()
    wf = MAKERS[make](mods, **kw)
    wf.thread_pool = None
    wf.initialize(device=mods["backends"].Device(backend="cpu"))
    return wf


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _to_valid(loader):
    """Serve minibatches until the first of a VALID class."""
    for _ in range(10000):
        loader.run()
        if loader.minibatch_class == VALID:
            return
    raise AssertionError("no VALID minibatch")


def unit_graph_valid_errors(wf):
    """One VALID pass through the unit graph's forward units and
    evaluator (from the next VALID class on): its error count."""
    loader = wf.loader
    _to_valid(loader)
    n_err = 0
    while True:
        for unit in wf.forwards:
            unit.run()
        wf.evaluator.run()
        n_err += int(wf.evaluator.n_err)
        if bool(loader.last_minibatch):
            return n_err
        loader.run()


@pytest.mark.parametrize("make", sorted(MAKERS))
def test_fuse_forwards_matches_reference(make):
    (r_specs, r_params), (p_specs, p_params) = (
        mods["fused"].fuse_forwards(_build(mods, make).forwards)
        for mods in (REF, PORT))
    assert p_specs == r_specs
    assert len(p_params) == len(r_params)
    for p, r in zip(p_params, r_params):
        assert sorted(p) == sorted(r)
        for key in r:
            assert p[key].dtype == np.asarray(r[key]).dtype
            assert p[key].tobytes() == np.asarray(r[key]).tobytes()
    trainer = P_fused.FusedClassifierTrainer.from_forwards(
        _build(PORT, make).forwards, device="cpu")
    assert trainer.specs == P_fused.normalize_specs(p_specs)


@pytest.mark.parametrize("lr_policy", [None, "exp"])
def test_train_fused_matches_reference(lr_policy):
    results, weights = [], []
    for mods in (REF, PORT):
        wf = _build(mods, "mnist", lr_policy=lr_policy)
        results.append(mods["fused"].train_fused(wf))
        weights.append([np.array(getattr(u, a).map_read())
                        for u in wf.forwards for a in ("weights", "bias")])
    assert results[1] == results[0]
    for p, r in zip(weights[1], weights[0]):
        assert _rel(p, r) < TOL


def test_train_fused_raises_for_a_mesh():
    """A mesh is a ``parallel.mesh.Mesh`` over a joined group (the
    meshed runs are tests/test_torch_parallel.py's); tensor parallelism
    needs one."""
    wf = _build(PORT, "mnist")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        P_fused.train_fused(wf, mesh=object())
    with pytest.raises(ValueError, match="needs a mesh"):
        P_fused.train_fused(wf, tensor_parallel=True)


def test_write_back_forward_matches_predict():
    """Two fused steps with dropout on, then ``write_back``: the unit
    graph's VALID forward (a softmax tail: probabilities) equals the
    softmax of ``trainer.predict`` on the same minibatch."""
    wf = _build(PORT, "alexnet", dropout=0.5)
    trainer = P_fused.FusedClassifierTrainer.from_forwards(
        wf.forwards, device="cpu", learning_rate=0.01)
    loader = wf.loader
    steps = 0
    while steps < 2:
        loader.run()
        if loader.minibatch_class == 2:
            trainer.step(loader.minibatch_data.devmem,
                         loader.minibatch_labels.devmem)
            steps += 1
    before = np.array(wf.forwards[0].weights.map_read())
    trainer.write_back(wf.forwards)
    after = np.array(wf.forwards[0].weights.map_read())
    assert not np.array_equal(before, after)
    assert after.tobytes() == \
        trainer.params[0]["w"].detach().numpy().tobytes()
    assert wf.gds[-1].weights is wf.forwards[0].weights
    _to_valid(loader)
    for unit in wf.forwards:
        unit.run()
    graph = wf.forwards[-1].output.map_read()[:loader.minibatch_size]
    fused = torch.softmax(trainer.predict(
        loader.minibatch_data.devmem), dim=-1).numpy()
    assert _rel(graph, fused[:loader.minibatch_size]) < TOL


def test_train_fused_last_valid_errors_match_the_unit_graph(monkeypatch):
    """``train_fused``'s closing VALID sweep, recorded, equals one VALID
    pass through the unit graph after the write-back."""
    counts = []
    count = P_fused.FusedClassifierTrainer.count_errors

    def recording(self, x, labels):
        counts.append(count(self, x, labels))
        return counts[-1]

    monkeypatch.setattr(P_fused.FusedClassifierTrainer, "count_errors",
                        recording)
    wf = _build(PORT, "alexnet", dropout=0.5)
    out = P_fused.train_fused(wf)
    n_valid_mb = -(-wf.loader.class_lengths[VALID] //
                   wf.loader.max_minibatch_size)
    last = sum(counts[-n_valid_mb:])
    assert out["epochs"] == 1 and len(counts) == 2 * n_valid_mb
    assert unit_graph_valid_errors(wf) == last
    assert out["min_validation_error_pt"] <= \
        100.0 * last / wf.loader.class_lengths[VALID]


@pytest.mark.parametrize("make", sorted(MAKERS))
def test_engines_from_workflow_and_snapshot(make, tmp_path):
    """Train through ``train_fused``, snapshot, serve: ``from_workflow``
    and ``from_snapshot`` (the restored workflow on the host) answer
    bitwise alike, ``from_forwards`` without the normalizer differs only
    by it, and the reference's engine over the same weights agrees
    within 1e-4."""
    wf = _build(PORT, make)
    P_fused.train_fused(wf)
    path = Snapshotter(wf, directory=str(tmp_path), prefix=make,
                       compression=None).save()
    live = InferenceEngine.from_workflow(wf, device="cpu")
    restored = InferenceEngine.from_snapshot(path, device="cpu")
    assert live.name == restored.name == type(wf).__name__
    rows = np.random.default_rng(3).random(
        (7,) + tuple(wf.loader.minibatch_data.shape[1:])).astype(np.float32)
    rows *= 255.0 if make == "alexnet" else 1.0
    got = live.apply(rows)
    assert got.tobytes() == restored.apply(rows).tobytes()
    assert np.allclose(got.sum(axis=-1), 1.0, atol=1e-5)
    ref = _build(REF, make)
    for ru, pu in zip(ref.forwards, wf.forwards):
        if hasattr(pu, "weights"):
            ru.weights.reset(np.array(pu.weights.map_read()))
            ru.bias.reset(np.array(pu.bias.map_read()))
    want = np.asarray(R_engine.InferenceEngine.from_workflow(ref).apply(rows))
    assert _rel(got, want) < TOL
    bare = InferenceEngine.from_forwards(wf.forwards, device="cpu")
    assert bare.apply(rows).shape == got.shape
