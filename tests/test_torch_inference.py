"""Port parity of the forward plane: ``veles_tpu_torch``'s
``InferenceEngine`` on the CPU against the JAX package's on the same
numpy-seeded weights and rows, and the bucket discipline both share.

Tolerance: f32 on both sides, outputs within 1e-4 relative to their
scale (the bound of the port's f32 parity tests; products and
convolutions differ from XLA's in summation order only). Nothing is
captured on the CPU: the engine runs its forward eagerly and records
the bucket shapes it served, which is what ``compile_count`` counts
on either device.
"""

import numpy as np
import pytest
import torch

import veles_tpu.models.flagship as JF
import veles_tpu.normalization as R_norm
import veles_tpu_torch.normalization as P_norm
from veles_tpu.models.transformer import TransformerConfig as JConfig
from veles_tpu.models.transformer import init_params
from veles_tpu.serve.engine import InferenceEngine as JEngine
from veles_tpu_torch.models.transformer import TransformerConfig
from veles_tpu_torch.serve import InferenceEngine, bucket_for

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

MLP_SPECS = [("fc", "tanh"), ("fc", "softmax")]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _mlp_params(seed=0, in_dim=6, hidden=8, classes=4):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((in_dim, hidden)).astype(
                np.float32) / 3, "b": np.zeros(hidden, np.float32)},
            {"w": rng.standard_normal((hidden, classes)).astype(
                np.float32) / 3, "b": np.zeros(classes, np.float32)}]


def _mlp(seed=0, **kw):
    return InferenceEngine.from_specs(MLP_SPECS, _mlp_params(seed),
                                      device="cpu", **kw)


def test_mlp_matches_reference_engine():
    params = _mlp_params(1)
    x = np.random.default_rng(2).random((5, 6), dtype=np.float32)
    ours = InferenceEngine.from_specs(MLP_SPECS, params, device="cpu")
    ref = JEngine.from_specs(MLP_SPECS, params)
    out = ours.apply(x)
    assert out.dtype == np.float32 and out.shape == (5, 4)
    assert _rel(out, ref.apply(x)) <= 1e-4
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-5)
    assert ours.compile_count == ref.compile_count == 1
    assert ours.buckets == ref.buckets == [8]


def test_normalize_spec_leads_the_stack_like_the_reference():
    params = _mlp_params(3)
    rng = np.random.default_rng(4)
    norm = {"mean": rng.random(6).astype(np.float32),
            "rdisp": (1.0 + rng.random(6)).astype(np.float32)}
    specs = [("normalize",)] + MLP_SPECS
    x = rng.random((3, 6), dtype=np.float32) * 5
    ours = InferenceEngine.from_specs(specs, [norm] + params, device="cpu")
    ref = JEngine.from_specs(specs, [norm] + params)
    assert _rel(ours.apply(x), ref.apply(x)) <= 1e-4
    with pytest.raises(ValueError, match="must lead"):
        InferenceEngine.from_specs(MLP_SPECS + [("normalize",)],
                                   params + [norm], device="cpu")


def test_alexnet_matches_reference_engine():
    """The 10-class 64 x 64 AlexNet at f32 (dropout is the identity
    in a forward), conv, pooling and LRN included."""
    specs, params, _ = JF.alexnet_fused(n_classes=10, image_size=64)
    x = np.random.default_rng(5).random((3, 64, 64, 3), dtype=np.float32)
    ours = InferenceEngine.from_specs(specs, params, device="cpu")
    ref = JEngine.from_specs(specs, params)
    out = ours.apply(x)
    assert out.shape == (3, 10)
    assert _rel(out, ref.apply(x)) <= 1e-4
    assert ours.buckets == [4]


def test_from_transformer_matches_reference_logits():
    small = dict(vocab=32, embed=32, heads=2, layers=2, seq_len=16)
    params = init_params(JConfig(**small), seed=7)
    tokens = np.random.default_rng(8).integers(0, 32, (3, 16)).astype(
        np.int32)
    ours = InferenceEngine.from_transformer(TransformerConfig(**small),
                                            params, device="cpu")
    ref = JEngine.from_transformer(JConfig(**small, attention_impl="lax"),
                                   params)
    out = ours.apply(tokens)
    assert ours.input_dtype == np.int32 and out.shape == (3, 16, 32)
    assert _rel(out, ref.apply(tokens)) <= 1e-4


def test_bucket_record_bounds_the_shapes_served():
    """Mixed request sizes run one shape per power-of-two bucket, as
    many as the reference compiles; a replay adds none."""
    engine = _mlp()
    ref = JEngine.from_specs(MLP_SPECS, _mlp_params())
    rng = np.random.default_rng(1)
    sizes = [int(n) for n in rng.integers(1, 18, 40)]
    for n in sizes:
        x = rng.random((n, 6), dtype=np.float32)
        assert engine.apply(x).shape == (n, 4)
        ref.apply(x)
    assert engine.compile_count == len({bucket_for(n) for n in sizes})
    assert engine.compile_count == ref.compile_count
    assert engine.buckets == ref.buckets
    before = engine.compile_count
    for n in sizes[:10]:
        engine.apply(rng.random((n, 6), dtype=np.float32))
    assert engine.compile_count == before


def test_padding_rows_never_reach_real_outputs():
    engine = _mlp()
    x = np.random.default_rng(2).random((8, 6), dtype=np.float32)
    np.testing.assert_allclose(engine.apply(x[:5]), engine.apply(x)[:5],
                               rtol=1e-6)
    with pytest.raises(ValueError, match="non-empty"):
        engine.apply(np.zeros((0, 6), np.float32))
    with pytest.raises(ValueError, match="non-empty"):
        engine.apply(np.zeros(6, np.float32))


def test_warmup_serves_every_bucket_once():
    engine = _mlp(min_bucket=2)
    assert engine.warmup((6,), max_batch=16) == 4   # 2, 4, 8, 16
    assert engine.buckets == [2, 4, 8, 16]
    assert engine.warmup((6,), max_batch=16) == 0
    assert engine.compile_count == 4


def test_swap_params_in_place_and_validated():
    engine = _mlp(0)
    x = np.random.default_rng(4).random((3, 6), dtype=np.float32)
    out1 = engine.apply(x)
    leaves = [t for p in engine.params for t in p.values()]
    compiles = engine.compile_count
    engine.swap_params(_mlp_params(9))
    out2 = engine.apply(x)
    assert engine.compile_count == compiles
    assert not np.allclose(out1, out2)
    # the live tensors were rewritten, not rebound (a captured graph
    # reads them at their addresses)
    assert all(a is b for a, b in zip(
        leaves, [t for p in engine.params for t in p.values()]))
    np.testing.assert_allclose(out2, _mlp(9).apply(x), rtol=1e-6)
    bad = _mlp_params(0)
    bad[0] = {"w": bad[0]["w"][:, :4], "b": bad[0]["b"][:4]}
    with pytest.raises(ValueError, match="swap_params"):
        engine.swap_params(bad)
    with pytest.raises(ValueError, match="structure"):
        engine.swap_params(_mlp_params(0)[:1])


def test_device_policy_and_unported_constructors():
    """Graphs need a CUDA device; ``mesh=`` takes a mesh
    (``from_specs(normalizer=)`` is ported: its parity test is below;
    ``from_forwards``, ``from_workflow`` and ``from_snapshot`` are held
    to the reference in ``tests/test_torch_train_fused.py``,
    ``from_package`` in ``tests/test_torch_package.py``; a missing
    archive raises)."""
    with pytest.raises(ValueError, match="cuda_graphs"):
        _mlp(cuda_graphs=True)
    assert _mlp(cuda_graphs=False).apply(
        np.ones((1, 6), np.float32)).shape == (1, 4)
    assert _mlp(normalizer=P_norm.normalizer("none")).apply(
        np.ones((1, 6), np.float32)).shape == (1, 4)
    with pytest.raises(FileNotFoundError):
        InferenceEngine.from_package("x")
    # a mesh is a parallel.mesh.Mesh (the sharded engine's parity is
    # tests/test_torch_sharded_serving.py's), and shardings need one
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        InferenceEngine(lambda p, x: x, [], device="cpu", mesh=object())
    with pytest.raises(ValueError, match="without a mesh"):
        InferenceEngine(lambda p, x: x, [], device="cpu",
                        param_shardings=[])


NORMALIZED = {
    "mean_disp": {},
    "range_linear": dict(source=(0.0, 255.0), interval=(-1.0, 1.0)),
}


@pytest.mark.parametrize("name", sorted(NORMALIZED))
def test_from_specs_normalizer_matches_reference(name):
    """Raw rows in, the loader normalizer applied after the cast to the
    compute dtype: probabilities within 1e-4 of the reference engine's.
    A stateful normalizer's statistics are the last params entry: a
    swap of the body alone keeps them, a swap that carries new
    statistics changes the next answer (they are read, not frozen)."""
    rng = np.random.default_rng(5)
    train = (rng.random((32, 6)) * 255).astype(np.float32)
    x = (rng.random((5, 6)) * 255).astype(np.float32)
    ref_norm = R_norm.normalizer(name, **NORMALIZED[name])
    port_norm = P_norm.normalizer(name, **NORMALIZED[name])
    ref_norm.analyze(train)
    port_norm.analyze(train)
    params = _mlp_params(3)
    ref = JEngine.from_specs(MLP_SPECS, params, normalizer=ref_norm)
    ours = InferenceEngine.from_specs(MLP_SPECS, params, device="cpu",
                                      normalizer=port_norm)
    out = ours.apply(x)
    assert _rel(out, ref.apply(x)) <= 1e-4
    stateful = bool(port_norm.stat_arrays())
    assert len(ours.params) == len(params) + stateful
    assert ours.compile_count == ref.compile_count == 1
    # the normalizer is really applied: raw rows score differently
    plain = InferenceEngine.from_specs(MLP_SPECS, params, device="cpu")
    assert not np.allclose(out, plain.apply(x), atol=1e-3)

    ours.swap_params(_mlp_params(4))           # the body alone
    ref.swap_params(_mlp_params(4))
    body_swapped = ours.apply(x)
    assert _rel(body_swapped, ref.apply(x)) <= 1e-4
    if not stateful:
        return
    stats = ours.params[-1]
    shifted = {k: v.numpy() * 0.5 for k, v in stats.items()}
    leaves = [t for t in stats.values()]
    ours.swap_params(_mlp_params(4) + [shifted])
    assert all(a is b for a, b in zip(leaves, ours.params[-1].values()))
    moved = ours.apply(x)
    assert not np.allclose(moved, body_swapped, atol=1e-4)
    ref.swap_params(_mlp_params(4) + [shifted])
    assert _rel(moved, ref.apply(x)) <= 1e-4
