"""Port parity of the training strategies on a mesh, on the CPU: the
fused classifier's data and tensor parallelism and the LM's data,
sequence and expert parallelism (``veles_tpu_torch`` in spawned gloo
worlds of 2 and 4 ranks) against the JAX package's meshed trainers on
the conftest's virtual CPU devices, on the same numpy inputs and
params at f32; and, within the port, each meshed run against one rank.

Tolerances. Params after 3 SGD steps and LM losses: 1e-4 of the
scale (the bound of the JAX package's multichip dry run for its meshed
runs; the meshed steps differ from one device in summation order
only). Dropout is at ratio 0 wherever the two frameworks meet (the
port's masks are Philox draws, not threefry's); with dropout on, the
meshed masks are compared with the one-rank masks of the port, sliced
to the rank's rows and channels, bitwise. The MoE aux term of an
unbalanced routing: 1e-5 absolute, where the per-rank statistics would
miss by ~0.9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
import veles_tpu.models.flagship as JF
import veles_tpu.models.transformer as JT
from veles_tpu.parallel.fused import FusedClassifierTrainer as JTrainer
from veles_tpu.parallel.mesh import MeshConfig as JMeshConfig
from veles_tpu.parallel.mesh import make_mesh as jmake_mesh
from veles_tpu_torch.parallel import multiprocess as mp

torch.set_num_threads(1)

TOL = 1e-4
WORLD_TIMEOUT_S = 240
HYPER = dict(learning_rate=0.1, momentum=0.9, weight_decay=5e-4)
STEPS = 3

#: the JAX package's multichip dry run's classifier (graft entry)
DRYRUN = [
    {"type": "conv_relu", "n_kernels": 8, "kx": 3, "padding": 1},
    {"type": "max_pooling", "kx": 2},
    {"type": "lrn"},
    {"type": "all2all_tanh", "output_sample_shape": 32},
    {"type": "dropout", "dropout_ratio": 0.2},
    {"type": "softmax", "output_sample_shape": 10},
]
#: AlexNet's layer order at toy widths: LRN between a column and a row
#: conv, conv -> flatten -> row FC, a column FC before the head
ALEX = [
    {"type": "conv_relu", "n_kernels": 8, "kx": 3, "sliding": (2, 2),
     "padding": 1},
    {"type": "lrn"},
    {"type": "max_pooling", "kx": 2, "sliding": (2, 2)},
    {"type": "conv_relu", "n_kernels": 8, "kx": 3, "padding": 1},
    {"type": "lrn"},
    {"type": "max_pooling", "kx": 2, "sliding": (1, 1)},
    {"type": "conv_relu", "n_kernels": 8, "kx": 3, "padding": 1},
    {"type": "conv_relu", "n_kernels": 8, "kx": 3, "padding": 1},
    {"type": "conv_relu", "n_kernels": 8, "kx": 3, "padding": 1},
    {"type": "max_pooling", "kx": 2, "sliding": (2, 2)},
    {"type": "all2all_relu", "output_sample_shape": 16},
    {"type": "dropout", "dropout_ratio": 0.5},
    {"type": "all2all_relu", "output_sample_shape": 16},
    {"type": "dropout", "dropout_ratio": 0.5},
    {"type": "softmax", "output_sample_shape": 10},
]
LM = dict(vocab=32, embed=32, heads=2, layers=1, seq_len=32)
LM_LR = 1e-3
MOE = dict(vocab=32, embed=16, heads=2, layers=1, seq_len=8, moe_experts=2)
MNIST = dict(layers=(32, 10), max_epochs=2,
             loader_kwargs=dict(n_train=300, n_valid=100,
                                minibatch_size=50))
LM_LOADER = dict(n_tokens=16 * 33 * 8)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _no_dropout(layers):
    return [dict(l, dropout_ratio=0.0) if l["type"] == "dropout" else l
            for l in layers]


def _batch(n_rows, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.random((n_rows, 16, 16, 3), dtype=np.float32),
            rng.integers(0, 10, n_rows).astype(np.int32))


def _classifier_cases(n):
    """(name, mesh config, tensor_parallel, layers) of a world."""
    if n == 2:
        return [("dp2", dict(data=2), False, _no_dropout(DRYRUN)),
                ("tp2", dict(model=2), True, _no_dropout(DRYRUN)),
                ("tp2_alex", dict(model=2), True, _no_dropout(ALEX)),
                ("dp2_dropout", dict(data=2), False, DRYRUN)]
    return [("dp2xtp2", dict(data=2, model=2), True, _no_dropout(DRYRUN)),
            ("dp2xtp2_alex", dict(data=2, model=2), True,
             _no_dropout(ALEX)),
            ("dp2xtp2_alex_dropout", dict(data=2, model=2), True, ALEX)]


def _lm_cases(n):
    """(name, mesh config, LM config) of a world."""
    moe = dict(LM, moe_experts=2)
    if n == 2:
        return [("seq2", dict(seq=2), LM), ("ep2", dict(model=2), moe)]
    return [("data2_seq2", dict(data=2, seq=2), LM), ("seq4", dict(seq=4), LM),
            ("data2_ep2", dict(data=2, model=2), moe)]


def _tokens(seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, LM["vocab"], (4, LM["seq_len"] + 1))


def _moe_inputs():
    """An unbalanced routing over data=2: the first two rows go to
    expert 0, the last two to expert 1."""
    rng = np.random.default_rng(4)
    e = MOE["embed"]
    h = rng.standard_normal((4, 4, e)).astype(np.float32) * 0.01
    h[:2, :, 0] += 1.0
    h[2:, :, 1] += 1.0
    gate = np.zeros((e, 2), np.float32)
    gate[0, 0] = gate[1, 1] = 3.0
    return h, gate


def _reference_classifier(cfg, tp, layers, x, labels):
    specs, params, _ = JF.fused_from_layer_dicts(layers, (16, 16, 3))
    n = int(np.prod(list(cfg.values())))
    mesh = jmake_mesh(jax.devices()[:n], JMeshConfig(**cfg))
    tr = JTrainer(specs, params, mesh=mesh, tensor_parallel=tp,
                  dropout_impl="threefry2x32", compute_dtype=jnp.float32,
                  **HYPER)
    losses = [float(tr.step(x, labels)["loss"]) for _ in range(STEPS)]
    return losses, [{k: np.asarray(v) for k, v in p.items()}
                    for p in tr.params]


def _reference_lm(cfg, tcfg, tokens):
    n = int(np.prod(list(cfg.values())))
    mesh = jmake_mesh(jax.devices()[:n], JMeshConfig(**cfg))
    tr = JT.TransformerTrainer(
        JT.TransformerConfig(**tcfg, attention_impl="lax"), mesh=mesh,
        seq_axis="seq" if "seq" in cfg else None, learning_rate=LM_LR)
    return [float(tr.step(tokens)["loss"]) for _ in range(STEPS)]


def _spawn(n):
    x, labels = _batch(16)
    classifier = []
    for name, cfg, tp, layers in _classifier_cases(n):
        specs, params, _ = JF.fused_from_layer_dicts(layers, (16, 16, 3))
        classifier.append((name, cfg, tp, specs, params, x, labels, STEPS,
                           HYPER))
    tokens = _tokens()
    lm = [(name, cfg, tcfg, tokens, STEPS, LM_LR)
          for name, cfg, tcfg in _lm_cases(n)]
    extras = {}
    if n == 2:
        extras = {"moe_aux": ("moe_aux_world", (MOE,) + _moe_inputs()),
                  "train_fused": ("train_fused_world", (MNIST, 5)),
                  "lm_workflow": ("lm_workflow_world",
                                  (dict(vocab=64, embed=32, heads=2,
                                        layers=1, seq_len=32),
                                   LM_LOADER, 7))}
    return mp.run_world(W.parallel_world, n, "gloo", "cpu",
                        args=(classifier, lm, extras),
                        timeout_s=WORLD_TIMEOUT_S, threads=1)


@pytest.fixture(scope="module")
def world2():
    return _spawn(2)


@pytest.fixture(scope="module")
def world4():
    return _spawn(4)


def _world(request, n):
    return request.getfixturevalue("world%d" % n)


def _cases(dropout):
    out = []
    for n in (2, 4):
        for case in _classifier_cases(n):
            has = any(l["type"] == "dropout" and l["dropout_ratio"]
                      for l in case[3])
            if has == dropout:
                out.append((n,) + case)
    return out


@pytest.mark.parametrize("n,name,cfg,tp,layers", _cases(False),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_classifier_mesh_matches_reference(request, n, name, cfg, tp,
                                           layers):
    """Params and losses after 3 steps of the meshed port (every rank's
    whole params) against the JAX package's meshed trainer."""
    x, labels = _batch(16)
    losses, params = _reference_classifier(cfg, tp, layers, x, labels)
    for out in _world(request, n):
        run = out["classifier"][name]["mesh"]
        assert np.allclose(run["losses"], losses, rtol=TOL), name
        for a, b in zip(run["params"], params):
            assert sorted(a) == sorted(b)
            for k in b:
                assert _rel(a[k], b[k]) <= TOL, (name, k)


@pytest.mark.parametrize("n,name,cfg,tp,layers", _cases(True),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_classifier_dropout_masks_are_the_one_rank_masks(request, n, name,
                                                         cfg, tp, layers):
    """With dropout on, each rank's masks are the one-rank masks at its
    rows and channels, bitwise, so the meshed params follow the one-rank
    params within 1e-4."""
    for out in _world(request, n):
        runs = out["classifier"][name]
        mesh, one = runs["mesh"], runs["one"]
        assert len(mesh["masks"]) == len(one["masks"]) > 0
        d, m = runs["coords"].get("data", 0), runs["coords"].get("model", 0)
        for got, full in zip(mesh["masks"], one["masks"]):
            rows = full.shape[0] // cfg.get("data", 1)
            want = full[d * rows:(d + 1) * rows]
            if got.shape[-1] != want.shape[-1]:
                cols = got.shape[-1]
                want = want[..., m * cols:(m + 1) * cols]
            np.testing.assert_array_equal(got, want)
        assert 0 < np.mean([f.mean() for f in one["masks"]]) < 1
        assert mesh["n_err"] == one["n_err"]
        for a, b in zip(mesh["params"], one["params"]):
            for k in b:
                assert _rel(a[k], b[k]) <= TOL, (name, k)


@pytest.mark.parametrize("n,name,cfg,tcfg", [
    (n,) + case for n in (2, 4) for case in _lm_cases(n)],
    ids=lambda v: v if isinstance(v, str) else None)
def test_lm_mesh_matches_reference(request, n, name, cfg, tcfg):
    """The meshed LM's losses over 3 Adam steps (every rank's) against
    the JAX package's meshed trainer on the same tokens; the eval loss
    after them agrees across the ranks."""
    want = _reference_lm(cfg, tcfg, _tokens())
    evals = set()
    for out in _world(request, n):
        run = out["lm"][name]
        assert np.allclose(run["losses"], want, rtol=TOL), (name,
                                                            run["losses"],
                                                            want)
        evals.add(run["eval"])
    assert len(evals) == 1


def test_moe_aux_uses_global_statistics(world2):
    """On an unbalanced routing the per-rank Switch term differs from
    the global one; the meshed term is the global one (the reference's
    single-device value on the whole batch)."""
    h, gate = _moe_inputs()
    config = JT.TransformerConfig(**MOE)
    rng = np.random.default_rng(0)
    e, m = config.embed, config.embed * config.mlp_ratio
    block = {"gate": gate,
             "mlp_in": rng.standard_normal((2, e, m)).astype(np.float32) / 8,
             "mlp_out": rng.standard_normal((2, m, e)).astype(np.float32) / 8}
    y, aux = JT._moe_ffn(jnp.asarray(h), block, config, None, None)
    for rank, out in enumerate(world2):
        got = out["moe_aux"]
        assert abs(got["aux"] - float(aux)) <= 1e-5
        assert abs(got["aux_local"] - float(aux)) > 0.5
        assert _rel(got["y"], np.asarray(y)[2 * rank:2 * rank + 2]) <= TOL


def test_train_fused_on_a_mesh_matches_one_rank(world2):
    for out in world2:
        (res_mesh, w_mesh), (res_one, w_one) = (out["train_fused"]["mesh"],
                                                out["train_fused"]["one"])
        assert res_mesh == res_one
        for a, b in zip(w_mesh, w_one):
            assert _rel(a, b) <= TOL


def test_lm_workflow_on_a_mesh_matches_one_rank(world2):
    for out in world2:
        mesh, one = out["lm_workflow"]["mesh"], out["lm_workflow"]["one"]
        assert mesh["epochs"] == one["epochs"] == 2
        assert abs(mesh["min_validation_loss"] -
                   one["min_validation_loss"]) <= \
            TOL * abs(one["min_validation_loss"])


@pytest.mark.parametrize("n", [2, 4])
def test_cuda_graphs_on_a_gloo_mesh_raise(request, n):
    for out in _world(request, n):
        assert "cannot be captured" in out["lm"]["graphs_error"]
