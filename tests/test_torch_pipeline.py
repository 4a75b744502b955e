"""Port parity of the GPipe pipeline on the CPU: ``veles_tpu_torch.
parallel.pipeline.PipelineMLPTrainer`` over ``pipe`` 2 and 4 (spawned
gloo worlds) against the JAX package's ``PipelineMLPTrainer`` on the
conftest's virtual CPU devices: the reference's only configuration of
it (8 features, hidden 16, 6 classes, 2 microbatches a stage of 4
rows), the same initial draws (bitwise), the loss and every gradient
of one step within 1e-4 of their scale, and the loss against the
sequential ``reference_loss_fn`` of each package.
"""

import jax
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from veles_tpu.parallel.mesh import grid_mesh as jgrid_mesh
from veles_tpu.parallel.pipeline import PipelineMLPTrainer as JPipeline
from veles_tpu_torch.parallel import multiprocess as mp

torch.set_num_threads(1)

TOL = 1e-4
LR = 0.1
WORLD_TIMEOUT_S = 180


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _data(n):
    rng = np.random.default_rng(1)
    return (rng.random((2 * n, 4, 8)).astype(np.float32),
            rng.integers(0, 6, (2 * n, 4)).astype(np.int32))


def _leaves(tree):
    return {"in_w": tree["in_w"], "stages.w": tree["stages"]["w"],
            "stages.b": tree["stages"]["b"], "head_w": tree["head_w"]}


@pytest.fixture(scope="module", params=[2, 4])
def pair(request):
    n = request.param
    x, labels = _data(n)
    port = mp.run_world(W.pipeline_world, n, "gloo", "cpu",
                        args=(n, x, labels, LR), timeout_s=WORLD_TIMEOUT_S,
                        threads=1)[0]
    ref = JPipeline(jgrid_mesh(jax.devices()[:n], {"pipe": n}),
                    n_features=8, hidden=16, n_classes=6, n_stages=n,
                    learning_rate=LR)
    before = jax.tree.map(np.asarray, ref.params)
    loss, grads = jax.value_and_grad(ref._loss_fn)(ref.params, x, labels)
    ref_out = dict(before=before, loss=float(loss),
                   grads=jax.tree.map(np.asarray, grads),
                   seq_loss=float(ref.reference_loss_fn()(before, x,
                                                          labels)))
    ref_out["step_loss"] = float(ref.step(x, labels)["loss"])
    ref_out["after"] = jax.tree.map(np.asarray, ref.params)
    return n, port, ref_out


def test_initial_params_are_the_reference_draws(pair):
    _, port, ref = pair
    for key, a in _leaves(port["before"]).items():
        np.testing.assert_array_equal(a, _leaves(ref["before"])[key])


def test_pipeline_loss_matches(pair):
    _, port, ref = pair
    for got in (port["loss"], port["step_loss"], port["seq_loss"]):
        assert abs(got - ref["loss"]) <= TOL * abs(ref["loss"])
    assert abs(ref["seq_loss"] - ref["loss"]) <= TOL * abs(ref["loss"])


@pytest.mark.parametrize("leaf", ["in_w", "stages.w", "stages.b",
                                  "head_w"])
def test_pipeline_grads_match(pair, leaf):
    _, port, ref = pair
    assert _rel(_leaves(port["grads"])[leaf],
                _leaves(ref["grads"])[leaf]) <= TOL
    assert _rel(_leaves(port["after"])[leaf],
                _leaves(ref["after"])[leaf]) <= TOL


def test_pipe_axis_must_be_the_stage_count(pair):
    n, port, _ = pair
    assert port["mismatch"] == "mesh 'pipe' axis (%d) != n_stages %d" % (
        n, n + 1)
