"""Batch placement on the port's trainers: ``FusedClassifierTrainer``'s
``shard_batch``, ``shard_local_batch`` and ``shard_batch_stack``,
``TransformerTrainer.shard_tokens``, and ``PrefetchingServer(loader,
place=trainer.shard_batch)``, on one CPU device and on two gloo CPU
ranks (``data=2``), against the trainers fed the raw host batch and
against the JAX package's meshed trainer.

A placed batch is what the step takes: the whole batch on the device,
or on a mesh this rank's ``data`` rows only. ``shard_local_batch``
takes only the rank's rows (rows ``[p n, (p + 1) n)`` at ``data``
index p, the reference's order), and the step sums the ranks'
valid-row counts over ``data``.

Tolerances: a placed batch runs the ops of today's meshed step (each
rank handed the global batch and slicing it) in the same order, and
the valid-row count is an integer sum, so parameters and losses are
compared bitwise; the meshed port against the JAX package's meshed
trainer within 1e-4 of the scale (``tests/test_torch_parallel.py``'s
bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
import veles_tpu.models.flagship as JF
from veles_tpu.parallel.fused import FusedClassifierTrainer as JTrainer
from veles_tpu.parallel.mesh import MeshConfig as JMeshConfig
from veles_tpu.parallel.mesh import make_mesh as jmake_mesh
from veles_tpu_torch.loader import PrefetchingServer
from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                TransformerTrainer)
from veles_tpu_torch.parallel import multiprocess as mp
from veles_tpu_torch.parallel.fused import FusedClassifierTrainer

torch.set_num_threads(1)

TOL = 1e-4
HYPER = dict(learning_rate=0.1, momentum=0.9, weight_decay=5e-4)
LAYERS = [{"type": "conv_relu", "n_kernels": 8, "kx": 3, "padding": 1},
          {"type": "max_pooling", "kx": 2},
          {"type": "all2all_tanh", "output_sample_shape": 16},
          {"type": "softmax", "output_sample_shape": 10}]
MLP = [{"type": "all2all_tanh", "output_sample_shape": 16},
       {"type": "softmax", "output_sample_shape": 5}]
LM = dict(vocab=32, embed=32, heads=2, layers=1, seq_len=16)
LM_LR = 1e-3
N_LOADER_BATCHES = 6


def _batches():
    """Three global batches of 16 rows; padding rows (label -1) fall
    unevenly on the two ``data`` halves, so a rank's own count is not
    half the global one."""
    rng = np.random.default_rng(1)
    out = []
    for pad in (slice(12, 16), slice(0, 0), slice(0, 3)):
        x = rng.random((16, 8, 8, 3), dtype=np.float32)
        labels = rng.integers(0, 10, 16).astype(np.int32)
        labels[pad] = -1
        out.append((x, labels))
    return out


def _tokens():
    return np.random.default_rng(3).integers(0, LM["vocab"],
                                             (4, LM["seq_len"] + 1))


@pytest.fixture(scope="module")
def world():
    specs, params, _ = JF.fused_from_layer_dicts(LAYERS, (8, 8, 3))
    lspecs, lparams, _ = JF.fused_from_layer_dicts(MLP, (6, 6, 3))
    return specs, params, mp.run_world(
        W.placement_world, 2, "gloo", "cpu",
        args=(specs, params, _batches(), HYPER,
              (lspecs, lparams, N_LOADER_BATCHES), LM, _tokens(), LM_LR),
        timeout_s=240, threads=1)


def _equal_params(a, b):
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        assert sorted(pa) == sorted(pb)
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k])


@pytest.mark.parametrize("feed", ["local", "placed", "stack",
                                  "local_contiguous"])
def test_placed_batches_train_as_the_global_batch_bitwise(world, feed):
    """Two ranks: each passing only its own rows (``shard_local_batch``,
    also through ``.contiguous()``), ``shard_batch`` of the global
    batch, and one placed stack through ``step_many`` reach bitwise the
    losses and parameters of today's step, where each rank is handed
    the global batch and slices it."""
    _, _, ranks = world
    assert sorted(r["data_index"] for r in ranks) == [0, 1]
    for out in ranks:
        assert out[feed]["losses"] == out["global"]["losses"]
        _equal_params(out[feed]["params"], out["global"]["params"])


def test_a_batch_that_lost_its_placement_is_refused_on_a_mesh(world):
    """A copy of a placed batch (here a clone of the labels or tokens)
    carries no mark; on a mesh the trainer that placed batches refuses
    it, and an unplaced global batch after a placement, rather than cut
    this rank's rows a second time."""
    _, _, ranks = world
    for out in ranks:
        for msg in out["lost"] + [out["lm"]["lost"]]:
            assert msg is not None and "carries no placement" in msg


def test_local_rows_train_as_the_reference_meshed_trainer(world):
    specs, params, ranks = world
    mesh = jmake_mesh(jax.devices()[:2], JMeshConfig(data=2))
    tr = JTrainer(specs, params, mesh=mesh, compute_dtype=jnp.float32,
                  **HYPER)
    losses = [float(tr.step(x, lb)["loss"]) for x, lb in _batches()]
    want = [{k: np.asarray(v) for k, v in p.items()} for p in tr.params]
    for out in ranks:
        run = out["local"]
        assert np.allclose(run["losses"], losses, rtol=TOL)
        for a, b in zip(run["params"], want):
            for k in b:
                scale = max(np.abs(b[k]).max(), 1e-30)
                assert np.abs(a[k] - b[k]).max() / scale <= TOL, k


def test_prefetched_placed_batches_step_as_the_raw_ones_on_a_mesh(world):
    _, _, ranks = world
    for out in ranks:
        assert len(out["raw"]["losses"]) == N_LOADER_BATCHES
        assert out["prefetched"]["losses"] == out["raw"]["losses"]
        _equal_params(out["prefetched"]["params"], out["raw"]["params"])


def test_shard_tokens_train_as_the_global_tokens_on_a_mesh(world):
    _, _, ranks = world
    for out in ranks:
        lm = out["lm"]
        assert len(lm["global"]) == 4
        assert lm["placed"] == lm["global"]
        for a, b in zip(lm["placed_params"], lm["global_params"]):
            np.testing.assert_array_equal(a, b)
    assert ranks[0]["lm"]["global"] == ranks[1]["lm"]["global"]


# -- one device --------------------------------------------------------------

def _one(model=LAYERS, shape=(8, 8, 3)):
    specs, params, _ = JF.fused_from_layer_dicts(model, shape)
    return lambda: FusedClassifierTrainer(specs, params, device="cpu",
                                          **HYPER)


def test_one_device_placement_is_the_whole_batch():
    """On one device every ``shard_*`` places the whole batch: the steps
    equal the raw batch's bitwise; the caller's tensors are never
    marked, and a batch another trainer placed is refused."""
    make = _one()
    batches = _batches()
    runs = {}
    for feed in ("raw", "placed", "local", "stack"):
        tr = make()
        if feed == "stack":
            xs, ls = (np.stack(a) for a in zip(*batches))
            losses = tr.step_many(*tr.shard_batch_stack(xs, ls))[
                "loss"].tolist()
        else:
            place = {"raw": lambda x, lb: (x, lb),
                     "placed": tr.shard_batch,
                     "local": tr.shard_local_batch}[feed]
            losses = [float(tr.step(*place(x, lb))["loss"])
                      for x, lb in batches]
        runs[feed] = (losses, tr.params_numpy())
    for feed in ("placed", "local", "stack"):
        assert runs[feed][0] == runs["raw"][0]
        _equal_params(runs[feed][1], runs["raw"][1])
    tr, other = make(), make()
    labels = torch.from_numpy(batches[0][1]).long()
    x, placed = tr.shard_batch(batches[0][0], labels)
    assert x.device.type == "cpu" and placed.dtype == torch.int64
    assert not hasattr(labels, "_veles_placement")
    with pytest.raises(ValueError, match="another trainer"):
        other.step(x, placed)


def test_prefetching_server_places_with_the_trainer_on_one_device():
    specs, params, _ = JF.fused_from_layer_dicts(MLP, (6, 6, 3))
    runs = {}
    for feed in ("raw", "prefetched"):
        tr = FusedClassifierTrainer(specs, params, device="cpu", **HYPER)
        loader = W._host_loader(32, (6, 6, 3), 8)
        if feed == "raw":
            losses = []
            for _ in range(N_LOADER_BATCHES):
                loader.run()
                losses.append(float(tr.step(
                    np.array(loader.minibatch_data.map_read()),
                    np.array(loader.minibatch_labels.map_read()))["loss"]))
        else:
            with PrefetchingServer(loader, depth=2,
                                   place=tr.shard_batch) as server:
                got = [server.get(timeout=60)
                       for _ in range(N_LOADER_BATCHES)]
            assert all(isinstance(b.data, torch.Tensor) for b in got)
            losses = [float(tr.step(b.data, b.labels)["loss"])
                      for b in got]
        runs[feed] = (losses, tr.params_numpy())
    assert runs["prefetched"][0] == runs["raw"][0]
    _equal_params(runs["prefetched"][1], runs["raw"][1])


def test_shard_tokens_on_one_device():
    runs = {}
    tokens = _tokens()
    for feed in ("raw", "placed"):
        tr = TransformerTrainer(TransformerConfig(**LM), device="cpu",
                                learning_rate=LM_LR)
        one = tokens if feed == "raw" else tr.shard_tokens(tokens)
        losses = [float(tr.step(one)["loss"]) for _ in range(2)]
        stack = np.stack([tokens, tokens[::-1]])
        many = stack if feed == "raw" else tr.shard_tokens(stack)
        losses += tr.step_many(many)["loss"].tolist()
        runs[feed] = (losses, tr.params["blocks"][0]["qkv"].detach())
    assert runs["placed"][0] == runs["raw"][0]
    assert torch.equal(runs["placed"][1], runs["raw"][1])
