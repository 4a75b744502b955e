"""The ranks' side of the port's mesh tests (tests/test_torch_mesh.py,
test_torch_ring.py, test_torch_parallel.py, test_torch_pipeline.py).

Each function here runs in every rank of a spawned world
(``veles_tpu_torch.parallel.multiprocess.run_world``: gloo, the CPU),
so this module imports torch, numpy and the port only, never JAX: the
test modules compute the JAX package's side in the parent process. Each
returns plain numpy and Python values.
"""

import numpy as np
import torch

from veles_tpu_torch.parallel import collectives
from veles_tpu_torch.parallel import multiprocess as mp
from veles_tpu_torch.parallel.mesh import MeshConfig, grid_mesh, make_mesh


def _np(t):
    return t.detach().cpu().numpy().copy()


# ---------------------------------------------------------------------------
# mesh, collectives, multiprocess
# ---------------------------------------------------------------------------

def mesh_world(rank, n):
    """The mesh's coordinates and groups, every collective forward and
    backward, host_to_global and the second initialize, on this rank."""
    from veles_tpu_torch.backends import Device
    out = {"count": mp.process_count(), "index": mp.process_index()}
    # the same membership again is a no-op
    coordinator, world, pid, backend = mp.membership()
    mp.initialize(coordinator, world, pid, backend=backend, device="cpu")
    cfg = MeshConfig(data=2, model=n // 2)
    mesh = make_mesh(cfg, device="cpu")
    out["coords"] = dict(mesh.coords)
    out["shape"] = dict(mesh.shape)
    data, model = mesh.axis("data"), mesh.axis("model")
    out["data_ranks"], out["model_ranks"] = data.ranks, model.ranks
    out["both_size"] = mesh.axis("data", "model").size
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    w = torch.arange(1, 7, dtype=torch.float32).reshape(2, 3) + rank

    def grad_of(fn, leaf):
        leaf = leaf.clone().requires_grad_()
        y = fn(leaf)
        (y * torch.ones_like(y) * (rank + 1)).sum().backward()
        return _np(y), _np(leaf.grad)

    out["psum"] = grad_of(lambda t: collectives.psum(t, data), x)
    out["pvary"] = grad_of(lambda t: collectives.pvary(t, data), x)
    out["gather"] = grad_of(lambda t: collectives.all_gather(t, data, 1), x)
    out["gather_inv"] = grad_of(
        lambda t: collectives.all_gather_invariant(t, data, 0), x)
    out["scatter"] = _np(collectives.reduce_scatter_sum(w[:, :2], data, 1))
    out["shard"] = grad_of(lambda t: collectives.shard(t, data, 0), w)
    ring = [(i, (i + 1) % data.size) for i in range(data.size)]
    out["ppermute"] = grad_of(
        lambda t: collectives.ppermute(t, data, ring), x)
    out["flat"] = [_np(t) for t in collectives.sum_flat(
        [x, w[0], torch.tensor([float(rank)])], mesh.axis("data", "model"))]
    out["bf16"] = _np(collectives.all_gather_cat(
        x.to(torch.bfloat16) / 7, data, 0).float())
    host = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    out["host_to_global"] = _np(mp.host_to_global(mesh, ("data", "model"),
                                                  host))
    out["local_batch"] = _np(mp.local_batch_to_global(
        mesh, ("data",), host[:4], global_batch=8))
    dev_mesh = Device(backend="cpu").mesh({"data": n})
    out["device_mesh"] = (dict(dev_mesh.shape), str(dev_mesh.device))
    try:
        grid_mesh({"data": n + 1}, device="cpu")
    except ValueError as e:
        out["bad_size"] = str(e)
    return out


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

def ring_world(rank, cases):
    """cases: (name, mesh config dict, causal, q, k, v, do) -> (out,
    dq, dk, dv) of the port's sharded ring (rank 0's copies)."""
    from veles_tpu_torch.parallel.ring_attention import (
        attention_reference, ring_attention_local, ring_attention_sharded)
    out = {}
    for name, cfg, causal, q, k, v, do in cases:
        mesh = make_mesh(MeshConfig(**cfg), device="cpu")
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        o = ring_attention_sharded(*leaves, mesh, "seq", causal)
        (o * torch.from_numpy(do)).sum().backward()
        out[name] = [_np(o)] + [_np(t.grad) for t in leaves]
    q, k, v = (torch.from_numpy(a) for a in cases[0][3:6])
    out["local_no_axis"] = _np(ring_attention_local(q, k, v, None, True))
    out["dense"] = _np(attention_reference(q, k, v, True))
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# the classifier: data and tensor parallelism
# ---------------------------------------------------------------------------

def classifier_world(rank, cases):
    """cases: (name, mesh config, tensor_parallel, specs, params, x,
    labels, steps, hyper) -> the whole params after the steps, the
    losses and this rank's dropout masks of every step; with
    ``one_rank`` also the same run on one rank (no mesh)."""
    from veles_tpu_torch.parallel.fused import FusedClassifierTrainer
    out = {}
    for name, cfg, tp, specs, params, x, labels, steps, hyper in cases:
        runs = {}
        mesh = make_mesh(MeshConfig(**cfg), device="cpu")
        for key, kw in (("mesh", dict(mesh=mesh, tensor_parallel=tp)),
                        ("one", dict(device="cpu"))):
            tr = FusedClassifierTrainer(specs, params, **hyper, **kw)
            tr.record_masks = []
            losses = [float(tr.step(x, labels)["loss"])
                      for _ in range(steps)]
            runs[key] = dict(losses=losses,
                             params=tr.params_numpy(whole=True),
                             masks=[_np(m) for m in tr.record_masks],
                             n_err=int(tr.count_errors(x, labels)))
        runs["coords"] = dict(mesh.coords)
        out[name] = runs
    return out


# ---------------------------------------------------------------------------
# the LM: data, sequence and expert parallelism
# ---------------------------------------------------------------------------

def lm_world(rank, cases):
    """cases: (name, mesh config, TransformerConfig kwargs, tokens,
    steps, lr) -> the meshed trainer's losses (rank 0's), every rank's
    agreeing, and the trainer's eval_loss after."""
    from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerTrainer)
    out = {}
    for name, cfg, tcfg, tokens, steps, lr in cases:
        mesh = make_mesh(MeshConfig(**cfg), device="cpu")
        tr = TransformerTrainer(TransformerConfig(**tcfg), mesh=mesh,
                                learning_rate=lr,
                                seq_axis="seq" if "seq" in cfg else None)
        losses = [float(tr.step(tokens)["loss"]) for _ in range(steps)]
        out[name] = dict(losses=losses, eval=float(tr.eval_loss(tokens)))
    try:
        TransformerTrainer(TransformerConfig(**cases[0][2]), mesh=mesh,
                           cuda_graphs=True)
    except ValueError as e:
        out["graphs_error"] = str(e)
    return out


def moe_aux_world(rank, tcfg, h, gate):
    """The MoE aux term of an unbalanced routing over ``data``: the
    meshed (global-statistics) value and this rank's per-rank one."""
    from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                    _moe_ffn, _Par)
    config = TransformerConfig(**tcfg)
    mesh = make_mesh(MeshConfig(data=2), device="cpu")
    par = _Par(mesh, None, config)
    e, m = config.embed, config.embed * config.mlp_ratio
    rng = np.random.default_rng(0)
    block = {"gate": torch.from_numpy(gate),
             "mlp_in": torch.from_numpy(rng.standard_normal(
                 (config.moe_experts, e, m)).astype(np.float32) / 8),
             "mlp_out": torch.from_numpy(rng.standard_normal(
                 (config.moe_experts, m, e)).astype(np.float32) / 8)}
    rows = torch.from_numpy(h).chunk(2)[mesh.index("data")]
    y, aux = _moe_ffn(rows, block, config, par)
    _, aux_local = _moe_ffn(rows, block, config)
    return dict(aux=float(aux), aux_local=float(aux_local), y=_np(y))


def train_fused_world(rank, mnist_kw, seed):
    """train_fused(MnistWorkflow, mesh=data 2) and train_fused on one
    rank from the same seed: their metrics and written-back weights."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models.mnist import MnistWorkflow
    from veles_tpu_torch.parallel.fused import train_fused
    root.common.engine.compute_type = "float32"
    mesh = make_mesh(MeshConfig(data=2), device="cpu")
    out = {}
    for key, m in (("mesh", mesh), ("one", None)):
        root.common.random.seed = seed
        prng.reset()
        wf = MnistWorkflow(**mnist_kw)
        wf.thread_pool = None
        wf.initialize(device=Device(backend="cpu"))
        result = train_fused(wf, mesh=m)
        out[key] = (result, [np.array(getattr(u, a).map_read())
                             for u in wf.forwards
                             for a in ("weights", "bias")])
    return out


def lm_workflow_world(rank, tcfg, loader_kwargs, seed):
    """TransformerWorkflow(mesh=) on a seq mesh for two epochs, and the
    same workflow on one rank: their decision metrics."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.backends import Device
    from veles_tpu_torch.config import root
    from veles_tpu_torch.models.lm import TransformerWorkflow
    from veles_tpu_torch.models.transformer import TransformerConfig
    mesh = make_mesh(MeshConfig(seq=2), device="cpu")
    out = {}
    for key, m in (("mesh", mesh), ("one", None)):
        root.common.random.seed = seed
        prng.reset()
        wf = TransformerWorkflow(config=TransformerConfig(**tcfg),
                                 max_epochs=2, fail_iterations=100,
                                 loader_kwargs=loader_kwargs, mesh=m)
        wf.thread_pool = None
        wf.initialize(device=Device(backend="cpu"))
        wf.run()
        out[key] = wf.decision.get_metric_values()
    return out


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def pipeline_world(rank, n, x, labels, lr):
    """The port's PipelineMLPTrainer over ``pipe`` n: its initial params,
    the loss and the gradients of one step (stages gathered), the
    loss after it and the sequential reference loss, all on rank 0."""
    from veles_tpu_torch.parallel.pipeline import PipelineMLPTrainer
    mesh = grid_mesh({"pipe": n}, device="cpu")
    tr = PipelineMLPTrainer(mesh, n_features=8, hidden=16, n_classes=6,
                            n_stages=n, learning_rate=lr)
    before = tr.params_numpy()
    loss, (g_in, g_w, g_b, g_head) = tr.loss_and_grads(x, labels)
    stage = mesh.axis("pipe")
    grads = {"in_w": _np(g_in), "head_w": _np(g_head),
             "stages": {"w": _np(collectives.all_gather_cat(
                 g_w[None], stage, 0)),
                 "b": _np(collectives.all_gather_cat(g_b[None], stage, 0))}}
    step_loss = float(tr.step(x, labels)["loss"])
    after = tr.params_numpy()
    seq_loss = float(tr.reference_loss_fn()(before, x, labels))
    try:
        PipelineMLPTrainer(mesh, 8, 16, 6, n_stages=n + 1)
        mismatch = None
    except ValueError as e:
        mismatch = str(e)
    if rank:
        return None
    return dict(before=before, loss=float(loss), grads=grads,
                step_loss=step_loss, after=after, seq_loss=seq_loss,
                mismatch=mismatch)


def fail_on_rank_1(rank):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def parallel_world(rank, classifier_cases, lm_cases, extras):
    """One world for tests/test_torch_parallel.py: the classifier and
    LM cases, and the ``extras`` (name -> (worker name, args))."""
    out = {"classifier": classifier_world(rank, classifier_cases),
           "lm": lm_world(rank, lm_cases)}
    for name, (fn, args) in extras.items():
        out[name] = globals()[fn](rank, *args)
    return out
