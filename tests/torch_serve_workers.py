"""The ranks' side of the port's sharded serving tests
(tests/test_torch_sharded_serving.py).

Each function here runs in every rank of a spawned world
(``veles_tpu_torch.parallel.multiprocess.run_world``: gloo, the CPU), so
this module imports torch, numpy and the port only, never JAX: the test
module computes the JAX package's side in the parent process. Rank 0
leads each sharded engine (it serves), the other ranks follow it until
it stops them; each returns plain numpy and Python values.
"""

import os
import time

import numpy as np
import torch

from veles_tpu_torch.models.transformer import (ServeContext,
                                                TransformerTrainer,
                                                prefill)
from veles_tpu_torch.parallel import collectives
from veles_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from veles_tpu_torch.serve import (GenerativeEngine, InferenceEngine,
                                   PagedGenerativeEngine)
from veles_tpu_torch.serve.sharding import (place_tree, serve_mesh,
                                            transformer_param_shardings)


def _lead_or_follow(engine, rank, drive):
    """Rank 0 runs ``drive(engine)`` and stops the followers; the others
    follow. Returns (drive's result or the calls followed)."""
    if rank == 0:
        try:
            return drive(engine)
        finally:
            engine.stop_followers()
    return engine.follow()


def _greedy(engine, prompts, n):
    return [[int(t) for t in g]
            for g in engine.generate(prompts, max_new_tokens=n)]


def sharded_world(rank, config, params, prompts, n_new, swap_params,
                  draft, mlp):
    """Every sharded leg of the CPU parity tests on one world of
    ``tp`` ranks: slab and paged greedy tokens, the per-shard gauges,
    ``hbm_bytes`` at tp, a re-sharding swap, speculative decoding with
    a sharded draft, the sharded forward engine, the ``qkv`` layout and
    prefill logits, and ``generate_logits`` on a trainer's mesh."""
    torch.manual_seed(0)
    mesh = serve_mesh(torch.distributed.get_world_size(), device="cpu")
    out = {"rank": rank, "coords": dict(mesh.coords)}

    slab = GenerativeEngine(config, params, max_slots=4, device="cpu",
                            mesh=mesh)

    def drive_slab(engine):
        got = {"tokens": _greedy(engine, prompts, n_new)}
        engine.warm()
        got["after_warm"] = _greedy(engine, prompts[:2], n_new)
        got["stats"] = engine.decode_stats()
        engine.swap_params(swap_params)
        got["swapped"] = _greedy(engine, prompts[:2], n_new)
        return got
    out["slab"] = _lead_or_follow(slab, rank, drive_slab)
    out["slab_kv_local"] = {k: tuple(v.shape)
                            for k, v in slab._cache.items()}

    paged = PagedGenerativeEngine(config, params, max_slots=4,
                                  page_size=8, device="cpu", mesh=mesh)

    def drive_paged(engine):
        got = {"tokens": _greedy(engine, prompts, n_new)}
        got["free_after"] = (engine.pool.free_pages, engine.pool.n_pages)
        got["stats"] = engine.decode_stats()
        # a shared prompt head: copy-on-write pages on every rank
        head = np.asarray(prompts[2][:8], np.int32)
        got["shared"] = _greedy(engine, [head, head], n_new)
        return got
    out["paged"] = _lead_or_follow(paged, rank, drive_paged)

    budget = PagedGenerativeEngine(config, params, max_slots=2,
                                   page_size=8, device="cpu", mesh=mesh,
                                   hbm_bytes=64 * 8 * _token_bytes(config))
    out["hbm_pages"] = budget.pool.n_pages
    out["hbm_followed"] = _lead_or_follow(budget, rank,
                                          lambda e: e.pool.n_pages)

    draft_cfg, draft_params = draft
    spec = PagedGenerativeEngine(config, params, max_slots=2, page_size=8,
                                 device="cpu", mesh=mesh,
                                 draft_params=draft_params,
                                 draft_config=draft_cfg, draft_tokens=3)

    def drive_spec(engine):
        opts = [{"draft": True}] * 2
        toks = engine.generate(prompts[:2], max_new_tokens=n_new,
                               sampling=opts)
        return {"tokens": [[int(t) for t in g] for g in toks],
                "accepted": engine.spec_accepted_total,
                "proposed": engine.spec_proposed_total}
    out["spec"] = _lead_or_follow(spec, rank, drive_spec)

    specs, mlp_params, x = mlp
    fwd = InferenceEngine.from_specs(specs, mlp_params, device="cpu",
                                     mesh=mesh)
    out["mlp_local"] = [{k: tuple(v.shape) for k, v in layer.items()}
                        for layer in fwd.params]
    out["mlp"] = _lead_or_follow(fwd, rank, lambda e: e.apply(x))

    # the qkv layout: this rank's columns, and prefill on the shards
    shardings = transformer_param_shardings(mesh, params)
    local = place_tree(shardings, params)
    out["qkv0"] = local["blocks"][0]["qkv"].numpy().copy()
    tokens = torch.from_numpy(np.stack([
        np.resize(np.asarray(p, np.int64), 12) for p in prompts]))
    lengths = torch.tensor([min(len(p), 12) for p in prompts])
    with torch.inference_mode():
        logits, cache = prefill(local, tokens, lengths, config,
                                par=ServeContext(mesh))
    out["prefill_logits"] = logits.numpy().copy()
    out["prefill_k"] = cache["k"].numpy().copy()

    # generate_logits on a trainer's mesh (model over heads)
    tmesh = make_mesh(MeshConfig(data=1, model=mesh.size("model")),
                      device="cpu")
    trainer = TransformerTrainer(config, device="cpu", mesh=tmesh)
    trainer.load_state(params)
    out["trainer_logits"] = trainer.generate_logits(
        tokens.numpy()).numpy().copy()
    out["staged"] = dict(collectives.STAGED_BYTES)
    return out


def _token_bytes(config):
    return 2 * config.layers * config.heads * config.head_dim * 4


def misuse_world(rank, odd_config, odd_params, config, params):
    """Construction-time misuse on a real mesh: heads not divisible by
    tp, ``cuda_graphs=True`` on a mesh of more than one rank."""
    mesh = serve_mesh(torch.distributed.get_world_size(), device="cpu")
    out = {}
    for name, make in (
            ("slab", lambda: GenerativeEngine(odd_config, odd_params,
                                              device="cpu", mesh=mesh)),
            ("paged", lambda: PagedGenerativeEngine(
                odd_config, odd_params, device="cpu", mesh=mesh)),
            ("graphs", lambda: GenerativeEngine(
                config, params, device="cpu", mesh=mesh,
                cuda_graphs=True))):
        try:
            make()
        except ValueError as e:
            out[name] = str(e)
    return out


def follower_death_world(rank, config, params, prompts, die_after):
    """Rank 1 follows ``die_after`` calls, then its process exits at
    once; rank 0 keeps serving and reports how its next calls ended and
    how long they took."""
    mesh = serve_mesh(2, device="cpu", timeout_s=10)
    engine = GenerativeEngine(config, params, max_slots=2, device="cpu",
                              mesh=mesh)
    if rank == 1:
        shard = engine._shard
        for _ in range(die_after):
            name, args = collectives.broadcast_object(None, shard._control)
            shard._run(engine, name, args)
        os._exit(3)
    slots, _ = engine.admit([prompts[0]])
    for _ in range(die_after - 1):
        engine.decode()
    t0 = time.monotonic()
    errors = []
    for _ in range(3):
        try:
            engine.decode()
        except Exception as e:  # noqa: BLE001 — what the test reads
            errors.append(type(e).__name__ + ": " + str(e)[:200])
            break
    return {"errors": errors, "seconds": time.monotonic() - t0}


def follower_failure_world(rank, config, params, prompts):
    """Rank 1's engine raises inside a decode step (the process stays
    alive): the leader's call raises, the follower's loop raises its
    own error, and neither hangs (the step's collectives wait 10 s)."""
    mesh = serve_mesh(2, device="cpu", timeout_s=10)
    engine = GenerativeEngine(config, params, max_slots=2, device="cpu",
                              mesh=mesh)
    if rank == 1:
        def broken(*args):
            raise FloatingPointError("follower fault")
        engine._device_decode = broken
        t0 = time.monotonic()
        try:
            engine.follow()
        except FloatingPointError as e:
            return {"raised": str(e), "seconds": time.monotonic() - t0}
        return {"raised": None}
    engine.admit([prompts[0]])
    t0 = time.monotonic()
    try:
        engine.decode()
    except Exception as e:  # noqa: BLE001 — what the test reads
        return {"raised": type(e).__name__ + ": " + str(e)[:300],
                "seconds": time.monotonic() - t0}
    return {"raised": None}


def aot_fingerprint_world(rank, config, params):
    """Each engine's AOT identity off the mesh and on a tp=2 serve mesh
    (every rank builds both; nothing is served): name -> (the
    unsharded signature's mesh field, the sharded one's, both
    fingerprints)."""
    mesh = serve_mesh(2, device="cpu")
    makers = {
        "slab": lambda m: GenerativeEngine(config, params, max_slots=2,
                                           device="cpu", mesh=m),
        "paged": lambda m: PagedGenerativeEngine(
            config, params, max_slots=2, page_size=16, device="cpu",
            mesh=m),
        "apply": lambda m: InferenceEngine.from_transformer(
            config, params, device="cpu", mesh=m)}
    out = {}
    for name, make in makers.items():
        single, sharded = make(None), make(mesh)
        out[name] = (single.aot_signature[1].get("mesh"),
                     sharded.aot_signature[1]["mesh"],
                     single._fingerprint(), sharded._fingerprint())
    return out
