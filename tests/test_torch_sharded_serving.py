"""Port parity of sharded serving (``veles_tpu_torch.serve.sharding`` and
the engines' ``mesh=``) against the JAX package's SPMD engines, on the
CPU at f32.

The port runs one process a rank: a gloo world of 2 ranks
(``tests/torch_serve_workers.py``, spawned by
``parallel.multiprocess.run_world``), rank 0 serving and rank 1
following it. The JAX package's engines run here on the 8 virtual CPU
devices of the conftest, over its ``serve_mesh(2)``. Greedy tokens at
tp=2, on the slab and on the page pool (copy-on-write pages and a
sharded speculative draft included), are token for token the JAX
package's tp=2 engine's and the port's one-device engine's; the sharded
forward engine is within 1e-4 of the JAX package's sharded one. The
fused ``qkv`` is split by heads (a deliberate divergence from the
reference's contiguous split, ROADMAP.md queue 3), pinned against one
device. A follower that dies, or fails inside a step, makes the
leader's call raise within its timeout.
"""

import multiprocessing
import time

import numpy as np
import pytest
import torch

import torch_serve_workers as W
from veles_tpu.models.transformer import TransformerConfig as RConfig
from veles_tpu.models.transformer import init_params as r_init_params
from veles_tpu.serve.engine import GenerativeEngine as RGenerative
from veles_tpu.serve.engine import InferenceEngine as RInference
from veles_tpu.serve.engine import PagedGenerativeEngine as RPaged
from veles_tpu.serve.sharding import serve_mesh as r_serve_mesh
from veles_tpu_torch.models.transformer import (TransformerConfig,
                                                forward, init_params,
                                                params_from_numpy)
from veles_tpu_torch.parallel import multiprocess as mp
from veles_tpu_torch.serve import GenerativeEngine, PagedGenerativeEngine
from veles_tpu_torch.serve.sharding import (MODEL_AXIS, mesh_tp,
                                            parse_mesh_spec,
                                            validate_serve_mesh)

torch.set_num_threads(1)

TOL = 1e-4
KW = dict(vocab=61, embed=64, heads=4, layers=2, seq_len=64)
CONFIG = TransformerConfig(**KW)
R_CONFIG = RConfig(**KW)
PARAMS = init_params(CONFIG, seed=5)
SWAP = init_params(CONFIG, seed=6)
DRAFT_KW = dict(vocab=61, embed=32, heads=2, layers=1, seq_len=64)
DRAFT = (TransformerConfig(**DRAFT_KW),
         init_params(TransformerConfig(**DRAFT_KW), seed=8))
N_NEW = 8
MLP_SPECS = [("fc", "tanh"), ("fc", "tanh"), ("fc", "softmax")]


def _prompts(*lens):
    rng = np.random.default_rng(11)
    return [rng.integers(1, CONFIG.vocab, n).astype(np.int32)
            for n in lens]


PROMPTS = _prompts(3, 7, 12)


def _mlp():
    rng = np.random.default_rng(4)
    dims = [6, 16, 8, 4]
    params = [{"w": (rng.standard_normal((a, b)) / 3).astype(np.float32),
               "b": (rng.standard_normal(b) / 10).astype(np.float32)}
              for a, b in zip(dims, dims[1:])]
    x = rng.random((5, 6), dtype=np.float32)
    return MLP_SPECS, params, x


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _greedy(engine, prompts, **kw):
    return [[int(t) for t in g]
            for g in engine.generate(prompts, max_new_tokens=N_NEW, **kw)]


@pytest.fixture(scope="module")
def world():
    """The sharded legs, run once on a gloo world of 2 ranks."""
    return mp.run_world(W.sharded_world, 2, "gloo", "cpu",
                        args=(CONFIG, PARAMS, PROMPTS, N_NEW, SWAP, DRAFT,
                              _mlp()),
                        timeout_s=400, threads=1)


@pytest.fixture(scope="module")
def one_device():
    slab = GenerativeEngine(CONFIG, PARAMS, max_slots=4, device="cpu")
    paged = PagedGenerativeEngine(CONFIG, PARAMS, max_slots=4, page_size=8,
                                  device="cpu")
    head = PROMPTS[2][:8]
    swapped = GenerativeEngine(CONFIG, SWAP, max_slots=4, device="cpu")
    spec = PagedGenerativeEngine(CONFIG, PARAMS, max_slots=2, page_size=8,
                                 device="cpu", draft_params=DRAFT[1],
                                 draft_config=DRAFT[0], draft_tokens=3)
    return {"slab": _greedy(slab, PROMPTS),
            "paged": _greedy(paged, PROMPTS),
            "shared": _greedy(paged, [head, head]),
            "swapped": _greedy(swapped, PROMPTS[:2]),
            "spec": _greedy(spec, PROMPTS[:2],
                            sampling=[{"draft": True}] * 2)}


@pytest.fixture(scope="module")
def reference():
    """The JAX package's tp=2 engines over its serve mesh."""
    mesh = r_serve_mesh(2)
    params = r_init_params(R_CONFIG, seed=5)
    slab = RGenerative(R_CONFIG, params, max_slots=4, donate=False,
                       mesh=mesh)
    paged = RPaged(R_CONFIG, params, max_slots=4, page_size=8,
                   donate=False, mesh=mesh)
    specs, mlp_params, x = _mlp()
    fwd = RInference.from_specs(specs, mlp_params, donate=False,
                                mesh=mesh)
    return {"slab": _greedy(slab, PROMPTS),
            "paged": _greedy(paged, PROMPTS),
            "mlp": np.asarray(fwd.apply(x)),
            "stats": slab.decode_stats()}


# -- mesh spec and misuse ---------------------------------------------------

def test_parse_mesh_spec():
    assert parse_mesh_spec("tp=2") == {"tp": 2}
    assert parse_mesh_spec(" TP=4 ") == {"tp": 4}
    for bad in ("", "tp", "tp=x", "tp=0", "dp=2", "tp=2,sp=2"):
        with pytest.raises(ValueError):
            parse_mesh_spec(bad)


class _FakeMesh:
    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def test_validate_serve_mesh_misuse():
    """The loud ValueError contract: heads not divisible by tp (the
    draft's too) and a mesh without the ``model`` axis."""
    mesh = _FakeMesh(data=1, model=2)
    assert mesh_tp(mesh) == 2 and validate_serve_mesh(mesh, CONFIG) == 2
    odd = TransformerConfig(vocab=61, embed=33, heads=3, layers=1,
                            seq_len=32)
    with pytest.raises(ValueError, match="not divisible by mesh tp"):
        validate_serve_mesh(mesh, odd)
    with pytest.raises(ValueError, match="draft model"):
        validate_serve_mesh(mesh, CONFIG, draft_config=odd)
    with pytest.raises(ValueError, match="'model' axis"):
        validate_serve_mesh(_FakeMesh(data=2), CONFIG)
    assert mesh_tp(_FakeMesh(data=2)) == 1 and MODEL_AXIS == "model"


def test_engines_refuse_misuse_on_a_mesh():
    odd = TransformerConfig(vocab=61, embed=48, heads=3, layers=1,
                            seq_len=32)
    out = mp.run_world(W.misuse_world, 2, "gloo", "cpu",
                       args=(odd, init_params(odd, seed=0), CONFIG, PARAMS),
                       timeout_s=120, threads=1)
    for rank in out:
        assert set(rank) == {"slab", "paged", "graphs"}
        assert "not divisible by mesh tp" in rank["slab"]
        assert "not divisible by mesh tp" in rank["paged"]
        assert "cuda_graphs=True on a mesh of 2 ranks" in rank["graphs"]


def test_replica_argv_passes_serve_mesh_through():
    """--serve-mesh survives replica_argv, so a fleet's spawned replicas
    are sharded too (it is in neither strip list)."""
    from veles_tpu_torch.distributed.spawn import replica_argv
    argv = replica_argv(
        ["wf.py", "--route", "127.0.0.1:7000", "--replicas", "2",
         "--serve-mesh", "tp=2", "--serve-gen-slots", "4"],
        "127.0.0.1:7001")
    i = argv.index("--serve-mesh")
    assert argv[i + 1] == "tp=2"
    assert "--serve" in argv and "--route" not in argv


# -- tp=2 parity ------------------------------------------------------------

@pytest.mark.parametrize("plane", ["slab", "paged"])
def test_tp2_greedy_matches_reference_and_one_device(world, one_device,
                                                     reference, plane):
    """Token for token: the port's tp=2 engine, the JAX package's tp=2
    engine and the port's one-device engine."""
    leader, follower = world
    assert leader["coords"] == {"data": 0, "model": 0}
    assert follower["coords"] == {"data": 0, "model": 1}
    assert leader[plane]["tokens"] == reference[plane]
    assert leader[plane]["tokens"] == one_device[plane]
    assert follower[plane] > 0      # the calls it followed


def test_tp2_slab_warm_swap_and_gauges(world, one_device, reference):
    leader, follower = world
    slab = leader["slab"]
    assert slab["after_warm"] == one_device["slab"][:2]
    # a re-sharding weight swap: the new weights' tokens
    assert slab["swapped"] == one_device["swapped"]
    stats = slab["stats"]
    assert stats["tp"] == 2 and stats["mesh_axes"] == {"data": 1,
                                                       "model": 2}
    assert stats["mesh_devices"] == 2
    assert stats["kv_bytes_per_shard"] * 2 == stats["kv_bytes_total"]
    assert stats["kv_bytes_total"] == reference["stats"]["kv_bytes_total"]
    # each rank holds its half of the heads of the slab
    for rank in world:
        assert rank["slab_kv_local"]["k"][3] == CONFIG.heads // 2


def test_tp2_paged_pool_sharing_and_gauges(world, one_device):
    paged = world[0]["paged"]
    free, total = paged["free_after"]
    assert free == total                     # every page back
    assert paged["shared"] == one_device["shared"]
    assert paged["stats"]["kv_bytes_per_shard"] * 2 == \
        paged["stats"]["kv_bytes_total"]


def test_hbm_bytes_is_a_per_shard_budget(world):
    """The same ``hbm_bytes`` holds twice the pages at tp=2: a page
    costs ``token_bytes // tp`` on each rank."""
    one = PagedGenerativeEngine(
        CONFIG, PARAMS, max_slots=2, page_size=8, device="cpu",
        hbm_bytes=64 * 8 * W._token_bytes(CONFIG))
    assert one.pool.n_pages == 64
    assert [r["hbm_pages"] for r in world] == [128, 128]


def test_tp2_speculative_draft_sharded(world, one_device):
    """A draft model sharded on the same mesh: the tokens of the
    one-device speculative engine, every proposal accepted or not
    exactly as there."""
    spec = world[0]["spec"]
    assert spec["tokens"] == one_device["spec"]
    assert spec["proposed"] > 0


def test_sharded_inference_engine_matches_reference(world, reference):
    specs, params, x = _mlp()
    leader, follower = world
    assert _rel(leader["mlp"], reference["mlp"]) <= TOL
    # column then row then column: the Megatron alternation
    assert leader["mlp_local"][0]["w"] == (6, 8)
    assert leader["mlp_local"][1]["w"] == (8, 8)
    assert leader["mlp_local"][2]["w"] == (8, 2)


def test_qkv_layout_is_by_heads_and_matches_one_device(world):
    """Rank r holds the q, k and v columns of its own heads (three
    strided blocks of the fused matrix), so its ``[.., 3, H/tp, Dh]``
    view holds whole heads; prefill on the shards gives the one-device
    logits and each rank's heads of the one-device K cache."""
    e, hd = CONFIG.embed, CONFIG.head_dim
    half = CONFIG.heads // 2 * hd
    qkv = PARAMS["blocks"][0]["qkv"]
    tokens = np.stack([np.resize(p.astype(np.int64), 12) for p in PROMPTS])
    lengths = [min(len(p), 12) for p in PROMPTS]
    from veles_tpu_torch.models.transformer import prefill
    whole = params_from_numpy(PARAMS, CONFIG, "cpu")
    with torch.inference_mode():
        logits, cache = prefill(whole, torch.from_numpy(tokens),
                                torch.tensor(lengths), CONFIG)
    for r, rank in enumerate(world):
        cols = np.concatenate([np.arange(b * e + r * half,
                                         b * e + (r + 1) * half)
                               for b in range(3)])
        np.testing.assert_array_equal(rank["qkv0"], qkv[:, cols])
        assert _rel(rank["prefill_logits"], logits.numpy()) <= 1e-5
        heads = slice(r * CONFIG.heads // 2, (r + 1) * CONFIG.heads // 2)
        assert _rel(rank["prefill_k"], cache["k"][:, :, :, heads]
                    .numpy()) <= 1e-5


def test_generate_logits_on_a_mesh_matches_one_device(world):
    tokens = np.stack([np.resize(p.astype(np.int64), 12) for p in PROMPTS])
    whole = params_from_numpy(PARAMS, CONFIG, "cpu")
    with torch.inference_mode():
        want = forward(whole, torch.from_numpy(tokens), CONFIG)[0].numpy()
    for rank in world:
        assert _rel(rank["trainer_logits"], want) <= 1e-5


def test_the_leader_broadcasts_and_stages_through_the_host(world):
    """The followers received the leader's calls as pickled host
    objects (counted), and the step's sums crossed gloo."""
    for rank in world:
        assert rank["staged"]["broadcast"] > 0


# -- a follower that fails --------------------------------------------------

def _run_until_rank0(fn, n, args, timeout_s):
    """A world whose other ranks may die: rank 0's result (raised if it
    failed), every process ended afterwards."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = mp.free_port()
    procs = [ctx.Process(target=mp._world_main, daemon=True,
                         args=(fn, r, n, port, "gloo", "cpu",
                               int(timeout_s), args, queue, 1))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            rank, ok, value = queue.get(timeout=max(
                1.0, deadline - time.monotonic()))
            if not ok:
                raise RuntimeError("rank %d failed:\n%s" % (rank, value))
            if rank == 0:
                return value
    finally:
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        queue.close()


def test_a_follower_that_dies_makes_the_leader_raise():
    """Rank 1's process exits after following three calls: the
    leader's next decode raises (the transport's error), well within
    its timeout, instead of hanging."""
    out = _run_until_rank0(W.follower_death_world, 2,
                           (CONFIG, PARAMS, PROMPTS, 3), timeout_s=180)
    assert out["errors"], "the leader served on without its follower"
    assert out["seconds"] < 25


def test_a_follower_that_fails_makes_the_leader_raise():
    """Rank 1's step raises while its process lives: the follower's
    loop raises that error, and the leader's call raises within the
    mesh's timeout."""
    leader, follower = mp.run_world(
        W.follower_failure_world, 2, "gloo", "cpu",
        args=(CONFIG, PARAMS, PROMPTS), timeout_s=180, threads=1)
    assert follower["raised"] == "follower fault"
    assert leader["raised"] is not None
    assert leader["seconds"] < 40
