"""Head dims outside 32, 64 and 128: the port's attention and its
gradients at D = 8, 80, 96 and 256 against the JAX package's Pallas
kernels (through the interpreter, as its own tests run them on the
CPU), one whole model at D = 80 decoded and one at D = 256 trained
through both packages, and the host constants that set how the kernels
take such a head dim.

The reference's kernels take the whole head dim as one block, so they
compute at any D; the port's kernels run a head dim d (a multiple of 8
up to 256) on the instance of the next width of 32, 64, 128 and 256
with the missing columns read as zeros. On the CPU the port runs its
plain path, which takes any D.

Tolerances: at float32 both sides compute the same blocked online
softmax and differ in the order of f32 sums only: 1e-4 of the output's
scale (the port's f32 parity bound). At bfloat16 the inputs are exact
in both and both round p and the output to bf16: one bf16 ulp of a
unit-scale output, 2e-2 absolute. Greedy tokens are compared exactly,
logits to 1e-4 relative. Gradients at float32 (of the attention and of
every parameter of a model) agree within 1e-4 of each gradient's scale,
for the same reason. Parameters after Adam steps agree within 2 lr per
step: Adam turns each gradient into about +-lr whatever its size, so a
gradient that is zero up to f32 noise can flip sign between the two
frameworks (the bound of ``tests/test_torch_train.py``).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import veles_tpu.models.transformer as JT
import veles_tpu_torch.models.transformer as PT
from veles_tpu.serve import engine as J_engine
from veles_tpu_torch.serve import PagedGenerativeEngine

J = importlib.import_module("veles_tpu.ops.flash_attention")
P = importlib.import_module("veles_tpu_torch.ops.flash_attention")

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

HEAD_DIMS = [8, 80, 96, 256]
PALLAS = {"impl": "pallas", "interpret": True}
TOL_F32 = 1e-4
TOL_BF16 = 2e-2


def _inputs(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(n)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_attention_matches_pallas_f32(d, causal):
    q, k, v = _inputs((1, 128, 2, d), seed=d)
    ref = J.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                            block_q=64, block_k=64, **PALLAS)
    out = P.flash_attention(*map(torch.from_numpy, (q, k, v)),
                            causal=causal)
    assert out.shape == (1, 128, 2, d) and out.dtype == torch.float32
    assert _rel(out.numpy(), ref) <= TOL_F32


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_attention_grads_match_pallas_f32(d, causal):
    """The port's autograd backward (``_plain_bwd``, what K2 and K3
    compute) against ``jax.grad`` through the reference's Pallas
    forward and backward kernels."""
    q, k, v, do = _inputs((1, 128, 2, d), seed=d + 10, n=4)

    def f(q, k, v):
        return (J.flash_attention(q, k, v, causal=causal, block_q=64,
                                  block_k=64, **PALLAS) * do).sum()

    ref = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = P.flash_attention(*xs, causal=causal)
    (out * torch.from_numpy(do)).sum().backward()
    for x, theirs in zip(xs, ref):
        assert x.grad.shape == (1, 128, 2, d)
        assert _rel(x.grad.numpy(), theirs) <= TOL_F32


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_attention_matches_reference_bf16(d):
    q, k, v = _inputs((2, 64, 2, d), seed=d + 1)
    ref = J.flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                              for x in (q, k, v)), causal=True,
                            block_q=32, block_k=32, impl="lax")
    out = P.flash_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                              for x in (q, k, v)), causal=True,
                            block_q=32, block_k=32)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=TOL_BF16)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_decode_matches_pallas(d):
    """Slabs [2, 256, 2, D], lengths 100 and the full 256."""
    k, v = _inputs((2, 256, 2, d), seed=d + 2, n=2)
    (q,) = _inputs((2, 2, d), seed=d + 3, n=1)
    lengths = np.array([100, 256], np.int32)
    ref = J.flash_decode(*map(jnp.asarray, (q, k, v, lengths)), **PALLAS)
    out = P.flash_decode(*map(torch.from_numpy, (q, k, v, lengths)))
    assert _rel(out.numpy(), ref) <= TOL_F32


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_decode_paged_matches_pallas(d):
    """The same caches as 16-token pages of one pool, scrambled through
    a block table whose last entries are the sentinel."""
    rng = np.random.default_rng(d + 4)
    ps, n_blk, b, h = 16, 16, 2, 2
    n_pages = b * n_blk
    kp, vp = _inputs((n_pages, ps, h, d), seed=d + 5, n=2)
    table = rng.permutation(n_pages).astype(np.int32).reshape(b, n_blk)
    table[0, 7:] = n_pages                 # length 100: 7 pages, sentinels
    (q,) = _inputs((b, h, d), seed=d + 6, n=1)
    lengths = np.array([100, 256], np.int32)
    ref = J.flash_decode_paged(*map(jnp.asarray, (q, kp, vp, table,
                                                  lengths)), **PALLAS)
    out = P.flash_decode_paged(*map(torch.from_numpy, (q, kp, vp, table,
                                                       lengths)))
    assert _rel(out.numpy(), ref) <= TOL_F32


# -- a whole model at D = 80 -------------------------------------------------

D80 = dict(vocab=64, embed=160, heads=2, layers=2, seq_len=64)
D80_PARAMS = JT.init_params(JT.TransformerConfig(**D80), seed=9)


def _d80_port():
    config = PT.TransformerConfig(**D80)
    assert config.embed // config.heads == 80
    return config, PT.params_from_numpy(D80_PARAMS, config, "cpu")


def _prompts(seed, lens, width):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), width), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, D80["vocab"], n)
    return toks, np.asarray(lens, np.int32)


def test_d80_model_decodes_the_reference_tokens(monkeypatch):
    """Prefill and 16 greedy decode steps at 2 heads of 80 equal the
    JAX package's token for token, its flash calls run through the
    Pallas interpreter."""
    attention, decode = JT.flash_attention, JT.flash_decode
    monkeypatch.setattr(JT, "flash_attention",
                        lambda *a, **k: attention(*a, interpret=True, **k))
    monkeypatch.setattr(JT, "flash_decode",
                        lambda *a, **k: decode(*a, interpret=True, **k))
    jcfg = JT.TransformerConfig(**D80, attention_impl="pallas")
    config, params = _d80_port()
    toks, lens = _prompts(3, [5, 11], 16)
    jcache = JT.init_kv_cache(jcfg, 2, max_len=32)
    jlogits, jcache = JT.prefill(D80_PARAMS, jnp.asarray(toks),
                                 jnp.asarray(lens), jcfg, jcache)
    cache = PT.init_kv_cache(config, 2, max_len=32, device="cpu")
    logits, cache = PT.prefill(params, torch.from_numpy(toks).long(),
                               torch.from_numpy(lens), config, cache)
    assert _rel(logits.numpy(), jlogits) <= TOL_F32
    jtok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    tok = torch.argmax(logits, -1).to(torch.int32)
    jlen, plen = jnp.asarray(lens), torch.from_numpy(lens)
    for step in range(16):
        assert tok.tolist() == jtok.tolist(), "diverged at step %d" % step
        jlogits, jcache, jlen = JT.decode_step(
            D80_PARAMS, jnp.asarray(jtok), jcache, jlen, jcfg)
        logits, cache, plen = PT.decode_step(params, tok, cache, plen,
                                             config)
        assert _rel(logits.numpy(), jlogits) <= TOL_F32
        jtok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
        tok = torch.argmax(logits, -1).to(torch.int32)
    assert plen.tolist() == [21, 27]


# -- a whole model at D = 256, trained ---------------------------------------

D256 = dict(vocab=64, embed=512, heads=2, layers=2, seq_len=64)
LR = 3e-3


def _d256_tokens(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, D256["vocab"],
                        (2, D256["seq_len"] + 1)).astype(np.int32)


def test_d256_model_loss_and_grads_match_pallas(monkeypatch):
    """2 layers of 2 heads of 256: the loss and the gradient of every
    parameter equal the JAX package's, its flash calls (forward and both
    backward kernels) through the Pallas interpreter."""
    attention = JT.flash_attention
    monkeypatch.setattr(JT, "flash_attention", lambda *a, **k: attention(
        *a, interpret=True, **dict(k, impl="pallas")))
    jcfg = JT.TransformerConfig(**D256, attention_impl="pallas")
    config = PT.TransformerConfig(**D256)
    assert config.head_dim == 256
    params = JT.init_params(jcfg, seed=5)
    tok = _d256_tokens(1)
    ref_loss, ref_grads = jax.value_and_grad(JT._loss)(
        params, jnp.asarray(tok[:, :-1]), jnp.asarray(tok[:, 1:]), jcfg,
        None, None)
    tree = PT.params_from_numpy(params, config, "cpu")
    leaves = PT._tree_leaves(tree)
    for leaf in leaves:
        leaf.requires_grad_(True)
    t = torch.from_numpy(tok).long()
    loss = PT._loss(tree, t[:, :-1], t[:, 1:], config)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(ref_loss)) <= \
        TOL_F32 * abs(float(ref_loss))
    ref = [np.asarray(x) for x in PT._tree_leaves(
        jax.tree.map(np.asarray, ref_grads))]
    assert len(ref) == len(grads)
    for ours, theirs in zip(grads, ref):
        assert _rel(ours.numpy(), theirs) <= TOL_F32


def test_d256_three_adam_steps_match_the_reference_trainer():
    """Three f32 Adam steps of the port's ``TransformerTrainer`` at 2
    heads of 256 against the reference trainer from the same seed:
    losses within 1e-4 relative, parameters within 2 lr per step."""
    jt = JT.TransformerTrainer(
        JT.TransformerConfig(**D256, attention_impl="lax"), mesh=None,
        learning_rate=LR, seed=2)
    pt = PT.TransformerTrainer(PT.TransformerConfig(**D256), device="cpu",
                               learning_rate=LR, seed=2)
    for i in range(3):
        tok = _d256_tokens(20 + i)
        ref = float(jt.step(tok)["loss"])
        got = pt.step(tok)
        assert int(got["nonfinite"]) == 0
        assert abs(float(got["loss"]) - ref) <= TOL_F32 * abs(ref)
    ours = [x.detach().numpy() for x in PT._tree_leaves(pt.params)]
    theirs = [np.asarray(x) for x in PT._tree_leaves(
        jax.tree.map(np.asarray, jt.params))]
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert np.abs(a - b).max() <= 2 * LR * 3


@functools.lru_cache(maxsize=None)
def _d80_reference_paged():
    return J_engine.PagedGenerativeEngine(
        JT.TransformerConfig(**D80, attention_impl="lax"), D80_PARAMS,
        max_slots=4, page_size=16)


def test_d80_paged_engine_generates_the_reference_tokens():
    """The paged engine (K5's path) at 2 heads of 80: greedy tokens of
    ragged prompts equal the reference's paged engine's."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, D80["vocab"], n).astype(np.int32)
               for n in (3, 17, 30)]
    config, _ = _d80_port()
    engine = PagedGenerativeEngine(config, D80_PARAMS, max_slots=4,
                                   page_size=16, device="cpu")
    got = [list(map(int, g)) for g in engine.generate(prompts, 12)]
    want = [list(map(int, g)) for g in
            _d80_reference_paged().generate(prompts, 12)]
    assert got == want


# -- how the kernels take a head dim -----------------------------------------

@pytest.mark.parametrize("d,width", [
    (8, 32), (16, 32), (24, 32), (32, 32), (40, 64), (48, 64), (64, 64),
    (72, 128), (80, 128), (96, 128), (128, 128), (136, 256), (200, 256),
    (256, 256)])
def test_head_dims_run_on_the_next_width(d, width):
    assert P.kernel_width(d) == width
    assert width in P.KERNEL_HEAD_DIMS


@pytest.mark.parametrize("d", [0, 4, 12, 44, 100, 252 + 2, 264, 512])
def test_head_dims_the_kernels_refuse(d):
    """Not a multiple of 8, or past 256: no instance, and a kernel
    wrapper raises naming both bounds (before it would look for a
    device or a library)."""
    assert P.kernel_width(d) == 0
    x = torch.zeros((1, 4, 1, max(d, 1)))
    with pytest.raises(ValueError, match="multiples of 8 from 8 to 256"):
        P._check_kernel_operands("flash_fwd", x)


@pytest.mark.parametrize("entry", ["flash_bwd_dkv", "flash_bwd_dq"])
@pytest.mark.parametrize("d", [100, 264])
def test_backward_kernels_refuse_head_dims_off_the_instances(entry, d):
    """K2 and K3 take what K1 takes: a head dim off the multiples of 8
    or past 256 raises naming both bounds."""
    x = torch.zeros((1, 4, 1, d))
    with pytest.raises(ValueError, match="multiples of 8 from 8 to 256"):
        P._check_kernel_operands(entry, x)


@pytest.mark.parametrize("d,tiles", [
    (8, {"flash_bwd_dq": (128, 64), "flash_bwd_dkv": (64, 128)}),
    (80, {"flash_bwd_dq": (128, 64), "flash_bwd_dkv": (64, 128)}),
    (128, {"flash_bwd_dq": (128, 64), "flash_bwd_dkv": (64, 128)}),
    (136, {"flash_bwd_dq": (64, 64), "flash_bwd_dkv": (64, 64)}),
    (256, {"flash_bwd_dq": (64, 64), "flash_bwd_dkv": (64, 64)})])
def test_backward_kernels_take_the_tiles_of_their_width(d, tiles):
    """(query tile, key tile) of K3 and K2 at the width a head dim runs
    on: 128 query rows over 64-key tiles (K3) and 128 keys over 64-row
    query tiles (K2) up to 128 columns; at 256 both hold 64 rows a side
    (one consumer warpgroup in K3, two warpgroups splitting the products
    in K2), which fit the card's shared memory and registers. The bf16
    operands are boxed by them."""
    width = P.kernel_width(d)
    for entry, want in tiles.items():
        assert P.tma_tiles(entry, width) == want
        xs = [torch.zeros((2, 130, 2, d), dtype=torch.bfloat16)
              for _ in range(4)]
        _, maps = P._tma_operands(entry, *xs)
        values = memoryview(maps).cast("q")
        rows = [values[12 * i + 9] for i in range(4)]
        assert rows == [want[0], want[1], want[1], want[0]]
        assert all(values[12 * i] == d for i in range(4))


def test_decode_workspace_rows_take_the_instance_width():
    """K4/K5's split partials are rows of the instance width plus
    (m, l), where the plain path stands in too (the memory plan)."""
    b, h, cap = 3, 4, 1000
    for d, width in ((80, 128), (256, 256), (32, 32), (8, 32)):
        assert P.kernel_workspace("flash_decode", b, h, d, capacity=cap) \
            == b * h * P.decode_chunks(cap) * (width + 2) * 4
