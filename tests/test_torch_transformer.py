"""Port parity: ``veles_tpu_torch.models.transformer`` (serving half)
against ``veles_tpu.models.transformer`` on the CPU, from the same
numpy-seeded weights and the same numpy inputs.

Tolerances: f32 logits agree within 1e-4 relative to the logits'
scale (the bound ``__graft_entry__.py`` holds sharded training to):
both sides run the same f32 ops and differ in summation order only.
Greedy tokens are compared exactly. At bfloat16 the two frameworks
round activations at different points (XLA fuses elementwise chains
and rounds once per fusion; PyTorch rounds after every op), so a
2-layer model's logits agree to a few bf16 ulps (bf16's epsilon is
7.8e-3) of the logits' scale: the bound is 2e-2 of it (4.7e-3 seen).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import veles_tpu.models.transformer as JT
import veles_tpu_torch.models.transformer as PT

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

SMALL = dict(vocab=64, embed=64, heads=2, layers=2, seq_len=64)
JAX_ATTN = {"lax": {"attention_impl": "lax"},
            "pallas-interpret": {"attention_impl": "pallas"}}
PARAMS = JT.init_params(JT.TransformerConfig(**SMALL), seed=5)


def _port(params=PARAMS, **kw):
    config = PT.TransformerConfig(**dict(SMALL, **kw))
    return config, PT.params_from_numpy(params, config, "cpu")


def _prompts(seed, lens, width):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), width), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, SMALL["vocab"], n)
    return toks, np.asarray(lens, np.int32)


def _rel_err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() /
                 np.abs(np.asarray(b)).max())


def _jax_pallas_interpret(monkeypatch):
    """Route the JAX package's flash calls through the Pallas
    interpreter (its tests' way of running the shipped kernels on the
    CPU); the transformer module holds its own references."""
    attention, decode = JT.flash_attention, JT.flash_decode

    def fwd(*a, **k):
        return attention(*a, interpret=True, **k)

    def dec(*a, **k):
        return decode(*a, interpret=True, **k)

    monkeypatch.setattr(JT, "flash_attention", fwd)
    monkeypatch.setattr(JT, "flash_decode", dec)


@pytest.mark.parametrize("moe", [0, 2])
def test_init_params_bitwise_equal(moe):
    cfg = dict(SMALL, moe_experts=moe)
    ref = JT.init_params(JT.TransformerConfig(**cfg), seed=11)
    ours = PT.init_params(PT.TransformerConfig(**cfg), seed=11)

    def walk(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for key in a:
                walk(a[key], b[key])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)

    walk(ref, ours)


def test_params_from_numpy_checks_the_tree():
    config, tree = _port()
    assert tree["blocks"][1]["qkv"].dtype == torch.float32
    assert tuple(tree["blocks"][1]["qkv"].shape) == (64, 192)
    np.testing.assert_array_equal(tree["embed"].numpy(), PARAMS["embed"])
    with pytest.raises(ValueError, match="blocks"):
        PT.params_from_numpy(PARAMS, PT.TransformerConfig(
            **dict(SMALL, layers=3)), "cpu")
    with pytest.raises(ValueError, match="shape"):
        PT.params_from_numpy(PARAMS, PT.TransformerConfig(
            **dict(SMALL, vocab=65)), "cpu")


@pytest.mark.parametrize("jax_impl", sorted(JAX_ATTN))
def test_prefill_logits_match_jax_and_forward(jax_impl, monkeypatch):
    """Prefill's last-position logits equal the JAX package's prefill,
    the JAX full forward and the port's full forward, for a ragged
    right-padded batch."""
    if jax_impl == "pallas-interpret":
        _jax_pallas_interpret(monkeypatch)
    jcfg = JT.TransformerConfig(**SMALL, **JAX_ATTN[jax_impl])
    config, params = _port()
    toks, lens = _prompts(7, [5, 9, 16], 16)
    ref, ref_cache = JT.prefill(PARAMS, jnp.asarray(toks),
                                jnp.asarray(lens), jcfg)
    logits, cache = PT.prefill(params, torch.from_numpy(toks).long(),
                               torch.from_numpy(lens), config)
    assert logits.dtype == torch.float32
    assert _rel_err(logits.numpy(), ref) <= 1e-4
    assert _rel_err(cache["k"].numpy(), ref_cache["k"]) <= 1e-4
    assert _rel_err(cache["v"].numpy(), ref_cache["v"]) <= 1e-4
    for i, n in enumerate(lens):
        full, _ = PT.forward(params, torch.from_numpy(toks[i:i + 1, :n])
                             .long(), config)
        jfull, _ = JT.forward(PARAMS, jnp.asarray(toks[i:i + 1, :n]),
                              jcfg, mesh=None, seq_axis=None)
        assert _rel_err(full.numpy()[0], np.asarray(jfull)[0]) <= 1e-4
        assert _rel_err(logits.numpy()[i], full.numpy()[0, -1]) <= 1e-4


@pytest.mark.parametrize("jax_impl", sorted(JAX_ATTN))
def test_greedy_decode_token_for_token_vs_jax(jax_impl, monkeypatch):
    """Greedy decode through the KV cache is token-for-token identical
    to the JAX package's ``decode_step`` over 20 steps, with ragged
    lengths and a generation that crosses out of its prompt bucket
    (16) in a 32-slot cache."""
    if jax_impl == "pallas-interpret":
        _jax_pallas_interpret(monkeypatch)
    jcfg = JT.TransformerConfig(**SMALL, **JAX_ATTN[jax_impl])
    config, params = _port()
    toks, lens = _prompts(7, [5, 9], 16)
    jcache = JT.init_kv_cache(jcfg, 2, max_len=32)
    jlogits, jcache = JT.prefill(PARAMS, jnp.asarray(toks),
                                 jnp.asarray(lens), jcfg, jcache)
    cache = PT.init_kv_cache(config, 2, max_len=32, device="cpu")
    logits, cache = PT.prefill(params, torch.from_numpy(toks).long(),
                               torch.from_numpy(lens), config, cache)
    jtok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
    tok = torch.argmax(logits, -1).to(torch.int32)
    jlen, plen = jnp.asarray(lens), torch.from_numpy(lens)
    for step in range(20):
        assert tok.tolist() == jtok.tolist(), "diverged at step %d" % step
        jlogits, jcache, jlen = JT.decode_step(
            PARAMS, jnp.asarray(jtok), jcache, jlen, jcfg)
        logits, cache, plen = PT.decode_step(params, tok, cache, plen,
                                             config)
        assert _rel_err(logits.numpy(), jlogits) <= 1e-4
        jtok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
        tok = torch.argmax(logits, -1).to(torch.int32)
    assert plen.tolist() == np.asarray(jlen).tolist() == [25, 29]


def test_decode_step_active_mask_freezes_inactive_rows():
    config, params = _port()
    toks = torch.ones((2, 8), dtype=torch.long)
    plens = torch.tensor([4, 6], dtype=torch.int32)
    cache = PT.init_kv_cache(config, 2, max_len=16, device="cpu")
    _, cache = PT.prefill(params, toks, plens, config, cache)
    _, _, new_len = PT.decode_step(
        params, torch.tensor([1, 1]), cache, plens, config,
        active=torch.tensor([True, False]))
    assert new_len.tolist() == [5, 6]


def test_bf16_logits_within_stated_bound():
    """bf16 activations: the port's prefill logits against the JAX
    package's at the same compute dtype, within 2e-2 of the logits'
    scale (the module docstring gives the reason)."""
    jcfg = JT.TransformerConfig(**SMALL, compute="bfloat16",
                                attention_impl="lax")
    config, params = _port(compute="bfloat16")
    toks, lens = _prompts(3, [7, 16], 16)
    ref, _ = JT.prefill(PARAMS, jnp.asarray(toks), jnp.asarray(lens),
                        jcfg)
    logits, cache = PT.prefill(params, torch.from_numpy(toks).long(),
                               torch.from_numpy(lens), config)
    assert logits.dtype == torch.float32
    assert cache["k"].dtype == torch.bfloat16
    assert _rel_err(logits.numpy(), np.asarray(ref, np.float32)) <= 2e-2


def test_moe_and_dense_attention_are_refused():
    """The dense-attention oracle is not ported and is refused (MoE is
    ported now: tests/test_torch_train.py checks it)."""
    config, params = _port(attention="dense")
    with pytest.raises(ValueError, match="flash"):
        PT.forward(params, torch.ones((1, 4), dtype=torch.long), config)
