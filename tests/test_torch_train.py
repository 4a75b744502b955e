"""Port parity: the training half of ``veles_tpu_torch.models.transformer``
(loss, Adam, ``TransformerTrainer``, MoE) against
``veles_tpu.models.transformer`` on the CPU, from the same numpy-seeded
weights and the same numpy token batches.

Tolerances: the loss and every parameter gradient at float32 agree
within 1e-4 of each leaf's scale (the bound ``__graft_entry__.py``
holds sharded training to): both sides run the same f32 ops and differ
in summation order only. Losses along a trajectory agree to 1e-4
relative. Parameters after Adam steps get a bound tied to the learning
rate instead: Adam's first steps turn each gradient into about +-lr
whatever its size, so a gradient that is zero up to f32 noise can flip
sign between the two frameworks and move that element by up to 2 lr
per step. The bound is that worst case, 2 lr per step taken.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import veles_tpu.models.transformer as JT
import veles_tpu_torch.models.transformer as PT
from veles_tpu_torch.parallel.fused import NonFiniteUpdate
from veles_tpu_torch.serve import GenerativeEngine

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

SMALL = dict(vocab=64, embed=64, heads=4, layers=2, seq_len=32)
LR = 3e-3
JAX_ATTN = ("lax", "pallas-interpret")


def _tokens(seed, batch=2, k=None):
    rng = np.random.default_rng(seed)
    shape = (batch, SMALL["seq_len"] + 1) if k is None else \
        (k, batch, SMALL["seq_len"] + 1)
    return rng.integers(0, SMALL["vocab"], shape).astype(np.int32)


def _leaves(tree):
    """Leaves of a params tree in the port's fixed order, as numpy."""
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)
            for x in PT._tree_leaves(tree)]


def _jax_pallas_interpret(monkeypatch):
    """Route the JAX package's flash calls through the Pallas
    interpreter (forward and both backward kernels)."""
    attention = JT.flash_attention

    def fwd(*a, **k):
        return attention(*a, interpret=True, **dict(k, impl="pallas"))

    monkeypatch.setattr(JT, "flash_attention", fwd)


def _jax_trainer(**kw):
    cfg = JT.TransformerConfig(**SMALL, attention_impl="lax")
    return JT.TransformerTrainer(cfg, mesh=None, learning_rate=LR, **kw)


def _port_trainer(**kw):
    return PT.TransformerTrainer(PT.TransformerConfig(**SMALL),
                                 device="cpu", learning_rate=LR, **kw)


def _assert_params_close(ours, theirs, steps):
    bound = 2 * LR * steps
    for a, b in zip(_leaves(ours), _leaves(theirs)):
        assert np.abs(a - b).max() <= bound


@pytest.mark.parametrize("jax_attn", JAX_ATTN)
@pytest.mark.parametrize("ce_chunk,moe", [(0, 0), (8, 0), (8, 2)])
def test_loss_and_grads_match_jax(jax_attn, ce_chunk, moe, monkeypatch):
    """``_loss`` and the gradient of every parameter, with the full and
    the chunked cross-entropy head, dense and MoE FFN."""
    if jax_attn == "pallas-interpret":
        _jax_pallas_interpret(monkeypatch)
    cfg = dict(SMALL, ce_chunk=ce_chunk, moe_experts=moe)
    jcfg = JT.TransformerConfig(**cfg, attention_impl="lax")
    config = PT.TransformerConfig(**cfg)
    params = JT.init_params(jcfg, seed=3)
    tok = _tokens(0)
    ref_loss, ref_grads = jax.value_and_grad(JT._loss)(
        params, jnp.asarray(tok[:, :-1]), jnp.asarray(tok[:, 1:]), jcfg,
        None, None)
    tree = PT.params_from_numpy(params, config, "cpu")
    leaves = PT._tree_leaves(tree)
    for leaf in leaves:
        leaf.requires_grad_(True)
    t = torch.from_numpy(tok).long()
    assert PT._ce_chunk(config, t.shape[1] - 1) == ce_chunk
    loss = PT._loss(tree, t[:, :-1], t[:, 1:], config)
    grads = torch.autograd.grad(loss, leaves)
    ref_loss = float(ref_loss)
    assert abs(float(loss.detach()) - ref_loss) <= 1e-4 * abs(ref_loss)
    ref = _leaves(jax.tree.map(np.asarray, ref_grads))
    assert len(ref) == len(grads)
    for ours, theirs in zip(grads, ref):
        scale = max(np.abs(theirs).max(), 1e-30)
        assert np.abs(ours.numpy() - theirs).max() <= 1e-4 * scale


def test_remat_and_chunking_do_not_change_the_gradient():
    """remat="none" vs "attn" and full vs chunked CE: the same loss and
    the same gradients within f32 sum order."""
    params = PT.init_params(PT.TransformerConfig(**SMALL), seed=4)
    t = torch.from_numpy(_tokens(1)).long()
    out = []
    for kw in (dict(remat="attn", ce_chunk=8), dict(remat="none",
                                                   ce_chunk=0)):
        config = PT.TransformerConfig(**SMALL, **kw)
        tree = PT.params_from_numpy(params, config, "cpu")
        leaves = PT._tree_leaves(tree)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = PT._loss(tree, t[:, :-1], t[:, 1:], config)
        out.append([loss] + list(torch.autograd.grad(loss, leaves)))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        config = PT.TransformerConfig(**SMALL, remat="bogus")
        PT._loss(PT.params_from_numpy(params, config, "cpu"),
                 t[:, :-1], t[:, 1:], config)


def test_three_steps_match_jax_trainer():
    """Three f32 Adam steps from the same seed on the same batches:
    losses within 1e-4 relative, params within 2 lr per step."""
    jt, pt = _jax_trainer(seed=1), _port_trainer(seed=1)
    for i in range(3):
        tok = _tokens(10 + i)
        ref = float(jt.step(tok)["loss"])
        got = pt.step(tok)
        assert got["loss"].dtype == torch.float32
        assert int(got["nonfinite"]) == 0
        assert abs(float(got["loss"]) - ref) <= 1e-4 * abs(ref)
    _assert_params_close(pt.params, jax.tree.map(np.asarray, jt.params), 3)
    assert pt.params["embed"].dtype == torch.float32


def test_step_many_matches_sequential_steps():
    """K steps per call equal K sequential step() calls exactly (the
    per-step bias correction rides the step counter), losses come back
    as a [K] tensor, and a K=1 step afterwards still agrees."""
    tokens = _tokens(20, k=6)
    seq = _port_trainer(seed=5)
    seq_losses = [float(seq.step(tokens[i])["loss"]) for i in range(6)]
    many = _port_trainer(seed=5)
    m1 = many.step_many(tokens[:3])
    assert tuple(m1["loss"].shape) == (3,)
    assert tuple(m1["nonfinite"].shape) == (3,)
    m2 = many.step_many(list(tokens[3:]))
    assert m1["loss"].tolist() + m2["loss"].tolist() == seq_losses
    assert float(seq.step(tokens[0])["loss"]) == \
        float(many.step(tokens[0])["loss"])
    for a, b in zip(_leaves(seq.params), _leaves(many.params)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        _port_trainer(steps_per_dispatch=0)


def _blow_up(trainer, tok):
    """Drive the NEXT step non-finite, as the reference's test does: a
    huge learning rate blows the params up on this step (its grads
    still finite), so the step after sees non-finite grads."""
    trainer.learning_rate = 1e30
    trainer.step(tok)
    trainer.learning_rate = LR


def test_skip_policy_leaves_state_bitwise_intact():
    tok = _tokens(30)
    tr = _port_trainer(seed=7, nan_policy="skip")
    assert int(tr.step(tok)["nonfinite"]) == 0
    _blow_up(tr, tok)
    state = (tr.params, tr.opt_m, tr.opt_v)
    blown = [x.copy() for x in _leaves(state)]
    metrics = tr.step(tok)
    assert int(metrics["nonfinite"]) == 1
    assert tr.nonfinite_count == 1
    for a, b in zip(blown, _leaves(state)):
        assert np.array_equal(a, b, equal_nan=True)


def test_raise_and_warn_policies(caplog):
    tok = _tokens(31)
    tr = _port_trainer(seed=7, nan_policy="raise")
    tr.step(tok)
    _blow_up(tr, tok)
    with pytest.raises(NonFiniteUpdate):
        tr.step(tok)
    tr = _port_trainer(seed=7, nan_policy="warn")
    tr.step(tok)
    _blow_up(tr, tok)
    with caplog.at_level(logging.WARNING, logger="TransformerTrainer"):
        tr.step(tok)
        assert "non-finite" not in caplog.text  # read 4 dispatches late
        assert tr.nonfinite_count >= 1
        assert "non-finite" in caplog.text
    with pytest.raises(ValueError, match="nan_policy"):
        _port_trainer(nan_policy="ignore")


def test_state_carried_from_a_jax_run():
    """JAX trains 2 steps; ``load_state`` carries its params, Adam m/v
    and step count over; both train 2 more steps and agree."""
    jt = _jax_trainer(seed=2)
    for i in range(2):
        jt.step(_tokens(40 + i))
    as_np = jax.tree.map(np.asarray, (jt.params, jt.opt_m, jt.opt_v))
    pt = _port_trainer(seed=99)
    pt.load_state(*as_np, step=2)
    for i in range(2, 4):
        tok = _tokens(40 + i)
        ref = float(jt.step(tok)["loss"])
        assert abs(float(pt.step(tok)["loss"]) - ref) <= 1e-4 * abs(ref)
    _assert_params_close(pt.params, jax.tree.map(np.asarray, jt.params), 2)
    for ours, theirs in ((pt.opt_m, jt.opt_m), (pt.opt_v, jt.opt_v)):
        for a, b in zip(_leaves(ours), _leaves(jax.tree.map(np.asarray,
                                                            theirs))):
            assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-30)


def test_moe_greedy_decode_matches_jax():
    """MoE FFN in the serving path: prefill + 8 greedy decode steps,
    token for token against the reference."""
    cfg = dict(SMALL, moe_experts=2)
    jcfg = JT.TransformerConfig(**cfg, attention_impl="lax")
    config = PT.TransformerConfig(**cfg)
    params = JT.init_params(jcfg, seed=6)
    tree = PT.params_from_numpy(params, config, "cpu")
    toks = np.zeros((2, 8), np.int32)
    toks[0, :5] = [3, 9, 1, 7, 2]
    toks[1, :8] = [5, 5, 8, 1, 9, 4, 4, 2]
    lens = np.array([5, 8], np.int32)
    jcache = JT.init_kv_cache(jcfg, 2, max_len=16)
    jlogits, jcache = JT.prefill(params, jnp.asarray(toks),
                                 jnp.asarray(lens), jcfg, jcache)
    cache = PT.init_kv_cache(config, 2, max_len=16, device="cpu")
    with torch.inference_mode():
        logits, cache = PT.prefill(tree, torch.from_numpy(toks).long(),
                                   torch.from_numpy(lens), config, cache)
        jlen, plen = jnp.asarray(lens), torch.from_numpy(lens)
        for _ in range(8):
            jtok = np.argmax(np.asarray(jlogits), -1).astype(np.int32)
            tok = torch.argmax(logits, -1).to(torch.int32)
            assert tok.tolist() == jtok.tolist()
            jlogits, jcache, jlen = JT.decode_step(
                params, jnp.asarray(jtok), jcache, jlen, jcfg)
            logits, cache, plen = PT.decode_step(tree, tok, cache, plen,
                                                 config)
    ref = np.asarray(jlogits)
    assert np.abs(logits.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_served_weights_do_not_move_with_training():
    """``GenerativeEngine.from_trainer`` copies the weights: further
    in-place training steps leave a live engine's logits unchanged."""
    tr = _port_trainer(seed=8)
    tr.step(_tokens(50))
    engine = GenerativeEngine.from_trainer(tr, max_slots=1, device="cpu")
    prompt = [np.asarray([4, 9, 2, 7], np.int32)]
    before = engine.generate(prompt, 6)[0]
    with torch.inference_mode():
        toks = torch.tensor([[4, 9, 2, 7]])
        served = PT.forward(engine.params, toks, engine.config)[0]
    torch.testing.assert_close(served, tr.generate_logits(toks),
                               rtol=0, atol=0)
    tr.step(_tokens(51))
    tr.step(_tokens(52))
    with torch.inference_mode():
        again = PT.forward(engine.params, toks, engine.config)[0]
    torch.testing.assert_close(again, served, rtol=0, atol=0)
    assert not torch.equal(tr.generate_logits(toks), served)
    assert engine.generate(prompt, 6)[0].tolist() == before.tolist()
