"""Port parity: ``veles_tpu_torch.ops.flash_attention`` (plain PyTorch
path, which CPU tensors take) against the JAX package's
``flash_attention`` / ``flash_decode``, run as the JAX package's own
tests run them on the CPU: ``impl="lax"`` and the shipped Pallas
kernels through the interpreter. Inputs are numpy, seeded, handed to
both.

Tolerances: at float32 both sides compute the same blocked online
softmax in f32 and differ only in the order of sums, so outputs and
the f32 residuals agree to 1e-5 absolute (l, a sum of up to T
exponentials, to 1e-5 relative). At bfloat16 the inputs are exactly
representable in both, p and the output round to bf16 in both; the
remaining difference is f32 sum order ahead of a bf16 rounding, one
bf16 ulp of a unit-scale output (2e-2 absolute).

Gradients: at float32 both sides run the same blocked backward and
differ in sum order only (2e-5 absolute on unit-scale gradients, sums
of up to T terms). At bfloat16 dS rounds to bf16 before the dK and dQ
products on both sides and the gradients round to bf16 at the end:
2e-2 of the gradient's scale, as for the outputs.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

J = importlib.import_module("veles_tpu.ops.flash_attention")
P = importlib.import_module("veles_tpu_torch.ops.flash_attention")

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

JAX_IMPLS = {"lax": {"impl": "lax"},
             "pallas-interpret": {"impl": "pallas", "interpret": True}}


def _inputs(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(n)]


def _padded_lax_stats(q, k, v, causal, bq, bk):
    """JAX ``_lax_fwd`` residuals (l, m) for the unpadded rows."""
    t = q.shape[1]
    bq = min(bq or J.DEFAULT_BLOCK, -(-t // 8) * 8)
    bk = min(bk or J.DEFAULT_BLOCK, -(-t // 8) * 8)
    mult = int(np.lcm(bq, bk))
    t_pad = -(-t // mult) * mult
    pad = [(0, 0), (0, t_pad - t), (0, 0), (0, 0)]
    spec = J._Spec(causal=causal, block_q=bq, block_k=bk, kv_len=t,
                   impl="lax", interpret=False)
    _, l, m = J._lax_fwd(spec, *(jnp.pad(x, pad) for x in (q, k, v)))
    return np.asarray(l)[..., :t], np.asarray(m)[..., :t]


FWD_CASES = [(64, True, None, None), (37, True, 16, 8),
             (50, False, 8, 16), (96, True, 32, 32), (1, True, None, None)]


@pytest.mark.parametrize("jax_impl", sorted(JAX_IMPLS))
@pytest.mark.parametrize("t,causal,bq,bk", FWD_CASES)
def test_flash_attention_matches_jax_f32(jax_impl, t, causal, bq, bk):
    q, k, v = _inputs((2, t, 2, 16), seed=t)
    ref = J.flash_attention(jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v), causal=causal, block_q=bq,
                            block_k=bk, **JAX_IMPLS[jax_impl])
    o, l, m = P.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block_q=bq, block_k=bk)
    assert o.dtype == torch.float32 and o.shape == (2, t, 2, 16)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    ref_l, ref_m = _padded_lax_stats(q, k, v, causal, bq, bk)
    np.testing.assert_allclose(l.numpy(), ref_l, rtol=1e-5, atol=0)
    np.testing.assert_allclose(m.numpy(), ref_m, rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax_bf16(causal):
    q, k, v = _inputs((2, 64, 2, 32), seed=7)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = J.flash_attention(jq, jk, jv, causal=causal, block_q=32,
                            block_k=32, impl="lax")
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in (q, k, v))
    out = P.flash_attention(tq, tk, tv, causal=causal, block_q=32,
                            block_k=32)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=2e-2)


@pytest.mark.parametrize("jax_impl", sorted(JAX_IMPLS))
@pytest.mark.parametrize("block_k", [None, 8])
def test_flash_decode_matches_jax(jax_impl, block_k):
    """Ragged per-sequence lengths, including an empty slot (zeros)
    and a full one."""
    b, s, h, d = 4, 40, 2, 16
    k, v = _inputs((b, s, h, d), seed=1, n=2)
    (q,) = _inputs((b, h, d), seed=2, n=1)
    lengths = np.array([0, 1, 23, 40], np.int32)
    ref = J.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(lengths), block_k=block_k,
                         **JAX_IMPLS[jax_impl])
    out = P.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), torch.from_numpy(lengths),
                         block_k=block_k)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    assert float(out[0].abs().max()) == 0.0


def test_flash_decode_clamps_lengths_to_the_slab():
    k, v = _inputs((2, 16, 1, 8), seed=3, n=2)
    (q,) = _inputs((2, 1, 8), seed=4, n=1)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    long = P.flash_decode(*args, torch.tensor([99, 16], dtype=torch.int32))
    full = P.flash_decode(*args, torch.tensor([16, 16], dtype=torch.int32))
    torch.testing.assert_close(long, full, rtol=0, atol=0)


@pytest.mark.parametrize("call,match", [
    (lambda x: P.flash_attention(x, x, x[:, :4]), "self-attention"),
    (lambda x: P.flash_attention(x, x, x, impl="lax"), "impl"),
    (lambda x: P.flash_attention(x, x, x, impl="cuda"), "CUDA"),
    (lambda x: P.flash_decode(x, x, x, torch.ones(2)), r"B, H, D"),
    (lambda x: P.flash_decode(x[:, 0], x, x[:, :4],
                              torch.ones(2)), "caches"),
    (lambda x: P.flash_decode(x[:, 0], x, x, torch.ones(2),
                              impl="pallas"), "impl"),
    (lambda x: P.flash_decode(x[:, 0], x, x, torch.ones(2),
                              impl="cuda"), "CUDA"),
    (lambda x: P.flash_fwd_cuda(x, x, x, True), "CUDA"),
    (lambda x: P.flash_decode_cuda(x[:, 0], x, x,
                                   torch.ones(2)), "CUDA"),
    (lambda x: P.flash_bwd_dkv_cuda(x, x, x, x, x, x, x, True), "CUDA"),
    (lambda x: P.flash_bwd_dq_cuda(x, x, x, x, x, x, x, True), "CUDA"),
])
def test_bad_input_raises(call, match):
    """Bad shapes and bad ``impl`` raise; asking for the kernel on a
    CPU tensor raises instead of running the plain path."""
    x = torch.zeros((2, 8, 2, 32))
    before = dict(P.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        call(x)
    assert P.LAUNCHES == before


GRAD_CASES = [(64, True, None, None), (37, True, 16, 8),
              (37, False, 8, 16), (50, False, 24, 8), (1, True, None, None)]


def _jax_grads(q, k, v, do, causal, bq, bk, **impl):
    import jax

    def f(q, k, v):
        return (J.flash_attention(q, k, v, causal=causal, block_q=bq,
                                  block_k=bk, **impl) * do).sum()

    return jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))


@pytest.mark.parametrize("jax_impl", sorted(JAX_IMPLS))
@pytest.mark.parametrize("t,causal,bq,bk", GRAD_CASES)
def test_flash_attention_grads_match_jax_f32(jax_impl, t, causal, bq, bk):
    """The port's autograd (``_FlashCore`` -> ``_plain_bwd``, with the
    pad rows sliced off by autograd) against ``jax.grad`` of the
    reference's custom_vjp."""
    q, k, v, do = _inputs((2, t, 2, 16), seed=100 + t, n=4)
    ref = _jax_grads(q, k, v, do, causal, bq, bk, **JAX_IMPLS[jax_impl])
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = P.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                            block_k=bk)
    (out * torch.from_numpy(do)).sum().backward()
    for ours, theirs in zip((tq, tk, tv), ref):
        assert ours.grad.shape == (2, t, 2, 16)
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(theirs),
                                   rtol=0, atol=2e-5)


def test_flash_attention_grads_match_jax_bf16():
    q, k, v, do = _inputs((2, 64, 2, 32), seed=9, n=4)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    import jax

    ref = jax.grad(lambda q, k, v: (J.flash_attention(
        q, k, v, causal=True, block_q=32, block_k=32, impl="lax")
        .astype(jnp.float32) * jdo.astype(jnp.float32)).sum(),
        argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
                  for x in (q, k, v))
    out = P.flash_attention(tq, tk, tv, causal=True, block_q=32,
                            block_k=32)
    tdo = torch.from_numpy(do).to(torch.bfloat16).float()
    (out.float() * tdo).sum().backward()
    for ours, theirs in zip((tq, tk, tv), ref):
        assert ours.grad.dtype == torch.bfloat16
        theirs = np.asarray(theirs, np.float32)
        err = np.abs(ours.grad.float().numpy() - theirs).max()
        assert err <= 2e-2 * np.abs(theirs).max()


def test_grads_reach_fused_qkv_through_views():
    """q, k, v as strided views of one [B,T,3,H,D] tensor (the
    transformer's fused projection): the gradient lands in the base
    and equals the gradient of contiguous copies."""
    (base,) = _inputs((2, 20, 3, 2, 8), seed=4, n=1)
    (do,) = _inputs((2, 20, 2, 8), seed=5, n=1)
    qkv = torch.from_numpy(base).requires_grad_()
    out = P.flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                            causal=True, block_q=8, block_k=8)
    (out * torch.from_numpy(do)).sum().backward()
    parts = [torch.from_numpy(base[:, :, i].copy()).requires_grad_()
             for i in range(3)]
    ref = P.flash_attention(*parts, causal=True, block_q=8, block_k=8)
    (ref * torch.from_numpy(do)).sum().backward()
    for i in range(3):
        torch.testing.assert_close(qkv.grad[:, :, i], parts[i].grad,
                                   rtol=0, atol=0)


def test_inference_mode_saves_nothing():
    """Under ``torch.inference_mode()`` (serving) the forward builds no
    graph: the output has no grad_fn even for inputs that require
    grad."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs((1, 16, 1, 8), seed=6))
    with torch.inference_mode():
        out = P.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None
    assert P.flash_attention(q, k, v, causal=True).grad_fn is not None
