"""The port's uniform fill (``veles_tpu_torch.ops.rng``, the K8 kernel's
plain version) on the CPU: its Philox-4x32-10 against an independent
numpy Philox and Random123's published test vectors (equal bits),
determinism per (seed, shape), range, scaling and dtype, odd sizes,
and the statistics ``tests/test_ops.py`` checks of the JAX package's
fill, made stronger.

The fill is not compared with the JAX package's values: the reference
draws from the TPU's hardware PRNG or ``jax.random``, and says itself
that its backends' streams differ. Statistical bounds: the mean of
2^20 uniforms has standard deviation 2.8e-4 and the variance 7.2e-5
(relative), so 5e-3 and 1% are beyond any seed's reach; the
correlation of two independent blocks of 2^18 draws has standard
deviation 2e-3, bounded at 1e-2.
"""

import numpy as np
import pytest
import torch

from veles_tpu_torch.ops import rng

# one intra-op thread: these tests share the CPU with the suite's
# parallel workers, where a thread pool per worker oversubscribes it
torch.set_num_threads(1)

M = (np.uint64(0xD2511F53), np.uint64(0xCD9E8D57))
W = (np.uint64(0x9E3779B9), np.uint64(0xBB67AE85))
U32 = np.uint64(0xFFFFFFFF)


def _np_philox(ctr, key):
    """Philox-4x32-10 in numpy uint64 (a 32 x 32 bit product fits),
    written from the Random123 paper's round: independent of the
    port's int64 limb arithmetic."""
    c = [np.asarray(w, np.uint64) for w in ctr]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    for r in range(10):
        if r:
            k0 = (k0 + W[0]) & U32
            k1 = (k1 + W[1]) & U32
        p0 = c[0] * M[0]
        p1 = c[2] * M[1]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & U32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & U32]
    return c


@pytest.mark.parametrize("ctr,key,expect", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))])
def test_philox_known_answers(ctr, key, expect):
    """Random123's known-answer vectors for philox4x32-10."""
    assert rng.philox4x32(ctr, key) == expect
    assert tuple(int(w) for w in _np_philox(ctr, key)) == expect


@pytest.mark.parametrize("seed", [0, 7, 2 ** 40 + 3, -1])
def test_plain_bits_equal_numpy_philox(seed):
    key = rng._key(seed)
    n_blocks = 1000
    bits = rng._plain_bits(n_blocks, key, "cpu").numpy()
    idx = np.arange(n_blocks, dtype=np.uint64)
    ref = _np_philox((idx & U32, idx >> np.uint64(32), idx * 0, idx * 0),
                     key)
    np.testing.assert_array_equal(bits, np.stack(ref, 1).astype(np.int64))
    # high counter word: block indices past 2^32
    big = np.uint64(2 ** 32 + 5)
    assert rng.philox4x32((big & U32, big >> np.uint64(32), 0, 0), key) \
        == tuple(int(w) for w in _np_philox(
            (big & U32, big >> np.uint64(32), 0, 0), key))


def test_fill_converts_bits_as_the_tpu_kernel():
    seed, n = 11, 37
    out = rng.uniform_fill(seed, (n,), device="cpu").numpy()
    words = rng._plain_bits(10, rng._key(seed), "cpu").numpy().reshape(-1)
    mant = ((words[:n] >> 9) | 0x3F800000).astype(np.uint32)
    np.testing.assert_array_equal(out, mant.view(np.float32) - 1.0)


def test_fill_range_and_determinism():
    out = rng.uniform_fill(7, (64, 128), device="cpu")
    assert out.shape == (64, 128) and out.dtype == torch.float32
    assert float(out.min()) >= 0.0 and float(out.max()) < 1.0
    assert torch.equal(out, rng.uniform_fill(7, (64, 128), device="cpu"))
    assert not torch.equal(out, rng.uniform_fill(8, (64, 128),
                                                 device="cpu"))
    # the values depend on the element count, not on the shape
    assert torch.equal(out.reshape(-1),
                       rng.uniform_fill(7, (8192,), device="cpu"))


@pytest.mark.parametrize("shape", [(7, 3), (1,), (), (5, 0), (3, 5, 7)])
def test_fill_odd_sizes(shape):
    out = rng.uniform_fill(2, shape, device="cpu")
    assert tuple(out.shape) == shape
    n = int(np.prod(shape)) if shape else 1
    flat = rng.uniform_fill(2, (n + 9,), device="cpu")
    # a prefix of a longer fill: element i is the same draw at any count
    assert torch.equal(out.reshape(-1), flat[:n])


def test_fill_scaling_and_dtype():
    out = rng.uniform_fill(1, (32, 16), low=-2.0, high=2.0, device="cpu")
    assert float(out.min()) >= -2.0 and float(out.max()) < 2.0
    base = rng.uniform_fill(1, (32, 16), device="cpu")
    assert torch.equal(out, base * 4.0 + -2.0)
    half = rng.uniform_fill(1, (32, 16), dtype=torch.bfloat16,
                            device="cpu")
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, base.to(torch.bfloat16))


def test_fill_statistics():
    """Mean 1/2 and variance 1/12 over 2^20 draws, no correlation
    between adjacent blocks of the stream, and every bit of the
    mantissa used."""
    out = rng.uniform_fill(3, (2 ** 20,), device="cpu").double()
    assert abs(float(out.mean()) - 0.5) < 5e-3
    assert abs(float(out.var()) * 12 - 1.0) < 1e-2
    a, b = out[: 2 ** 18], out[2 ** 18: 2 ** 19]
    assert abs(float(np.corrcoef(a.numpy(), b.numpy())[0, 1])) < 1e-2
    # neighbouring elements (words of one Philox block and of the next)
    assert abs(float(np.corrcoef(out[:-1].numpy(),
                                 out[1:].numpy())[0, 1])) < 1e-2
    hist = np.histogram(out.numpy(), bins=16, range=(0.0, 1.0))[0]
    assert hist.min() > 0.97 * 2 ** 16 and hist.max() < 1.03 * 2 ** 16
    words = (out.float().numpy() + 1.0).view(np.uint32) & 0x7FFFFF
    assert np.bitwise_or.reduce(words) == 0x7FFFFF


def test_fold_in_separates_streams():
    seeds = {rng.fold_in(rng.fold_in(0, step), layer)
             for step in range(1, 50) for layer in (11, 13)}
    assert len(seeds) == 98
    assert rng.fold_in(5, 3) == rng.fold_in(5, 3) != rng.fold_in(6, 3)


def test_fill_device_and_impl_policy(monkeypatch):
    with pytest.raises(ValueError, match="impl"):
        rng.uniform_fill(0, (4,), device="cpu", impl="tpu")
    with pytest.raises(ValueError, match="CUDA"):
        rng.uniform_fill(0, (4,), device="cpu", impl="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rng.uniform_fill(0, (4,))
    before = dict(rng.LAUNCHES)
    rng.uniform_fill(0, (4,), device="cpu")
    assert rng.LAUNCHES == before
