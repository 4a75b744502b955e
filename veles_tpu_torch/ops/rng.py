"""Device-side uniform fill: Philox-4x32-10, the counter-based generator
of cuRAND and Random123, written into the K8 kernel
(``csrc/rng.cu``) and, op for op, in plain PyTorch integer arithmetic.

Port of ``veles_tpu/ops/rng.py`` (``uniform_fill``). The TPU kernel
draws from the core's hardware PRNG, seeded per grid row; the port
keys Philox by the seed and counts by the element's index, so the bits
depend on the seed and the element count only, never on the grid or
the device. The kernel and its plain version agree bitwise; neither
gives the TPU's bits, and need not (the reference says as much of its
own backends).

Bits become floats as the TPU kernel converts them: 23 random mantissa
bits under exponent 127 give [1, 2), minus 1 gives [0, 1).
:func:`fold_in` derives a new seed from a seed and an integer, as
``jax.random.fold_in`` derives keys: the fused trainer keys its dropout
masks by ``fold_in(fold_in(seed, step), layer)``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from veles_tpu_torch.device import resolve
from veles_tpu_torch.ops import _build

#: Philox-4x32 multipliers and Weyl key increments (Random123).
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_ROUNDS = 10

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF

#: Kernel launches since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"uniform_fill": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _key(seed: int) -> Tuple[int, int]:
    seed = int(seed) & _MASK64
    return seed & _MASK32, seed >> 32


def philox4x32(counter: Sequence[int], key: Sequence[int]
               ) -> Tuple[int, int, int, int]:
    """One Philox-4x32-10 block on host integers: four 32-bit words
    from a four-word counter and a two-word key."""
    c0, c1, c2, c3 = (int(c) & _MASK32 for c in counter)
    k0, k1 = (int(k) & _MASK32 for k in key)
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        p0 = PHILOX_M[0] * c0
        p1 = PHILOX_M[1] * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & _MASK32,
                          (p0 >> 32) ^ c3 ^ k1, p0 & _MASK32)
    return c0, c1, c2, c3


def fold_in(seed: int, data: int) -> int:
    """A new 64-bit seed from ``seed`` and the integer ``data``: the
    first two words of the Philox block at counter ``data`` under the
    seed's key."""
    data = int(data) & _MASK64
    w = philox4x32((data & _MASK32, data >> 32, 0, 0), _key(seed))
    return w[0] | (w[1] << 32)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) words of the 64-bit product of the 32-bit values in the
    int64 tensor ``a`` and the constant ``m``. ``a * m`` itself can pass
    2^63, so ``m`` is split into 16-bit limbs: each partial product
    stays below 2^48."""
    big = a * (m >> 16)
    low = ((big & 0xFFFF) << 16) + a * (m & 0xFFFF)
    return (big >> 16) + (low >> 32), low & _MASK32


def _plain_bits(n_blocks: int, key: Tuple[int, int], device
                ) -> torch.Tensor:
    """Philox-4x32-10 over counters (i, 0, 0, 0) with the block index
    i split in two words, i < n_blocks: int64 [n_blocks, 4] holding
    32-bit words."""
    idx = torch.arange(n_blocks, dtype=torch.int64, device=device)
    c0, c1 = idx & _MASK32, idx >> 32
    c2 = torch.zeros_like(idx)
    c3 = torch.zeros_like(idx)
    k0, k1 = key
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack((c0, c1, c2, c3), dim=1)


def _plain_fill(n: int, key, device, scale: float, low: float,
                affine: bool) -> torch.Tensor:
    bits = _plain_bits(-(-n // 4), key, device).reshape(-1)[:n]
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    out = mant.view(torch.float32) - 1.0
    if affine:
        out = out * scale + low
    return out


# ---------------------------------------------------------------------------
# the K8 kernel
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    lib = _build.library("rng")
    if lib.veles_uniform_fill.argtypes is None:
        lib.veles_uniform_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
        lib.veles_uniform_fill.restype = ctypes.c_int
    return lib


def uniform_fill_cuda(n: int, key: Tuple[int, int], device,
                      scale: float = 1.0, low: float = 0.0,
                      affine: bool = False) -> torch.Tensor:
    """K8: ``n`` uniform f32 values on a CUDA device, the Philox stream
    of ``key`` (two 32-bit words); with ``affine``, ``u * scale +
    low``. Returns a contiguous [n] tensor."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    if n == 0:
        return out
    if out.data_ptr() % 16:
        raise ValueError("uniform_fill kernel needs a 16-byte aligned "
                         "output")
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.veles_uniform_fill(out.data_ptr(), n, key[0], key[1],
                                    scale, low, int(affine), stream)
    _build.check(lib, "uniform_fill", rc)
    LAUNCHES["uniform_fill"] += 1
    return out


def uniform_fill(seed: int, shape, dtype: Optional[torch.dtype] = None,
                 low: float = 0.0, high: float = 1.0, device=None,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Uniform [low, high) tensor of ``shape``, deterministic per
    (seed, element count) on every device.

    ``device=None`` is the current CUDA device (raises without one).
    ``impl``: "cuda" (the K8 kernel), "plain", or None = "cuda" on a
    CUDA device, else "plain". Drawn in f32, then cast to ``dtype``
    (default float32). Any element count works: the reference's
    ``jax.random`` fallback for counts that are not a multiple of 128
    has no counterpart here.
    """
    device = resolve(device)
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape)) if shape else 1
    impl = _build.resolve_impl(impl, device, "uniform_fill")
    affine = low != 0.0 or high != 1.0
    args = (n, _key(seed), device, high - low, low, affine)
    out = uniform_fill_cuda(*args) if impl == "cuda" else _plain_fill(*args)
    return out.reshape(shape).to(dtype or torch.float32)
