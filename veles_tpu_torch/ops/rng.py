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

The seed reaches the kernel by value (``veles_uniform_fill``) or, as
the TPU kernel reads its seed operand from memory, from an int64
tensor on the card (``veles_uniform_fill_keyed``, with the layer's
fold made there): a CUDA graph that captures the fill then reads the
key the host wrote before each replay.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from veles_tpu_torch.device import resolve
from veles_tpu_torch.ops import _build, launches

#: Philox-4x32 multipliers and Weyl key increments (Random123).
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_ROUNDS = 10

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF

#: Kernel launches since the last :func:`reset_launches`: every K8
#: launch, by either entry, under ``uniform_fill``; the keyed entry's
#: alone under ``uniform_fill_keyed`` too.
LAUNCHES: Dict[str, int] = {"uniform_fill": 0, "uniform_fill_keyed": 0}


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


def _philox_words(c0, c1, c2, c3, k0, k1):
    """Philox-4x32-10 on int64 tensors (or host integers) holding
    32-bit words: the counter's four words under the key's two."""
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _MASK32
            k1 = (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _plain_bits(n_blocks: int, key, device) -> torch.Tensor:
    """Philox-4x32-10 over counters (i, 0, 0, 0) with the block index
    i split in two words, i < n_blocks: int64 [n_blocks, 4] holding
    32-bit words. ``key``: two words, host integers or 0-d int64
    tensors on ``device``."""
    idx = torch.arange(n_blocks, dtype=torch.int64, device=device)
    zeros = torch.zeros_like(idx)
    return torch.stack(_philox_words(idx & _MASK32, idx >> 32, zeros,
                                     zeros, *key), dim=1)


def _tensor_key(key: torch.Tensor, fold: Optional[int]):
    """The two key words of the 64-bit key an int64 tensor holds, with
    ``fold`` folded in (:func:`fold_in`), as 0-d int64 tensors on its
    device: read there, with no host sync."""
    key = key.reshape(())
    k0, k1 = key & _MASK32, (key >> 32) & _MASK32
    if fold is None:
        return k0, k1
    fold = int(fold) & _MASK64
    w = _philox_words(fold & _MASK32, fold >> 32, 0, 0, k0, k1)
    return w[0], w[1]


def _plain_fill(n: int, key, device, scale: float, low: float,
                affine: bool) -> torch.Tensor:
    bits = _plain_bits(-(-n // 4), key, device).reshape(-1)[:n]
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    out = mant.view(torch.float32) - 1.0
    if affine:
        out = out * scale + low
    return out


def key_tensor(seed: int, device) -> torch.Tensor:
    """A 0-d int64 tensor on ``device`` holding the 64-bit ``seed``
    (as its two's complement), the form :func:`uniform_fill` reads a
    key from device memory in; :func:`write_key` rewrites it."""
    return write_key(torch.zeros((), dtype=torch.int64, device=device),
                     seed)


def write_key(key: torch.Tensor, seed: int) -> torch.Tensor:
    """Write the 64-bit ``seed`` into the int64 tensor ``key`` in place
    (a fill on its device: no host-to-device copy, nothing to wait
    for); returns ``key``."""
    seed = int(seed) & _MASK64
    return key.fill_(seed - (1 << 64) if seed >> 63 else seed)


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
        lib.veles_uniform_fill_keyed.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p]
        lib.veles_uniform_fill_keyed.restype = ctypes.c_int
    return lib


def _launch(n: int, device, entry: str, counted: Tuple[str, ...],
            *args) -> torch.Tensor:
    """One launch of C entry ``entry`` filling a new [n] f32 tensor:
    ``entry(out, n, *args, stream)``, counted under ``counted``."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    if n == 0:
        return out
    if out.data_ptr() % 16:
        raise ValueError("uniform_fill kernel needs a 16-byte aligned "
                         "output")
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(out.data_ptr(), n, *args, stream)
    _build.check(lib, counted[-1], rc)
    for name in counted:
        launches.count(LAUNCHES, name)
    return out


def uniform_fill_cuda(n: int, key: Tuple[int, int], device,
                      scale: float = 1.0, low: float = 0.0,
                      affine: bool = False) -> torch.Tensor:
    """K8: ``n`` uniform f32 values on a CUDA device, the Philox stream
    of ``key`` (two 32-bit words); with ``affine``, ``u * scale +
    low``. Returns a contiguous [n] tensor."""
    return _launch(n, device, "veles_uniform_fill", ("uniform_fill",),
                   key[0], key[1], scale, low, int(affine))


def uniform_fill_keyed_cuda(n: int, key: torch.Tensor,
                            fold: Optional[int], scale: float = 1.0,
                            low: float = 0.0,
                            affine: bool = False) -> torch.Tensor:
    """K8's keyed entry: as :func:`uniform_fill_cuda` under the 64-bit
    key the int64 CUDA tensor ``key`` holds, read by the kernel from
    device memory, with ``fold`` (an integer, or None) folded in there
    first: bitwise the by-value entry under ``fold_in(key, fold)``."""
    if key.dtype != torch.int64 or key.numel() != 1:
        raise ValueError("a key tensor holds one int64, got %s %s"
                         % (key.dtype, tuple(key.shape)))
    return _launch(n, key.device, "veles_uniform_fill_keyed",
                   ("uniform_fill", "uniform_fill_keyed"), key.data_ptr(),
                   0 if fold is None else int(fold) & _MASK64,
                   int(fold is not None), scale, low, int(affine))


def uniform_fill(seed, shape, dtype: Optional[torch.dtype] = None,
                 low: float = 0.0, high: float = 1.0, device=None,
                 impl: Optional[str] = None,
                 fold: Optional[int] = None) -> torch.Tensor:
    """Uniform [low, high) tensor of ``shape``, deterministic per
    (seed, element count) on every device.

    ``seed``: an integer, or an int64 tensor holding the 64-bit key
    (:func:`key_tensor`) on the fill's device, which the fill reads
    there (the K8 kernel from device memory, the plain version in
    tensor arithmetic): a CUDA graph that captures the fill reads the
    key the host last wrote. ``fold``: an integer folded into the key
    first, as :func:`fold_in` does (on the host for an integer seed, on
    the device for a tensor); the bits equal those of the integer seed
    ``fold_in(seed, fold)``.

    ``device=None`` is the key tensor's device, or for an integer seed
    the current CUDA device (raises without one). ``impl``: "cuda" (the
    K8 kernel), "plain", or None = "cuda" on a CUDA device, else
    "plain". Drawn in f32, then cast to ``dtype`` (default float32).
    Any element count works: the reference's ``jax.random`` fallback
    for counts that are not a multiple of 128 has no counterpart here.
    """
    keyed = torch.is_tensor(seed)
    if keyed:
        device = seed.device if device is None else torch.device(device)
        if device.type != seed.device.type or \
                device.index not in (None, seed.device.index):
            raise ValueError("the key tensor lies on %s, the fill on %s"
                             % (seed.device, device))
        device = seed.device
    else:
        device = resolve(device)
        if fold is not None:
            seed, fold = fold_in(seed, fold), None
    shape = tuple(int(d) for d in shape)
    n = int(np.prod(shape)) if shape else 1
    impl = _build.resolve_impl(impl, device, "uniform_fill")
    affine = low != 0.0 or high != 1.0
    if impl == "cuda":
        out = uniform_fill_keyed_cuda(n, seed, fold, high - low, low,
                                      affine) if keyed else \
            uniform_fill_cuda(n, _key(seed), device, high - low, low, affine)
    else:
        key = _tensor_key(seed, fold) if keyed else _key(seed)
        out = _plain_fill(n, key, device, high - low, low, affine)
    return out.reshape(shape).to(dtype or torch.float32)
