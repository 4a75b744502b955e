"""Reproducible, stream-keyed pseudo-random number generation.

Port of ``veles_tpu/prng/__init__.py``: a registry of named
``RandomGenerator`` streams (:func:`get`, :func:`seed_all`,
:func:`reset`), each with a save/restore-able state for snapshots and
for replaying initialize-time draws (``Unit._initialize_reproducibly``).

Host draws (``shuffle``, ``permutation``, ``randint``,
``random_sample``, ``choice``, ``fill_normal_host``) come from the
reference's own generator, ``np.random.default_rng([seed & 0xFFFFFFFF,
crc32(name)])``, so they give the reference's exact values for the
same seed and stream name.

Device fills go through the port's K8 (``ops.rng.uniform_fill``, the
Philox-4x32-10 kernel on a CUDA tensor, its plain PyTorch version on a
CPU tensor, bitwise equal): a stream's key is ``fold_in(seed,
crc32(name))`` and every fill advances a counter and draws under
``fold_in(key, counter)``; ``uniform`` is one fill, ``bernoulli`` is
``fill < p``, ``normal`` is Box-Muller over two fills. These draws are
not the reference's threefry draws, and need not be (as for the
dropout masks, ``ops/rng.py``). ``device=None`` is the current CUDA
device and raises without one.

A stream's ``state`` keeps the reference's layout, ``(seed, counter,
key, numpy generator state)``, with the port's key (the two 32-bit
words of the Philox seed, low first) in the key slot;
:func:`from_reference_state` turns a reference stream's state into the
port's, after which the host draws continue identically.
"""

from __future__ import annotations

import math
import threading
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from veles_tpu_torch.config import root
from veles_tpu_torch.device import resolve
from veles_tpu_torch.ops.rng import fold_in, uniform_fill

_MASK32 = 0xFFFFFFFF


def _name_salt(name: str) -> int:
    # crc32, NOT hash(): Python string hashing is randomized per
    # process, which would decorrelate identically seeded streams
    # across hosts and runs
    return zlib.crc32(name.encode()) if name else 0


def _key_words(seed64: int) -> np.ndarray:
    return np.asarray([seed64 & _MASK32, seed64 >> 32], np.uint32)


def _precision() -> torch.dtype:
    return getattr(torch, str(root.common.engine.precision_type))


class RandomGenerator:
    """A named, seedable, picklable RNG stream.

    ``split()`` advances the stream and returns a fresh 64-bit Philox
    seed for one device fill; the fills below call it.
    """

    def __init__(self, name: str = "default",
                 seed: Optional[int] = None) -> None:
        self.name = name
        self.seed(seed)

    # -- state -------------------------------------------------------------
    def seed(self, seed: Optional[int] = None) -> None:
        if seed is None:
            seed = int(root.common.random.seed)
        self._seed = seed
        self._counter = 0
        salt = _name_salt(self.name)
        self._key = _key_words(fold_in(seed, salt))
        self._np_rng = np.random.default_rng([seed & _MASK32, salt])
        # baseline for replaying initialize-time consumption even when
        # the stream was created mid-initialize
        self._state_at_seed = self.state

    @property
    def state(self):
        """Picklable stream state ``(seed, counter, key, numpy
        generator state)``."""
        return (self._seed, self._counter, self._key.copy(),
                self._np_rng.bit_generator.state)

    @state.setter
    def state(self, value) -> None:
        self._seed, self._counter, key, np_state = value
        self._key = np.asarray(key, np.uint32).copy()
        self._np_rng = np.random.default_rng()
        self._np_rng.bit_generator.state = np_state

    @property
    def state_at_seed(self):
        """Stream state right after the last seed()."""
        return self._state_at_seed

    def __getstate__(self):
        return {"name": self.name, "state": self.state,
                "state_at_seed": self._state_at_seed}

    def __setstate__(self, d):
        self.name = d["name"]
        self.state = d["state"]
        self._state_at_seed = d.get("state_at_seed", d["state"])

    # -- key discipline ----------------------------------------------------
    @property
    def key(self) -> int:
        """The stream's 64-bit Philox seed (does not advance it)."""
        return int(self._key[0]) | (int(self._key[1]) << 32)

    def split(self) -> int:
        """Advance the stream; return a fresh seed for one fill."""
        self._counter += 1
        return fold_in(self.key, self._counter)

    # -- device fills through K8 ---------------------------------------------
    def uniform(self, shape, dtype: Optional[torch.dtype] = None,
                low: float = 0.0, high: float = 1.0,
                device=None) -> torch.Tensor:
        """Uniform [low, high) tensor: one K8 fill."""
        return uniform_fill(self.split(), shape, dtype or _precision(),
                            low, high, device=resolve(device))

    def bernoulli(self, shape, p: float = 0.5,
                  device=None) -> torch.Tensor:
        """Bool tensor, True with probability ``p``: ``fill < p``."""
        return uniform_fill(self.split(), shape,
                            device=resolve(device)) < p

    def normal(self, shape, dtype: Optional[torch.dtype] = None,
               stddev: float = 1.0, device=None) -> torch.Tensor:
        """Standard normal draws times ``stddev``: Box-Muller over two
        K8 fills keyed by one split."""
        device = resolve(device)
        sub = self.split()
        u1 = uniform_fill(fold_in(sub, 0), shape, device=device)
        u2 = uniform_fill(fold_in(sub, 1), shape, device=device)
        # 1 - u1 lies in (0, 1]: the log never sees 0
        radius = torch.sqrt(-2.0 * torch.log1p(-u1))
        z = radius * torch.cos((2.0 * math.pi) * u2)
        return (z * stddev).to(dtype or _precision())

    # -- host-side helpers (the reference's own generator) ------------------
    def shuffle(self, arr: np.ndarray) -> None:
        """In-place host-side shuffle (loader index permutations)."""
        self._np_rng.shuffle(arr)

    def permutation(self, n: int) -> np.ndarray:
        return self._np_rng.permutation(n)

    def randint(self, low: int, high: Optional[int] = None,
                size: Any = None):
        return self._np_rng.integers(low, high, size)

    def random_sample(self, size: Any = None):
        return self._np_rng.random(size)

    def choice(self, seq, size: Any = None, replace: bool = True):
        return self._np_rng.choice(seq, size, replace=replace)

    def fill_normal_host(self, arr: np.ndarray, stddev: float = 1.0) -> None:
        arr[...] = self._np_rng.normal(0.0, stddev, arr.shape)

    def __repr__(self) -> str:
        return "<RandomGenerator %r seed=%s counter=%d>" % (
            self.name, self._seed, self._counter)


def from_reference_state(state, name: str = "default"):
    """A reference stream's state (``veles_tpu.prng.RandomGenerator``
    ``.state``: ``(seed, counter, threefry key data, numpy state)`` as
    numpy, or its pickled dict ``{"name", "state", ...}``) as the
    port's state for the stream ``name``: the seed, counter and numpy
    generator state carry over, so the host draws continue
    identically; the key slot takes the port's Philox key of that seed
    and name."""
    if isinstance(state, dict):
        name, state = state["name"], state["state"]
    seed, counter, _, np_state = state
    seed = int(seed)
    return (seed, int(counter),
            _key_words(fold_in(seed, _name_salt(name))), np_state)


_streams: Dict[str, RandomGenerator] = {}
_streams_lock = threading.Lock()


def get(name: str = "default") -> RandomGenerator:
    """Fetch (creating on first use) the named stream."""
    with _streams_lock:
        rng = _streams.get(name)
        if rng is None:
            rng = _streams[name] = RandomGenerator(name)
        return rng


def seed_all(seed: int) -> None:
    """Re-seed every existing stream and future streams."""
    root.common.random.seed = seed
    with _streams_lock:
        for rng in _streams.values():
            rng.seed(seed)


def reset() -> None:
    """Drop all streams (test isolation)."""
    with _streams_lock:
        _streams.clear()
