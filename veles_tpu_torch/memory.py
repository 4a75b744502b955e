"""Array: a host/device buffer pair with an explicit coherence protocol.

Port of ``veles_tpu/memory.py``: ``Array`` pairs a numpy array with a
device buffer and a map/unmap protocol (``map_read`` / ``map_write`` /
``map_invalidate`` / ``unmap``) tracking which side is dirty, plus a
global ``Watcher`` accounting the device memory in use. Pickling maps
the buffer back to the host first.

The device side is a torch tensor on the unit's device (the CUDA card,
or the CPU when the unit was bound to ``Device(backend="cpu")``).
Transfers are explicit copies, never shared views, so a host write
reaches the device only through ``unmap`` even on the CPU. Units read
``.devmem`` and assign fresh result tensors back to it, which marks the
host copy stale until the next ``map_read``. An Array with no device
bound puts its buffer on the current CUDA device (raising without one).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch.device import resolve


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The host dtype of a tensor dtype (bf16 maps to f32: numpy has
    no bf16)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=dtype).numpy().dtype


def torch_dtype(dtype) -> torch.dtype:
    """A numpy dtype as the torch dtype of the same name (a unit's
    ``device.precision_dtype`` for its results)."""
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def _nbytes(tensor: torch.Tensor) -> int:
    return tensor.numel() * tensor.element_size()


class Watcher:
    """Global device-memory accounting.

    A garbage collection can run ``Array.__del__`` on any thread at any
    allocation, also while that thread holds ``_lock`` inside ``add`` or
    ``sub``: the finalizer's :meth:`sub_finalized` therefore never
    blocks; bytes it cannot settle at once are settled by the next
    ``add`` or ``sub``."""

    _lock = threading.Lock()
    _unsettled: Deque[int] = deque()
    mem_in_use = 0
    max_mem_in_use = 0

    @classmethod
    def _settle(cls) -> None:
        """Fold in the finalizers' deferred bytes (``_lock`` held)."""
        while cls._unsettled:
            cls.mem_in_use -= cls._unsettled.popleft()

    @classmethod
    def add(cls, nbytes: int) -> None:
        with cls._lock:
            cls._settle()
            cls.mem_in_use += nbytes
            cls.max_mem_in_use = max(cls.max_mem_in_use, cls.mem_in_use)

    @classmethod
    def sub(cls, nbytes: int) -> None:
        with cls._lock:
            cls._settle()
            cls.mem_in_use -= nbytes

    @classmethod
    def sub_finalized(cls, nbytes: int) -> None:
        """``sub`` for a finalizer: settles now if ``_lock`` is free,
        else defers (the lock may be held by this very thread)."""
        if cls._lock.acquire(blocking=False):
            try:
                cls._settle()
                cls.mem_in_use -= nbytes
            finally:
                cls._lock.release()
        else:
            cls._unsettled.append(nbytes)

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._unsettled.clear()
            cls.mem_in_use = 0
            cls.max_mem_in_use = 0


class Array:
    """Host numpy array + device tensor with dirty-flag coherence.

    States: host-dirty (host writes not yet on the device),
    device-dirty (device results not yet on the host), or coherent.
    All transfers are explicit; nothing happens behind the unit's back.
    """

    def __init__(self, data: Any = None, shape: Optional[Tuple] = None,
                 dtype: Any = np.float32) -> None:
        if data is not None:
            self.mem: Optional[np.ndarray] = np.ascontiguousarray(data)
        elif shape is not None:
            self.mem = np.zeros(shape, dtype=dtype)
        else:
            self.mem = None
        self._reset_device_state()

    def _reset_device_state(self) -> None:
        self.device_ = None
        self.devmem_ = None
        self._host_dirty_ = self.mem is not None
        self._device_dirty_ = False
        self._accounted_ = 0

    def __del__(self):
        # keep Watcher accounting honest for garbage-collected Arrays
        try:
            if getattr(self, "_accounted_", 0):
                Watcher.sub_finalized(self._accounted_)
                self._accounted_ = 0
        except Exception:
            pass

    # -- basic protocol ----------------------------------------------------
    def reset(self, data: Any = None) -> "Array":
        """Re-point the host buffer; the device copy becomes stale."""
        self._release_devmem()
        self.mem = None if data is None else np.ascontiguousarray(data)
        self._host_dirty_ = self.mem is not None
        self._device_dirty_ = False
        return self

    @property
    def shape(self):
        if self.mem is not None:
            return self.mem.shape
        return tuple(self.devmem_.shape) if self.devmem_ is not None \
            else ()

    @property
    def dtype(self):
        if self.mem is not None:
            return self.mem.dtype
        return _numpy_dtype(self.devmem_.dtype) \
            if self.devmem_ is not None else None

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 0

    @property
    def nbytes(self) -> int:
        m = self.mem
        return m.nbytes if m is not None else (
            _nbytes(self.devmem_) if self.devmem_ is not None else 0)

    def __bool__(self) -> bool:
        return self.mem is not None or self.devmem_ is not None

    def __len__(self) -> int:
        s = self.shape
        return s[0] if s else 0

    def __getitem__(self, idx):
        return self.map_read()[idx]

    def __setitem__(self, idx, value):
        self.map_write()[idx] = value

    # -- device residency --------------------------------------------------
    def initialize(self, device) -> "Array":
        """Bind to a Device and push the host copy."""
        self.device_ = device
        if self.mem is not None:
            self.unmap()
        return self

    def _target(self) -> torch.device:
        return self.device_.torch_device if self.device_ is not None \
            else resolve(None)

    def _release_devmem(self) -> None:
        if self._accounted_:
            Watcher.sub(self._accounted_)
            self._accounted_ = 0
        self.devmem_ = None

    @property
    def devmem(self) -> torch.Tensor:
        """The device tensor; pushes host changes first."""
        if self._host_dirty_ or self.devmem_ is None:
            self.unmap()
        return self.devmem_

    @devmem.setter
    def devmem(self, value: Optional[torch.Tensor]) -> None:
        """Accept a fresh device result; the host copy is stale until
        map_read."""
        self._release_devmem()
        self.devmem_ = value
        if value is not None:
            self._accounted_ = _nbytes(value)
            Watcher.add(self._accounted_)
        self._device_dirty_ = value is not None
        self._host_dirty_ = False

    # -- map/unmap coherence -----------------------------------------------
    def map_read(self) -> np.ndarray:
        """Host view for reading; pulls device results if stale (a copy,
        also on the CPU: the host and device buffers never alias)."""
        if self._device_dirty_:
            t = self.devmem_.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            self.mem = t.cpu().numpy() if t.is_cuda \
                else t.numpy().copy()
            self._device_dirty_ = False
        return self.mem

    def map_write(self) -> np.ndarray:
        """Host view for read-modify-write; the next devmem access
        pushes."""
        m = self.map_read()
        self._host_dirty_ = True
        return m

    def map_invalidate(self) -> np.ndarray:
        """Host view for overwriting (the device copy is NOT pulled)."""
        self._device_dirty_ = False
        self._host_dirty_ = True
        return self.mem

    def unmap(self) -> None:
        """Push host changes to the device."""
        if self.mem is None:
            return
        if self._host_dirty_ or self.devmem_ is None:
            dev = torch.tensor(self.mem, device=self._target())
            self._release_devmem()
            self.devmem_ = dev
            self._accounted_ = _nbytes(dev)
            Watcher.add(self._accounted_)
            self._host_dirty_ = False
            self._device_dirty_ = False

    # -- pickling: map read first -----------------------------------------
    def __getstate__(self) -> Dict[str, Any]:
        if self._device_dirty_:
            self.map_read()
        return {"mem": self.mem}

    def __setstate__(self, state) -> None:
        self.mem = state["mem"]
        self._reset_device_state()

    def __repr__(self) -> str:
        where = []
        if self.mem is not None:
            where.append("host" + ("*" if self._host_dirty_ else ""))
        if self.devmem_ is not None:
            where.append("dev" + ("*" if self._device_dirty_ else ""))
        return "<Array %s %s [%s]>" % (
            self.shape, self.dtype, ",".join(where) or "empty")
