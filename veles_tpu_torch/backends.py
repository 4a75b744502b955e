"""Device backends: the CUDA card and the CPU, over PyTorch.

Port of ``veles_tpu/backends.py``: a registry of ``Device`` classes by
backend name with priorities, the ``Device()`` factory, the dtype
policy, explicit transfers (``put``, ``get``, ``sync``) and a
"computing power" probe that the job farm uses to balance workers.

``CudaDevice`` takes the place of the reference's ``TpuDevice``.
``Device()`` (backend ``"auto"``, the default of
``root.common.engine.backend``) is the CUDA card that
:func:`veles_tpu_torch.device.resolve` picks for every entry point,
and raises as it does without one: the CPU runs only when the caller
asks for it with ``Device(backend="cpu")``, as the tests do. There is
no silent fallback. :meth:`Device.benchmark` is a bf16 ``torch.matmul`` probe (a
plain product, so a library call is the right tool).
:meth:`Device.mesh` names the ranks of a joined process group as a grid
(``parallel.mesh``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from veles_tpu_torch.config import root
from veles_tpu_torch.device import compute_dtype as _compute_dtype
from veles_tpu_torch.device import resolve
from veles_tpu_torch.logger import Logger


class BackendRegistry(type):
    """The backend's name (``root.common.engine.backend``) -> Device
    class."""

    backends: Dict[str, type] = {}

    def __init__(cls, name, bases, namespace):
        super().__init__(name, bases, namespace)
        backend = namespace.get("BACKEND")
        if backend:
            BackendRegistry.backends[backend] = cls


class Device(Logger, metaclass=BackendRegistry):
    """A compute device: torch device handles + dtype policy + probes.

    ``Device()`` or ``Device(backend="auto")`` is the CUDA card (raises
    without one); ``Device(backend="cpu")`` the CPU.
    """

    BACKEND: Optional[str] = None

    def __new__(cls, backend: Optional[str] = None, **kwargs):
        if cls is not Device:
            return super().__new__(cls)
        name = backend or str(root.common.engine.backend or "auto")
        bcls = BackendRegistry.backends.get(name)
        if bcls is None:
            raise ValueError(
                "Unknown backend %r (known: %s)" %
                (name, sorted(BackendRegistry.backends)))
        return super().__new__(bcls)

    def __init__(self, backend: Optional[str] = None, **kwargs) -> None:
        super().__init__(**kwargs)
        self._torch_devices: Optional[List[torch.device]] = \
            self._discover()
        self._computing_power: Optional[float] = None
        self._lock = threading.Lock()

    # -- discovery ---------------------------------------------------------
    def _discover(self) -> List[torch.device]:
        raise NotImplementedError

    # -- handles -----------------------------------------------------------
    @property
    def backend_name(self) -> str:
        """The primary device's type: ``"cuda"`` or ``"cpu"``."""
        return self.torch_device.type

    def _ensure_devices(self) -> List[torch.device]:
        """Lazy re-discovery after unpickling; raises when the
        snapshot's backend is absent on this host."""
        if self._torch_devices is None:
            self._torch_devices = self._discover()
        return self._torch_devices

    @property
    def torch_devices(self) -> List[torch.device]:
        return self._ensure_devices()

    @property
    def torch_device(self) -> torch.device:
        """The primary device for single-card work."""
        return self._ensure_devices()[0]

    @property
    def device_count(self) -> int:
        return len(self._ensure_devices())

    # -- dtype policy: f32 params and accumulation, activations in the
    # compute dtype -------------------------------------------------------
    @property
    def precision_dtype(self) -> np.dtype:
        return np.dtype(str(root.common.engine.precision_type))

    @property
    def compute_dtype(self) -> torch.dtype:
        return _compute_dtype(str(root.common.engine.compute_type))

    # -- transfers ---------------------------------------------------------
    def put(self, x) -> torch.Tensor:
        """A copy of ``x`` (numpy, a scalar or a tensor) on this
        device."""
        if isinstance(x, torch.Tensor):
            return x.detach().to(self.torch_device, copy=True)
        return torch.tensor(np.asarray(x), device=self.torch_device)

    @staticmethod
    def get(x) -> np.ndarray:
        """``x`` as a host numpy array (a copy; bf16 comes back as
        f32, numpy has no bf16)."""
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.dtype == torch.bfloat16:
                x = x.float()
            return x.cpu().numpy().copy()
        return np.asarray(x)

    @staticmethod
    def sync(*arrays) -> None:
        """Block until the device work queued so far is done (a CUDA
        synchronize of the arrays' cards, or of the current card; a
        no-op on the CPU)."""
        if not torch.cuda.is_initialized():
            return
        cards = {a.device for a in arrays
                 if isinstance(a, torch.Tensor) and a.is_cuda}
        if not arrays:
            torch.cuda.synchronize()
        for card in cards:
            torch.cuda.synchronize(card)

    # -- mesh --------------------------------------------------------------
    def mesh(self, axes: Dict[str, int]):
        """A mesh over the joined process group with this device as the
        rank's, e.g. ``device.mesh({"data": 4, "model": 2})`` (the
        sizes multiply to the world size). Raises without a group:
        join first (``parallel.multiprocess.initialize``)."""
        from veles_tpu_torch.parallel.mesh import grid_mesh
        return grid_mesh(axes, device=self.torch_device)

    # -- benchmark / computing power --------------------------------------
    def benchmark(self, size: int = 2048, repeats: int = 4) -> float:
        """Measured matmul TFLOP/s on the primary device: a chain of
        ``size`` x ``size`` products in the compute dtype."""
        gen = torch.Generator().manual_seed(0)
        a = (torch.randn((size, size), generator=gen) / size ** 0.5).to(
            self.torch_device, self.compute_dtype)
        out = torch.matmul(a, a)                       # warm
        self.sync(out)
        t0 = time.perf_counter()
        out = a
        for _ in range(repeats):
            out = torch.matmul(out, a)
        self.sync(out)
        dt = (time.perf_counter() - t0) / repeats
        return 2 * size ** 3 / dt / 1e12

    @property
    def computing_power(self) -> float:
        """Cached worker-capability score for load balancing."""
        with self._lock:
            if self._computing_power is None:
                self._computing_power = self.benchmark()
                self.info("computing power: %.2f TFLOP/s (%s)",
                          self._computing_power, self.backend_name)
            return self._computing_power

    # device handles and locks are process-local: re-discover after
    # unpickling (a Device inside a snapshot is configuration, not state)
    def __getstate__(self):
        return {"backend": self.BACKEND}

    def __setstate__(self, state):
        # do not touch the card here: unpickling must succeed on any
        # host; discovery is lazy
        self._torch_devices = None
        self._computing_power = None
        self._lock = threading.Lock()

    def __repr__(self) -> str:
        devs = self._torch_devices
        return "<%s %s device(s): %s>" % (
            type(self).__name__,
            len(devs) if devs is not None else "?",
            devs[0] if devs else "-")


class CudaDevice(Device):
    """The CUDA cards of this host: first the one ``resolve(None)``
    picks for every entry point (raising without one), then the
    others."""

    BACKEND = "auto"

    def _discover(self) -> List[torch.device]:
        primary = resolve(None)
        return [primary] + [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())
                            if i != primary.index]


class CpuDevice(Device):
    """The CPU: the plain PyTorch path, the universal testing fake."""

    BACKEND = "cpu"

    def _discover(self) -> List[torch.device]:
        return [torch.device("cpu")]
