"""AcceleratedUnit: graph units whose work runs on the device.

Port of ``veles_tpu/accelerated_units.py``. What the design keeps:

- units bind to a :class:`veles_tpu_torch.backends.Device` at
  initialize (``Device()`` is the CUDA card and raises without one);
- a process-wide cache of one shared callable per pure function
  (``jit_cache``), so many unit instances share one; in the port the
  callable is the plain function, run eagerly;
- ``force_cpu`` runs a unit on the CPU even when the workflow is on
  the card;
- ``init_array`` creates or rebinds an :class:`~veles_tpu_torch.memory.Array`
  on the unit's device;
- the computing-power probe lives on
  :meth:`veles_tpu_torch.backends.Device.benchmark`.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

from veles_tpu_torch.backends import Device
from veles_tpu_torch.memory import Array
from veles_tpu_torch.units import Unit
from veles_tpu_torch.workflow import Workflow

_jit_cache: Dict[Tuple[Callable, Tuple], Callable] = {}
_jit_cache_lock = threading.Lock()


def jit_cache(fn: Callable, static_argnums: Tuple = (),
              donate_argnums: Tuple = ()) -> Callable:
    """Process-wide memo of one shared callable per pure function and
    its arguments, so every unit instance (and every workflow) gets the
    same object back. In the port that callable is the plain function:
    the units run it eagerly (no ``torch.compile``, no capture);
    ``static_argnums`` and ``donate_argnums`` are kept in the key for
    the reference's signature."""
    key = (fn, tuple(static_argnums), tuple(donate_argnums))
    with _jit_cache_lock:
        shared = _jit_cache.get(key)
        if shared is None:
            shared = _jit_cache[key] = fn
        return shared


class AcceleratedUnit(Unit):
    """A unit whose run() does device work.

    Subclasses implement ordinary ``initialize``/``run``, call pure
    functions on the tensors of their
    :class:`veles_tpu_torch.memory.Array` buffers (:meth:`jit` hands
    out the shared callable) and assign results back to ``devmem``.
    ``force_cpu`` runs this unit on the CPU even when the workflow is
    on the card.
    """

    hide_from_registry = True

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.force_cpu = kwargs.pop("force_cpu", False)
        super().__init__(workflow, **kwargs)

    def init_unpickled(self) -> None:
        super().init_unpickled()
        self.device_: Optional[Device] = None

    @property
    def device(self) -> Optional[Device]:
        return self.device_

    @device.setter
    def device(self, value: Optional[Device]) -> None:
        self.device_ = value

    def initialize(self, device: Optional[Device] = None,
                   **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if device is not None:
            self.device = device
        if self.device is None or self.force_cpu:
            self.device = Device(backend="cpu" if self.force_cpu
                                 else None)
        return None

    def jit(self, fn: Callable, static_argnums: Tuple = (),
            donate_argnums: Tuple = ()) -> Callable:
        return jit_cache(fn, static_argnums, donate_argnums)

    def init_array(self, attr: str, shape=None, dtype=None,
                   data=None) -> Array:
        """Create-or-rebind an Array attribute on this unit's device."""
        import numpy as np
        dtype = dtype or (self.device.precision_dtype
                          if self.device else "float32")
        arr = getattr(self, attr, None)
        if not isinstance(arr, Array):
            arr = Array(data=data, shape=shape, dtype=dtype)
            setattr(self, attr, arr)
        elif data is not None:
            arr.reset(data)
        elif shape is not None and (arr.mem is None or
                                    arr.shape != tuple(shape)):
            arr.reset(np.zeros(shape, dtype=dtype))
        if self.device is not None:
            arr.initialize(self.device)
        return arr


class AcceleratedWorkflow(Workflow):
    """A workflow owning a Device, handed to every unit at initialize
    (reference: veles/accelerated_units.py:827-866)."""

    hide_from_registry = True

    def initialize(self, device: Optional[Device] = None,
                   **kwargs: Any) -> None:
        """``device=None`` picks ``Device()``: the CUDA card, raising
        without one (``Device(backend="cpu")`` runs on the CPU)."""
        if device is None and self.device is None:
            device = Device()
            self.info("selected device: %r", device)
        super().initialize(device=device if device is not None
                           else self.device, **kwargs)
