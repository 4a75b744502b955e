"""Kohonen self-organizing map units.

Port of ``veles_tpu/nn/kohonen.py``. The winner search is one distance
product and an ``argmin`` on the device (the first minimum, as
``jnp.argmin`` takes it); the trainer applies the whole minibatch in
one batch SOM update with a Gaussian neighbourhood over the 2-D grid,
whose radius and learning rate decay exponentially with the step. The
codebook starts from the host draw ``random_sample`` of the unit's
stream, bitwise the reference's. ``avg_quantization_err`` is one host
read a step.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.all2all import dot


def _winners(x, codebook, compute_dtype):
    """The nearest codebook row per sample and its squared distance:
    ``||x - c||^2`` through the product expansion ``x^2 - 2 x c + c^2``
    (``x^2`` does not change the winner)."""
    x2 = x.reshape(x.shape[0], -1)
    cross = dot(x2, codebook.T, compute_dtype, codebook.dtype)
    c_norm = (codebook * codebook).sum(dim=1)
    dist = c_norm[None, :] - 2.0 * cross
    win = dist.argmin(dim=1).to(torch.int32)
    x_norm = (x2 * x2).sum(dim=1)
    qerr = dist.gather(1, win[:, None].long())[:, 0] + x_norm
    return win, qerr.clamp_min(0.0)


def _som_update(codebook, grid, x, size: int, step: float, lr0: float,
                radius0: float, decay: float, compute_dtype):
    """Batch SOM update of ``codebook`` in place: every valid sample
    pulls every neuron with a Gaussian weight of its grid distance to
    the sample's winner. Returns (winners, summed quantization error)."""
    batch = x.shape[0]
    x2 = x.reshape(batch, -1)
    valid = (torch.arange(batch, device=x.device) < size).to(
        codebook.dtype)
    win, qerr = _winners(x2, codebook, compute_dtype)

    t = step * decay
    lr = lr0 * math.exp(-t)
    radius = max(radius0 * math.exp(-t), 0.5)

    win_pos = grid.index_select(0, win.long())                  # [B, 2]
    d2 = ((grid[None, :, :] - win_pos[:, None, :]) ** 2).sum(dim=-1)
    theta = torch.exp(-d2 / (2.0 * radius * radius)) * valid[:, None]
    num = dot(theta.T, x2, compute_dtype, codebook.dtype)
    den = theta.sum(dim=0)[:, None]
    delta = num - den * codebook
    codebook.add_(lr * delta / valid.sum().clamp_min(1.0))
    err_sum = (qerr.sqrt() * valid).sum()
    return win, err_sum


class KohonenForward(AcceleratedUnit):
    """Winner lookup unit: ``output`` holds the winners' indices [B]."""

    EXPORT_UUID = "veles.tpu.kohonen"
    MAPPING = "kohonen"
    MAPPING_GROUP = "unsupervised"

    def export_spec(self):
        """(props, arrays) of the unit: the map's shape and codebook."""
        return ({"shape": list(self.shape)},
                {"codebook": self.codebook.map_read()})

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.shape: Tuple[int, int] = tuple(kwargs.pop("shape", (8, 8)))
        self.weights_stddev = kwargs.pop("weights_stddev", 0.1)
        prng_stream = kwargs.pop("prng_stream", "default")
        super().__init__(workflow, **kwargs)
        self.input: Optional[Array] = None
        self.output = Array()       # winner indices
        self.codebook = Array()     # [n_neurons, features]
        self.rand = prng.get(prng_stream)
        self.demand("input")

    @property
    def n_neurons(self) -> int:
        return self.shape[0] * self.shape[1]

    def grid_positions(self) -> np.ndarray:
        ys, xs = np.mgrid[0:self.shape[0], 0:self.shape[1]]
        return np.stack([ys.ravel(), xs.ravel()], axis=1).astype(
            np.float32)

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.input:
            return True
        batch = self.input.shape[0]
        features = int(np.prod(self.input.shape[1:]))
        dtype = self.device.precision_dtype
        if not self.codebook or self.codebook.shape != (self.n_neurons,
                                                        features):
            init = self.rand.random_sample(
                (self.n_neurons, features)) * self.weights_stddev
            self.init_array("codebook", data=init.astype(dtype))
        else:
            self.init_array("codebook")
        self.init_array("output", shape=(batch,), dtype=np.int32)
        self._fwd_ = self.jit(_winners, static_argnums=(2,))
        return None

    def run(self) -> None:
        win, _ = self._fwd_(self.input.devmem, self.codebook.devmem,
                            self.device.compute_dtype)
        self.output.devmem = win


class KohonenTrainer(AcceleratedUnit):
    """Batch SOM update; shares the codebook with the forward unit.

    kwargs: ``learning_rate`` (initial), ``radius`` (initial, default
    max(grid) / 2), ``decay`` (per-step exponential decay constant)."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.learning_rate: float = kwargs.pop("learning_rate", 0.5)
        self.radius: Optional[float] = kwargs.pop("radius", None)
        self.decay: float = kwargs.pop("decay", 0.005)
        kwargs.setdefault("view_group", "TRAINER")
        super().__init__(workflow, **kwargs)
        self.input: Optional[Array] = None
        self.batch_size: Optional[int] = None
        self.codebook: Optional[Array] = None
        self.grid: Optional[np.ndarray] = None  # link from forward
        self.step_count = 0
        self.avg_quantization_err = np.inf
        #: the last step's winners [B] (int32, on the device)
        self.winners = None
        self.demand("input", "batch_size", "codebook", "grid")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.codebook:
            return True
        if callable(self.grid):
            self.grid = self.grid()
        if self.radius is None:
            self.radius = float(np.max(self.grid) / 2.0)
        self._grid_dev_ = self.device.put(
            np.asarray(self.grid, dtype=np.float32))
        self._step_ = self.jit(_som_update, static_argnums=(8,),
                               donate_argnums=(0,))
        return None

    def run(self) -> None:
        codebook = self.codebook.devmem
        self.winners, err_sum = self._step_(
            codebook, self._grid_dev_, self.input.devmem,
            int(self.batch_size), float(self.step_count),
            float(self.learning_rate), float(self.radius),
            float(self.decay), self.device.compute_dtype)
        self.codebook.devmem = codebook
        self.step_count += 1
        self.avg_quantization_err = float(err_sum) / max(
            int(self.batch_size), 1)
