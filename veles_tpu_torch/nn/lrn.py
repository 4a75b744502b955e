"""Local response normalization (cross-channel), AlexNet-style, and
its units.

Port of ``veles_tpu/nn/lrn.py``: ``lrn_raw`` and the units
``LRNormalizerForward`` and ``GDLRNormalizer``. Caffe semantics: ``y =
x / (k + alpha/n * sum_window(x^2))^beta`` over the last (channel)
axis. :func:`lrn_raw` is one ``torch.autograd.Function`` that saves
only ``x``, as the reference's ``custom_vjp`` does; the backward
recomputes the window sums. :func:`lrn_backward` is that backward
alone: ``GDLRNormalizer`` calls it, so a backward unit launches K7 and
no K6 (the reference's unit takes ``jax.vjp`` of the forward).

Three paths, by ``impl`` and the tensor's device:

- None on a CUDA tensor, or "cuda": the K6/K7 kernels
  (``ops.lrn.lrn_fwd`` / ``lrn_bwd``);
- None on a CPU tensor: the reference's lax formulation op for op
  (the banded window sum materialised in x's dtype, the reduce-window
  branch for more than 512 channels, the analytic ``_bwd``), so the
  CPU tests compare like with like;
- "plain": the kernels' plain PyTorch versions (the Pallas kernels'
  arithmetic), on any device: the oracle the kernels are held to.

The reference's units run the lax formulation (its Pallas kernels sit
behind ``VELES_LRN_PALLAS``); the port's units run the kernels on the
card (ROADMAP.md queue 3, deliberate divergences).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.memory import Array
from veles_tpu_torch.nn.conv import as_nhwc
from veles_tpu_torch.ops import _build
from veles_tpu_torch.ops.lrn import lrn_bwd, lrn_fwd

#: Channel count above which the window sum is a sliding sum, not a
#: banded [C, C] product (the reference's cutoff).
BAND_MAX_C = 512


def _window_sum(v: torch.Tensor, n: int, transpose: bool = False
                ) -> torch.Tensor:
    """The reference's ``_window_sum``: SAME stride-1 window-n sum over
    the channel axis, f32 accumulation, materialised in v's dtype; a
    banded [C, C] ones-matrix product up to :data:`BAND_MAX_C` channels,
    a sliding f32 sum above. ``transpose`` applies the adjoint."""
    c = v.shape[-1]
    lo = (n - 1) // 2
    hi = n - 1 - lo
    if transpose:
        lo, hi = hi, lo
    if c > BAND_MAX_C:
        vp = F.pad(v.float(), (lo, hi))
        acc = vp[..., 0:c]
        for d in range(1, n):
            acc = acc + vp[..., d:d + c]
        return acc.to(v.dtype)
    i = np.arange(c)[:, None]
    j = np.arange(c)[None, :]
    band = torch.from_numpy(
        ((i >= j - lo) & (i <= j + hi)).astype(np.float32)).to(v.device)
    return (v.float() @ band).to(v.dtype)


def _lax_fwd(x, k, n, alpha, beta):
    c = alpha / n
    u = k + c * _window_sum(x * x, n).float()
    return x * (u ** -beta).to(x.dtype)


def _lax_bwd(x, dy, k, n, alpha, beta):
    c = alpha / n
    u = k + c * _window_sum(x * x, n).float()
    t = u ** -beta
    inner = (dy * x).float() * (t / u)
    dx = dy * t.to(dy.dtype) - (2.0 * c * beta) * x * _window_sum(
        inner.to(x.dtype), n, transpose=True).to(x.dtype)
    return dx.to(x.dtype)


class _LRN(torch.autograd.Function):
    """y = lrn(x); saves only x."""

    @staticmethod
    def forward(ctx, x, k, n, alpha, beta, impl):
        ctx.save_for_backward(x)
        ctx.spec = (k, n, alpha, beta, impl)
        if impl == "lax":
            return _lax_fwd(x, k, n, alpha, beta)
        return lrn_fwd(x, k, n, alpha, beta, impl=impl)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        k, n, alpha, beta, impl = ctx.spec
        if impl == "lax":
            dx = _lax_bwd(x, dy, k, n, alpha, beta)
        else:
            dx = lrn_bwd(x, dy.to(x.dtype), k, n, alpha, beta, impl=impl)
        return dx, None, None, None, None, None


def _mode(x: torch.Tensor, impl: Optional[str], entry: str) -> str:
    if impl is None and not x.is_cuda:
        return "lax"
    return _build.resolve_impl(impl, x.device, entry)


def lrn_raw(x: torch.Tensor, k: float, n: int, alpha: float, beta: float,
            impl: Optional[str] = None) -> torch.Tensor:
    """LRN over the last axis of ``x`` (NHWC activations), differentiable.
    ``impl``: None (the kernels on CUDA tensors, the reference's lax
    formulation on CPU tensors), "cuda" or "plain" (module docstring)."""
    return _LRN.apply(x, k, n, alpha, beta, _mode(x, impl, "lrn_raw"))


def lrn_backward(x: torch.Tensor, dy: torch.Tensor, k: float, n: int,
                 alpha: float, beta: float,
                 impl: Optional[str] = None) -> torch.Tensor:
    """dx of :func:`lrn_raw` at ``x`` for the cotangent ``dy``, the
    window sums recomputed from ``x``: K7 alone on the card (``impl``
    as in :func:`lrn_raw`)."""
    mode = _mode(x, impl, "lrn_backward")
    if mode == "lax":
        return _lax_bwd(x, dy, k, n, alpha, beta)
    return lrn_bwd(x, dy.to(x.dtype), k, n, alpha, beta, impl=mode)


class LRNormalizerForward(AcceleratedUnit):
    """kwargs: ``k`` (bias, default 2), ``n`` (window, default 5),
    ``alpha`` (default 1e-4), ``beta`` (default 0.75)."""

    EXPORT_UUID = "veles.tpu.lrn"
    MAPPING = "lrn"
    MAPPING_GROUP = "layer"

    def export_spec(self):
        """(props, arrays) of the layer."""
        return {"k": self.k, "n": self.n, "alpha": self.alpha,
                "beta": self.beta}, {}

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.k: float = kwargs.pop("k", 2.0)
        self.n: int = kwargs.pop("n", 5)
        self.alpha: float = kwargs.pop("alpha", 1e-4)
        self.beta: float = kwargs.pop("beta", 0.75)
        super().__init__(workflow, **kwargs)
        self.input: Optional[Array] = None
        self.output = Array()
        self.demand("input")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.input:
            return True
        self._fwd_ = self.jit(lrn_raw, static_argnums=(1, 2, 3, 4))
        in_shape = self.input.shape
        out_shape = in_shape if len(in_shape) == 4 else in_shape + (1,)
        self.init_array("output", shape=out_shape,
                        dtype=self.device.precision_dtype)
        return None

    def run(self) -> None:
        self.output.devmem = self._fwd_(
            as_nhwc(self.input.devmem), self.k, self.n, self.alpha,
            self.beta)


class GDLRNormalizer(AcceleratedUnit):
    """Backward twin of :class:`LRNormalizerForward`; built by
    ``gd_for``."""

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.k: float = kwargs.pop("k", 2.0)
        self.n: int = kwargs.pop("n", 5)
        self.alpha: float = kwargs.pop("alpha", 1e-4)
        self.beta: float = kwargs.pop("beta", 0.75)
        kwargs.setdefault("view_group", "TRAINER")
        super().__init__(workflow, **kwargs)
        self.input: Optional[Array] = None
        self.err_output: Optional[Array] = None
        self.err_input = Array()
        self.demand("input", "err_output")

    def initialize(self, device=None, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(device=device, **kwargs)
        if retry:
            return retry
        if not self.input or not self.err_output:
            return True
        self._bwd_ = self.jit(lrn_backward, static_argnums=(2, 3, 4, 5))
        self.init_array("err_input", shape=self.input.shape,
                        dtype=self.device.precision_dtype)
        return None

    def run(self) -> None:
        err_input = self._bwd_(
            as_nhwc(self.input.devmem), self.err_output.devmem, self.k,
            self.n, self.alpha, self.beta)
        if tuple(err_input.shape) != tuple(self.input.shape):
            err_input = err_input.reshape(self.input.shape)
        self.err_input.devmem = err_input
