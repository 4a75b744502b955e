"""Local response normalization (cross-channel), AlexNet-style.

Port of ``lrn_raw`` from ``veles_tpu/nn/lrn.py`` (the unit classes wait
for the unit-graph slice). Caffe semantics: ``y = x / (k + alpha/n *
sum_window(x^2))^beta`` over the last (channel) axis. :func:`lrn_raw`
is one ``torch.autograd.Function`` that saves only ``x``, as the
reference's ``custom_vjp`` does; the backward recomputes the window
sums.

Three paths, by ``impl`` and the tensor's device:

- None on a CUDA tensor, or "cuda": the K6/K7 kernels
  (``ops.lrn.lrn_fwd`` / ``lrn_bwd``);
- None on a CPU tensor: the reference's lax formulation op for op
  (the banded window sum materialised in x's dtype, the reduce-window
  branch for more than 512 channels, the analytic ``_bwd``), so the
  CPU tests compare like with like;
- "plain": the kernels' plain PyTorch versions (the Pallas kernels'
  arithmetic), on any device: the oracle the kernels are held to.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

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


def lrn_raw(x: torch.Tensor, k: float, n: int, alpha: float, beta: float,
            impl: Optional[str] = None) -> torch.Tensor:
    """LRN over the last axis of ``x`` (NHWC activations), differentiable.
    ``impl``: None (the kernels on CUDA tensors, the reference's lax
    formulation on CPU tensors), "cuda" or "plain" (module docstring)."""
    if impl is None and not x.is_cuda:
        mode = "lax"
    else:
        mode = _build.resolve_impl(impl, x.device, "lrn_raw")
    return _LRN.apply(x, k, n, alpha, beta, mode)
