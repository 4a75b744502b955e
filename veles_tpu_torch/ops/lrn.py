"""Fused cross-channel LRN: the forward (K6) and backward (K7) kernels
of ``csrc/lrn.cu`` and their plain PyTorch versions.

Port of ``veles_tpu/ops/lrn_pallas.py``. Caffe's formula over the last
(channel) axis, ``y = x * (k + alpha/n * sum_window x^2) ** -beta``,
with the window ``[c - lo, c + hi]``, ``lo = (n-1)//2``; the backward
recomputes the window sums from ``x``. Both versions follow the Pallas
kernels' arithmetic: ``x * x`` in x's dtype, window sums in f32 term by
term from the window's low end, the power in f32, the result in x's
dtype. That is not the reference's lax formula (``nn/lrn.py``), which
rounds the window sum itself to x's dtype; at f32 the two differ only
in the order of the window sum.

The Pallas kernels' packing of samples into 128-lane rows and their
``MAX_C`` cutoff are TPU layout rules and have no counterpart here:
the kernels take any row count, any channel count and any window, and
read each lane's channels 16 bytes at a time where :func:`lrn_plan`
finds the pointers, the row strides and C aligned to it (a narrower
instance of the same kernel otherwise). Every kernel wrapper counts its
launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from veles_tpu_torch.ops import _build, launches

#: Kernel launches since the last :func:`reset_launches`, by kernel.
LAUNCHES: Dict[str, int] = {"lrn_fwd": 0, "lrn_bwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _window(n: int, transpose: bool):
    lo = (n - 1) // 2
    hi = n - 1 - lo
    return (hi, lo) if transpose else (lo, hi)


def window_sum(v: torch.Tensor, n: int, transpose: bool = False
               ) -> torch.Tensor:
    """f32 sum of ``v`` over the channel window (zero outside the
    channels), term by term from the window's low end: the Pallas
    kernels' order. ``transpose`` applies the adjoint window."""
    lo, hi = _window(n, transpose)
    c = v.shape[-1]
    vp = F.pad(v.float(), (lo, hi))
    acc = vp[..., 0:c]
    for d in range(1, n):
        acc = acc + vp[..., d:d + c]
    return acc


def _plain_fwd(x, k: float, n: int, alpha: float, beta: float):
    coef = alpha / n
    u = k + coef * window_sum(x * x, n)
    return (x.float() * u ** -beta).to(x.dtype)


def _plain_bwd(x, dy, k: float, n: int, alpha: float, beta: float):
    coef = alpha / n
    xf = x.float()
    dyf = dy.float()
    u = k + coef * window_sum(x * x, n)
    t = u ** -beta
    inner = (dyf * xf * (t / u)).to(x.dtype)
    dx = dyf * t - (2.0 * coef * beta) * xf * window_sum(inner, n, True)
    return dx.to(x.dtype)


def lrn_plan(dtype: torch.dtype, c: int, strides: Sequence[int],
             ptrs: Sequence[int]) -> int:
    """Channels a lane of K6/K7 loads at once: the widest of 16, 8, 4
    and 2 bytes (not below one element) that divides C's bytes, every
    row stride's bytes (``strides``, in elements) and every base
    address (``ptrs``), so each lane's vector starts aligned and lies
    in one row."""
    size = torch.finfo(dtype).bits // 8
    for nbytes in (16, 8, 4, 2):
        if nbytes < size:
            break
        if (c * size) % nbytes == 0 and \
                all(s * size % nbytes == 0 for s in strides) and \
                all(p % nbytes == 0 for p in ptrs):
            return nbytes // size
    return 1


def _rows(name: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` as a (M, C) view of its rows, without a copy: the channel
    axis must have unit stride and the leading axes must flatten to one
    row stride (as an NHWC activation does)."""
    if x.ndim < 1 or x.stride(-1) != 1 and x.shape[-1] > 1:
        raise ValueError("%s kernel needs unit stride on the channel axis, "
                         "got strides %r" % (name, x.stride()))
    try:
        return x.view(-1, x.shape[-1])
    except RuntimeError:
        raise ValueError("%s kernel needs the leading axes to flatten to "
                         "one row stride (no hidden copy), got shape %r "
                         "strides %r" % (name, tuple(x.shape), x.stride())
                         ) from None


def _check(name: str, *tensors: torch.Tensor) -> None:
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError("%s kernel takes float32 or bfloat16, got %s"
                         % (name, dtype))
    for x in tensors:
        if not x.is_cuda or x.device != dev or x.dtype != dtype or \
                x.shape != tensors[0].shape:
            raise ValueError("%s kernel operands must share one CUDA "
                             "device, dtype and shape" % name)


def _lib() -> ctypes.CDLL:
    lib = _build.library("lrn")
    if lib.veles_lrn_fwd.argtypes is None:
        p, i64, f = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        lib.veles_lrn_fwd.argtypes = [p, p] + [i64] * 6 + [f] * 3 + [
            ctypes.c_int, p]
        lib.veles_lrn_fwd.restype = ctypes.c_int
        lib.veles_lrn_bwd.argtypes = [p] * 3 + [i64] * 7 + [f] * 4 + [
            ctypes.c_int, p]
        lib.veles_lrn_bwd.restype = ctypes.c_int
    return lib


def lrn_fwd_cuda(x, k: float, n: int, alpha: float, beta: float):
    """K6 on a CUDA tensor ``[..., C]`` read in place (unit channel
    stride, leading axes of one row stride). Returns y, contiguous, of
    x's shape and dtype."""
    _check("lrn_fwd", x)
    x2 = _rows("lrn_fwd", x)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    y2 = y.view(-1, x.shape[-1])
    vec = lrn_plan(x.dtype, x2.shape[1], (x2.stride(0), y2.stride(0)),
                   (x2.data_ptr(), y2.data_ptr()))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.veles_lrn_fwd(
            x2.data_ptr(), y2.data_ptr(), x2.shape[0], x2.shape[1],
            x2.stride(0), y2.stride(0), int(n), vec, float(k), alpha / n,
            -beta, _DTYPE_CODES[x.dtype], stream)
    _build.check(lib, "lrn_fwd", rc)
    launches.count(LAUNCHES, "lrn_fwd")
    return y


def lrn_bwd_cuda(x, dy, k: float, n: int, alpha: float, beta: float):
    """K7: dx from x and dy, CUDA tensors of one shape and dtype, read
    in place as :func:`lrn_fwd_cuda` reads x. Returns dx, contiguous."""
    _check("lrn_bwd", x, dy)
    x2, dy2 = _rows("lrn_bwd", x), _rows("lrn_bwd", dy)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dx2 = dx.view(-1, x.shape[-1])
    strides = (x2.stride(0), dy2.stride(0), dx2.stride(0))
    ptrs = (x2.data_ptr(), dy2.data_ptr(), dx2.data_ptr())
    vec = lrn_plan(x.dtype, x2.shape[1], strides, ptrs)
    coef = alpha / n
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.veles_lrn_bwd(
            *ptrs, x2.shape[0], x2.shape[1], *strides, int(n), vec,
            float(k), coef, -beta, 2.0 * coef * beta,
            _DTYPE_CODES[x.dtype], stream)
    _build.check(lib, "lrn_bwd", rc)
    launches.count(LAUNCHES, "lrn_bwd")
    return dx


def lrn_fwd(x, k: float, n: int, alpha: float, beta: float,
            impl: Optional[str] = None):
    """y = x * (k + alpha/n * window_sum(x^2)) ** -beta over the last
    axis. ``impl``: "cuda" (K6), "plain", or None = "cuda" for a CUDA
    tensor, else "plain"."""
    if _build.resolve_impl(impl, x.device, "lrn_fwd") == "cuda":
        return lrn_fwd_cuda(x, k, n, alpha, beta)
    return _plain_fwd(x, k, n, alpha, beta)


def lrn_bwd(x, dy, k: float, n: int, alpha: float, beta: float,
            impl: Optional[str] = None):
    """dx of :func:`lrn_fwd` for the cotangent ``dy``, window sums
    recomputed from ``x``. ``impl`` as in :func:`lrn_fwd` (K7)."""
    if _build.resolve_impl(impl, x.device, "lrn_bwd") == "cuda":
        return lrn_bwd_cuda(x, dy, k, n, alpha, beta)
    return _plain_bwd(x, dy, k, n, alpha, beta)
