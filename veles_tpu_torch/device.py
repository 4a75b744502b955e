"""Device and dtype policy of the port.

Every entry point resolves ``device=None`` through :func:`resolve` to
the current CUDA device. Without a GPU that raises: the CPU runs the
plain PyTorch path only when the caller asks for it
(``device="cpu"``), as the tests do, and nothing carries on there
silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve(device: Optional[Union[str, torch.device]] = None
            ) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); any
    other value is taken as the caller's explicit choice."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (a "
            "workflow: Device(backend='cpu')) to run the plain PyTorch "
            "path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def compute_dtype(name: str) -> torch.dtype:
    """A compute dtype's name (``TransformerConfig.compute``, the fused
    trainer's ``compute_dtype``) -> torch dtype (f32 master params stay
    f32; activations run in this dtype)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            "the compute dtype must be 'float32' or 'bfloat16', got %r"
            % (name,)) from None
