"""Pooling (max / average) over NHWC windows, VALID.

Port of ``pool_raw`` from ``veles_tpu/nn/pooling.py`` (the unit classes
wait for the ``nn/`` units, ROADMAP.md queue 1 item 5). The windows run through
``torch.nn.functional.max_pool2d`` / ``avg_pool2d`` on the NCHW view of
the NHWC tensor (channels-last in memory). The max pool's backward
routes each window's cotangent to the window's first maximum in
row-major order, which is the reference's select-and-scatter
derivative, ties included. The reference's ``VELES_POOL_DILATED``
variant (an argmax-gather backward kept for TPU experiments) is not
ported.
"""

from __future__ import annotations

import torch.nn.functional as F


def pool_raw(kind: str, ky: int, kx: int, strides, x):
    """``kind`` "max", or anything else for the average, as the
    reference; x NHWC."""
    xc = x.permute(0, 3, 1, 2)
    if kind == "max":
        y = F.max_pool2d(xc, (ky, kx), tuple(strides))
    else:
        y = F.avg_pool2d(xc, (ky, kx), tuple(strides))
    return y.permute(0, 2, 3, 1)
