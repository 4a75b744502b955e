"""Deterministic host-side weight filling from a unit's random stream.

Port of ``veles_tpu/nn/filling.py`` (kwargs ``weights_filling`` /
``weights_stddev`` of every forward unit). The draws come from the
stream's numpy generator, which gives the reference's exact values for
the same seed and stream name, so a unit's initial weights are bitwise
the reference's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def fill_weights(rand, shape: Tuple[int, ...], filling: str = "uniform",
                 stddev: Optional[float] = None,
                 fan_in: Optional[int] = None,
                 fan_out: Optional[int] = None) -> np.ndarray:
    """Glorot-scaled uniform or gaussian f64 weights of ``shape``,
    reproducible through the stream's saved state
    (``Unit._initialize_reproducibly``)."""
    if fan_in is None:
        fan_in = int(np.prod(shape[:-1]))
    if fan_out is None:
        fan_out = int(shape[-1])
    if stddev is None:
        stddev = float(np.sqrt(6.0 / (fan_in + fan_out)))
    out = np.empty(shape, dtype=np.float64)
    if filling == "uniform":
        out[...] = rand.random_sample(shape) * 2 * stddev - stddev
    elif filling == "gaussian":
        rand.fill_normal_host(out, stddev)
    else:
        raise ValueError("unknown weights_filling %r" % filling)
    return out
