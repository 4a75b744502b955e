"""The flagship classifier: AlexNet in the fused trainer's format.

Port of ``veles_tpu/models/flagship.py`` (all of it) and of
``alexnet_layers`` from ``veles_tpu/models/alexnet.py`` (its workflow
class waits for the unit-graph slice). Pure numpy: the same generator
draws in the same order from the same seed, so :func:`alexnet_fused`
returns specs, params and FLOPs bitwise equal to the reference's.
Params are the reference's layout: HWIO conv weights, ``[in, out]`` FC
weights, f32.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def alexnet_layers(n_classes: int = 1000,
                   dropout: float = 0.5) -> List[dict]:
    """Classic caffe AlexNet geometry, without grouped convs."""
    return [
        {"type": "conv_relu", "n_kernels": 96, "kx": 11,
         "sliding": (4, 4), "padding": 2},
        {"type": "lrn"},
        {"type": "max_pooling", "kx": 3, "sliding": (2, 2)},
        {"type": "conv_relu", "n_kernels": 256, "kx": 5, "padding": 2},
        {"type": "lrn"},
        {"type": "max_pooling", "kx": 3, "sliding": (2, 2)},
        {"type": "conv_relu", "n_kernels": 384, "kx": 3, "padding": 1},
        {"type": "conv_relu", "n_kernels": 384, "kx": 3, "padding": 1},
        {"type": "conv_relu", "n_kernels": 256, "kx": 3, "padding": 1},
        {"type": "max_pooling", "kx": 3, "sliding": (2, 2)},
        {"type": "all2all_relu", "output_sample_shape": 4096},
        {"type": "dropout", "dropout_ratio": dropout},
        {"type": "all2all_relu", "output_sample_shape": 4096},
        {"type": "dropout", "dropout_ratio": dropout},
        {"type": "softmax", "output_sample_shape": n_classes},
    ]


def flagship_specs(layers: Tuple[int, ...] = (4096, 4096, 10),
                   in_dim: int = 784, seed: int = 0):
    """FC stack in fused format: tanh hidden layers, softmax tail."""
    rng = np.random.default_rng(seed)
    specs: List[Any] = []
    params: List[Dict[str, np.ndarray]] = []
    dims = (in_dim,) + tuple(layers)
    acts = ["tanh"] * (len(layers) - 1) + ["softmax"]
    for act, fan_in, fan_out in zip(acts, dims[:-1], dims[1:]):
        std = np.sqrt(6.0 / (fan_in + fan_out))
        specs.append(("fc", act))
        params.append({
            "w": rng.uniform(-std, std,
                             (fan_in, fan_out)).astype(np.float32),
            "b": np.zeros(fan_out, dtype=np.float32)})
    return tuple(specs), params


def fused_from_layer_dicts(layers: Sequence[Dict[str, Any]],
                           image_shape: Tuple[int, int, int],
                           seed: int = 0):
    """Layer-spec dicts -> fused specs + deterministic Glorot params,
    tracking shapes analytically.

    Returns (specs, params, fwd_flops_per_image)."""
    rng = np.random.default_rng(seed)
    h, w, c = image_shape
    specs: List[Any] = []
    params: List[Dict[str, np.ndarray]] = []
    flat: Optional[int] = None
    flops = 0

    def conv_out(size, k, stride, pad):
        return (size + 2 * pad - k) // stride + 1

    for spec in layers:
        spec = dict(spec)
        t = spec.pop("type")
        if t.startswith("conv"):
            act = t.split("_", 1)[1] if "_" in t else "linear"
            kx = spec["kx"]
            ky = spec.get("ky") or kx
            sx, sy = spec.get("sliding", (1, 1))
            pad = spec.get("padding", 0)
            px = py = pad if isinstance(pad, int) else 0
            n_kernels = spec["n_kernels"]
            wshape = (ky, kx, c, n_kernels)
            fan_in = ky * kx * c
            std = np.sqrt(6.0 / (fan_in + n_kernels))
            params.append({
                "w": rng.uniform(-std, std, wshape).astype(np.float32),
                "b": np.zeros(n_kernels, dtype=np.float32)})
            specs.append(("conv", act, (sy, sx),
                          ((py, py), (px, px))))
            h = conv_out(h, ky, sy, py)
            w = conv_out(w, kx, sx, px)
            flops += 2 * ky * kx * c * n_kernels * h * w
            c = n_kernels
        elif t.endswith("pooling"):
            kind = t.split("_", 1)[0]
            kx = spec["kx"]
            ky = spec.get("ky") or kx
            sx, sy = spec.get("sliding", (kx, ky))
            specs.append(("pool", kind, ky, kx, (sy, sx)))
            h = (h - ky) // sy + 1
            w = (w - kx) // sx + 1
            params.append({})
        elif t == "lrn":
            specs.append(("lrn", spec.get("k", 2.0), spec.get("n", 5),
                          spec.get("alpha", 1e-4),
                          spec.get("beta", 0.75)))
            params.append({})
        elif t == "dropout":
            specs.append(("dropout", spec.get("dropout_ratio", 0.5)))
            params.append({})
        elif t.startswith("all2all") or t == "softmax":
            act = "softmax" if t == "softmax" else (
                t.split("_", 1)[1] if "_" in t else "linear")
            fan_in = flat if flat is not None else h * w * c
            fan_out = int(np.prod(spec["output_sample_shape"]))
            std = np.sqrt(6.0 / (fan_in + fan_out))
            params.append({
                "w": rng.uniform(-std, std,
                                 (fan_in, fan_out)).astype(np.float32),
                "b": np.zeros(fan_out, dtype=np.float32)})
            specs.append(("fc", act))
            flops += 2 * fan_in * fan_out
            flat = fan_out
        else:
            raise ValueError("unknown layer type %r" % t)
    return tuple(specs), params, flops


def alexnet_fused(n_classes: int = 1000, image_size: int = 224,
                  seed: int = 0):
    """(specs, params, fwd_flops_per_image) for the AlexNet flagship."""
    return fused_from_layer_dicts(
        alexnet_layers(n_classes), (image_size, image_size, 3), seed)
