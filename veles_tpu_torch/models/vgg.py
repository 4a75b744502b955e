"""VGG-class conv workflows (the A/11 and D/16 configurations).

Port of ``veles_tpu/models/vgg.py``: spec lists for
:class:`veles_tpu_torch.models.standard.StandardWorkflow`, trained on
the synthetic color images (32 x 32 x 3 by default, minibatch 50).
"""

from __future__ import annotations

from typing import Any, List, Sequence

from veles_tpu_torch.loader.datasets import SyntheticColorImagesLoader
from veles_tpu_torch.models.standard import StandardWorkflow


def vgg_layers(config: Sequence = (1, 1, 2, 2, 2),
               widths: Sequence[int] = (64, 128, 256, 512, 512),
               fc: Sequence[int] = (4096, 4096),
               n_classes: int = 10,
               dropout: float = 0.5) -> List[dict]:
    """A VGG spec list: ``config[i]`` stacked 3x3 convs at ``widths[i]``
    followed by a 2x2 max pool, then the FC head. (1,1,2,2,2) is
    VGG-A/11; (2,2,3,3,3) is VGG-D/16."""
    layers: List[dict] = []
    for n_convs, width in zip(config, widths):
        for _ in range(n_convs):
            layers.append({"type": "conv_relu", "n_kernels": width,
                           "kx": 3, "padding": 1})
        layers.append({"type": "max_pooling", "kx": 2})
    for width in fc:
        layers.append({"type": "all2all_relu",
                       "output_sample_shape": width})
        if dropout:
            layers.append({"type": "dropout", "dropout_ratio": dropout})
    layers.append({"type": "softmax", "output_sample_shape": n_classes})
    return layers


VGG11_LAYERS = vgg_layers((1, 1, 2, 2, 2))
VGG16_LAYERS = vgg_layers((2, 2, 3, 3, 3))


class VggWorkflow(StandardWorkflow):
    """kwargs: ``depth`` 11|16 (default 11), or explicit ``layers``."""

    def __init__(self, workflow=None, depth: int = 11,
                 **kwargs: Any) -> None:
        lk = dict(kwargs.pop("loader_kwargs", None) or {})
        lk.setdefault("image_size", 32)
        lk.setdefault("minibatch_size", 50)
        kwargs["loader_kwargs"] = lk
        kwargs.setdefault("loader_cls", SyntheticColorImagesLoader)
        if "layers" not in kwargs:
            if depth not in (11, 16):
                raise ValueError(
                    "depth must be 11 or 16 (pass explicit layers for "
                    "other configurations), got %r" % (depth,))
            kwargs["layers"] = (VGG16_LAYERS if depth == 16
                                else VGG11_LAYERS)
        kwargs.setdefault("learning_rate", 0.01)
        kwargs.setdefault("momentum", 0.9)
        kwargs.setdefault("weight_decay", 5e-4)
        kwargs.setdefault("max_epochs", 10)
        super().__init__(workflow, **kwargs)


def run(load, main):
    from veles_tpu_torch.config import get, root
    load(VggWorkflow, **(get(root.vgg) or {}))
    main()
