"""Avatar: mirrors a loader's minibatch outputs into another (nested)
workflow without reading the dataset again.

Port of ``veles_tpu/avatar.py``. The reflected ``Array``s share the
source's device tensors instead of copying them: the loaders assign a
fresh tensor to ``devmem`` on every serve and an ``Array``'s ``unmap``
makes a new tensor too, so no later serve writes into a tensor an
Avatar holds.
"""

from __future__ import annotations

from typing import Any, Optional

from veles_tpu_torch.memory import Array
from veles_tpu_torch.units import Unit

# loader attributes an Avatar reflects by default
REFLECTED_ARRAYS = ("minibatch_data", "minibatch_labels",
                    "minibatch_indices")
REFLECTED_SCALARS = ("minibatch_class", "minibatch_size",
                     "minibatch_offset", "epoch_number")


class Avatar(Unit):
    """Links from a source loader; exposes the same minibatch attrs.

    >>> avatar = Avatar(wf, source=loader)
    >>> nested_unit.link_attrs(avatar, "minibatch_data", ...)
    """

    def __init__(self, workflow, **kwargs: Any) -> None:
        self.source = kwargs.pop("source", None)
        kwargs.setdefault("view_group", "LOADER")
        super().__init__(workflow, **kwargs)
        for attr in REFLECTED_ARRAYS:
            setattr(self, attr, Array())
        for attr in REFLECTED_SCALARS:
            setattr(self, attr, 0)
        self.demand("source")

    def initialize(self, **kwargs: Any) -> Optional[bool]:
        retry = super().initialize(**kwargs)
        if retry:
            return retry
        if not getattr(self.source, "minibatch_data", None):
            return True  # source loader not initialized yet
        return None

    def run(self) -> None:
        for attr in REFLECTED_ARRAYS:
            src = getattr(self.source, attr, None)
            if not src:
                continue
            mine: Array = getattr(self, attr)
            if src.devmem_ is not None:
                mine.devmem = src.devmem  # shared, not copied
            else:
                mine.reset(src.map_read().copy())
        for attr in REFLECTED_SCALARS:
            setattr(self, attr, getattr(self.source, attr, 0))
