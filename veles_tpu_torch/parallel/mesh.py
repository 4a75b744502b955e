"""The device mesh over ``torch.distributed``: one process a rank.

Port of ``veles_tpu/parallel/mesh.py``. The reference reshapes a list
of chips into a named grid and lets XLA insert the collectives; here
every rank is a process that holds its own shard, and the grid names
which ranks talk over which axis:

- ``data``  — batch (data parallelism; the gradients are summed over it)
- ``seq``   — sequence (ring attention rotates K/V over it)
- ``model`` — features or experts (tensor and expert parallelism)
- ``pipe``  — layer stages (the GPipe schedule of ``parallel.pipeline``)

The axes keep the reference's order ``(data, seq, model)`` (``pipe``
last), so neighbouring ``seq`` ranks are neighbouring ranks. Building a
mesh creates one process subgroup for every slice of every combination
of the axes larger than 1, on every rank and in the same order (what
``torch.distributed.new_group`` demands of its callers), so no caller
has to. Collectives over a mesh axis are in ``parallel.collectives``.
"""

from __future__ import annotations

import itertools
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from veles_tpu_torch.device import resolve

#: the axis order of every mesh (the reference's, plus ``pipe``)
AXES = ("data", "seq", "model", "pipe")


class MeshConfig:
    """Declarative mesh shape: ``MeshConfig(data=4, model=2)``,
    ``MeshConfig(data=2, seq=4)`` for sequence parallelism, or
    ``MeshConfig(pipe=2)`` for the pipeline."""

    def __init__(self, data: int = 1, model: int = 1, seq: int = 1,
                 pipe: int = 1) -> None:
        self.data = data
        self.model = model
        self.seq = seq
        self.pipe = pipe

    @property
    def n_devices(self) -> int:
        return self.data * self.seq * self.model * self.pipe

    def __repr__(self) -> str:
        text = "MeshConfig(data=%d, seq=%d, model=%d" % (
            self.data, self.seq, self.model)
        return text + (", pipe=%d)" % self.pipe if self.pipe > 1 else ")")


class Axis:
    """One rank's slice along one or more mesh axes: the process group
    (None when the slice is this rank alone), the slice's global ranks
    in group order, and this rank's index among them."""

    def __init__(self, names: Tuple[str, ...], ranks: Sequence[int],
                 index: int, group) -> None:
        self.names = names
        self.ranks = [int(r) for r in ranks]
        self.index = int(index)
        self.group = group

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self) -> str:
        return "Axis(%s, index %d of %d)" % ("x".join(self.names) or "-",
                                             self.index, self.size)


class Mesh:
    """A named grid of ranks (a port ``Mesh``): ``shape`` maps each axis
    name to its size in grid order, ``coords`` this rank's index on
    each, ``device`` the rank's device. :meth:`axis` gives the subgroup
    of a combination of axes."""

    def __init__(self, axes: Dict[str, int], rank: int, device,
                 backend: str, timeout_s: Optional[float] = None) -> None:
        for name in axes:
            if name not in AXES:
                raise ValueError("unknown mesh axis %r (known: %s)"
                                 % (name, ", ".join(AXES)))
        names = tuple(sorted(axes, key=AXES.index))
        self.shape: Dict[str, int] = {n: int(axes[n]) for n in names}
        self.axis_names = names
        self.rank = int(rank)
        self.device = torch.device(device)
        self.backend = backend
        #: every collective's deadline (None: the process group's)
        self.timeout_s = timeout_s
        sizes = tuple(self.shape.values())
        self.ranks = np.arange(int(np.prod(sizes)), dtype=np.int64).reshape(
            sizes)
        self.coords = dict(zip(names, (int(c) for c in np.unravel_index(
            self.rank, sizes)))) if sizes else {}
        self._axes: Dict[Tuple[str, ...], Axis] = {}
        big = [n for n in names if self.shape[n] > 1]
        kwargs = {} if timeout_s is None else {
            "timeout": timedelta(seconds=timeout_s)}
        # every rank walks the same combinations and slices in the same
        # order, creating each group whether or not it is a member
        for k in range(1, len(big) + 1):
            for combo in itertools.combinations(big, k):
                self._axes[combo] = self._build(combo, kwargs)

    def _build(self, combo: Tuple[str, ...], kwargs) -> Axis:
        names = self.axis_names
        keep = [names.index(n) for n in combo]
        rest = [i for i in range(len(names)) if i not in keep]
        slices = np.transpose(self.ranks, rest + keep).reshape(
            -1, int(np.prod([self.shape[n] for n in combo])))
        mine = None
        for ranks in slices:
            group = dist.new_group(ranks=[int(r) for r in ranks], **kwargs)
            if self.rank in ranks:
                mine = Axis(combo, ranks, list(ranks).index(self.rank),
                            group)
        return mine

    def size(self, *names: str) -> int:
        """The number of ranks along ``names`` (1 for an absent axis)."""
        return int(np.prod([self.shape.get(n, 1) for n in names]))

    def index(self, *names: str) -> int:
        """This rank's index along ``names`` (row-major, grid order)."""
        idx = 0
        for n in sorted(names, key=AXES.index):
            idx = idx * self.shape.get(n, 1) + self.coords.get(n, 0)
        return idx

    def axis(self, *names: str) -> Axis:
        """This rank's slice along the axes ``names`` (absent and
        size-1 axes are dropped; a slice of one rank has no group)."""
        combo = tuple(n for n in sorted(set(names), key=AXES.index)
                      if self.shape.get(n, 1) > 1)
        if not combo:
            return Axis((), [self.rank], 0, None)
        return self._axes[combo]

    @property
    def n_devices(self) -> int:
        return int(self.ranks.size)

    def __repr__(self) -> str:
        return "Mesh(%s, rank %d on %s, %s)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()),
            self.rank, self.device, self.backend)


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is None or a :class:`Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a veles_tpu_torch.parallel.mesh.Mesh "
                        "(make_mesh / grid_mesh / Device.mesh over a "
                        "joined process group), got %r" % (mesh,))


def grid_mesh(axes: Dict[str, int], device=None,
              timeout_s: Optional[float] = None) -> Mesh:
    """The single mesh-construction core (also used by ``Device.mesh``):
    the joined process group as a named grid. The sizes must multiply
    to the world size. ``device`` is this rank's device; None takes the
    one ``multiprocess.initialize`` chose, else the current CUDA device.
    Raises without a process group: joining is the caller's
    (``multiprocess.initialize``), never done here."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a mesh needs a joined process group: call "
            "veles_tpu_torch.parallel.multiprocess.initialize(...) (or "
            "torch.distributed.init_process_group) on every rank first")
    world = dist.get_world_size()
    n = int(np.prod(list(axes.values()))) if axes else 1
    if n != world:
        raise ValueError("mesh %r needs %d ranks, the group has %d"
                         % (dict(axes), n, world))
    if device is None:
        from veles_tpu_torch.parallel import multiprocess
        device = multiprocess.device()
    device = resolve(device)
    return Mesh(axes, dist.get_rank(), device, dist.get_backend(),
                timeout_s)


def make_mesh(config: Optional[MeshConfig] = None, device=None,
              timeout_s: Optional[float] = None) -> Mesh:
    """A :class:`Mesh` with the framework's axis names over the joined
    group. With no config, every rank goes on ``data`` (pure data
    parallelism); ``pipe`` appears only when larger than 1."""
    if not (dist.is_available() and dist.is_initialized()):
        grid_mesh({}, device)  # raises the no-group error
    if config is None:
        config = MeshConfig(data=dist.get_world_size())
    axes = {"data": config.data}
    if config.seq > 1:
        axes["seq"] = config.seq
    axes["model"] = config.model
    if config.pipe > 1:
        axes["pipe"] = config.pipe
    return grid_mesh(axes, device, timeout_s)
