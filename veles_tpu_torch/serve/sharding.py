"""SPMD serving: the tensor-parallel layouts of the serve plane.

Port of ``veles_tpu/serve/sharding.py``. The training side already
speaks mesh (``parallel/mesh.py`` axes, the Megatron column/row specs of
``parallel/fused.py:param_specs``, the process group of
``parallel/multiprocess.py``). This module maps the SERVE plane onto
the same ``model`` axis, one process a rank, so an engine runs SPMD
across ``tp`` ranks while every serving invariant survives unchanged
(token-for-token greedy parity with the one-device engines at f32, one
captured decode round at world 1):

- **weights** — Megatron tensor parallelism per block: ``qkv`` and
  ``mlp_in`` column-sharded, ``proj`` and ``mlp_out`` row-sharded;
  embeddings, the positional table and the layer norms replicated (so
  is the tied LM head). The fused ``qkv`` ``[E, 3E]`` is split by
  HEADS: rank r holds the q, k and v columns of its own ``H/tp`` heads,
  three strided blocks (:data:`QKV_HEADS`), where the reference shards
  the matrix contiguously and lets GSPMD reshard it at its ``[3, H,
  Dh]`` view. A rank computing alone cannot reshard, so the layout is
  chosen so that its ``[.., 3, H/tp, Dh]`` view holds whole heads
  (ROADMAP.md queue 3, deliberate divergences).
- **KV** — the slab ``[L, slots, cap, H, Dh]`` and the page pool
  ``[L, n_pages, page_size, H, Dh]`` are partitioned over the HEADS
  axis: each rank holds ``H/tp`` heads of every page, so its KV bytes
  divide by tp and the pool is sized per shard.
- **control state** — block tables, lengths, last tokens, sampling
  state, active masks: replicated. The engine on the ``model`` axis's
  first rank (the leader) decides them and broadcasts each device call
  with its host inputs; the other ranks follow (``serve/engine.py``).

A sharding here is a :class:`NamedSharding`: a mesh and a
``PartitionSpec``-like tuple (an axis name or None a dim). The
``place_*`` and ``zeros_*`` functions give THIS rank its shard on the
mesh's device; no full-size host buffer is built for zeros.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from veles_tpu_torch.parallel.mesh import MeshConfig, check_mesh, make_mesh

#: The mesh axis serving shards over (tensor parallelism). Serve
#: meshes may carry other axes (``data`` of size >= 1 from
#: ``make_mesh``); the serve plane replicates over them.
MODEL_AXIS = "model"

#: the marker of the fused ``qkv`` layout: the trailing dim is three
#: blocks (q, k, v), each split over ``model`` by heads
QKV_HEADS = "model/qkv"


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """Parse a ``--serve-mesh`` value: ``"tp=2"`` (comma-separated
    ``key=int`` pairs; only ``tp`` is understood today — the serving
    plane shards heads, long-context sequence parallelism stays on
    the training path). Returns ``{"tp": N}``."""
    out: Dict[str, int] = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                "--serve-mesh wants key=int pairs ('tp=2'), got %r"
                % (spec,))
        key, _, value = part.partition("=")
        key = key.strip().lower()
        if key != "tp":
            raise ValueError(
                "--serve-mesh axis %r is not supported (only 'tp': "
                "the serve plane shards attention heads; seq/data "
                "parallel serving is more replicas, not a mesh axis)"
                % key)
        try:
            out[key] = int(value)
        except ValueError:
            raise ValueError("--serve-mesh %s=%r is not an int"
                             % (key, value.strip()))
        if out[key] < 1:
            raise ValueError("--serve-mesh tp must be >= 1, got %d"
                             % out[key])
    if "tp" not in out:
        raise ValueError("--serve-mesh needs tp=N, got %r" % (spec,))
    return out


def serve_mesh(tp: int, device=None, timeout_s: Optional[float] = None):
    """A mesh for a sharded serving replica over the joined process
    group: ``tp`` ranks on the ``model`` axis, the remaining ones (if
    any) on ``data`` (the serve specs name only ``model``, so ``data``
    is replication: each ``model`` slice is a replica with a leader of
    its own). Every rank calls it. ``device`` as ``make_mesh``'s (None:
    the one ``multiprocess.initialize`` chose); ``timeout_s`` bounds
    every collective of the mesh. Raises without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        make_mesh(None, device)  # raises the no-group error
    world = dist.get_world_size()
    tp = int(tp)
    if tp < 1:
        raise ValueError("tp must be >= 1, got %d" % tp)
    if world % tp:
        raise ValueError(
            "serve mesh tp=%d does not divide the %d rank(s) of the "
            "group" % (tp, world))
    return make_mesh(MeshConfig(data=world // tp, model=tp), device,
                     timeout_s)


def mesh_tp(mesh) -> int:
    """Tensor-parallel degree of a serve mesh (size of the ``model``
    axis; 1 when the axis is absent)."""
    return int(dict(getattr(mesh, "shape", {})).get(MODEL_AXIS, 1))


def validate_serve_mesh(mesh, config, draft_config=None) -> int:
    """The loud misuse gate for sharded engines: the mesh must carry
    the ``model`` axis and its size must divide the head count (and
    the draft model's head count, when speculation is configured) —
    head-partitioned KV needs whole head groups per shard. Returns
    the validated tp degree."""
    axes = tuple(getattr(mesh, "axis_names", ()))
    if MODEL_AXIS not in axes:
        raise ValueError(
            "sharded engine needs a mesh with a %r axis (got axes "
            "%r) — build one with serve_mesh(tp) or "
            "parallel.mesh.make_mesh(MeshConfig(model=tp))"
            % (MODEL_AXIS, axes))
    tp = mesh_tp(mesh)
    for label, cfg in (("model", config), ("draft model", draft_config)):
        if cfg is None:
            continue
        if int(cfg.heads) % tp:
            raise ValueError(
                "sharded engine misuse: %s has %d heads, not "
                "divisible by mesh tp=%d — KV is partitioned over "
                "the heads axis, so every shard needs whole head "
                "groups (pick tp dividing heads, or mesh=None for "
                "the single-device engine)"
                % (label, int(cfg.heads), tp))
    return tp


def mesh_signature(mesh) -> Dict[str, Any]:
    """Mesh topology for config fingerprints: axis names + sizes,
    device count and process count (from ``torch.distributed``)."""
    return {
        "axes": [[name, int(size)]
                 for name, size in dict(mesh.shape).items()],
        "devices": int(np.prod([int(s)
                                for s in dict(mesh.shape).values()])),
        "processes": int(dist.get_world_size()
                         if dist.is_available() and dist.is_initialized()
                         else 1),
    }


class NamedSharding:
    """A mesh and a spec: one entry a dim, an axis name (the dim split
    evenly over that axis, this rank taking its index's block), None
    (replicated), or :data:`QKV_HEADS` (the trailing dim of the fused
    ``qkv``: three blocks, each split over ``model``)."""

    def __init__(self, mesh, spec: Tuple[Any, ...] = ()) -> None:
        check_mesh(mesh)
        self.mesh = mesh
        self.spec = tuple(spec)

    def _entries(self, ndim: int) -> Tuple[Any, ...]:
        if len(self.spec) > ndim:
            raise ValueError("spec %r has more entries than the %d dims"
                             % (self.spec, ndim))
        return self.spec + (None,) * (ndim - len(self.spec))

    def index(self, shape) -> Tuple[Any, ...]:
        """This rank's index into a global array of ``shape``: a slice
        a dim, or an index array for a :data:`QKV_HEADS` dim."""
        out = []
        for dim, name in enumerate(self._entries(len(shape))):
            if name is None:
                out.append(slice(None))
                continue
            axis = MODEL_AXIS if name == QKV_HEADS else name
            n, i = self.mesh.size(axis), self.mesh.index(axis)
            size = int(shape[dim])
            blocks = 3 if name == QKV_HEADS else 1
            if size % (blocks * n):
                raise ValueError("dim %d of %s does not split %d ways "
                                 "over %r" % (dim, tuple(shape),
                                              blocks * n, axis))
            if blocks == 1:
                step = size // n
                out.append(slice(i * step, (i + 1) * step))
            else:
                width = size // 3
                step = width // n
                out.append(np.concatenate([
                    np.arange(b * width + i * step,
                              b * width + (i + 1) * step)
                    for b in range(3)]))
        return tuple(out)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shape of this rank's shard of a global ``shape``."""
        out = []
        for dim, idx in enumerate(self.index(shape)):
            if isinstance(idx, slice):
                start, stop, _ = idx.indices(int(shape[dim]))
                out.append(stop - start)
            else:
                out.append(len(idx))
        return tuple(out)

    def __repr__(self) -> str:
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _block_spec(key: str, ndim: int) -> Tuple[Any, ...]:
    if key == "qkv":
        return (None,) * (ndim - 1) + (QKV_HEADS,)
    if key == "mlp_in":
        # column parallel: shard the output-features dim
        return (None,) * (ndim - 1) + (MODEL_AXIS,)
    if key in ("proj", "mlp_out"):
        # row parallel: shard the input-features (contraction) dim
        return (None,) * (ndim - 2) + (MODEL_AXIS, None)
    return ()


def transformer_param_shardings(mesh, params):
    """A sharding tree congruent with a transformer param tree
    (``models/transformer.py:init_params``): Megatron column/row
    alternation on the block weights (``qkv`` by heads), everything
    else replicated. MoE experts keep the same column/row split on
    their trailing matmul dims (the leading experts dim stays whole —
    expert parallelism is a different axis)."""
    def blocks(block):
        return {key: (NamedSharding(mesh, _block_spec(
            key, len(np.shape(leaf)))) if not isinstance(leaf, dict)
            else {k: replicated(mesh) for k in leaf})
            for key, leaf in block.items()}

    return {key: ([blocks(b) for b in node] if key == "blocks" else
                  {k: replicated(mesh) for k in node}
                  if isinstance(node, dict) else replicated(mesh))
            for key, node in params.items()}


def mlp_param_shardings(mesh, specs, params):
    """A sharding list for an ``InferenceEngine.from_specs`` param
    list: the training side's Megatron alternation
    (``parallel/fused.py:param_specs`` with ``tensor_parallel=True``)
    for the fc/conv entries; any layer it does not cover (normalize
    state, the loss tail) is replicated."""
    from veles_tpu_torch.parallel.fused import normalize_specs, param_specs
    base = param_specs(normalize_specs(specs), tensor_parallel=True)
    out: List[Dict[str, Any]] = []
    for i, layer in enumerate(params):
        layer_specs = base[i] if i < len(base) else {}
        out.append({key: NamedSharding(mesh, layer_specs.get(key, ()))
                    for key in layer})
    return out


def kv_cache_shardings(mesh) -> Dict[str, NamedSharding]:
    """Head-partitioned KV sharding, one spec for both planes: the
    slab ``[L, slots, cap, H, Dh]`` and the page pool
    ``[L, n_pages, page_size, H, Dh]`` both carry heads at axis 3."""
    ns = NamedSharding(mesh, (None, None, None, MODEL_AXIS, None))
    return {"k": ns, "v": ns}


def place_host(sharding: NamedSharding, arr, dtype=None) -> torch.Tensor:
    """This rank's shard of a host array (numpy, or a tensor, the same
    on every rank) under ``sharding``, on the mesh's device: only the
    shard crosses to the device. ``dtype`` (None: the array's; a numpy
    array keeps its own, a tensor its own)."""
    if isinstance(arr, torch.Tensor):
        host = arr.detach()
        part = host[tuple(torch.as_tensor(i) if isinstance(i, np.ndarray)
                          else i for i in sharding.index(host.shape))]
        part = part.to(device=sharding.mesh.device, copy=True)
    else:
        host = np.asarray(arr)
        part = np.ascontiguousarray(host[sharding.index(host.shape)])
        part = torch.from_numpy(part).to(sharding.mesh.device)
    return part if dtype is None else part.to(dtype)


def place_tree(shardings, tree, dtype=None):
    """:func:`place_host` over a whole (params) tree with a congruent
    sharding tree."""
    if isinstance(tree, dict):
        return {key: place_tree(shardings[key], node, dtype)
                for key, node in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [place_tree(sh, node, dtype)
                for sh, node in zip(shardings, tree)]
    return place_host(shardings, tree, dtype)


def zeros_global(shape, dtype, sharding: NamedSharding) -> torch.Tensor:
    """This rank's all-zeros shard of a global array of ``shape``,
    made on the device (no host buffer)."""
    return torch.zeros(sharding.shard_shape(tuple(int(s) for s in shape)),
                       dtype=dtype, device=sharding.mesh.device)


def zeros_tree(shardings, tree):
    """Sharded zeros congruent with ``tree``, whose leaves give the
    GLOBAL shapes and dtypes (tensors, e.g. on the ``meta`` device)."""
    if isinstance(tree, dict):
        return {key: zeros_tree(shardings[key], node)
                for key, node in tree.items()}
    return zeros_global(tree.shape, tree.dtype, shardings)


def control_group(mesh, timeout_s: Optional[float]):
    """A gloo group of this rank's ``model`` slice whose waits last
    ``timeout_s`` (None: the process group's): the leader's call
    broadcasts and their acknowledgements, on host objects whatever the
    mesh's backend. Every rank of the world calls this, in the same
    order, since ``new_group`` demands it. None for a slice of one
    rank."""
    names = mesh.axis_names
    keep = names.index(MODEL_AXIS)
    rest = [i for i in range(len(names)) if i != keep]
    slices = np.transpose(mesh.ranks, rest + [keep]).reshape(
        -1, mesh.size(MODEL_AXIS))
    if slices.shape[1] == 1:
        return None
    kwargs = {} if timeout_s is None else {
        "timeout": timedelta(seconds=timeout_s)}
    mine = None
    for ranks in slices:
        group = dist.new_group(ranks=[int(r) for r in ranks],
                               backend="gloo", **kwargs)
        if mesh.rank in ranks:
            mine = group
    return mine
