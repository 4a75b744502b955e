"""Fused classifier training on one device, and the trainers'
non-finite sentinel.

Port of ``veles_tpu/parallel/fused.py``: :func:`normalize_specs`,
:func:`_apply` (the forward: conv, FC, pooling, LRN, dropout),
:func:`_loss_fn` (masked softmax cross-entropy), :func:`_train_step`
(autograd backward, SGD with momentum and weight decay, the in-
arithmetic ``skip`` policy), :func:`_train_multi_step` and
:class:`FusedClassifierTrainer`, with ``update_ok`` and the sentinel
that the transformer trainer shares. The reference compiles a step
into one XLA computation; here it is the same sequence of ops run
eagerly, and the update writes the params and momentum in place.

Layer specs are the reference's tuples: ``("fc", act)``, ``("conv",
act, strides_hw, padding)``, ``("pool", kind, ky, kx, strides_hw)``,
``("lrn", k, n, alpha, beta)``, ``("dropout", ratio)``; a bare
activation string means ``("fc", act)``. Params are a list of
``{"w", "b"}`` dicts (``{}`` for parameterless layers) in the
reference's layout: HWIO conv weights, ``[in, out]`` FC weights.

Dropout masks come from ``ops.rng.uniform_fill`` (the K8 kernel on the
card), keyed by ``fold_in(fold_in(dropout_seed, step), layer)`` where
the reference folds its JAX key the same way: a mask depends on
nothing else, so :meth:`FusedClassifierTrainer.step_many` equals K
calls of :meth:`~FusedClassifierTrainer.step` bitwise. The draws are
not JAX's (the reference's own masks already differ between its
threefry and TPU rbg generators); at dropout ratio 0 both sides are
the identity.

:meth:`FusedClassifierTrainer.make_loader_step` folds a
``FullBatchLoader``'s device gather into the step: the loader keeps
its host bookkeeping (``external_gather``) and the step gathers and
normalizes its window through ``FullBatchLoader.gather``, one step a
call or K a call (``steps_per_dispatch``), on the same counters,
dropout keys and learning rates as ``step``/``step_many``.

A trainer whose ``sched_tenant`` is set runs each ``step``/``step_many``
and each loader-step dispatch as one quantum of a shared device
(``veles_tpu_torch.sched``).

:func:`fuse_forwards`, ``FusedClassifierTrainer.from_forwards``,
:meth:`~FusedClassifierTrainer.write_back` and :func:`train_fused`
carry a unit graph's forward stack onto this plane and back.

Over a mesh (``parallel.mesh``; ``mesh=``, ``tensor_parallel=``) the
trainer is SPMD, one process a rank: data parallelism over ``data``
and the reference's Megatron layout (:func:`param_specs`) over
``model``, with the collectives written out (``parallel.collectives``)
where the reference's GSPMD inserts them.

Under an AOT plan (``aot/warmup.py``) the first dispatch of each
``step_many`` shape and of each loader step hands its record to the
plan (``mlp_step_many/...``, ``loader_step_many/...``); the dispatch
runs as it would without one, so a planned run is bitwise an
unplanned one.
"""

from __future__ import annotations

import contextlib
import logging
from collections import deque
from functools import partial
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from veles_tpu_torch import graphs
from veles_tpu_torch.aot import export as aot_export
from veles_tpu_torch.aot import warmup as aot_warmup
from veles_tpu_torch.config import get, root
from veles_tpu_torch.device import compute_dtype as _dtype_of
from veles_tpu_torch.device import resolve
from veles_tpu_torch.nn.activation import ACTIVATIONS
from veles_tpu_torch.nn.conv import conv_raw, conv_s2d_raw
from veles_tpu_torch.nn.lr_policy import make_policy
from veles_tpu_torch.nn.lrn import lrn_raw
from veles_tpu_torch.nn.pooling import pool_raw
from veles_tpu_torch.obs import profile as obs_profile
from veles_tpu_torch.ops import _build, launches
from veles_tpu_torch.ops.rng import fold_in, uniform_fill
from veles_tpu_torch.parallel import collectives
from veles_tpu_torch.parallel.mesh import check_mesh
from veles_tpu_torch.sched import quantum_or_null


def update_ok(loss: torch.Tensor, grads: Iterable[torch.Tensor]
              ) -> torch.Tensor:
    """On-device sentinel: a 0-d bool tensor, True iff the loss and
    every gradient are finite. Detection is one ``isfinite(sum(g))``
    reduce per gradient (a single non-finite element makes the f32 sum
    non-finite), not an elementwise scan."""
    ok = torch.isfinite(loss)
    for g in grads:
        ok = ok & torch.isfinite(g.float().sum())
    return ok


class NonFiniteUpdate(RuntimeError):
    """``nan_policy="raise"``: a train step produced a non-finite
    loss or gradient."""


class NonFiniteSentinel:
    """Host-side policy enforcement for the on-device non-finite flag.

    Every policy accumulates the per-dispatch flag into a DEVICE
    scalar (no host sync; read it via :attr:`count`). ``raise`` reads
    the flag at once — a debugging policy: the read waits for the
    step. ``warn`` reads flags LAGGED: a flag is only read after
    :data:`LAG` further dispatches were enqueued, by which point its
    step has long finished, so the host keeps running ahead of the
    card. ``skip`` never reads (the skipping itself happens in the
    update's arithmetic)."""

    #: dispatches a warn-policy flag ages before the host reads it
    LAG = 4

    def __init__(self, policy: str, name: str) -> None:
        if policy not in ("raise", "skip", "warn"):
            raise ValueError(
                "nan_policy must be raise|skip|warn, got %r"
                % (policy,))
        self.policy = policy
        self._name = name
        self._total_dev: Optional[torch.Tensor] = None
        self._pending: "deque[torch.Tensor]" = deque()

    def note(self, flag: torch.Tensor) -> None:
        """Record one dispatch's nonfinite flag (``[]`` or ``[K]`` int32
        device tensor) and enforce the policy."""
        total = flag.sum()
        self._total_dev = total if self._total_dev is None else \
            self._total_dev + total
        if self.policy == "raise":
            n = int(total)
            if n:
                raise NonFiniteUpdate(
                    "%d train step(s) in this dispatch produced a "
                    "non-finite loss or gradient" % n)
        elif self.policy == "warn":
            self._pending.append(total)
            while len(self._pending) > self.LAG:
                self._emit(int(self._pending.popleft()))

    def _emit(self, n: int) -> None:
        if n:
            logging.getLogger(self._name).warning(
                "non-finite loss/gradient in %d train step(s) "
                "(update applied; nan_policy=warn)", n)

    @property
    def count(self) -> int:
        """Cumulative non-finite steps (reading syncs the device
        accumulator and flushes pending warnings)."""
        while self._pending:
            self._emit(int(self._pending.popleft()))
        return 0 if self._total_dev is None else int(self._total_dev)


# ---------------------------------------------------------------------------
# the step, as functions of (specs, params, batch)
# ---------------------------------------------------------------------------

def normalize_specs(specs: Sequence[Any]) -> Tuple[Any, ...]:
    return tuple(("fc", s) if isinstance(s, str) else tuple(s)
                 for s in specs)


def fuse_forwards(forwards: Sequence[Any]) -> Tuple[Tuple[Any, ...],
                                                    List[Dict[str, Any]]]:
    """(layer specs, host params) of a stack of forward units (conv,
    all2all, pooling, LRN, dropout), the params as numpy copies in the
    reference's layouts; parameterless layers get ``{}``."""
    from veles_tpu_torch.nn.all2all import All2All
    from veles_tpu_torch.nn.conv import Conv
    from veles_tpu_torch.nn.dropout import Dropout
    from veles_tpu_torch.nn.lrn import LRNormalizerForward
    from veles_tpu_torch.nn.pooling import Pooling
    specs: List[Any] = []
    params: List[Dict[str, Any]] = []

    def host_params(unit):
        return {"w": np.array(unit.weights.map_read()),
                "b": np.array(unit.bias.map_read())}

    for unit in forwards:
        if isinstance(unit, Conv):
            specs.append(("conv", unit.ACTIVATION, tuple(unit.strides_hw),
                          unit.padding))
            params.append(host_params(unit))
        elif isinstance(unit, All2All):
            specs.append(("fc", unit.ACTIVATION))
            params.append(host_params(unit))
        elif isinstance(unit, Pooling):
            specs.append(("pool", unit.KIND, unit.ky, unit.kx,
                          tuple(unit.strides_hw)))
            params.append({})
        elif isinstance(unit, LRNormalizerForward):
            specs.append(("lrn", unit.k, unit.n, unit.alpha, unit.beta))
            params.append({})
        elif isinstance(unit, Dropout):
            specs.append(("dropout", unit.dropout_ratio))
            params.append({})
        else:
            raise TypeError("cannot fuse unit %r" % (unit,))
    return tuple(specs), params


def _fc(h, w, b, compute_dtype, out_dtype):
    """The reference's ``jnp.dot(h, w, preferred_element_type=f32)
    .astype(out_dtype) + b``: operands rounded to the compute dtype,
    f32 accumulation. An f32 result (the logits head) takes the
    product in f32 on the rounded operands; a compute-dtype result is
    the compute-dtype product (f32 accumulation, one rounding). ``b``
    None: no bias."""
    h2 = h.reshape(h.shape[0], -1).to(compute_dtype)
    wc = w.to(compute_dtype)
    if out_dtype != compute_dtype:
        z = (h2.float() @ wc.float()).to(out_dtype)
    else:
        z = h2 @ wc
    return z if b is None else z + b.to(out_dtype)


def param_specs(specs: Tuple[Any, ...], tensor_parallel: bool):
    """The reference's PartitionSpecs as tuples (an axis name or None a
    dim): pure data parallelism replicates everything; tensor
    parallelism alternates the sharded dim per *parametric* layer
    (Megatron column then row for FC, output then input channels for
    conv), one psum a pair."""
    out = []
    parametric_idx = 0
    for spec in specs:
        kind = spec[0]
        if kind not in ("fc", "conv"):
            out.append({})
            continue
        if not tensor_parallel:
            out.append({"w": (), "b": ()})
        elif parametric_idx % 2 == 0:   # shard output features/channels
            w = (None, "model") if kind == "fc" else \
                (None, None, None, "model")
            out.append({"w": w, "b": ("model",)})
        else:                           # shard input features/channels
            w = ("model", None) if kind == "fc" else \
                (None, None, "model", None)
            out.append({"w": w, "b": ()})
        parametric_idx += 1
    return out


class _Shards:
    """A classifier's place on a mesh: its ``data`` rows and, under
    tensor parallelism, its ``model`` shards (the layouts of
    :func:`param_specs`, the role of each parametric layer: "col"
    shards the output channels, "row" the input channels)."""

    def __init__(self, mesh, specs, tensor_parallel: bool) -> None:
        self.mesh = mesh
        self.data = mesh.axis("data")
        self.model = mesh.axis("model") if tensor_parallel else \
            mesh.axis()
        self.pspecs = param_specs(specs, self.model.size > 1)
        self.roles = [None if not p or not p["w"] else
                      ("col" if p["w"][-1] == "model" else "row")
                      for p in self.pspecs]

    def rows(self, x):
        """This rank's rows of a global batch (dim 0 over ``data``)."""
        n = self.data.size
        if x.shape[0] % n:
            raise ValueError("a batch of %d does not split over 'data' %d"
                             % (x.shape[0], n))
        step = x.shape[0] // n
        return x[self.data.index * step:(self.data.index + 1) * step]

    def local(self, leaf, spec):
        """This rank's shard of a whole leaf under ``spec``."""
        for dim, name in enumerate(spec):
            if name is not None:
                n = self.model.size
                if leaf.shape[dim] % n:
                    raise ValueError("dim %d of %s does not split over "
                                     "'model' %d" % (dim,
                                                     tuple(leaf.shape), n))
                step = leaf.shape[dim] // n
                idx = [slice(None)] * leaf.ndim
                idx[dim] = slice(self.model.index * step,
                                 (self.model.index + 1) * step)
                leaf = leaf[tuple(idx)]
        return leaf


def _gather_channels(h, shards):
    """A channel-sharded activation made whole (varying: the ranks'
    cotangents of it are summed back by the gather's transpose). The
    operations that need the whole channel axis (LRN, the flatten into
    a row-sharded FC) take it here, where GSPMD reshards in the
    reference."""
    return collectives.all_gather(h, shards.model, h.ndim - 1)


def _apply(specs: Tuple[Any, ...], train: bool, params, x, key: int,
           compute_dtype: torch.dtype, kernel_impl: Optional[str] = None,
           shards: Optional[_Shards] = None, masks: Optional[list] = None):
    """Forward pass; a softmax tail returns LOGITS (the loss takes
    log_softmax). Inter-layer activations live in the compute dtype,
    the logits head in the params' dtype (f32). ``key`` is the step's
    dropout seed (unused unless ``train``); ``kernel_impl`` goes to the
    LRN and fill wrappers.

    ``shards`` (a mesh): ``x`` is this rank's rows and ``params`` its
    shards. A column layer computes its output channels; a row layer
    its input channels' partial product, summed over ``model``
    (``psum``); an activation held alike by every ``model`` rank enters
    a column layer through ``pvary``. LRN, the flatten into a row FC
    and a sharded logits head gather the channels first. Dropout fills
    the mask of the GLOBAL activation (K8, the one-rank key) and takes
    this rank's rows and channels, so the masks are the one-rank masks.
    ``masks``: a list that receives each dropout's keep mask."""
    h = x.to(compute_dtype)
    if h.ndim == 3:
        h = h[..., None]
    last_parametric = max(
        (i for i, s in enumerate(specs) if s[0] in ("fc", "conv")),
        default=-1)
    model = shards.model if shards is not None else None
    tp = model is not None and model.size > 1
    sharded = False     # channels split over ``model`` (else whole)
    invariant = True    # the same on every ``model`` rank
    for i, (spec, p) in enumerate(zip(specs, params)):
        kind = spec[0]
        last = i == last_parametric
        role = shards.roles[i] if tp else None
        if kind in ("fc", "conv"):
            out_dtype = p["w"].dtype if last else compute_dtype
            if role == "col":
                if sharded:
                    h, sharded, invariant = (_gather_channels(h, shards),
                                             False, False)
                if invariant and h.requires_grad:
                    h = collectives.pvary(h, model)
            elif role == "row":
                if kind == "fc" and h.ndim > 2:
                    if sharded:
                        h = _gather_channels(h, shards)
                    elif invariant:
                        h = collectives.pvary(h, model)
                    h = h.reshape(h.shape[0], -1).chunk(
                        model.size, dim=1)[model.index]
                elif not sharded:
                    if invariant:
                        h = collectives.pvary(h, model)
                    h = h.chunk(model.size, dim=-1)[model.index]
            bias = None if role == "row" else p["b"]
        if kind == "fc":
            act = spec[1]
            z = _fc(h, p["w"], bias, compute_dtype, out_dtype)
        elif kind == "conv":
            _, act, strides, padding = spec
            # space-to-depth for strided few-channel stems (conv1), as
            # the reference chooses it
            s2d_ok = (strides[0] == strides[1] and strides[0] > 1 and
                      h.shape[-1] * strides[0] ** 2 <= 256 and
                      p["w"].shape[2] == h.shape[-1] and
                      isinstance(padding, (tuple, list)) and
                      padding[0][0] == padding[0][1] and
                      padding[1][0] == padding[1][1])
            conv_fn = conv_s2d_raw if s2d_ok else conv_raw
            z = conv_fn(h, p["w"], bias, strides, padding, compute_dtype,
                        out_dtype=out_dtype)
        elif kind == "pool":
            _, pkind, ky, kx, strides = spec
            h = pool_raw(pkind, ky, kx, strides, h)
        elif kind == "lrn":
            _, k, n, alpha, beta = spec
            if sharded:
                h, sharded, invariant = (_gather_channels(h, shards), False,
                                         False)
            h = lrn_raw(h, k, n, alpha, beta, impl=kernel_impl)
        elif kind == "dropout":
            if train:
                keep = 1.0 - spec[1]
                shape = tuple(h.shape)
                if shards is not None:
                    shape = (shape[0] * shards.data.size,) + shape[1:-1] + (
                        shape[-1] * (model.size if sharded else 1),)
                fill = uniform_fill(fold_in(key, i), shape,
                                    device=h.device, impl=kernel_impl)
                if shards is not None:
                    fill = shards.rows(fill)
                    if sharded:
                        fill = fill.chunk(model.size, dim=-1)[model.index]
                mask = fill < keep
                if masks is not None:
                    masks.append(mask)
                h = h * (mask.to(h.dtype) / keep)
        else:
            raise ValueError("unknown fused layer kind %r" % (kind,))
        if kind in ("fc", "conv"):
            if role == "row":
                z = collectives.psum(z, model) + p["b"].to(out_dtype)
                sharded, invariant = False, True
            elif role == "col":
                sharded, invariant = True, False
            h = z if act == "softmax" else ACTIVATIONS[act](z)
    if sharded:
        h = collectives.all_gather_invariant(h, model, h.ndim - 1)
    return h


def _loss_fn(specs, train, params, x, labels, key, compute_dtype,
             kernel_impl=None, shards=None, n_valid=None, masks=None):
    """Mean softmax cross-entropy over the rows with ``labels >= 0``
    (padding rows carry -1); returns (loss, logits). ``n_valid``: the
    count to divide by (a mesh rank's rows count toward the GLOBAL
    batch's mean; default: these rows' count)."""
    logits = _apply(specs, train, params, x, key, compute_dtype,
                    kernel_impl, shards, masks)
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1).gather(1, safe[:, None])[:, 0]
    if n_valid is None:
        n_valid = valid.sum().clamp_min(1)
    loss = -(logp * valid).sum() / n_valid
    return loss, logits


def _leaves(params) -> List[torch.Tensor]:
    return [t for p in params if p for t in (p["w"], p["b"])]


def _train_step(specs, params, velocity, x, labels, key, lr: float,
                weight_decay: float, momentum: float, compute_dtype,
                skip_nonfinite: bool = False,
                kernel_impl: Optional[str] = None,
                shards: Optional[_Shards] = None, n_valid=None,
                masks: Optional[list] = None):
    """One step in place on ``params`` and ``velocity``: forward, loss,
    autograd backward, then ``v = momentum v - lr (g + wd w)`` (no
    decay on biases) and ``p += v``. Returns (loss, n_err, nonfinite)
    as 0-d device tensors. On a mesh (``shards``; ``x``/``labels`` this
    rank's rows, ``n_valid`` the global batch's valid rows) the
    gradients, the loss and the error count are summed over ``data``
    by ONE all-reduce of one flat buffer before the update."""
    loss, logits = _loss_fn(specs, True, params, x, labels, key,
                            compute_dtype, kernel_impl, shards, n_valid,
                            masks)
    grads = torch.autograd.grad(loss, _leaves(params))
    loss = loss.detach()
    valid = labels >= 0
    n_err = (valid & (logits.detach().argmax(dim=-1) != labels)).sum()
    if shards is not None and shards.data.size > 1:
        summed = collectives.sum_flat(
            list(grads) + [loss[None], n_err.float()[None]], shards.data)
        grads, loss, n_err = summed[:-2], summed[-2][0], summed[-1][0]
    with torch.no_grad():
        ok = update_ok(loss, grads)
        if skip_nonfinite:
            # nan_policy="skip", in the arithmetic as the reference: on
            # a bad step g = 0, momentum 1 and lr 0 make nv == v bitwise,
            # and the 0-valued gate makes p + 0*nv == p bitwise
            okf = ok.float()
            momentum = torch.where(ok, momentum, 1.0)
            lr = torch.where(ok, lr, 0.0)
        g_iter = iter(grads)
        for p, v in zip(params, velocity):
            if not p:
                continue
            gw, gb = next(g_iter), next(g_iter)
            if skip_nonfinite:
                gw = torch.where(ok, gw, torch.zeros((), dtype=gw.dtype,
                                                     device=gw.device))
                gb = torch.where(ok, gb, torch.zeros((), dtype=gb.dtype,
                                                     device=gb.device))
            nv_w = momentum * v["w"] - lr * (gw + weight_decay * p["w"])
            nv_b = momentum * v["b"] - lr * gb
            v["w"].copy_(nv_w)
            v["b"].copy_(nv_b)
            if skip_nonfinite:
                p["w"].copy_(p["w"] + okf * nv_w)
                p["b"].copy_(p["b"] + okf * nv_b)
            else:
                p["w"].copy_(p["w"] + nv_w)
                p["b"].copy_(p["b"] + nv_b)
    return loss, n_err.to(torch.int32), (~ok).to(torch.int32)


def _train_multi_step(specs, params, velocity, xs, labels, key: int,
                      counters, lrs, weight_decay, momentum, compute_dtype,
                      skip_nonfinite=False, kernel_impl=None, local=None):
    """K steps over ``xs``/``labels`` ([K, B, ...]), step k's dropout
    seed folded from ``counters[k]`` and its learning rate ``lrs[k]``:
    the same ops as K :func:`_train_step` calls. Returns the [K] losses,
    error counts and non-finite flags. ``local``: a mesh rank's
    ``(x, labels) -> (x, labels, shards, n_valid)``."""
    out = []
    for x, lbl, c, lr in zip(xs, labels, counters, lrs):
        extra = ()
        if local is not None:
            x, lbl, *extra = local(x, lbl)
        out.append(_train_step(specs, params, velocity, x, lbl,
                               fold_in(key, c), lr, weight_decay, momentum,
                               compute_dtype, skip_nonfinite, kernel_impl,
                               *extra))
    return tuple(torch.stack(m) for m in zip(*out))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

class FusedClassifierTrainer:
    """Owns f32 params and momentum on one device; one train step =
    forward + masked cross-entropy + backward + SGD update, in place.

    >>> specs, params, _ = alexnet_fused()
    >>> trainer = FusedClassifierTrainer(specs, params, device="cuda",
    ...                                  learning_rate=0.01)
    >>> metrics = trainer.step(x_batch, labels)   # NHWC f32, int

    ``compute_dtype``: activations' dtype, None = bfloat16 on a CUDA
    device and float32 elsewhere (the reference's accelerator policy);
    params, momentum and the logits stay f32. ``kernel_impl``: "cuda"
    (the LRN kernels K6/K7 and the fill kernel K8), "plain" (their
    plain PyTorch versions, on any device), or None = the kernels on a
    CUDA device; on the CPU, None runs the reference's lax LRN
    formulation (``nn.lrn``). ``nan_policy`` as in
    :class:`NonFiniteSentinel`; None reads
    ``root.common.train.nan_policy`` (default "warn").

    ``steps_per_dispatch``: the K of :meth:`make_loader_step`'s
    dispatches (default 1).

    ``sched_tenant`` (a ``TenantHandle``, None = free-running): every
    ``step``/``step_many`` and loader-step dispatch runs as ONE
    scheduler quantum, with
    the same counters, dropout keys and learning-rate stream, so the
    trajectory stays bitwise that of an unscheduled run.

    ``mesh`` (a ``parallel.mesh.Mesh``; its device is the trainer's):
    SPMD over its ranks, every rank calling :meth:`step` with the same
    GLOBAL batch. The rows shard over ``data``; ``tensor_parallel``
    shards the params over ``model`` as the reference's
    :func:`param_specs` place them, each rank holding exactly its
    shards. The loss is the mean over the global batch, and the
    gradients are summed over ``data`` by one all-reduce of one flat
    buffer a step.
    """

    def __init__(self, specs: Sequence[Any], params: List[Dict[str, Any]],
                 learning_rate: float = 0.1, weight_decay: float = 0.0,
                 momentum: float = 0.9, lr_policy=None, compute_dtype=None,
                 dropout_seed: int = 0, steps_per_dispatch: int = 1,
                 nan_policy: Optional[str] = None,
                 kernel_impl: Optional[str] = None, device=None,
                 mesh=None, tensor_parallel: bool = False) -> None:
        check_mesh(mesh)
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError("device %s is not the mesh's %s"
                                 % (device, mesh.device))
            device = mesh.device
        elif tensor_parallel:
            raise ValueError("tensor_parallel needs a mesh")
        self.device = resolve(device)
        if steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1, got %d" %
                             steps_per_dispatch)
        #: K steps a dispatch of :meth:`make_loader_step` (its default);
        #: :meth:`step_many` takes any K a call
        self.steps_per_dispatch = int(steps_per_dispatch)
        if nan_policy is None:
            nan_policy = get(root.common.train.nan_policy, "warn")
        if kernel_impl is not None:
            _build.resolve_impl(kernel_impl, self.device, "kernel_impl")
        self.kernel_impl = kernel_impl
        self.lr_policy = make_policy(lr_policy)
        self.epoch = 0  # callers may advance for epoch-based policies
        self.specs = normalize_specs(specs)
        if len(params) != len(self.specs):
            raise ValueError("%d param entries for %d layer specs"
                             % (len(params), len(self.specs)))
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dropout_seed = int(dropout_seed)
        self.mesh = mesh
        self.tensor_parallel = bool(tensor_parallel)
        self._shards = None if mesh is None else _Shards(
            mesh, self.specs, self.tensor_parallel)
        #: a list to receive each step's dropout keep masks (this rank's
        #: part), or None
        self.record_masks: Optional[list] = None
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.device.type == "cuda" \
                else torch.float32
        elif isinstance(compute_dtype, str):
            compute_dtype = _dtype_of(compute_dtype)
        self.compute_dtype = compute_dtype
        self._sentinel = NonFiniteSentinel(nan_policy,
                                           "FusedClassifierTrainer")
        self.nan_policy = nan_policy
        #: multi-tenant device sharing (veles_tpu_torch.sched): when set
        #: to a TenantHandle, every step/step_many dispatch runs as ONE
        #: scheduler quantum
        self.sched_tenant = None
        #: dispatch shapes whose AOT record was made
        self._aot_seen: set = set()
        self.aot_hits = self.aot_misses = self.aot_fallbacks = 0
        self.load_state(params)

    @classmethod
    def from_forwards(cls, forwards: Sequence[Any],
                      **kwargs) -> "FusedClassifierTrainer":
        """A trainer over a unit graph's forward units (their specs and
        current params, :func:`fuse_forwards`)."""
        specs, params = fuse_forwards(forwards)
        return cls(specs, params, **kwargs)

    def load_state(self, params: List[Dict[str, Any]],
                   velocity: Optional[List[Dict[str, Any]]] = None,
                   step: int = 0) -> None:
        """Take params (and momentum and the step count) as numpy or
        tensors in the reference's layout, e.g. a JAX trainer's through
        ``jax.device_get``: training continues where that trainer
        stopped. Missing momentum starts at zero."""
        def tensor(v, spec):
            if self._shards is not None:
                v = self._shards.local(v, spec)
            if torch.is_tensor(v):
                return v.detach().to(self.device, torch.float32, copy=True)
            return torch.from_numpy(np.array(v, np.float32)).to(self.device)

        specs = self._shards.pspecs if self._shards is not None else \
            [{k: () for k in p} for p in params]

        def tensors(tree):
            return [{k: tensor(v, sp[k]) for k, v in p.items()}
                    for p, sp in zip(tree, specs)]

        self.params = tensors(params)
        for leaf in _leaves(self.params):
            leaf.requires_grad_(True)
        self.velocity = tensors(velocity) if velocity is not None else [
            {k: torch.zeros_like(v, requires_grad=False)
             for k, v in p.items()} for p in self.params]
        self._step_counter = int(step)

    def params_numpy(self, whole: bool = False
                     ) -> List[Dict[str, np.ndarray]]:
        """The params as numpy in the reference's layout (the
        counterpart of the reference's ``write_back``); ``{}`` for
        parameterless layers, so the list feeds a new trainer as is. On
        a tensor-parallel mesh: this rank's shards, or with ``whole``
        the whole params, gathered over ``model`` (a collective: every
        rank of the mesh calls it)."""
        out = []
        for p, sp in zip(self.params, self._pspecs()):
            leaves = {}
            for k, v in p.items():
                v = v.detach()
                if whole and "model" in sp[k]:
                    v = collectives.all_gather_cat(
                        v.contiguous(), self._shards.model,
                        sp[k].index("model"))
                leaves[k] = v.cpu().numpy().copy()
            out.append(leaves)
        return out

    def _pspecs(self):
        if self._shards is not None:
            return self._shards.pspecs
        return [{k: () for k in p} for p in self.params]

    def _local(self, x, labels):
        """(x, labels) of a global batch -> this rank's (x rows, label
        rows, shards, global valid-row count) on the device; only the
        rank's rows cross to it."""
        sh = self._shards
        labels = self._labels(labels)
        n_valid = (labels >= 0).sum().clamp_min(1)
        x = sh.rows(x)
        return (self._x(x), sh.rows(labels), sh, n_valid)

    def _step_args(self, x, labels):
        """The batch arguments of :func:`_train_step` for this trainer:
        the whole batch, or on a mesh this rank's part of it."""
        if self._shards is not None:
            return self._local(x, labels)
        return (self._x(x), self._labels(labels))

    # -- non-finite sentinel ------------------------------------------------
    @property
    def nonfinite_count(self) -> int:
        """Train steps whose loss or grads were non-finite so far
        (reading syncs the device accumulator)."""
        return self._sentinel.count

    # -- the hot path ------------------------------------------------------
    def _quantum(self):
        """One scheduler quantum when this trainer is a tenant of a
        shared device; free-running otherwise."""
        return quantum_or_null(self.sched_tenant)

    def _x(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _labels(self, labels) -> torch.Tensor:
        if isinstance(labels, torch.Tensor):
            return labels.to(self.device, torch.int64)
        return torch.from_numpy(np.asarray(labels, np.int64)).to(
            self.device)

    def _lr(self, counter: int) -> float:
        return float(self.lr_policy(self.learning_rate, self.epoch,
                                    counter))

    def step(self, x, labels) -> Dict[str, Any]:
        """One train step on a batch (numpy or tensors; NHWC images or
        flat rows; ``labels < 0`` rows are padding). Returns ``{"loss",
        "n_err", "nonfinite"}`` as 0-d device tensors."""
        self._step_counter += 1
        key = fold_in(self.dropout_seed, self._step_counter)
        x, labels, *extra = self._step_args(x, labels)
        lr = self._lr(self._step_counter)
        with self._quantum():
            loss, n_err, nonfinite = _train_step(
                self.specs, self.params, self.velocity, x, labels, key,
                lr, float(self.weight_decay), float(self.momentum),
                self.compute_dtype, self.nan_policy == "skip",
                self.kernel_impl, *(extra or (None, None)),
                self.record_masks)
        self._sentinel.note(nonfinite)
        obs_profile.on_step()
        return {"loss": loss, "n_err": n_err, "nonfinite": nonfinite}

    def step_many(self, xs, labels) -> Dict[str, Any]:
        """K train steps over a [K, B, ...] stack (or a list of K
        batches). Returns ``{"loss", "n_err", "nonfinite"}`` as [K]
        device tensors; numerics equal K sequential :meth:`step` calls
        (same dropout seeds and learning-rate stream)."""
        local = self._local if self._shards is not None else None
        if isinstance(xs, (list, tuple)):
            xs = torch.stack([torch.as_tensor(x) for x in xs])
            labels = torch.stack([torch.as_tensor(lb) for lb in labels])
        if local is None:
            xs, labels = self._x(xs), self._labels(labels)
        k = int(xs.shape[0])
        counters = list(range(self._step_counter + 1,
                              self._step_counter + k + 1))
        self._step_counter += k
        lrs = [self._lr(c) for c in counters]
        name = "mlp_step_many/k%d_%s_%s" % (
            k, "x".join(str(d) for d in xs.shape[1:]),
            "x".join(str(d) for d in labels.shape[1:]))
        with self._quantum(), self._dispatch_record(name, (xs, labels)):
            losses, n_errs, nonfinite = _train_multi_step(
                self.specs, self.params, self.velocity, xs, labels,
                self.dropout_seed, counters, lrs,
                float(self.weight_decay), float(self.momentum),
                self.compute_dtype, self.nan_policy == "skip",
                self.kernel_impl, local)
        self._sentinel.note(nonfinite)
        obs_profile.on_step(k)
        return {"loss": losses, "n_err": n_errs, "nonfinite": nonfinite}

    def make_loader_step(self, loader, steps_per_dispatch=None):
        """Fold a ``FullBatchLoader``'s device gather into the train
        step: each call gathers its window from the loader's device
        dataset, normalizes it (the loader's normalizer and statistics),
        and takes one train step, as ``step`` on the loader's served
        minibatch would. Marks the loader ``external_gather``: its
        ``run()`` keeps the epoch and offset bookkeeping, serves no
        data, and raises on a minibatch that is not TRAIN (clear the
        flag to hand serving back). Raises on a loader that is not
        initialized.

        K = ``steps_per_dispatch`` (default: the trainer's knob). K = 1
        returns ``step()``, to call after each ``loader.run()``; K > 1
        returns ``multi_step()``, which drives ``loader.run()`` K times
        itself (host bookkeeping only) and then takes the K steps in
        one quantum, returning [K] device metrics. Either way the
        dataset is read afresh each dispatch (a re-upload is seen); a
        floating dataset wider than the compute dtype is cast once,
        the cast cached on the source tensor's identity. The K windows
        are slices of the permutation each ``run()`` left, kept with
        the tensor they slice, so a reshuffle inside a dispatch cannot
        move them and no index is uploaded. The counters, dropout keys
        and learning rates are ``step``'s: K steps in one dispatch
        equal K single loader steps bitwise."""
        if getattr(loader, "_dataset_dev_", None) is None:
            raise RuntimeError(
                "make_loader_step needs an initialized loader: "
                "loader.initialize(device=...) puts the dataset the "
                "fused step gathers from on the device")
        k = self.steps_per_dispatch if steps_per_dispatch is None \
            else int(steps_per_dispatch)
        if k < 1:
            raise ValueError("steps_per_dispatch must be >= 1, got %d" % k)
        loader.external_gather = True
        # closure-local, so one trainer may step over several loaders
        cast_cache: Dict[str, Any] = {"src": None, "out": None}

        def current_dataset() -> torch.Tensor:
            src = loader._dataset_dev_
            if src is None:
                raise RuntimeError(
                    "the loader's device dataset vanished (initialize "
                    "the loader again before stepping)")
            if src is not cast_cache["src"]:
                out = src
                if src.is_floating_point() and \
                        torch.finfo(self.compute_dtype).bits < \
                        torch.finfo(src.dtype).bits:
                    out = src.to(self.compute_dtype)
                cast_cache["src"], cast_cache["out"] = src, out
            return cast_cache["out"]

        def served_window():
            size = loader.minibatch_size
            return loader._perm_dev_, loader.minibatch_offset - size, size

        def dispatch(windows):
            counters = list(range(self._step_counter + 1,
                                  self._step_counter + len(windows) + 1))
            self._step_counter += len(windows)
            lrs = [self._lr(c) for c in counters]
            with self._quantum():
                # inside the quantum: a first cast of the dataset is a
                # whole-dataset device copy, scheduled like the steps
                dataset = current_dataset()
                name = "loader_step_many/k%d_%s" % (
                    len(windows), "x".join(str(d) for d in dataset.shape))
                with self._dispatch_record(name, (dataset,), partial(
                        aot_export.loader_fingerprint, self,
                        loader.normalizer, loader.minibatch_size, dataset,
                        "step_many")):
                    out = [self._window_step(loader, dataset, window, c, lr)
                           for window, c, lr in zip(windows, counters, lrs)]
            return out

        def step() -> Dict[str, Any]:
            (loss, n_err, nonfinite), = dispatch([served_window()])
            self._sentinel.note(nonfinite)
            obs_profile.on_step()
            return {"loss": loss, "n_err": n_err, "nonfinite": nonfinite}

        if k == 1:
            return step

        def multi_step() -> Dict[str, Any]:
            windows = []
            for _ in range(k):
                loader.run()
                windows.append(served_window())
            losses, n_errs, nonfinite = (
                torch.stack(m) for m in zip(*dispatch(windows)))
            self._sentinel.note(nonfinite)
            obs_profile.on_step(k)
            return {"loss": losses, "n_err": n_errs, "nonfinite": nonfinite}

        return multi_step

    def _window_step(self, loader, dataset, window, counter, lr):
        """One loader step over ``window`` (perm, start, size)."""
        perm, start, size = window
        x, labels = loader.gather(start, size, dataset, perm)
        x, labels, *extra = self._step_args(x, labels)
        return _train_step(
            self.specs, self.params, self.velocity, x, labels,
            fold_in(self.dropout_seed, counter), lr,
            float(self.weight_decay), float(self.momentum),
            self.compute_dtype, self.nan_policy == "skip",
            self.kernel_impl, *(extra or (None, None)), self.record_masks)

    @contextlib.contextmanager
    def _dispatch_record(self, name: str, inputs, fingerprint=None):
        """Around a dispatch: its AOT record at the first dispatch of
        ``name`` (the launches it made, observed; an eager dispatch
        has no replay), nothing at a later one."""
        if name in self._aot_seen:
            yield
            return
        with launches.observing(self.device) as seen:
            yield
        self._aot_seen.add(name)
        graphs.note_shape()
        aot_warmup.note(self, fingerprint or partial(
            aot_export.fused_trainer_fingerprint, self), name, inputs,
            ("params", "velocity"), seen, captured=False, owner="trainer")

    def predict(self, x) -> torch.Tensor:
        """Logits [B, classes] f32 of the forward without dropout (on a
        mesh: every rank computes its rows, and all get the whole
        batch's logits; a collective)."""
        with torch.no_grad():
            if self._shards is None:
                return _apply(self.specs, False, self.params, self._x(x), 0,
                              self.compute_dtype, self.kernel_impl)
            logits = _apply(self.specs, False, self.params,
                            self._x(self._shards.rows(x)), 0,
                            self.compute_dtype, self.kernel_impl,
                            self._shards)
            return collectives.all_gather_cat(logits, self._shards.data, 0)

    def count_errors(self, x, labels) -> int:
        """Masked argmax error count on a (possibly padded) batch."""
        logits = self.predict(x)
        labels = self._labels(labels)
        valid = labels >= 0
        return int((valid & (logits.argmax(dim=-1) != labels)).sum())

    # -- interop with the unit graph ---------------------------------------
    def write_back(self, forwards: Sequence[Any]) -> None:
        """Put the trained params into the forward units' Arrays (host
        copies; the next device read uploads them). The gradient-descent
        units share these Arrays."""
        for unit, p in zip(forwards, self.params_numpy(whole=True)):
            if p:
                unit.weights.reset(p["w"])
                unit.bias.reset(p["b"])


def train_fused(workflow, mesh=None, tensor_parallel: bool = False,
                max_epochs: Optional[int] = None,
                compute_dtype=None, steps_per_dispatch: int = 1,
                kernel_impl: Optional[str] = None):
    """Train an initialized StandardWorkflow through
    :class:`FusedClassifierTrainer`, then write the params back into
    its unit graph.

    The unit graph stays the definition and bookkeeping surface
    (loader, snapshots, serving); the hot loop is one fused step per
    TRAIN minibatch on the workflow's device:

    >>> wf = MnistWorkflow(max_epochs=10)
    >>> wf.initialize(device=Device())
    >>> metrics = train_fused(wf)          # instead of wf.run()

    The hyperparameters (lr, weight decay, momentum, lr policy) come
    from the workflow's GD units and its scheduler's ``base_lr``. The
    TRAIN error counts stay on the device and are read once an epoch;
    a VALID minibatch reads its count when scored. The run ends with a
    VALID sweep of the trained params, as the unit graph's decision
    scores them. Returns the decision's metrics (min validation error
    %, its epoch, min train error %, epochs).

    ``mesh``/``tensor_parallel``: the fused trainer's (every rank runs
    the same workflow, whose loader serves the same global minibatches;
    each rank steps on its rows and shards, and the whole params are
    written back on every rank)."""
    from veles_tpu_torch.loader.base import TRAIN, VALID

    if workflow.device is None:
        raise RuntimeError("train_fused needs an initialized workflow "
                           "(workflow.initialize(device=...))")
    loader = workflow.loader
    gd = next(g for g in workflow.gds if hasattr(g, "learning_rate"))
    policy = None
    base_lr = float(gd.learning_rate)
    scheduler = getattr(workflow, "lr_scheduler", None)
    if scheduler is not None:
        policy = scheduler.policy
        # gd.learning_rate already has the policy applied (the
        # scheduler runs at initialize): use the recorded base
        if scheduler.base_lr is not None:
            base_lr = scheduler.base_lr
    trainer = FusedClassifierTrainer.from_forwards(
        workflow.forwards, learning_rate=base_lr,
        weight_decay=float(getattr(gd, "weight_decay", 0.0)),
        momentum=float(getattr(gd, "momentum", 0.0)),
        lr_policy=policy, compute_dtype=compute_dtype,
        steps_per_dispatch=steps_per_dispatch, kernel_impl=kernel_impl,
        device=workflow.device.torch_device, mesh=mesh,
        tensor_parallel=tensor_parallel)

    if max_epochs is None:
        max_epochs = getattr(workflow.decision, "max_epochs", 10) or 10

    min_val_err = float("inf")
    min_val_epoch = -1
    min_train_err = float("inf")
    val_err = 0
    val_samples = 0
    # the TRAIN steps' n_err stay device scalars, summed and read once
    # an epoch (by then the steps have run anyway)
    train_err_dev: List[torch.Tensor] = []
    train_samples = 0
    while loader.epoch_number < max_epochs:
        loader.run()
        klass = loader.minibatch_class
        size = loader.minibatch_size
        x = loader.minibatch_data.devmem
        labels = loader.minibatch_labels.devmem
        trainer.epoch = loader.epoch_number
        if klass == TRAIN:
            metrics = trainer.step(x, labels)
            train_err_dev.append(metrics["n_err"])
            train_samples += size
        elif klass == VALID:
            val_err += trainer.count_errors(x, labels)
            val_samples += size
        if bool(loader.epoch_ended):
            if val_samples:
                err_pt = 100.0 * val_err / val_samples
                if err_pt < min_val_err:
                    min_val_err = err_pt
                    min_val_epoch = loader.epoch_number
                val_err = 0
                val_samples = 0
            if train_samples:
                epoch_train_err = int(torch.stack(train_err_dev).sum())
                min_train_err = min(
                    min_train_err,
                    100.0 * epoch_train_err / train_samples)
                train_err_dev = []
                train_samples = 0
    # The last VALID sweep: VALID precedes TRAIN in the serving order,
    # so the loop above ends after the last TRAIN segment without
    # scoring the trained model (the unit-graph decision scores it)
    while True:
        loader.run()
        klass = loader.minibatch_class
        if klass == TRAIN:
            break  # the next TRAIN segment: stop before training more
        if klass == VALID:
            val_err += trainer.count_errors(
                loader.minibatch_data.devmem,
                loader.minibatch_labels.devmem)
            val_samples += loader.minibatch_size
            if bool(loader.last_minibatch):
                break
    if val_samples:
        err_pt = 100.0 * val_err / val_samples
        if err_pt < min_val_err:
            min_val_err = err_pt
            min_val_epoch = loader.epoch_number
    trainer.write_back(workflow.forwards)
    return {
        "min_validation_error_pt": min_val_err,
        "min_validation_epoch": min_val_epoch,
        "min_train_error_pt": min_train_err,
        "epochs": loader.epoch_number,
    }
