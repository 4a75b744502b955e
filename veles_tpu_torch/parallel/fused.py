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

A trainer whose ``sched_tenant`` is set runs each ``step``/``step_many``
as one quantum of a shared device (``veles_tpu_torch.sched``). The
reference's mesh and tensor-parallel placement, ``shard_*``, AOT
dispatch, ``make_loader_step`` (with its loader steps),
``fuse_forwards`` and ``train_fused`` are queued in ROADMAP.md.
"""

from __future__ import annotations

import logging
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from veles_tpu_torch.config import get, root
from veles_tpu_torch.device import compute_dtype as _dtype_of
from veles_tpu_torch.device import resolve
from veles_tpu_torch.nn.activation import ACTIVATIONS
from veles_tpu_torch.nn.conv import conv_raw, conv_s2d_raw
from veles_tpu_torch.nn.lr_policy import make_policy
from veles_tpu_torch.nn.lrn import lrn_raw
from veles_tpu_torch.nn.pooling import pool_raw
from veles_tpu_torch.obs import profile as obs_profile
from veles_tpu_torch.ops import _build
from veles_tpu_torch.ops.rng import fold_in, uniform_fill
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


def _fc(h, w, b, compute_dtype, out_dtype):
    """The reference's ``jnp.dot(h, w, preferred_element_type=f32)
    .astype(out_dtype) + b``: operands rounded to the compute dtype,
    f32 accumulation. An f32 result (the logits head) takes the
    product in f32 on the rounded operands; a compute-dtype result is
    the compute-dtype product (f32 accumulation, one rounding)."""
    h2 = h.reshape(h.shape[0], -1).to(compute_dtype)
    wc = w.to(compute_dtype)
    if out_dtype != compute_dtype:
        z = (h2.float() @ wc.float()).to(out_dtype)
    else:
        z = h2 @ wc
    return z + b.to(out_dtype)


def _apply(specs: Tuple[Any, ...], train: bool, params, x, key: int,
           compute_dtype: torch.dtype, kernel_impl: Optional[str] = None):
    """Forward pass; a softmax tail returns LOGITS (the loss takes
    log_softmax). Inter-layer activations live in the compute dtype,
    the logits head in the params' dtype (f32). ``key`` is the step's
    dropout seed (unused unless ``train``); ``kernel_impl`` goes to the
    LRN and fill wrappers."""
    h = x.to(compute_dtype)
    if h.ndim == 3:
        h = h[..., None]
    last_parametric = max(
        (i for i, s in enumerate(specs) if s[0] in ("fc", "conv")),
        default=-1)
    for i, (spec, p) in enumerate(zip(specs, params)):
        kind = spec[0]
        last = i == last_parametric
        if kind == "fc":
            act = spec[1]
            out_dtype = p["w"].dtype if last else compute_dtype
            z = _fc(h, p["w"], p["b"], compute_dtype, out_dtype)
            h = z if act == "softmax" else ACTIVATIONS[act](z)
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
            z = conv_fn(h, p["w"], p["b"], strides, padding,
                        compute_dtype,
                        out_dtype=p["w"].dtype if last else compute_dtype)
            h = z if act == "softmax" else ACTIVATIONS[act](z)
        elif kind == "pool":
            _, pkind, ky, kx, strides = spec
            h = pool_raw(pkind, ky, kx, strides, h)
        elif kind == "lrn":
            _, k, n, alpha, beta = spec
            h = lrn_raw(h, k, n, alpha, beta, impl=kernel_impl)
        elif kind == "dropout":
            if train:
                keep = 1.0 - spec[1]
                fill = uniform_fill(fold_in(key, i), h.shape,
                                    device=h.device, impl=kernel_impl)
                h = h * ((fill < keep).to(h.dtype) / keep)
        else:
            raise ValueError("unknown fused layer kind %r" % (kind,))
    return h


def _loss_fn(specs, train, params, x, labels, key, compute_dtype,
             kernel_impl=None):
    """Mean softmax cross-entropy over the rows with ``labels >= 0``
    (padding rows carry -1); returns (loss, logits)."""
    logits = _apply(specs, train, params, x, key, compute_dtype,
                    kernel_impl)
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1).gather(1, safe[:, None])[:, 0]
    n_valid = valid.sum().clamp_min(1)
    loss = -(logp * valid).sum() / n_valid
    return loss, logits


def _leaves(params) -> List[torch.Tensor]:
    return [t for p in params if p for t in (p["w"], p["b"])]


def _train_step(specs, params, velocity, x, labels, key, lr: float,
                weight_decay: float, momentum: float, compute_dtype,
                skip_nonfinite: bool = False,
                kernel_impl: Optional[str] = None):
    """One step in place on ``params`` and ``velocity``: forward, loss,
    autograd backward, then ``v = momentum v - lr (g + wd w)`` (no
    decay on biases) and ``p += v``. Returns (loss, n_err, nonfinite)
    as 0-d device tensors."""
    loss, logits = _loss_fn(specs, True, params, x, labels, key,
                            compute_dtype, kernel_impl)
    grads = torch.autograd.grad(loss, _leaves(params))
    loss = loss.detach()
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
        valid = labels >= 0
        pred = logits.detach().argmax(dim=-1)
        n_err = (valid & (pred != labels)).sum().to(torch.int32)
    return loss, n_err, (~ok).to(torch.int32)


def _train_multi_step(specs, params, velocity, xs, labels, key: int,
                      counters, lrs, weight_decay, momentum, compute_dtype,
                      skip_nonfinite=False, kernel_impl=None):
    """K steps over ``xs``/``labels`` ([K, B, ...]), step k's dropout
    seed folded from ``counters[k]`` and its learning rate ``lrs[k]``:
    the same ops as K :func:`_train_step` calls. Returns the [K] losses,
    error counts and non-finite flags."""
    out = [_train_step(specs, params, velocity, x, lbl, fold_in(key, c),
                       lr, weight_decay, momentum, compute_dtype,
                       skip_nonfinite, kernel_impl)
           for x, lbl, c, lr in zip(xs, labels, counters, lrs)]
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

    ``sched_tenant`` (a ``TenantHandle``, None = free-running): every
    ``step``/``step_many`` dispatch runs as ONE scheduler quantum, with
    the same counters, dropout keys and learning-rate stream, so the
    trajectory stays bitwise that of an unscheduled run.
    """

    def __init__(self, specs: Sequence[Any], params: List[Dict[str, Any]],
                 learning_rate: float = 0.1, weight_decay: float = 0.0,
                 momentum: float = 0.9, lr_policy=None, compute_dtype=None,
                 dropout_seed: int = 0, nan_policy: Optional[str] = None,
                 kernel_impl: Optional[str] = None, device=None) -> None:
        self.device = resolve(device)
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
        self.load_state(params)

    def load_state(self, params: List[Dict[str, Any]],
                   velocity: Optional[List[Dict[str, Any]]] = None,
                   step: int = 0) -> None:
        """Take params (and momentum and the step count) as numpy or
        tensors in the reference's layout, e.g. a JAX trainer's through
        ``jax.device_get``: training continues where that trainer
        stopped. Missing momentum starts at zero."""
        def tensor(v):
            if torch.is_tensor(v):
                return v.detach().to(self.device, torch.float32, copy=True)
            return torch.from_numpy(np.array(v, np.float32)).to(self.device)

        def tensors(tree):
            return [{k: tensor(v) for k, v in p.items()} for p in tree]

        self.params = tensors(params)
        for leaf in _leaves(self.params):
            leaf.requires_grad_(True)
        self.velocity = tensors(velocity) if velocity is not None else [
            {k: torch.zeros_like(v, requires_grad=False)
             for k, v in p.items()} for p in self.params]
        self._step_counter = int(step)

    def params_numpy(self) -> List[Dict[str, np.ndarray]]:
        """The params as numpy in the reference's layout (the
        counterpart of the reference's ``write_back``); ``{}`` for
        parameterless layers, so the list feeds a new trainer as is."""
        return [{k: v.detach().cpu().numpy().copy() for k, v in p.items()}
                for p in self.params]

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
        x, labels = self._x(x), self._labels(labels)
        lr = self._lr(self._step_counter)
        with self._quantum():
            loss, n_err, nonfinite = _train_step(
                self.specs, self.params, self.velocity, x, labels, key,
                lr, float(self.weight_decay), float(self.momentum),
                self.compute_dtype, self.nan_policy == "skip",
                self.kernel_impl)
        self._sentinel.note(nonfinite)
        obs_profile.on_step()
        return {"loss": loss, "n_err": n_err, "nonfinite": nonfinite}

    def step_many(self, xs, labels) -> Dict[str, Any]:
        """K train steps over a [K, B, ...] stack (or a list of K
        batches). Returns ``{"loss", "n_err", "nonfinite"}`` as [K]
        device tensors; numerics equal K sequential :meth:`step` calls
        (same dropout seeds and learning-rate stream)."""
        if isinstance(xs, (list, tuple)):
            xs = torch.stack([self._x(x) for x in xs])
            labels = torch.stack([self._labels(lb) for lb in labels])
        xs, labels = self._x(xs), self._labels(labels)
        k = int(xs.shape[0])
        counters = list(range(self._step_counter + 1,
                              self._step_counter + k + 1))
        self._step_counter += k
        lrs = [self._lr(c) for c in counters]
        with self._quantum():
            losses, n_errs, nonfinite = _train_multi_step(
                self.specs, self.params, self.velocity, xs, labels,
                self.dropout_seed, counters, lrs,
                float(self.weight_decay), float(self.momentum),
                self.compute_dtype, self.nan_policy == "skip",
                self.kernel_impl)
        self._sentinel.note(nonfinite)
        obs_profile.on_step(k)
        return {"loss": losses, "n_err": n_errs, "nonfinite": nonfinite}

    def predict(self, x) -> torch.Tensor:
        """Logits [B, classes] f32 of the forward without dropout."""
        with torch.no_grad():
            return _apply(self.specs, False, self.params, self._x(x), 0,
                          self.compute_dtype, self.kernel_impl)

    def count_errors(self, x, labels) -> int:
        """Masked argmax error count on a (possibly padded) batch."""
        logits = self.predict(x)
        labels = self._labels(labels)
        valid = labels >= 0
        return int((valid & (logits.argmax(dim=-1) != labels)).sum())
