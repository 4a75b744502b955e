"""Pipeline parallelism: layer stages across a ``pipe`` mesh axis.

Port of ``veles_tpu/parallel/pipeline.py``. Each rank of the ``pipe``
axis holds one stage of a repeated, shape-preserving layer stack and
runs the GPipe schedule over ``M`` microbatches in ``M + S - 1`` ticks:
at tick t stage s applies itself to microbatch ``t - s`` (when there is
one) and sends the result to stage s + 1; stage 0 injects, the last
stage banks. The outputs are then summed over the axis (only the last
stage banked), so every rank holds them, as the reference's ``psum``
leaves them.

The reference differentiates through its ``scan`` and ``ppermute``;
here the schedule is one ``torch.autograd.Function`` whose backward is
the reverse schedule written out: the last stage takes the outputs'
cotangent, each stage back-propagates its microbatches in reverse order
and sends each input's cotangent to the stage before, and stage 0's
input cotangents are summed over the axis (the trunk's input is the
same on every rank). Sends and receives pair up in one order on both
ends, so the schedule cannot deadlock.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from veles_tpu_torch.parallel import collectives


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, stage_fn, names, *leaves):
        n_stages, stage = axis.size, axis.index
        m = x.shape[0]
        params = {k: p.detach().requires_grad_() for k, p in
                  zip(names, leaves)}
        ins, outs = [None] * m, [None] * m
        banked = torch.zeros_like(x)
        for tick in range(m + n_stages - 1):
            mb = tick - stage
            if not 0 <= mb < m:
                continue
            if stage == 0:
                act = x[mb].detach()
            else:
                act = collectives.recv(x.shape[1:], x.dtype, x.device, axis,
                                       stage - 1)
            act.requires_grad_()
            with torch.enable_grad():
                out = stage_fn(params, act)
            ins[mb], outs[mb] = act, out
            if stage < n_stages - 1:
                collectives.send(out.detach(), axis, stage + 1)
            else:
                banked[mb] = out.detach()
        ctx.graph = (axis, params, ins, outs)
        # only the last stage banked: the sum over the axis is its copy
        return collectives.all_reduce_sum(banked, axis)

    @staticmethod
    def backward(ctx, g):
        axis, params, ins, outs = ctx.graph
        n_stages, stage = axis.size, axis.index
        keys = list(params)
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        dx = torch.zeros_like(g)
        for mb in reversed(range(len(ins))):
            if stage == n_stages - 1:
                g_out = g[mb]
            else:
                g_out = collectives.recv(g.shape[1:], g.dtype, g.device,
                                         axis, stage + 1)
            got = torch.autograd.grad(
                outs[mb], [ins[mb]] + [params[k] for k in keys], g_out)
            for k, gk in zip(keys, got[1:]):
                grads[k] += gk
            if stage > 0:
                collectives.send(got[0], axis, stage - 1)
            else:
                dx[mb] = got[0]
        ctx.graph = None
        return ((collectives.all_reduce_sum(dx, axis), None, None, None)
                + tuple(grads[k] for k in keys))


def pipeline_spmd(stage_fn: Callable, stage_params: Dict[str, Any], x,
                  axis):
    """The GPipe schedule over the mesh axis ``axis`` (a ``Mesh.axis``
    whose size is the stage count).

    ``stage_fn(params, act) -> act`` (shape-preserving); ``stage_params``
    this rank's stage's params (a dict of tensors); ``x`` ``[M, mb, F]``
    microbatches, the same on every rank. Returns ``[M, mb, F]`` trunk
    outputs, the same on every rank; differentiable in ``x`` and the
    stage's params."""
    names = list(stage_params)
    if axis.size == 1:
        return torch.stack([stage_fn(stage_params, x[i])
                            for i in range(x.shape[0])])
    return _GPipe.apply(x, axis, stage_fn, names,
                        *[stage_params[k] for k in names])


def _stage_fn(p, act):
    return torch.tanh(act @ p["w"] + p["b"])


def _head_loss(h, head_w, labels):
    logits = torch.einsum("mbh,hc->mbc", h, head_w)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None])[..., 0].mean()


class PipelineMLPTrainer:
    """A repeated shape-preserving MLP trunk pipelined over ``pipe``:
    in_proj -> S x [mb, H]->[mb, H] stages -> head, trained with SGD.
    Every rank holds ``in_w`` and ``head_w`` (and computes them alike)
    and its stage's ``w``/``b``; initial params are the reference's
    draws (same generator, same order)."""

    def __init__(self, mesh, n_features: int, hidden: int, n_classes: int,
                 n_stages: int, learning_rate: float = 0.1,
                 seed: int = 0) -> None:
        if mesh.shape.get("pipe", 1) != n_stages:
            raise ValueError("mesh 'pipe' axis (%s) != n_stages %d" %
                             (mesh.shape.get("pipe"), n_stages))
        self.mesh = mesh
        self.axis = mesh.axis("pipe")
        self.device = mesh.device
        self.learning_rate = learning_rate
        rng = np.random.default_rng(seed)

        def glorot(shape, fan_in, fan_out):
            s = np.sqrt(6.0 / (fan_in + fan_out))
            return rng.uniform(-s, s, shape).astype(np.float32)

        host = {
            "in_w": glorot((n_features, hidden), n_features, hidden),
            "stages": {
                "w": glorot((n_stages, hidden, hidden), hidden, hidden),
                "b": np.zeros((n_stages, hidden), np.float32),
            },
            "head_w": glorot((hidden, n_classes), hidden, n_classes),
        }
        s = self.axis.index

        def tensor(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device).requires_grad_()

        self.params = {
            "in_w": tensor(host["in_w"]),
            "stages": {k: tensor(v[s]) for k, v in host["stages"].items()},
            "head_w": tensor(host["head_w"]),
        }

    def _leaves(self):
        p = self.params
        return [p["in_w"], p["stages"]["w"], p["stages"]["b"], p["head_w"]]

    def _loss(self, x, labels):
        h = torch.tanh(torch.einsum("mbf,fh->mbh", x, self.params["in_w"]))
        h = pipeline_spmd(_stage_fn, self.params["stages"], h, self.axis)
        return _head_loss(h, self.params["head_w"], labels)

    def _inputs(self, x, labels):
        x = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        labels = torch.as_tensor(np.asarray(labels, np.int64)).to(
            self.device)
        return x, labels

    def loss_and_grads(self, x, labels):
        """(loss, grads of ``in_w``, this stage's ``w``, ``b`` and
        ``head_w``) of the microbatches, nothing updated."""
        loss = self._loss(*self._inputs(x, labels))
        return loss.detach(), torch.autograd.grad(loss, self._leaves())

    def step(self, x, labels) -> Dict[str, Any]:
        """x ``[M, mb, F]`` microbatches; labels ``[M, mb]`` int. One SGD
        step; returns ``{"loss"}`` (0-d device tensor, the same on every
        rank)."""
        loss, grads = self.loss_and_grads(x, labels)
        with torch.no_grad():
            for p, g in zip(self._leaves(), grads):
                p -= self.learning_rate * g
        return {"loss": loss}

    def loss(self, x, labels) -> float:
        with torch.no_grad():
            return float(self._loss(*self._inputs(x, labels)))

    def params_numpy(self) -> Dict[str, Any]:
        """The whole params as numpy in the reference's layout, the
        stages gathered over ``pipe`` (a collective)."""
        def host(t):
            return t.detach().cpu().numpy().copy()

        stages = {k: host(collectives.all_gather_cat(
            v.detach()[None], self.axis, 0))
            for k, v in self.params["stages"].items()}
        return {"in_w": host(self.params["in_w"]), "stages": stages,
                "head_w": host(self.params["head_w"])}

    def reference_loss_fn(self):
        """The SAME network computed sequentially (no pipeline) for
        parity tests: ``loss_fn(params, x, labels)`` on the CPU, the
        params numpy or tensors (differentiable through tensors)."""
        def ref(params, x, labels, device: Optional[str] = "cpu"):
            def t(a):
                return torch.as_tensor(a).to(device)

            x = t(np.asarray(x, np.float32))
            labels = t(np.asarray(labels, np.int64))
            h = torch.tanh(torch.einsum("mbf,fh->mbh", x, t(params["in_w"])))
            ws, bs = params["stages"]["w"], params["stages"]["b"]
            for s in range(np.shape(ws)[0]):
                h = torch.tanh(h @ t(ws[s]) + t(bs[s]))
            return _head_loss(h, t(params["head_w"]), labels)

        return ref
